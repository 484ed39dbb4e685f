"""Distributed bundle adjustment: landmarks sharded over the ranks of a
`torch.distributed` group (port of `viso_tpu/parallel/dist_ba.py`).

Camera blocks are replicated, landmark blocks and their Schur
marginalization stay rank-local, and only the reduced camera system
crosses between ranks: per LM iteration one fused `all_reduce` of U, g_c,
the Schur cross terms and the cost inside `ba.schur_solve`, and one of the
accept test's (cost, n_obs) -- the reference's two `psum`s. Their size
depends on the camera count alone (`psum_bytes_per_iter`).

Every rank builds the same full problem, solves its landmark block, and
after the LM loop the blocks are gathered once, so every rank ends with
the full solution (the reference's `device_put` to one device and its
`collect`). The gather is a sum of disjoint zero-padded blocks through
`all_reduce`, because gloo has no all-gather for CUDA tensors; it is
exact, and it is one collective per solve, not per iteration.

SPMD discipline: every rank must hold the same replicated problem and
call the solver the same number of times in the same order.

The solve is a program (`ShardedSolver.program`, the reference's
`jax.jit(shard_map(ba.solve_impl))`) where its collectives can be
captured in a CUDA graph: over NCCL, or with no group. Its first call is
eager (on NCCL it makes the communicator a capture needs), its second
captures, later calls replay. gloo's collectives cannot be captured, so
over gloo the solver runs eagerly (`capturable`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
import torch.nn.functional as F

from viso_tpu_torch.backend import ba
from viso_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_landmarks


def pad_landmarks(prob: ba.BAProblem, multiple: int) -> ba.BAProblem:
    """Pad the landmark axis so it splits evenly across the group."""
    L = prob.points.shape[0]
    pad = (-L) % multiple
    if pad == 0:
        return prob
    return prob._replace(
        points=F.pad(prob.points, (0, 0, 0, pad)),
        obs_uv=F.pad(prob.obs_uv, (0, 0, 0, pad)),
        obs_mask=F.pad(prob.obs_mask, (0, pad)),
        point_mask=F.pad(prob.point_mask, (0, pad)),
    )


def psum_bytes_per_iter(num_cams: int, dtype_bytes: int = 4) -> int:
    """Bytes each LM iteration all-reduces over the group: the fused
    reduction inside schur_solve (U (C,6,6), g_c (C,6), S_cross
    (C,C,6,6), b_cross (C,6), the folded cost) and the accept test's
    (cost, n_obs). Independent of the landmark count."""
    C = num_cams
    per_iter = (
        C * 36        # U
        + C * 6       # g_c
        + C * C * 36  # S_cross
        + C * 6       # b_cross
        + 1           # folded current-state cost
        + 2           # accept-test compute_cost: cost + n_obs
    )
    return per_iter * dtype_bytes


# Collectives per LM iteration: the fused normal-equation reduction and
# the accept-test scalars.
PSUMS_PER_ITER = 2


def capturable(mesh: Mesh) -> bool:
    """Whether the sharded solve can be captured as a CUDA graph: with no
    group (a world of one: nothing to reduce) or over NCCL, whose
    collectives a graph holds; not over gloo."""
    return mesh.group is None or dist.get_backend(mesh.group) == "nccl"


@dataclass
class CollectiveStats:
    """What the last solve handed to `all_reduce`: the bytes of each call
    in order, CUDA events around each call of an eager solve on a CUDA
    group (none in a captured one: a graph's events cannot be timed), and
    the bytes of the one point gather (not an LM reduction, so not in
    `sizes`)."""

    sizes: list = field(default_factory=list)
    events: list = field(default_factory=list)
    gather_bytes: int = 0

    def reset(self):
        self.sizes, self.events, self.gather_bytes = [], [], 0

    @property
    def calls(self) -> int:
        return len(self.sizes)

    def per_iter(self, iters: int):
        """(calls, bytes, ms) per LM iteration: every call but the initial
        and the final cost's, over `iters`. ms is their stream time from
        the CUDA events (synchronises), None without them."""
        loop, events = self.sizes[1:-1], self.events[1:-1]
        ms = None
        if events:
            events[-1][1].synchronize()
            ms = sum(s.elapsed_time(e) for s, e in events) / iters
        return len(loop) / iters, sum(loop) / iters, ms


class ShardedSolver:
    """A landmark-sharded `ba.solve_impl` over `mesh` (see the module
    docstring). Call it with the full, replicated problem, padded to a
    multiple of the group size; it returns (problem, info) like
    `ba.solve_impl`, with the gathered points of every rank."""

    def __init__(self, mesh: Mesh, params: ba.BAParams):
        self.mesh = mesh
        self.params = params
        self.stats = CollectiveStats()
        self._captured = None   # (sizes, gather bytes) of the captured solve

    def program(self, capture_stream):
        """This solver as a program (`slam/programs.Program`, named
        `ba_solve`): eager at its first call, captured at its second on the
        stream `capture_stream()` gives, replayed after; `stats` restored
        from the capture after each replay. Raises over gloo."""
        from viso_tpu_torch.slam import programs

        if not capturable(self.mesh):
            raise ValueError("the sharded solve over gloo cannot be captured: call the "
                             "solver eagerly")
        return programs.Program(self, self.mesh.device, name="ba_solve",
                                capture_stream=capture_stream, counted=False,
                                on_replay=self.replayed)

    def replayed(self):
        """After a replay of the captured solve: `stats` as the capture
        recorded them (a replay runs no Python), with no events."""
        sizes, gather_bytes = self._captured
        self.stats.sizes, self.stats.events, self.stats.gather_bytes = (
            list(sizes), [], gather_bytes)

    def reduce(self, tensors):
        """Sum `tensors` in place over the group: one flat buffer, one
        `all_reduce`. Counted; the identity without a group."""
        self.stats.sizes.append(sum(x.numel() * x.element_size() for x in tensors))
        if self.mesh.group is None:
            return
        flat = torch.cat([x.reshape(-1) for x in tensors])
        if flat.is_cuda and not torch.cuda.is_current_stream_capturing():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dist.all_reduce(flat, group=self.mesh.group)
            end.record()
            self.stats.events.append((start, end))
        else:
            dist.all_reduce(flat, group=self.mesh.group)
        for x, part in zip(tensors, flat.split([x.numel() for x in tensors])):
            x.copy_(part.view_as(x))

    def _gather(self, block, lo: int, L: int):
        # Under a capture `full` comes from the graph's own memory pool: a
        # static buffer of the program.
        if self.mesh.group is None:
            return block
        full = block.new_zeros((L,) + tuple(block.shape[1:]))
        full[lo:lo + block.shape[0]] = block
        self.stats.gather_bytes += full.numel() * full.element_size()
        dist.all_reduce(full, group=self.mesh.group)
        return full

    def __call__(self, prob: ba.BAProblem):
        dev = prob.R.device
        if dev.type != self.mesh.device.type or (
            None not in (dev.index, self.mesh.device.index) and dev.index != self.mesh.device.index
        ):
            raise ValueError(f"problem on {dev}, mesh on {self.mesh.device}")
        self.stats.reset()
        if prob.cam_fixed is None:
            prob = prob._replace(
                cam_fixed=torch.zeros(prob.R.shape[0], dtype=torch.bool, device=dev)
            )
        L = prob.points.shape[0]
        lo, hi = shard_landmarks(self.mesh, L)
        local = prob._replace(
            points=prob.points[lo:hi],
            obs_uv=prob.obs_uv[:, lo:hi],
            obs_mask=prob.obs_mask[:, lo:hi],
            point_mask=prob.point_mask[lo:hi],
        )
        out, info = ba.solve_impl(local, self.params, reduce=self.reduce)
        out = prob._replace(R=out.R, t=out.t, points=self._gather(out.points, lo, L))
        if prob.R.is_cuda and torch.cuda.is_current_stream_capturing():
            self._captured = (list(self.stats.sizes), self.stats.gather_bytes)
        return out, info


@functools.lru_cache(maxsize=32)
def make_sharded_solver(mesh: Mesh, params: ba.BAParams) -> ShardedSolver:
    """The landmark-sharded solver of (mesh, params), built once: engine
    loops ask for it at every keyframe and get the same object."""
    return ShardedSolver(mesh, params)


def solve_sharded(prob: ba.BAProblem, params: ba.BAParams = ba.BAParams(),
                  mesh: Mesh | None = None):
    """Distributed `ba.solve_impl` over `mesh` (default: the whole world,
    on the problem's device). Any landmark count: padded here and
    stripped from the result. Returns (BAProblem, info)."""
    if mesh is None:
        mesh = make_mesh(device=prob.R.device)
    out, info = make_sharded_solver(mesh, params)(pad_landmarks(prob, mesh.size))
    L0 = prob.points.shape[0]
    return out._replace(
        points=out.points[:L0],
        obs_uv=out.obs_uv[:, :L0],
        obs_mask=out.obs_mask[:, :L0],
        point_mask=out.point_mask[:L0],
    ), info
