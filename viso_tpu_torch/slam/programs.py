"""The engines' compiled device programs: `Program`, the port's
counterpart of `jax.jit` and the JAX engine's `_kernels` cache.

A program is a function of tensors with a fixed signature (track,
templates, keyframe insertion, window BA). On a CUDA engine, `Program`
captures it once as a CUDA graph and replays the graph on every later
call; both trace the program once at fixed shapes and run it again on new
inputs. Each call:

  * stages its arguments into static buffers that the program owns: a
    tensor is copied in, a Python bool, int or float (a slot, an eviction
    flag, a frame id: what the JAX jit traces) is written into a 0-d
    tensor with `fill_`, which puts the value in the kernel's arguments
    without a host copy. A tensor the engine keeps for its whole life
    (its map, pose and templates: `owned`) is read where it lies, with no
    copy; passing another tensor in its place raises;
  * on the card: at the first call, warms the function up on a side
    stream (two eager calls: lazy library and handle set-up), captures
    it with `torch.cuda.graph(..., capture_error_mode="thread_local")`
    and replays; later calls replay. A capture that fails raises: there
    is no eager fallback and no switch;
  * on the CPU: calls the function eagerly and copies its outputs into
    static output buffers, so the CPU sees the aliasing the card does;
  * returns the same output tensors every time. They hold this call's
    results until the next call of the program overwrites them: a caller
    that keeps one longer copies it. An output that is a view of an input
    (a field the program passes through) is that view.

Python-side launch counters (`COUNTERS`: K1's and K2's) move when their
wrapper launches a kernel, and a replay runs no Python. So the capture
measures how far each counter moved inside it (the launches the graph
holds), takes that back (a capture launches nothing), and each replay
adds it (`Program._replayed`).

The bare functions stay callable: tools and checks that want the eager
version call them directly (`vo._track(...)`).
"""

from __future__ import annotations

import torch

from viso_tpu_torch.geometry import extract, extract_aligned

# (object, attribute) of each Python-side launch counter of the port.
COUNTERS = ((extract.launch, "launches"), (extract_aligned.launch, "launches"))
# Eager calls on a side stream before the capture.
WARMUP_CALLS = 2
_SCALAR_DTYPES = {bool: torch.bool, int: torch.int64, float: torch.float32}


def flatten(tree):
    """(leaves, spec) of nested tuples, named tuples and lists."""
    leaves = []

    def walk(x):
        if isinstance(x, (tuple, list)):
            return type(x), tuple(walk(v) for v in x)
        leaves.append(x)
        return None

    return leaves, walk(tree)


def unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, kids = s
        vals = [build(k) for k in kids]
        return kind(vals) if kind in (tuple, list) else kind(*vals)

    return build(spec)


def measure_counts(fn):
    """Call `fn()`, then take back what it added to each of `COUNTERS`;
    returns {(object, attribute): moves} for the counters that moved."""
    before = [getattr(obj, attr) for obj, attr in COUNTERS]
    fn()
    moved = {}
    for (obj, attr), b in zip(COUNTERS, before):
        if getattr(obj, attr) != b:
            moved[(obj, attr)] = getattr(obj, attr) - b
            setattr(obj, attr, b)
    return moved


def add_counts(counts):
    for (obj, attr), n in counts.items():
        setattr(obj, attr, getattr(obj, attr) + n)


class Program:
    """One engine program, captured once and replayed (module docstring).

    fn: the bare function; device: the engine's; owned: the data pointers
    of the tensors the engine keeps for its life, read in place."""

    def __init__(self, fn, device, owned=frozenset()):
        self.fn = fn
        self.name = getattr(fn, "__name__", type(fn).__name__)
        self.device = torch.device(device)
        self.owned = owned
        self.graphed = self.device.type == "cuda"
        self.spec = None
        self.inputs = None      # static input leaves (tensors, or None)
        self.values = None      # the Python scalars last written
        self.graph = None
        self.outputs = None
        self._out_leaves = None  # (CPU) the output leaves and which of
        self._passed = None      # them are views of an input
        self.counts = {}        # counter moves one replay holds
        self.replays = 0

    def __call__(self, *args):
        self._stage(args)
        if not self.graphed:
            return self._eager()
        if self.graph is None:
            self.graph, self.outputs, self.counts = _capture(
                self.fn, unflatten(self.spec, self.inputs), self.device)
        self.graph.replay()
        self._replayed()
        return self.outputs

    def _replayed(self):
        self.replays += 1
        add_counts(self.counts)

    def _stage(self, args):
        leaves, spec = flatten(args)
        if self.spec is None:
            self.spec = spec
            self.values = [None if isinstance(x, torch.Tensor) else x for x in leaves]
            self.inputs = [self._static(x) for x in leaves]
            return
        if spec != self.spec:
            raise TypeError(f"{self.name}: the arguments' structure changed")
        for i, (x, s) in enumerate(zip(leaves, self.inputs)):
            if isinstance(x, torch.Tensor):
                if x.data_ptr() == s.data_ptr() and x.shape == s.shape:
                    continue
                if s.data_ptr() in self.owned:
                    raise ValueError(f"{self.name}: argument {i} is the engine's own "
                                     "tensor; pass that tensor")
                if x.shape != s.shape or x.dtype != s.dtype:
                    raise ValueError(f"{self.name}: argument {i} is {x.dtype} "
                                     f"{tuple(x.shape)}, captured as {s.dtype} "
                                     f"{tuple(s.shape)}")
                s.copy_(x)
            elif s is None:
                if x is not None:
                    raise TypeError(f"{self.name}: argument {i} was None")
            else:
                if type(x) is not type(self.values[i]):
                    raise TypeError(f"{self.name}: argument {i} is {type(x).__name__}, "
                                    f"was {type(self.values[i]).__name__}")
                if x != self.values[i]:
                    s.fill_(x)
                    self.values[i] = x

    def _static(self, x):
        if isinstance(x, torch.Tensor):
            return x if x.data_ptr() in self.owned else x.clone()
        if x is None:
            return None
        if type(x) not in _SCALAR_DTYPES:
            raise TypeError(f"{self.name}: cannot stage an argument of type {type(x).__name__}")
        return torch.empty((), dtype=_SCALAR_DTYPES[type(x)], device=self.device).fill_(x)

    def _eager(self):
        out = self.fn(*unflatten(self.spec, self.inputs))
        leaves, spec = flatten(out)
        if self.outputs is None:
            ins = {s.untyped_storage().data_ptr() for s in self.inputs
                   if isinstance(s, torch.Tensor)}
            self._passed = [isinstance(x, torch.Tensor)
                            and x.untyped_storage().data_ptr() in ins for x in leaves]
            self._out_leaves = leaves
            self.outputs = unflatten(spec, self._out_leaves)
            return self.outputs
        for x, s, p in zip(leaves, self._out_leaves, self._passed):
            if isinstance(x, torch.Tensor) and not p:
                s.copy_(x)
        return self.outputs


def _capture(fn, args, device):
    """Warm `fn(*args)` up on a side stream, capture it as a CUDA graph.
    Returns (graph, static outputs, counter moves one replay holds)."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(WARMUP_CALLS):
            fn(*args)
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    out = []

    def capture():
        with torch.cuda.device(device), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            out.append(fn(*args))

    counts = measure_counts(capture)
    return graph, out[0], counts
