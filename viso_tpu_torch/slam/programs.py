"""The engines' compiled device programs: `Program`, the port's
counterpart of `jax.jit` and the JAX engine's `_kernels` cache.

A program is a function of tensors with a fixed signature (track,
templates, keyframe insertion, window BA). On a CUDA engine, `Program`
captures it once as a CUDA graph and replays the graph on every later
call; both trace the program once at fixed shapes and run it again on new
inputs. Each call:

  * stages its arguments into static buffers that the program owns: a
    tensor is copied in (from pinned host memory without waiting for
    the device), a Python bool, int or float (a slot, an eviction
    flag, a frame id: what the JAX jit traces) is written into a 0-d
    tensor with `fill_`, which puts the value in the kernel's arguments
    without a host copy. A tensor the engine keeps for its whole life
    (its map, pose and templates: `owned`) is read where it lies, with no
    copy; passing another tensor in its place raises;
  * on the card: at the first call, warms the function up on a side
    stream (two eager calls: lazy library and handle set-up), captures
    it there (`capture_error_mode="thread_local"`) and replays; later
    calls replay. A capture that fails raises: there is no eager
    fallback and no switch;
  * on the CPU: calls the function eagerly and copies its outputs into
    static output buffers, so the CPU sees the aliasing the card does;
  * returns the same output tensors every time. They hold this call's
    results until the next call of the program overwrites them: a caller
    that keeps one longer copies it. An output that is a view of an input
    (a field the program passes through) is that view.

Python-side launch counters (`COUNTERS`: K1's, K2's and the direct GN
kernel's) move when their wrapper launches a kernel, and a replay runs
no Python. So the capture measures how far each counter moved inside it
(the launches the graph holds), takes that back (a capture launches
nothing), and each replay adds it (`Program._replayed`).

Each call is a span of the frame recorder (`utils/profiling.RECORDER`),
`launch.<name>`, and a capture is `capture.<name>` inside it (or inside
a drain's `drain`), counted as `captures`. A capture keeps its graph's
`cudaGraph_t` to count the kernel nodes once (`Program.kernels`); each
replay runs between a pair of the frame's CUDA events and adds that
count to the frame's `graph_kernels`.

The bare functions stay callable: tools and checks that want the eager
version call them directly (`vo._track(...)`).

A layer that runs one function at several static shapes (the SLAM loop
layer: a pose-graph solve per power-of-two bucket, loop detection, the
keyframe digest) keeps its programs in a `Cache`, keyed by name and
static shape as the JAX jit cache is. A cached program's first call runs
the function eagerly on the caller's stream and returns that result
(it is the warm-up: lazy library and handle set-up on the calling
thread); its second call captures and replays on the caller's stream;
later calls replay. Only the cache's own thread (the one that made it:
the engine's dispatch thread) captures, and only its own programs, at
their second call. A program made on another thread (the loop worker's
detection and solves) runs eagerly at its second call too and asks for
its capture (`Cache.drain`): the engine drains those requests on its
own thread at the start of each `process()` and in `join()` and
`trajectory()`. So no capture runs while the engine's caller is outside
an engine call, and a caller's device-wide synchronise between those
calls never meets one (a synchronise from any thread during a capture
is refused and breaks it). The worker runs the program eagerly until
its graph is in place, then replays it.

Every capture of a program runs on a stream that the cache keeps for
the thread that made the program, and that no eager work uses: work
another thread or a finalizer enqueues there (the pinned host allocator
records its events on the streams a block was copied on, when the block
is freed) would join the graph. Captures begin and end on their stream
alone (`capture_begin(capture_error_mode="thread_local")`), with no
device-wide synchronisation: the worker's eager work goes on while the
dispatch thread captures.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import threading
import time

import torch

from viso_tpu_torch import _cuda
from viso_tpu_torch.geometry import extract, extract_aligned
from viso_tpu_torch.ops import direct
from viso_tpu_torch.utils.profiling import RECORDER

# (object, attribute) of each Python-side launch counter of the port.
COUNTERS = ((extract.launch, "launches"), (extract_aligned.launch, "launches"),
            (direct.launch, "launches"))
# Eager calls on a side stream before the capture.
WARMUP_CALLS = 2
_SCALAR_DTYPES = {bool: torch.bool, int: torch.int64, float: torch.float32}


def flatten(tree):
    """(leaves, spec) of nested tuples, named tuples, lists and dicts."""
    leaves = []

    def walk(x):
        if isinstance(x, (tuple, list)):
            return type(x), tuple(walk(v) for v in x)
        if isinstance(x, dict):
            return dict, tuple((k, walk(v)) for k, v in x.items())
        leaves.append(x)
        return None

    return leaves, walk(tree)


def unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, kids = s
        if kind is dict:
            return {k: build(v) for k, v in kids}
        vals = [build(k) for k in kids]
        return kind(vals) if kind in (tuple, list) else kind(*vals)

    return build(spec)


def host_tensors(arrays, device):
    """Numpy arrays as CPU tensors to stage into a program on `device`: in
    pinned memory when it is a CUDA device, so that the copies need not
    wait for it."""
    pin = torch.device(device).type == "cuda"
    return [torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a) for a in arrays]


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
    of the tensors the engine keeps for its life, read in place; name:
    the program's name (the function's by default); cache: the `Cache`
    whose program it is: its first call then runs `fn` eagerly and
    returns its result (the warm-up), and its second captures with no
    further warm-up on the cache's thread or asks the cache for its
    capture on another (by default: capture at the first call, on a new
    side stream after WARMUP_CALLS there); counted: whether a capture measures
    `COUNTERS` (a program that holds no counted kernel and is captured
    while another thread launches one must not, or it would take that
    thread's launches back); on_replay: called after each replay, for
    Python-side records that the function keeps and a replay does not
    run (`parallel/dist_ba.ShardedSolver.replayed`)."""

    def __init__(self, fn, device, owned=frozenset(), *, name=None, cache=None,
                 counted=True, on_replay=None):
        self.fn = fn
        self.on_replay = on_replay
        self.name = name or getattr(fn, "__name__", type(fn).__name__)
        self.device = torch.device(device)
        self.owned = owned
        self.cache = cache
        self.graphed = cache.graphed if cache is not None else self.device.type == "cuda"
        # The thread that made the program: its captures use that thread's
        # stream of the cache.
        self.thread = threading.get_ident()
        self.requested = False  # its capture is queued in the cache
        self.counted = counted
        self.spec = None
        self.inputs = None      # static input leaves (tensors, or None)
        self.values = None      # the Python scalars last written
        self.graph = None
        self.outputs = None
        self._out_leaves = None  # (CPU) the output leaves and which of
        self._passed = None      # them are views of an input
        self.counts = {}        # counter moves one replay holds
        self.kernels = None     # kernel nodes of its graph (None: not counted)
        self.calls = 0
        self.replays = 0
        self._span = "launch." + self.name

    def __call__(self, *args):
        with RECORDER.time(self._span):
            self._stage(args)
            self.calls += 1
            if not self.graphed:
                return self._eager()
            graph = self.graph   # read once: another thread may set it
            if graph is None:
                if self.cache is not None and (self.calls == 1
                                               or not self.cache.capture_here(self)):
                    return self.fn(*unflatten(self.spec, self.inputs))
                self.capture()
                graph = self.graph
            RECORDER.replay(self.name, graph, self.kernels)
            self._replayed()
            return self.outputs

    def capture(self):
        """Capture the program on its staged inputs (`_capture`): a cache's
        program with no further warm-up on the cache's stream for the
        thread that made it, any other on a new side stream after
        WARMUP_CALLS. Counts its graph's kernel nodes."""
        kw = {}
        if self.cache is not None:
            kw = {"warmups": 0, "counted": self.counted,
                  "stream": self.cache.capture_stream(self.thread)}
        RECORDER.count("captures")
        with RECORDER.time("capture." + self.name):
            graph, self.outputs, self.counts = _capture(
                self.fn, unflatten(self.spec, self.inputs), self.device, **kw)
            self.kernels = kernel_nodes(graph)
        self.graph = graph   # last: a thread that sees the graph finds its outputs

    def _replayed(self):
        self.replays += 1
        add_counts(self.counts)
        if self.on_replay is not None:
            self.on_replay()

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
                s.copy_(x, non_blocking=True)
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
            if x.data_ptr() in self.owned:
                return x
            # Always the program's own copy: `x.to(device)` returns `x`
            # itself when `x` lies there already (an argument on "cuda:0" of
            # a program made for "cuda"), and the caller's tensor would
            # become the program's buffer.
            if x.device.type != self.device.type:   # host memory
                return x.to(self.device, non_blocking=True)
            return x.clone()
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


class Cache:
    """Programs keyed by name and static shape, each made at its first
    use (the JAX jit cache): `get(key, fn)` returns the program of `key`,
    whose first element names it, made from `fn` when the key is new.
    Its programs run eagerly at their first call and capture at their
    second, on the cache's thread; one made on another thread asks for
    its capture, which `drain` makes (module docstring). owned: data
    pointers read in place, a set that the layer extends with the tensors
    it keeps for its life. `captures` records each drained capture as
    (name, seconds on the host clock)."""

    def __init__(self, device, owned=()):
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self.owned = set(owned)
        self.programs: dict = {}
        self.thread = threading.get_ident()
        self.captures: list = []
        self._streams: dict = {}   # thread id -> the stream of its programs' captures
        self._requests = collections.deque()
        self._lock = threading.Lock()

    def own(self, *tensors):
        self.owned.update(x.data_ptr() for x in tensors)

    def get(self, key, fn, *, counted=False):
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = Program(fn, self.device, self.owned, name=key[0],
                                                cache=self, counted=counted)
        return prog

    def run(self, name, fn, statics, *args, counted=False):
        """`fn(*args, **statics)` through the program of its name, static
        arguments and argument shapes: the `run(name, fn, statics, *args)`
        of a function split into segments between the calls that read the
        device on the host (`ops/ransac.py`, `ops/twoview.py`,
        `slam/loop_closure._detect`)."""
        shapes = tuple(tuple(x.shape) for x in flatten(args)[0])
        key = (name, tuple(sorted(statics.items())), shapes)
        return self.get(key, functools.partial(fn, **statics), counted=counted)(*args)

    def capture_here(self, prog) -> bool:
        """Whether `prog` (due to capture) captures now: on the cache's
        thread, a program made there. Otherwise its capture is queued,
        once, for `drain`, and it runs eagerly meanwhile."""
        if threading.get_ident() == self.thread == prog.thread:
            return True
        with self._lock:
            if not prog.requested:
                prog.requested = True
                self._requests.append(prog)
        return False

    @property
    def pending(self) -> int:
        """Captures asked for and not yet made."""
        return len(self._requests)

    def drain(self):
        """Make, on the calling thread, the captures that programs made on
        another thread asked for (each on the stream of the thread that
        made it). The engine calls this inside its own calls only."""
        if not self._requests:
            return
        with RECORDER.time("drain"):
            while self._requests:
                prog = self._requests.popleft()
                if prog.graph is None:
                    t0 = time.perf_counter()
                    prog.capture()
                    self.captures.append((prog.name, time.perf_counter() - t0))

    def capture_stream(self, thread):
        """The stream the captures of the programs made on `thread` (an
        ident) use, made at its first use (within the cache's life, so
        that the stream pool's round robin does not hand it to the layer's
        other streams)."""
        with self._lock:
            if thread not in self._streams:
                self._streams[thread] = torch.cuda.Stream(self.device)
            return self._streams[thread]


def _capture(fn, args, device, warmups=WARMUP_CALLS, counted=True, stream=None):
    """Capture `fn(*args)` as a CUDA graph on `stream` (a new side stream
    by default), after `warmups` eager calls there, ordered after the
    current stream's work. Returns (graph, static outputs, counter moves
    one replay holds)."""
    main = torch.cuda.current_stream(device)
    stream = stream if stream is not None else torch.cuda.Stream(device)
    stream.wait_stream(main)
    # The cudaGraph_t is kept, for `kernel_nodes`; the executable graph is
    # made below, once the capture has ended.
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    out = []

    def capture():
        with gc_paused(), torch.cuda.device(device), torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out.append(fn(*args))
            finally:
                graph.capture_end()

    with torch.cuda.device(device), torch.cuda.stream(stream):
        for _ in range(warmups):
            fn(*args)
    if counted:
        counts = measure_counts(capture)
    else:
        capture()
        counts = {}
    with torch.cuda.device(device):
        graph.instantiate()
    main.wait_stream(stream)
    return graph, out[0], counts


def kernel_nodes(graph):
    """The kernel nodes of a captured graph that keeps its `cudaGraph_t`
    (`_capture`), its child graphs' included (`_cuda.graph_nodes`); None
    for any other graph, or where the driver cannot be asked."""
    raw = getattr(graph, "raw_cuda_graph", None)
    if raw is None:
        return None
    try:
        return _cuda.graph_nodes(raw()).get(_cuda.GRAPH_NODE_KERNEL, 0)
    except (OSError, RuntimeError):
        return None


# Captures in flight, and whether the collector ran before the first.
_GC_PAUSE = {"depth": 0, "enabled": True}
_GC_LOCK = threading.Lock()


@contextlib.contextmanager
def gc_paused():
    """The cyclic garbage collector off while a capture runs. An engine is
    a reference cycle (its programs hold its bound methods), so a closed
    engine's CUDA graphs go when a collection finds it; a graph destroyed
    during a capture ("operation not permitted when stream is capturing")
    breaks that capture. The collector's state is the process's, so
    overlapping pauses nest."""
    with _GC_LOCK:
        if _GC_PAUSE["depth"] == 0:
            _GC_PAUSE["enabled"] = gc.isenabled()
            gc.disable()
        _GC_PAUSE["depth"] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_PAUSE["depth"] -= 1
            if _GC_PAUSE["depth"] == 0 and _GC_PAUSE["enabled"]:
                gc.enable()
