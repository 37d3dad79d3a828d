"""CUDA graphs of the port's steps: the counterpart of ``jax.jit``'s cache.

The JAX package runs each step as one compiled program, one program per
static signature (``medmamba_tpu/train/trainer.py:92``, ``:119``,
``cli/evaluate.py:107``). Here a :class:`CompiledStep` captures a step
function into one CUDA graph per signature and replays it:

* **The signature** (:func:`cache_key`): the step's name, the input shapes
  and dtypes, its static arguments (``augment``, ``image_size``, ...) and
  the scan setting a CUDA tensor's scan reads at each call,
  ``MEDMAMBA_SCAN_KERNEL`` and ``MEDMAMBA_SCAN_COMPUTE``. A graph freezes
  the kernel it recorded, so a change of either variable captures a new
  graph and never replays a stale one.
* **Capture** (:class:`Graph`): the inputs are copied into static buffers;
  the step runs WARMUP times on a side stream (a kernel's first launch
  builds it with ``nvcc`` and an optimizer's first step makes its state,
  neither of which may happen inside a capture); then it is captured into
  a private memory pool with the default ``capture_error_mode="global"``.
  The warm-up ran real steps, so the caller's ``restore`` puts the model,
  the optimizer and the generators back as they were before it (see
  ``train/trainer.py``). A capture that fails raises, naming the last
  operator it reached; nothing falls back to the eager step.
* **Replay**: each call copies its inputs into the static buffers, replays
  the graph and returns the graph's output tensors, which the next replay
  overwrites: clone what must outlive it.
* **Launch counts**: the kernel wrappers count in Python, which a replay
  does not run. The counts recorded while capturing are kept as the
  graph's ``counts``, the warm-up's and the capture's own are taken back
  out (they are the compile step's, as ``jax.jit``'s tracing is), and each
  replay adds ``counts``: a replayed step counts the launches an eager step
  would.
* **The state guard** (:class:`StateGuard`): a graph reads and writes the
  tensors it was captured with. A replay raises if a parameter, buffer,
  tensor attribute, optimizer-state tensor or tensor learning rate was
  replaced since capture (``opt.load_state_dict``, ``model.to(other)``),
  rather than updated in place.
* **Tracing** (``utils/tracing.py``): a call is the span ``graph.call``
  (the signature, the lookup, the capture or the replay) and counts
  ``graph.replays``, ``graph.captures`` and ``graph.evictions``; a capture
  is the span ``graph.capture`` and sets the gauge ``graph.nodes.<label>``,
  its graph's node count; a replay's parts are the spans ``graph.guard``,
  ``graph.copy_in`` and ``graph.launch``.

Random draws from a ``torch.Generator`` inside the step come from the
generators registered with the graph (``CUDAGraph.register_generator_state``;
the card's default generator is registered by torch itself): a replay
draws what the eager step draws from the same generator state, and
advances it as the eager step does.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from medmamba_tpu_torch.ops import rotate, scan_cuda, scan_hillis
from medmamba_tpu_torch.ops import selective_scan as ss
from medmamba_tpu_torch.utils import tracing

WARMUP = 2
# the kernel wrappers' launch counters: (module, attribute)
COUNTERS = ((scan_cuda, "LAUNCHES"), (scan_cuda, "BWD_LAUNCHES"),
            (scan_hillis, "HILLIS_LAUNCHES"),
            (scan_hillis, "HILLIS_BWD_LAUNCHES"), (rotate, "LAUNCHES"))


def read_counts() -> Dict[str, int]:
    """The launch counters, keyed ``module.attribute``."""
    return {f"{m.__name__.rsplit('.', 1)[1]}.{a}": getattr(m, a)
            for m, a in COUNTERS}


def add_counts(delta: Dict[str, int]) -> None:
    for m, a in COUNTERS:
        setattr(m, a, getattr(m, a)
                + delta.get(f"{m.__name__.rsplit('.', 1)[1]}.{a}", 0))


def counted(fn: Callable, *args):
    """``(fn(*args), the launches it counted)``, the counters left as they
    were before the call."""
    before = read_counts()
    out = fn(*args)
    after = read_counts()
    add_counts({k: before[k] - after[k] for k in before})
    return out, {k: after[k] - before[k] for k in before}


def cache_key(name: str, tensors: Sequence[torch.Tensor], static: Dict):
    """The static signature of one call of a step: its name, each input's
    shape and dtype, the static arguments, and the kernel pair and compute
    mode a CUDA tensor's scan runs now (``MEDMAMBA_SCAN_KERNEL``,
    ``MEDMAMBA_SCAN_COMPUTE``)."""
    return (name, tuple((tuple(t.shape), t.dtype) for t in tensors),
            tuple(sorted(static.items())),
            (ss._kernel_impl(), ss._compute_env()))


class StateGuard:
    """The data pointers of a model's parameters, buffers and tensor
    attributes and of an optimizer's state tensors and tensor learning
    rates, as they were when the guard was made; :meth:`check` raises if
    any has changed. The
    tensors are looked up where the model and the optimizer hold them
    (module by module, parameter by parameter), found once here: a check
    walks no module tree."""

    def __init__(self, model: torch.nn.Module,
                 opt: Optional[torch.optim.Optimizer] = None):
        mods = list(model.modules())
        self.slots = {
            "a parameter": [(m._parameters, n) for m in mods
                            for n, p in m._parameters.items()
                            if p is not None],
            "a buffer": [(m._buffers, n) for m in mods
                         for n, b in m._buffers.items() if b is not None],
            # a tensor held as a plain attribute: an exported program's
            # lifted constants (the preprocessing's resize weights)
            "a constant tensor": [(vars(m), n) for m in mods
                                  for n, v in vars(m).items()
                                  if torch.is_tensor(v)]}
        self.opt = opt
        if opt is not None:
            self.slots["a learning-rate tensor"] = [
                (g, "lr") for g in opt.param_groups
                if torch.is_tensor(g["lr"])]
            self.opt_slots = [(p, k) for p, st in opt.state.items()
                              for k, v in st.items() if torch.is_tensor(v)]
        self.want = self._pointers()

    def _pointers(self) -> Dict[str, list]:
        try:
            ptrs = {kind: [d[n].data_ptr() for d, n in slots]
                    for kind, slots in self.slots.items()}
        except (KeyError, AttributeError):
            return {}
        if self.opt is not None:
            state = self.opt.state
            try:
                ptrs["an optimizer state tensor"] = [
                    state[p][k].data_ptr() for p, k in self.opt_slots]
            except (KeyError, AttributeError):
                ptrs["an optimizer state tensor"] = None
        return ptrs

    def check(self) -> None:
        got = self._pointers()
        for kind, want in self.want.items():
            if got.get(kind) != want:
                raise RuntimeError(
                    f"{kind} was replaced since the step was captured (e.g. "
                    "by load_state_dict or .to()); its graph would use the "
                    "old one. Load state in place before the first call, or "
                    "compile the step again")


def node_count(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a graph captured with ``keep_graph=True``
    (``cuGraphGetNodes`` of ``libcuda``)."""
    get = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_size_t)]
    get.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = get(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed ({rc})")
    return n.value


class _LastOp(TorchDispatchMode):
    """Records the name of the last operator dispatched, for the error of a
    capture that fails."""

    name = "no operator"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.name = str(func)
        return func(*args, **(kwargs or {}))


class Graph:
    """One step captured at one signature (see the module docstring).

    ``fn(*static_inputs)`` is the step of ``model`` (and ``opt``, whose
    tensors the guard watches with the model's); ``inputs`` give the static
    buffers' shapes, dtypes and first values, on the model's device.
    ``restore()`` (optional) is called after the capture to undo the
    warm-up; ``generators`` are registered with the graph. After capture,
    ``counts`` holds the launches a replay adds, ``capture_s`` the seconds
    of warm-up, capture and restore (the ``graph.capture`` span), and
    ``pool_bytes`` the device memory the capture's private pool took at its
    peak."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], *,
                 label: str, model: torch.nn.Module,
                 opt: Optional[torch.optim.Optimizer] = None,
                 restore: Optional[Callable[[], None]] = None,
                 generators: Iterable[torch.Generator] = ()):
        device = next(model.parameters()).device
        if device.type != "cuda":
            raise RuntimeError(f"{label}: CUDA graphs need a CUDA device, "
                               f"got {device}; call the eager step instead")
        generators = list(generators)
        if generators and not hasattr(torch.cuda.CUDAGraph,
                                      "register_generator_state"):
            raise RuntimeError(
                f"{label}: this torch ({torch.__version__}) cannot register "
                "a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state)")
        with tracing.span("graph.capture") as timed:
            self.static = [x.to(device, copy=True) for x in inputs]
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            before = read_counts()
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(*self.static)
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            # the graph kept after capture, so its nodes can be counted
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            for g in generators:
                self.graph.register_generator_state(g)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            last = _LastOp()
            try:
                with torch.cuda.graph(self.graph), last:
                    self.outputs, self.counts = counted(fn, *self.static)
            except Exception as e:
                raise RuntimeError(f"capturing the {label} failed at "
                                   f"{last.name}: {e}") from e
            finally:
                add_counts({k: before[k] - v
                            for k, v in read_counts().items()})
            self.graph.instantiate()
            if restore is not None:
                restore()
            torch.cuda.synchronize(device)
            self.pool_bytes = torch.cuda.max_memory_allocated(device) - base
        self.capture_s = timed.seconds
        tracing.gauge(f"graph.nodes.{label}", node_count(self.graph))
        self.guard = StateGuard(model, opt)

    def __call__(self, *inputs: torch.Tensor):
        with tracing.span("graph.guard"):
            self.guard.check()
        with tracing.span("graph.copy_in"):
            for s, x in zip(self.static, inputs):
                if x is not s:
                    s.copy_(x, non_blocking=True)
        with tracing.span("graph.launch"):
            self.graph.replay()
        add_counts(self.counts)
        return self.outputs

    def free(self) -> None:
        """Release the graph, its buffers and its pool's tensors."""
        self.graph.reset()
        self.static = self.outputs = None


class CompiledStep:
    """A step function with one :class:`Graph` per static signature,
    captured at the first call with that signature: the port's ``jax.jit``.

    ``capture(*inputs, **static) -> Graph`` makes the graph of one
    signature; ``free`` (optional) is called after the graphs are freed.
    ``graphs`` maps each signature (:func:`cache_key`) to its graph, least
    recently used first. With ``maxsize``, capturing one more graph than
    that first frees the least recently used one (``Graph.free``) and
    returns its pool to the card, as the JAX package's ``_LRU`` bounds its
    programs: a server called at many shapes holds at most ``maxsize``
    pools."""

    def __init__(self, name: str, capture: Callable[..., Graph],
                 free: Optional[Callable[[], None]] = None,
                 maxsize: Optional[int] = None):
        if maxsize is not None and maxsize < 1:
            raise ValueError(f"maxsize must be at least 1, got {maxsize}")
        self.name, self._capture, self._free = name, capture, free
        self.maxsize = maxsize
        self.graphs: Dict[tuple, Graph] = {}

    def __call__(self, *inputs: torch.Tensor, **static):
        with tracing.span("graph.call"):
            key = cache_key(self.name, inputs, static)
            graph = self.graphs.pop(key, None)
            if graph is None:
                if (self.maxsize is not None
                        and len(self.graphs) >= self.maxsize):
                    self.graphs.pop(next(iter(self.graphs))).free()
                    torch.cuda.empty_cache()
                    tracing.count("graph.evictions")
                graph = self._capture(*inputs, **static)
                tracing.count("graph.captures")
            self.graphs[key] = graph
            tracing.count("graph.replays")
            return graph(*inputs)

    def free(self) -> None:
        for graph in self.graphs.values():
            graph.free()
        self.graphs.clear()
        if self._free is not None:
            self._free()
        torch.cuda.empty_cache()
