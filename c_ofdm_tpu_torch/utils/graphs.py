"""The port's counterpart of ``jax.jit``: a step captured as a CUDA graph.

The JAX package runs each hot entry point (``transmit_jit``,
``receive_batch_jit``, ``receive_capture_jit``, ``demod_frames_jit``,
``process_buffer``, the ``rx`` app's steps) as one compiled program per
call, cached by the static arguments and the input shapes.  On the card the
counterpart is a CUDA graph (``torch.cuda.CUDAGraph``): the step's kernels,
K1-K4 among them, are recorded once and replayed with one launch.

``CapturedCall`` holds the graphs of one step, one per key (the input
shapes, dtypes and device, and whatever static part the caller adds: the
spec, the static arguments).  On CPU tensors it runs the step eagerly, as
the caller asked for the CPU.  The first call on the card for a key

1. copies the inputs into static input tensors (plain allocations);
2. runs the step eagerly ``WARMUP`` times on a side stream, which builds
   and loads the kernel libraries (``ops/_kernels.py::library``), creates
   the cuBLAS and cuFFT state and fills the ``lru_cache``d constants, and
   loads every CUDA module the step touches; tensors the step updates in
   place (``restore``) are put back after each warm-up run;
3. captures one run on that stream into the graph's own memory pool, under
   ``torch.cuda.graph``'s default ``capture_error_mode="global"``: a host
   synchronisation or a pageable host-to-device copy inside the step raises
   (with the key in the message).  Nothing falls back to an eager run.

A graph records the addresses of the device constants it reads, not the
tensors.  The per-device constant caches (``device_cache``) therefore hand
every value they return during a capture to that graph, which holds it:
an entry the cache later evicts stays allocated for as long as the graph
replays it.

Every call then copies its inputs into the static inputs (one copy kernel
each), replays the graph, and returns fresh clones of the static outputs
(one copy kernel per output tensor, ``Graph.clone_launches``): ``jax.jit``
returns new arrays on every call, and callers keep the outputs of one call
while they make the next.

Kernel launch counts.  The kernel wrappers count their launches on the host
(``ops.extract``'s three wrappers: ``launches`` and ``class_launches``;
``ops.dft.dft``: ``launches`` and one ``<route>_launches`` a route).  No
Python runs on a replay, so a graph records the counts its capture added
and adds them again on every replay; the set-up runs (warm-up and capture)
leave the counts as they found them.  A count therefore says how many times
the path launched the kernel in calls made by its users.

Tracing (``io/trace.py``).  With the recorder on, a call runs under an
``entry`` span and is captured and replayed as a graph of its own (the
tracing state is part of the key): its capture carries the stage marks and
the sync's hit counter, and ends with the ``end`` mark; ``capture``,
``copy_in``, ``launch`` and ``clone`` spans time its host path.  The
recorder's work counts ride the launch counts.  With the recorder off, a
call costs one flag test more than an untraced program, and its graphs
are node for node those of one.

K1's launch plan reads the addresses of its operands (the ``.cu``'s
``plan_window``); inside a graph those addresses are the static tensors'
and the pool's, fixed for the life of the graph, so the plan that capture
bakes in stays valid on every replay.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time
from typing import Any, Callable, Dict, Hashable, NamedTuple, Sequence

import torch

from ..io import trace

WARMUP = 2      # eager runs before a capture (torch.cuda.make_graphed_callables
#                 runs 3; two fill every cache the port's steps have)

_held: list | None = None   # the cached constants the running capture reads


def device_cache(maxsize: int) -> Callable:
    """``functools.lru_cache(maxsize)`` for the device constants a step
    reads; a value returned while a capture runs is also held by the graph
    being captured (see the module's docstring)."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            value = cached(*args)
            if _held is not None:
                _held.append(value)
            return value

        get.cache_clear = cached.cache_clear
        get.cache_info = cached.cache_info
        return get
    return wrap


@contextlib.contextmanager
def _holding():
    """The ``device_cache`` values returned inside the block, as a list."""
    global _held
    _held = held = []
    try:
        yield held
    finally:
        _held = None


def _counted():
    """The kernel wrappers whose launch counts a graph replays, and the
    trace recorder's ``count``, whose work counts ride with them."""
    from ..ops import dft, extract
    return (extract.extract_windows, extract.extract_windows_single,
            extract.extract_windows_multi, dft.dft, trace.count)


def launch_counts() -> Dict[tuple, int]:
    """Every launch count of the kernel wrappers, and the recorder's work
    counts: {(wrapper, attribute, class or None): count}."""
    counts = {}
    for fn in _counted():
        for name, value in vars(fn).items():
            if not name.endswith(("launches", "work_counts")):
                continue
            if isinstance(value, dict):
                for k, v in value.items():
                    counts[(fn, name, k)] = v
            else:
                counts[(fn, name, None)] = value
    return counts


def _set_counts(counts: Dict[tuple, int]) -> None:
    for (fn, name, k), v in counts.items():
        if k is None:
            setattr(fn, name, v)
        else:
            getattr(fn, name)[k] = v


def _add_counts(delta: Dict[tuple, int]) -> None:
    for (fn, name, k), d in delta.items():
        if k is None:
            setattr(fn, name, getattr(fn, name) + d)
        else:
            getattr(fn, name)[k] = getattr(fn, name).get(k, 0) + d


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a nest of tuples, NamedTuples and lists;
    anything else is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return tree


def tree_leaves(tree) -> list:
    """The tensors of a nest, in order."""
    out = []
    tree_map(out.append, tree)
    return out


def tensor_key(tensors: Sequence[torch.Tensor]) -> tuple:
    """(shape, dtype, device) of each tensor: what a graph's static inputs
    fix."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream warm-up and capture run on, one per device (the cuBLAS
    workspace it needs is then made during warm-up, not in the capture)."""
    return torch.cuda.Stream(device)


class Graph(NamedTuple):
    """One captured step."""
    graph: torch.cuda.CUDAGraph
    static_in: tuple          # tensors the inputs are copied into
    static_out: Any           # the captured run's outputs (in the pool)
    delta: Dict[tuple, int]   # launch counts one replay adds
    clone_launches: int       # copy kernels the fresh outputs cost
    capture_s: float          # warm-up + capture, host seconds
    pool_bytes: int           # memory the capture reserved (its pool)
    held: list                # the cached constants the graph reads

    def replay(self, inputs: Sequence[torch.Tensor]):
        for s, x in zip(self.static_in, inputs):
            s.copy_(x)
        self.graph.replay()
        _add_counts(self.delta)
        return tree_map(torch.Tensor.clone, self.static_out)

    def replay_traced(self, inputs: Sequence[torch.Tensor]):
        """``replay`` under the recorder's ``copy_in``, ``launch`` and
        ``clone`` spans."""
        rec = trace.recorder
        with rec.span("copy_in"):
            for s, x in zip(self.static_in, inputs):
                s.copy_(x)
        with rec.span("launch"):
            self.graph.replay()
        with rec.span("clone"):
            _add_counts(self.delta)
            return tree_map(torch.Tensor.clone, self.static_out)


class CapturedCall:
    """The graphs of one step, one per key.  ``name`` labels errors.  The
    graphs, their pools and the key's static part (a spec, held by
    identity) live until ``clear``: reuse one spec across calls, as a new
    spec object captures a new graph."""

    def __init__(self, name: str):
        self.name = name
        self.graphs: Dict[Hashable, Graph] = {}

    def clear(self) -> None:
        """Drop every graph (their pools are freed with them)."""
        self.graphs.clear()

    def __call__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 restore: Sequence[torch.Tensor] = (),
                 static: Hashable = ()):
        """``fn(*inputs)``: eagerly unless every input is a CUDA tensor,
        else as the replay of the graph keyed by ``static`` and the inputs'
        ``tensor_key``, captured on the first call for that key.  ``fn`` may
        update the tensors in ``restore`` in place (stream state,
        accumulators): the graph then updates them on every replay, and
        warm-up puts them back."""
        inputs = tuple(inputs)
        if trace.recorder.on:
            return self._traced(fn, inputs, tuple(restore), static)
        if not inputs or any(x.device.type != "cuda" for x in inputs):
            return fn(*inputs)
        key = (static, tensor_key(inputs))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(key, fn, inputs,
                                                 tuple(restore))
        return g.replay(inputs)

    def _traced(self, fn, inputs, restore, static):
        """``__call__`` with the recorder on: an ``entry`` span around the
        call, and on the card the graph of the traced key (``("traced",
        static)``), whose capture ends with the ``end`` mark and adds to the
        device's hit counter."""
        rec = trace.recorder

        def marked(*xs):
            out = fn(*xs)
            rec.mark("end", xs[0] if xs else None)
            return out

        with rec.entry(self.name):
            if not inputs or any(x.device.type != "cuda" for x in inputs):
                return marked(*inputs)
            key = (("traced", static), tensor_key(inputs))
            g = self.graphs.get(key)
            if g is None:
                label = f"{self.name} {[s for s, _, _ in key[1]]}"
                with rec.span("capture", label):
                    hits = rec.hit_counter(inputs[0].device)
                    g = self.graphs[key] = self._capture(
                        key, marked, inputs, restore + (hits,))
            return g.replay_traced(inputs)

    def _capture(self, key, fn, inputs, restore) -> Graph:
        dev = inputs[0].device
        t0 = time.perf_counter()
        counts = launch_counts()
        with torch.cuda.device(dev):
            static_in = tuple(x.clone() for x in inputs)
            saved = tuple(t.clone() for t in restore)
            side = _side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            try:
                with torch.cuda.stream(side):
                    for _ in range(WARMUP):
                        fn(*static_in)
                        for t, s in zip(restore, saved):
                            t.copy_(s)
            finally:
                _set_counts(counts)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # torch.cuda.graph empties the allocator's cache on entry: do it
            # first, so that what the capture reserves is its pool alone
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            try:
                # the outer context puts the caller's stream back even when
                # the capture's own exit raises before doing so
                with _holding() as held, torch.cuda.stream(side):
                    with torch.cuda.graph(graph, stream=side):
                        static_out = fn(*static_in)
            except Exception as e:
                _set_counts(counts)
                raise RuntimeError(f"{self.name}: CUDA-graph capture failed "
                                   f"for key {key!r}: {e}") from e
            pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = launch_counts()
        delta = {k: v - counts.get(k, 0) for k, v in after.items()
                 if v != counts.get(k, 0)}
        _set_counts(counts)
        return Graph(graph, static_in, static_out, delta,
                     len(tree_leaves(static_out)),
                     time.perf_counter() - t0, pool_bytes, held)


def jit(fn: Callable, static_argnums: Sequence[int] = (0,)) -> Callable:
    """``fn`` as ``jax.jit(fn, static_argnums=...)`` runs it: on CUDA
    tensors, one graph replay per call, captured on the first call for each
    (static arguments, tensor shapes, dtypes and device); on CPU tensors,
    ``fn`` itself (eager).  The other arguments are tensors, or NamedTuples
    or tuples of tensors, all on one device.  The graphs are held by
    ``.graphs`` (a ``CapturedCall``), which ``.graphs.clear()`` empties;
    a static argument is keyed by identity and held with its graph, so
    pass the same spec object on every call."""
    sig = inspect.signature(fn)
    names = list(sig.parameters)
    static = {names[i] for i in static_argnums}
    name = f"{fn.__name__}_jit"
    call = CapturedCall(name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        dyn = {k: v for k, v in bound.arguments.items() if k not in static}
        leaves = tree_leaves(list(dyn.values()))
        for k, v in dyn.items():
            if not tree_leaves(v) and v is not None:
                raise TypeError(f"{name}: argument {k!r} must be "
                                f"a tensor (or tensors), got {type(v)}")
        devices = {t.device for t in leaves}
        if len(devices) > 1:
            raise ValueError(f"{name}: tensors on {devices}")

        def body(*tensors):
            it = iter(tensors)
            args = dict(bound.arguments)
            for k, v in dyn.items():
                args[k] = tree_map(lambda _: next(it), v)
            return fn(**args)

        return call(body, leaves, static=tuple(
            bound.arguments[k] for k in names if k in static))

    wrapped.__name__ = wrapped.__qualname__ = name
    wrapped.graphs = call
    return wrapped
