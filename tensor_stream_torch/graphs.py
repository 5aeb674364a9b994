"""cuda_graph: a function of fixed shapes replayed as one CUDA graph.

The port's counterpart of ``jax.jit`` for the functions the JAX package
jits: a served tick, the fused VPP and model, a training step. PyTorch runs
eagerly and pays the host's time for every kernel it enqueues; a CUDA graph
records those launches once and replays them in one call.

    step = cuda_graph(model)                       # y = step(x)
    step = cuda_graph(partial(stream_step, model), carry=True)
    cache, y = step(cache, x)                      # cache updated in place

For CUDA inputs, each input signature (the tree of shapes, dtypes, strides
and devices, and the values of any non-tensor arguments) goes through
three calls:

1. the first runs ``fn`` eagerly on a side stream (a warm-up: lazy state
   such as cuBLAS handles, kernel attributes and optimizer buffers is made
   outside the capture) and returns its real result;
2. the second copies the inputs into static buffers, captures ``fn`` over
   them and replays the graph once;
3. every later call copies its inputs into the static buffers on the
   current stream and replays.

Outputs come back as copies, out of the graph's memory, so a result held
several ticks deep is not overwritten by the next replay.

The stateful form, ``carry=True``, is ``fn(carry, x) -> (carry, out)`` with
the carry updated in place: its tensors are the graph's own state and are
never copied. A capture raises unless the returned carry is the same
tensors (same ``data_ptr``) as the carry passed in; a carry with other
storage (a clone, or an evicted row) is another signature, with a capture
of its own.

``generators``: CUDA ``torch.Generator``s that ``fn`` draws from. Each is
registered with every graph captured, so that a replay draws the numbers
an eager call would draw from the generator's state at that time, and
advances it as the call would (the default CUDA generator needs no
registration). A generator left out would replay the capture's draws.

CPU inputs call ``fn`` directly, and so does a call made while the current
stream is being captured (the outer graph records it, as ``jax.jit``
inlines a jitted function). Nothing falls back: a capture or replay that
fails raises.

The kernels' launch counters (``ops/nv12_rgb.py``, ``ops/resize.py``,
``ops/augment.py``, ``ops/flash_attention.py``, ``ops/block_fusions.py``,
and the ring's hops, ``ops/ring_attention.py``)
move only when Python calls a wrapper. A capture records what its
wrappers added (``snapshot``, ``difference``), takes it back (nothing ran),
and each replay adds it again (``add``).
"""
from typing import Callable, Dict

import torch

from .ops import (augment, block_fusions, flash_attention, nv12_rgb,
                  resize, ring_attention)

# The counters a replay must advance: (module, attribute) pairs, each an
# int or a dict of ints.
COUNTERS = tuple(
    [(nv12_rgb, name) for name in ("launches", "launches_by_variant")]
    + [(resize, name) for name in ("launches", "area_launches_by_variant")]
    + [(augment, name) for name in (
        "launches", "launches_by_pass", "nv12_launches",
        "nv12_launches_by_pass", "nv12_launches_by_mode")]
    + [(flash_attention, name) for name in (
        "launches", "launches_by_mode", "launches_by_design",
        "recompute_launches", "bwd_launches", "bwd_launches_by_design",
        "dout_copies")]
    + [(ring_attention, name) for name in ("launches_by_mode",
                                           "bwd_launches_by_mode")]
    + [(block_fusions, name) for name in ("launches", "recompute_launches",
                                          "grad_copies")])


def leaves(tree):
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return []


def tree_map(fn, tree):
    """`tree` with `fn` applied to each tensor; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def signature(tree):
    """A hashable description of a call's arguments: the tree's structure,
    each tensor's shape, dtype, strides and device, and every other leaf's
    value."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.stride(),
                tree.device)
    if isinstance(tree, dict):
        return ("dict", tuple((k, signature(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(signature(v) for v in tree))
    return ("value", tree)


def snapshot(counters=COUNTERS) -> Dict:
    """The current values of `counters`, dicts copied."""
    return {(mod.__name__, name): (dict(getattr(mod, name))
                                   if isinstance(getattr(mod, name), dict)
                                   else getattr(mod, name))
            for mod, name in counters}


def difference(after: Dict, before: Dict) -> Dict:
    """What each counter gained from `before` to `after`."""
    out = {}
    for key, value in after.items():
        if isinstance(value, dict):
            out[key] = {k: v - before[key][k] for k, v in value.items()}
        else:
            out[key] = value - before[key]
    return out


def add(delta: Dict, times: int = 1, counters=COUNTERS) -> None:
    """Adds `times` x `delta` to `counters` (a negative `times` takes it
    back)."""
    for mod, name in counters:
        gained = delta[(mod.__name__, name)]
        if isinstance(gained, dict):
            current = getattr(mod, name)
            for k, v in gained.items():
                current[k] += times * v
        else:
            setattr(mod, name, getattr(mod, name) + times * gained)


def _copy_in(static, given):
    for s, g in zip(leaves(static), leaves(given)):
        if s.data_ptr() != g.data_ptr():
            s.copy_(g)


def _check_carry(out, carry):
    if not (isinstance(out, tuple) and len(out) == 2):
        raise TypeError("the stateful form must return (carry, out)")
    if ([t.data_ptr() for t in leaves(out[0])]
            != [t.data_ptr() for t in leaves(carry)]):
        raise ValueError("the returned carry is not the carry passed in: a "
                         "graphed stateful function must update its carry "
                         "in place")


class _Entry:
    """One input signature: warmed up, then captured."""

    def __init__(self):
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.counts = None


class CudaGraph:
    """``fn`` behind CUDA graphs, one a signature (see the module's
    docstring). ``captures`` and ``replays`` count what it did;
    ``graphs`` holds the captured graphs in order, to time a replay."""

    def __init__(self, fn: Callable, carry: bool = False, generators=()):
        self.fn = fn
        self.carry = bool(carry)
        self.generators = tuple(generators)
        self.captures = 0
        self.replays = 0
        self.graphs = []
        self._entries = {}

    def __call__(self, *args):
        tensors = leaves(args)
        if not any(t.device.type == "cuda" for t in tensors):
            return self.fn(*args)
        if torch.cuda.is_current_stream_capturing():
            return self.fn(*args)
        devices = {t.device for t in tensors}
        if len(devices) != 1:
            raise ValueError(f"inputs on {sorted(map(str, devices))}: a "
                             "graph runs on one CUDA device")
        device, = devices
        if self.carry and len(args) != 2:
            raise TypeError("the stateful form takes (carry, x)")
        key = self._key(args)
        entry = self._entries.get(key)
        with torch.cuda.device(device):
            if entry is None:
                out = self._warm_up(args, device)
                self._entries[key] = _Entry()
                return out
            if entry.graph is None:
                self._capture(entry, args)
            return self._replay(entry, args)

    def _key(self, args):
        if not self.carry:
            return signature(args)
        carry, x = args
        return (signature(carry),
                tuple(t.data_ptr() for t in leaves(carry)), signature(x))

    def _warm_up(self, args, device):
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        current.wait_stream(side)
        for t in leaves(out):
            if t.device == device:
                t.record_stream(current)
        if self.carry:
            _check_carry(out, args[0])
        return out

    def _capture(self, entry, args):
        if self.carry:
            carry, x = args
            static = (carry, tree_map(torch.empty_like, x))
        else:
            static = tree_map(torch.empty_like, args)
        _copy_in(static, args)
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        before = snapshot()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self.fn(*static)
        finally:
            delta = difference(snapshot(), before)
            add(delta, -1)  # the capture recorded launches; none ran
        if self.carry:
            _check_carry(out, static[0])
        entry.graph, entry.static_in, entry.static_out = graph, static, out
        entry.counts = delta
        self.graphs.append(graph)
        self.captures += 1

    def _replay(self, entry, args):
        _copy_in(entry.static_in, args)
        entry.graph.replay()
        add(entry.counts)
        self.replays += 1
        if self.carry:
            return args[0], tree_map(torch.clone, entry.static_out[1])
        return tree_map(torch.clone, entry.static_out)


# The entry point: ``cuda_graph(fn)``, or ``cuda_graph(fn, carry=True)``
# for ``fn(carry, x) -> (carry, out)`` with the carry updated in place;
# ``generators=`` names the generators ``fn`` draws from.
cuda_graph = CudaGraph
