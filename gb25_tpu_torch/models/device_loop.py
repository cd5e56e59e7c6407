"""The device-resident loop: n time steps replayed from a captured CUDA
graph, the port's counterpart of the ``jax.lax.fori_loop`` that runs the
JAX package's ``loop``, ``coupled_loop`` and ``sw_loop`` as one program on
the device.

``device_loop(step, state, n, cache)`` takes the step as a
``functools.partial`` of a step function over all its arguments but the
state; the function and those arguments are the key of the captured graph
(``plan`` gives the split of n). On a CUDA state it:
  1. runs the first step eagerly where it must: the Euler step at
     iteration 0 (the AB2 coefficients branch on the host's iteration, so
     that step cannot be recorded), and before a capture one real step,
     which builds the kernels and fills every per-grid cache (K3's
     coefficients, K2's metric planes and mask check, the blocked solve's
     statics). A capture only records kernels: a tensor first filled under
     it would hold garbage until the first replay, and a host read under it
     raises, so no cache may be cold when it starts;
  2. captures ``block`` steps into one CUDA graph that reads a static copy
     of the state and ends by copying its result back into that copy, so
     that replays chain with no host work between them and the state is
     copied once a block, not once a step. ``cache`` (the grid's) keeps one
     graph: a later call with the same key and state layout replays it
     without capturing again, and a call with another frees it before it
     captures its own;
  3. copies the state into the static copy (unless it is that copy), replays
     the graph as often as n allows and runs the rest eagerly;
  4. returns a state of its own, which no later replay writes: its iteration
     advanced by n on the host, its clock by the steps on the device.

A driver that runs its steps in chunks (``simulation.Simulation``) calls
with ``block`` its chunk length and ``lead=True``: a chunk that must begin
with an eager step (the Euler step, or the step before a first capture)
then replays the rest of that chunk from a second graph, of ``block - 1``
steps, kept beside the first with the same static state and memory pool,
so that every full chunk runs from graphs and only chunks cut short by a
schedule run eagerly.

The state is a dataclass of tensors, dicts of tensors and dataclasses of
those (the (ocean, ice) pair of ``coupled_ice_loop``), with an
``iteration``. Arguments of the step other than values (the grid, the
atmosphere, a restoring dict's tensors) are told apart by identity; the
graph keeps the tensors of a dict or tuple argument (the restoring
targets and rates), which it reads by address, so they live as long as
it does, and another tensor in their place makes another key.

On a CPU state it is the plain host loop (``host_loop``): the CPU has no
graphs. On the decomposed path (a ``comm``) the loop is replayed where the
mesh is the one card (the forced 1x1 "local" and "ring" modes): there every
exchange is a copy or a fill on the device and no exchange calls
``torch.distributed`` (``parallel.mesh.post`` raises if one tries under a
capture). A mesh of several ranks (``spans_ranks``) keeps the host loop:
its exchanges are ``torch.distributed`` P2P calls, which gloo cannot
capture (NCCL between cards could be; ROADMAP.md queues that for the first
4-card cell). Nowhere else does the loop fall back: a capture that fails
raises. The graph reads the grid's and the comm's cached operands
(K3's coefficients, the blocked solve's statics), so it keeps them.

A call's boundary is traced (``utils.tracing``): ``loop/call`` spans the
call, ``loop/copy_in`` the copies into the static state, ``loop/replay``
the replays (the steps and the ``loop/copy_back`` that a capture records
take it as their parent, so its own time is mostly the card's wait for
the graph's first step) and ``loop/own`` the clones on return;
``STATS.copy_bytes`` counts the bytes of those copies and clones. A
graph's key holds ``tracing.stamping()``: one captured with the tracer's
stamps is replayed only while that tracer is on.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import weakref

import torch

from gb25_tpu_torch.utils import tracing
from gb25_tpu_torch.utils.cuda_build import launch_counts

# steps a captured graph holds; chosen on the H100 (PERF.md, the block
# length table): the copy of the state back into the graph's input is paid
# once a block
BLOCK_STEPS = 16

_ENTRY = "device_loop"  # the captured graph's name in a grid's cache
_LEAD = "device_loop/lead"  # the chunk's lead graph (``lead_plan``)


@dataclasses.dataclass
class LoopStats:
    """Steps run by ``device_loop`` since the last ``reset``: eagerly,
    recorded by a capture (launching nothing), and replayed; the graphs
    captured and replayed, the memory their pools took, and the bytes
    copied at the calls' boundaries (``copy_bytes``: each copy of a field
    into a graph's static state before the replays, and each clone of a
    field out of it on return). A replay does not pass through the
    kernels' wrappers, so their launch counts see the eager and the
    recorded steps only: ``recorded_launches`` holds each kernel's launches
    that captures recorded, ``replayed_launches`` those that replays made
    (a graph's recorded launches, each replay)."""

    eager_steps: int = 0
    captured_steps: int = 0
    replayed_steps: int = 0
    captures: int = 0
    replays: int = 0
    pool_bytes: int = 0  # device memory the captured graphs' private pools reserved
    copy_bytes: int = 0  # bytes copied into the static state and cloned out of it
    recorded_launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    replayed_launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def reset(self):
        self.__init__()

    def launches(self, kernel):
        """``kernel``'s launches on the device since its count and these
        stats were set to 0: its wrapper's count, less the launches that
        captures recorded (which ran nothing), plus those that replays
        made."""
        return (kernel.launches - self.recorded_launches[kernel]
                + self.replayed_launches[kernel])


STATS = LoopStats()


def plan(n, iteration, block, captured):
    """(head, replays, tail): of ``n`` steps from ``iteration``, the steps
    run eagerly first (the Euler step at iteration 0; one real step before
    the graph is ``captured``), the replays of a graph of ``block`` steps,
    and the steps left over, run eagerly. Without a replay all n run
    eagerly and nothing is captured."""
    head = min(n, 1 if iteration == 0 or not captured else 0)
    replays, tail = divmod(n - head, block)
    if replays == 0:
        return n, 0, 0
    return head, replays, tail


def lead_plan(n, iteration, block, captured):
    """(head, lead, replays, tail) with ``lead``: as ``plan``, but where an
    eager head step cuts the call's first block, the rest of that block
    (``lead`` = block - 1 steps) replays from a graph of its own; a call of
    fewer than ``block`` steps runs eagerly."""
    if n < block:
        return n, 0, 0, 0
    head = 1 if iteration == 0 or not captured else 0
    lead = block - head if head else 0
    replays, tail = divmod(n - head - lead, block)
    return head, lead, replays, tail


def spans_ranks(comm) -> bool:
    """Whether a step with ``comm`` exchanges with other ranks through
    ``torch.distributed`` (a mesh of several ranks), which keeps its loop on
    the host; a 1x1 mesh exchanges on the device alone."""
    return comm is not None and comm.mesh.size > 1


def run_loop(step, state, n, comm, cache, chunk=None):
    """``n`` steps of ``step`` with the exchange ``comm`` (None serially):
    from the host where ``comm`` spans ranks, else ``device_loop``, in
    blocks of ``chunk`` steps with its ``lead`` graph where a driver runs
    chunks of that length."""
    if spans_ranks(comm):
        return host_loop(step, state, n)
    if chunk:
        return device_loop(step, state, n, cache, chunk, lead=True)
    return device_loop(step, state, n, cache)


def host_loop(step, state, n):
    """``n`` calls of ``step``, each launched from the host."""
    for _ in range(n):
        state = step(state)
    return state


def device_loop(step, state, n, cache, block=BLOCK_STEPS, lead=False):
    """``n`` applications of ``step`` (a ``functools.partial``: state ->
    next state) to ``state``; on a CUDA state, replayed from a graph of
    ``block`` steps kept in ``cache`` (the grid's) under the key that
    ``step``'s function and arguments, the state's layout and ``block``
    make; with ``lead``, also from a graph of ``block - 1`` steps after an
    eager head step (``lead_plan``)."""
    if not isinstance(step, functools.partial):
        raise TypeError("device_loop takes the step as a functools.partial of a step function "
                        "over its arguments but the state: they make the captured graph's key")
    with tracing.span("loop/call"):
        return _call(step, state, n, cache, block, lead)


def _call(step, state, n, cache, block, lead):
    tensors = _tensors(state)
    if not _on_card(tensors):
        return _eager(step, state, n)
    key = _key(step, tensors, block)
    for name in (_ENTRY, _LEAD):
        entry = cache.get(name)
        if entry is not None and entry.key != key:
            del cache[name]  # frees the graph and its pool before another capture
    entry = cache.get(_ENTRY)
    captured = entry is not None or cache.get(_LEAD) is not None
    if lead:
        head, lead_steps, replays, tail = lead_plan(n, state.iteration, block, captured)
    else:
        (head, replays, tail), lead_steps = plan(n, state.iteration, block, captured), 0
    if replays == 0 and lead_steps == 0:
        return _eager(step, state, n)
    state = _eager(step, state, head)
    static = None
    if lead_steps:
        state, static = _replay(step, state, lead_steps, key, cache, _LEAD, 1)
    if replays:
        state, static = _replay(step, state, block, key, cache, _ENTRY, replays)
    return _own(_eager(step, state, tail), static)


def warm(step, state):
    """One eager step of ``step`` (a ``functools.partial``, as
    ``device_loop`` takes it) on a copy of a CUDA ``state``: it builds, or
    loads, the kernels that the step's dispatch launches and fills every
    cache a capture needs warm, without advancing ``state``. A run script's
    "compile first_time_step" phase. Returns the stepped copy, which
    ``prepare`` captures from; None on a CPU state (nothing to build)."""
    if not isinstance(step, functools.partial):
        raise TypeError("warm takes the step as device_loop does: a functools.partial")
    tensors = _tensors(state)
    if not _on_card(tensors):
        return None
    return _eager(step, _with_tensors(state, {f: t.clone() for f, t in tensors.items()}), 1)


def prepare(step, warmed, cache, block=BLOCK_STEPS):
    """Capture, ahead of the loop, the graph that ``device_loop(step, s, n,
    cache, block)`` replays for a state laid out as ``warmed`` (``warm``'s
    copy): the capture records ``block`` steps from it (recorded, not run).
    A run script's "compile loop" phase. Returns False, and does nothing,
    where ``warmed`` is None (a CPU state, whose loop does not replay)."""
    if warmed is None:
        return False
    key = _key(step, _tensors(warmed), block)
    entry = cache.get(_ENTRY)
    if entry is not None and entry.key == key:
        return True
    for name in (_ENTRY, _LEAD):
        cache.pop(name, None)  # frees another key's graph before the capture
    cache[_ENTRY] = _capture(step, warmed, block, key, cache)
    return True


def _replay(step, state, block, key, cache, name, replays):
    """``replays`` replays of the graph of ``block`` steps kept under
    ``name`` in ``cache``, captured first where it is missing (sharing the
    other kept graph's static state and memory pool); (the state after,
    the static state)."""
    entry = cache.get(name)
    if entry is None:
        other = cache.get(_LEAD if name == _ENTRY else _ENTRY)
        entry = cache[name] = _capture(step, state, block, key, cache,
                                       **({} if other is None else {"share": other}))
    static = entry.static
    with tracing.span("loop/copy_in"):
        for field, t in _tensors(state).items():
            if t is not static[field]:
                static[field].copy_(t)
                STATS.copy_bytes += _nbytes(t)
    with tracing.span("loop/replay"):
        for _ in range(replays):
            entry.graph.replay()
    STATS.replays += replays
    STATS.replayed_steps += replays * block
    for kernel, count in entry.recorded.items():
        STATS.replayed_launches[kernel] += count * replays
    return _with_tensors(state, static).replace(iteration=state.iteration + replays * block), static


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    static: dict    # field -> tensor: the state the graph reads and writes back
    key: tuple      # what the graph was captured for (``device_loop``)
    keep: tuple     # the grid's and the comm's cached operands at capture, which the graph reads
    recorded: dict  # kernel -> its launches in the graph, which each replay makes


def _on_card(tensors):
    return next(iter(tensors.values())).is_cuda


def _capture(step, state, block, key, cache, share=None):
    """A graph of ``block`` steps of ``step`` from ``state``; with ``share``
    (another kept graph of the same key), on its static state and in its
    memory pool: the two never run at once, and neither leaves a tensor in
    the pool between replays (each copies its result into the static
    state, which lies outside)."""
    if share is None:
        static = {field: t.clone() for field, t in _tensors(state).items()}
    else:
        static = share.static
    graph = torch.cuda.CUDAGraph()
    # A graph freed while another captures (cyclic garbage that holds one,
    # collected at some allocation) frees device memory, which ends the
    # capture with an error: collect first, and not during the capture.
    gc.collect()
    torch.cuda.empty_cache()  # as the capture does: what it reserves then is its pool
    reserved = torch.cuda.memory_reserved()
    before = launch_counts()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with (torch.cuda.graph(graph, pool=None if share is None else share.graph.pool()),
              tracing.parent("loop/replay")):
            out = _tensors(host_loop(step, _with_tensors(state, static), block))
            _check_aliases(out, static)
            with tracing.span("loop/copy_back"):
                for field, t in out.items():
                    if t is not static[field]:
                        static[field].copy_(t)
    finally:
        if collecting:
            gc.enable()
    recorded = {k: c - before.get(k, 0) for k, c in launch_counts().items()
                if c != before.get(k, 0)}
    STATS.captures += 1
    STATS.captured_steps += block
    STATS.pool_bytes += torch.cuda.memory_reserved() - reserved
    STATS.recorded_launches.update(recorded)
    return _Captured(graph, static, key, _kept(step, cache), recorded)


def _kept(step, cache):
    """What a graph of ``step`` reads by address and must keep: the grid's
    cached operands (a later dt replaces K3's coefficients in the cache),
    on a tile the comm's (the blocked solve's statics), and the tensors of
    the step's dict and tuple arguments (the restoring targets and
    rates), and the tracer's device tables, which its stamps write."""
    keep = tuple(v for name, v in cache.items() if name not in (_ENTRY, _LEAD))
    keep += tracing.kept()
    comm = step.keywords.get("comm")
    if comm is not None:
        keep += tuple(comm.cache.values())
    for arg in (*step.args, *step.keywords.values()):
        keep += tuple(_tensors_in(arg))
    return keep


def _tensors_in(x):
    """The tensors in a dict or tuple argument, at any depth."""
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (dict, tuple)):
        for v in (x.values() if isinstance(x, dict) else x):
            yield from _tensors_in(v)


def _eager(step, state, n):
    STATS.eager_steps += n
    return host_loop(step, state, n)


def _tensors(state):
    """A state's tensors by field, dict and dataclass fields flattened to
    "field/name"."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if torch.is_tensor(v):
            out[f.name] = v
        elif isinstance(v, dict):
            out.update({f"{f.name}/{k}": t for k, t in v.items()})
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}/{k}": t for k, t in _tensors(v).items()})
    return out


def _with_tensors(state, tensors):
    """``state`` with its tensors taken from ``tensors`` (``_tensors``'s
    names)."""
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if torch.is_tensor(v):
            kw[f.name] = tensors[f.name]
        elif isinstance(v, dict):
            kw[f.name] = {k: tensors[f"{f.name}/{k}"] for k in v}
        elif dataclasses.is_dataclass(v):
            prefix = f.name + "/"
            kw[f.name] = _with_tensors(v, {k[len(prefix):]: t for k, t in tensors.items()
                                           if k.startswith(prefix)})
    return dataclasses.replace(state, **kw)


def _layout(tensors):
    """The fields' names, shapes, dtypes and devices (not their strides:
    the copy into the static state takes any)."""
    return tuple((f, tuple(t.shape), t.dtype, t.device) for f, t in tensors.items())


def _key(step, tensors, block):
    """A graph's key: the step, the state's layout, the block length and
    whether (with which table) the tracer stamps."""
    return (_step_key(step), _layout(tensors), block, tracing.stamping())


def _step_key(step):
    """``step``'s function and arguments, each held as ``_arg`` holds it."""
    return (_arg(step.func), tuple(_arg(a) for a in step.args),
            tuple((k, _arg(v)) for k, v in sorted(step.keywords.items())))


def _arg(x):
    """A step argument in a graph's key: itself where it is a value (a
    config, dt, a flag); a dict or tuple by its items (a restoring dict:
    its names and each (target, rate) pair of tensors); else a ``_Ref``
    (the grid, whose cache holds the graph; an atmosphere; a tensor; the
    step function)."""
    if _is_value(x):
        return x
    if isinstance(x, dict):
        return ("dict", tuple((k, _arg(v)) for k, v in x.items()))
    if isinstance(x, tuple):
        return tuple(map(_arg, x))
    return _Ref(x)


def _is_value(x):
    """A plain value, or a tuple or frozen dataclass of values."""
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype)):
        return True
    if isinstance(x, tuple):
        return all(map(_is_value, x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return x.__dataclass_params__.frozen and all(
            _is_value(getattr(x, f.name)) for f in dataclasses.fields(x))
    return False


class _Ref:
    """An argument told apart by identity and held by weak reference, so
    that the key neither keeps it alive (the grid would keep itself) nor
    matches another object that takes its address after it is freed."""

    __hash__ = None

    def __init__(self, x):
        try:
            self.ref = weakref.ref(x)
        except TypeError:  # no weak reference to it (a dict): held
            self.ref = lambda: x

    def __eq__(self, other):
        x = self.ref()
        return isinstance(other, _Ref) and x is not None and x is other.ref()


def _storage(t):
    return t.untyped_storage().data_ptr()


def _check_aliases(out, static):
    """A step's result may pass a field through (the same tensor), but no
    field may alias another field's static tensor: the copy back would read
    it half written."""
    owner = {_storage(t): field for field, t in static.items()}
    for field, t in out.items():
        other = owner.get(_storage(t), field)
        if other != field:
            raise ValueError(f"the step's {field} aliases the loop's static {other}")


def _nbytes(t):
    return t.numel() * t.element_size()


def _own(state, static):
    """``state`` with every tensor that lies in the static copy cloned: a
    later replay or call overwrites that copy."""
    with tracing.span("loop/own"):
        kept = {_storage(t) for t in static.values()}
        tensors = {}
        for f, t in _tensors(state).items():
            if _storage(t) in kept:
                t = t.clone()
                STATS.copy_bytes += _nbytes(t)
            tensors[f] = t
        return _with_tensors(state, tensors)
