"""The step loop of a schedule, captured once as a CUDA graph and replayed.

The port's counterpart of the JAX package's compiled dispatch. There the
scan executor runs a whole transform as one jitted ``lax.scan``
(``ecfft_tpu/ops/schedule.py``, ``_run_scan``) and the unrolled executor
compiles runs of steps into cached jitted segments
(``ecfft_tpu/ops/unrolled.py``, ``_SEG_CACHE``), so a call costs one
dispatch a transform, or one a segment. The port's executors are Python
loops of several launches a step (``_run_steps`` in ``ops/schedule.py``
and ``ops/unrolled.py``): gathers and the kernel, and in the unrolled
loop index synthesis and the D-engine's one-lane products too. On a
card, :class:`GraphCache` captures such a loop once per key as a CUDA
graph and replays it on every later call, one graph launch a chunk of
lanes.

- **The key**: the schedule, what its loop reads (the pool and residual
  bank, or the scan loop's step plan, which holds both), the executor
  with its parameters, the lanes of the chunk's graph and
  the device. A graph's lanes are a power of two (:func:`bucket`): a
  chunk of fewer lanes is packed into the low lanes of its state, and the
  lanes above them compute on zeros and are cut off at the unpack, so a
  run of batch sizes up to B captures at most log2(B) + 1 graphs a loop.
  The record of a key holds those objects, so their ids stay unique while
  it lives.
- **The first call on a key** runs the loop eagerly once on the chunk's
  state (the warm-up: it loads each kernel module, which CUDA loads at a
  kernel's first launch, outside the capture; its result is that call's
  answer), then captures the loop on the same state, with the tree's
  device current. Warm-up, capture and instantiation are set-up, timed
  in the record.
- **The state** is a static (W, L, lanes) int32 buffer that the graphs of
  one (W, L, lanes, device) share (:func:`static_state`): each call packs
  its chunk into it, and ``ops.schedule.run_chunks`` copies the output
  out into a fresh tensor, so no call returns a view of it. The pack and
  the unpack (with the Montgomery conversions) stay outside the capture.
- **Memory**: the graphs of one device allocate their temporaries from one
  memory pool. Replays run in order on the device's current stream, and
  no graph's output lives in the pool, so one graph's temporaries are
  dead when another replays. What the pool holds is counted in the chunk
  budget (:func:`pool_bytes`), and the batch sizes of one bucket keep the
  chunking their first call chose (:meth:`GraphCache.lanes`). The static
  states of one (W, L) are powers of two of lanes up to a chunk's, so
  together they hold less than two chunks' states.
- **Launch counts**: each kernel wrapper counts its launches in Python,
  by form (``launches``) and by form, rows and lanes (``shapes``), and a
  replay runs no Python. A capture records what its body added to the
  counts and takes it back (nothing ran); each replay adds it again.
- **Spans** (``utils.profiling.span``): ``ecfft.replay`` around a
  replay's graph launch, ``ecfft.warmup`` and ``ecfft.capture`` around a
  first call's two parts.
- A CPU tensor runs the eager loop and never reaches this module. A
  failed capture or replay raises :class:`GraphError` naming its key;
  nothing falls back to the eager loop. A private entry,
  :func:`_eager_loop`, runs the eager loop on the card, to compare the
  two.

Calls on one device share its static buffers, so they must come in
order on one stream: the device's current stream, as the eager loop's
launches did.
"""

from __future__ import annotations

import collections
import contextlib
import time
import weakref

import torch

from ecfft_tpu_torch.errors import EcfftError
from ecfft_tpu_torch.utils.profiling import span

_EAGER = False  # set by _eager_loop()


class GraphError(EcfftError, RuntimeError):
    """A capture or a replay of a step loop failed."""


@contextlib.contextmanager
def _eager_loop():
    """Run the eager step loop on the card while active (no capture, no
    replay): the loop that the graphs record, for comparing the two."""
    global _EAGER
    saved, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = saved


def bucket(lanes: int) -> int:
    """The lanes of the graph that runs a chunk of ``lanes`` lanes: the
    least power of two at or above it."""
    return 1 << (lanes - 1).bit_length()


def replays(tensor) -> bool:
    """Whether a step loop on ``tensor``'s device runs as a graph."""
    return tensor.is_cuda and not _EAGER


# ------------------------------------------------------ device resources


class _Pool:
    """A device's graph memory pool and its capture stream; made anew once
    no graph of the old pool lives (the allocator frees a pool whose
    graphs are gone)."""

    def __init__(self, device):
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.bytes = 0  # what the captures grew it by
        self.live = weakref.WeakSet()  # its graphs' records


_POOLS: dict = {}
_STATES = weakref.WeakValueDictionary()  # (W, L, lanes, device) → buffer


def _indexed(device):
    """``device`` with its index: "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _pool(device) -> _Pool:
    device = _indexed(device)
    p = _POOLS.get(device)
    if p is None or not p.live:
        p = _POOLS[device] = _Pool(device)
    return p


def pool_bytes(device) -> int:
    """Bytes the graph memory pool of ``device`` holds: reserved on the
    card, free to no allocation outside the graphs."""
    p = _POOLS.get(_indexed(device))
    return p.bytes if p is not None and p.live else 0


def static_state(W: int, L: int, lanes: int, device):
    """The (W, L, lanes) int32 state buffer of ``device`` that the graphs
    of that shape share; it lives while a graph holds it."""
    key = (W, L, lanes, device)
    state = _STATES.get(key)
    if state is None:
        state = torch.empty((W, L, lanes), dtype=torch.int32, device=device)
        _STATES[key] = state
    return state


# ------------------------------------------------------------ the counts


def _counted() -> tuple:
    """Every kernel wrapper with a ``launches`` Counter."""
    from ecfft_tpu_torch.ops import step, unrolled

    return (*step.STEP_WRAPPERS, *step.PAIR_WRAPPERS,
            *unrolled.FUSED_WRAPPERS)


def _counts_now() -> list:
    return [(w, collections.Counter(w.launches),
             collections.Counter(w.shapes)) for w in _counted()]


def _added(before: list) -> tuple:
    """What was counted since ``before``: ([(wrapper, Counter of launches
    by form)], [(wrapper, Counter of launches by (form, rows, lanes))])."""
    launches, shapes = [], []
    for w, old, old_shapes in before:
        new = w.launches - old
        if new:
            launches.append((w, new))
        new = w.shapes - old_shapes
        if new:
            shapes.append((w, new))
    return launches, shapes


def _take_back(before: list) -> tuple:
    """Restore the counts of ``before`` and return what was added since
    (:func:`_added`)."""
    added = _added(before)
    for w, old, old_shapes in before:
        w.launches.clear()
        w.launches.update(old)
        w.shapes.clear()
        w.shapes.update(old_shapes)
    return added


# --------------------------------------------- capture and replay on a card


def _capture(device, pool: _Pool, body, state):
    """Capture ``body(state)`` into a new CUDA graph on ``device``'s
    capture stream, allocating from ``pool`` (what ``torch.cuda.graph``
    does, with the capture ended, and the stream restored, where the body
    fails); returns (graph, capture s, instantiate s, bytes the pool grew
    by). Capture seconds are the body's under capture; instantiate
    seconds the end of the capture with the instantiation, and the
    synchronize and cache release before the capture."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        with torch.cuda.stream(pool.stream):
            graph.capture_begin(pool=pool.handle,
                                capture_error_mode="thread_local")
            try:
                reserved = torch.cuda.memory_reserved(device)
                t1 = time.perf_counter()
                body(state)
                t2 = time.perf_counter()
                grown = torch.cuda.memory_reserved(device) - reserved
            except BaseException:
                with contextlib.suppress(Exception):  # the body's fault
                    graph.capture_end()
                raise
            graph.capture_end()
        t3 = time.perf_counter()
    return graph, t2 - t1, (t1 - t0) + (t3 - t2), max(grown, 0)


def _replay(device, graph) -> None:
    with torch.cuda.device(device):
        graph.replay()


class Captured:
    """One captured step loop: its graph, the static state it reads and
    writes, what it pins, the launches one replay makes (by form, and by
    form, rows and lanes), and its set-up seconds."""

    __slots__ = ("graph", "state", "pins", "counts", "shapes", "warmup_s",
                 "capture_s", "instantiate_s", "replays", "__weakref__")

    def __init__(self, graph, state, pins, counts, shapes, warmup_s,
                 capture_s, instantiate_s):
        self.graph, self.state, self.pins = graph, state, pins
        self.counts = counts  # [(wrapper, Counter of launches by form)]
        self.shapes = shapes  # [(wrapper, Counter by (form, rows, lanes))]
        self.warmup_s, self.capture_s = warmup_s, capture_s
        self.instantiate_s = instantiate_s
        self.replays = 0


class GraphCache:
    """The captured step loops of one owner (a tree or a plan), by key,
    and the step plans those loops read (``plans``, by the ids of the
    schedule, pool and bank, which each plan pins; see
    ``ops.schedule.step_plan``), freed with it: trees and plans keep one
    beside their schedule entries, and ``FFTree.place_on`` starts a new
    one. The plans are kept on the CPU too, where no graph is."""

    def __init__(self):
        self.graphs: dict = {}
        self.plans: dict = {}
        self._lanes: dict = {}

    def lanes(self, loop_key: tuple, batch: int, device, budget) -> int:
        """The lanes a chunk of a ``batch``-lane call gets: a power of two,
        the most that ``budget(lanes)`` (the lanes of a chunk that fit, up
        to ``lanes``) allows for :func:`bucket` (``batch``) at the first
        call of that bucket, kept for the later ones, so that they replay
        the graphs the first captured."""
        want = bucket(batch)
        k = (loop_key, want, device)
        if k not in self._lanes:
            self._lanes[k] = 1 << (budget(want).bit_length() - 1)
        return self._lanes[k]

    def state(self, key: tuple, W: int, L: int):
        """The state buffer of ``key``: its graph's, or for a key not
        captured yet the shared one of its shape."""
        rec = self.graphs.get(key)
        _, lanes, device = key
        return (rec.state if rec is not None
                else static_state(W, L, lanes, device))

    def run(self, key: tuple, state, body, pins: tuple) -> Captured:
        """Run the step loop ``body`` on ``state`` in place: a replay of
        the key's graph, or at the first call the warm-up and the
        capture; returns the key's record (``replays`` 0 after the
        capture). ``pins``: the schedule first, then what else the loop
        reads (the key holds their ids). Raises :class:`GraphError`
        naming the key where either fails."""
        device = state.device
        rec = self.graphs.get(key)
        if rec is not None:
            if rec.state is not state:
                raise GraphError(f"{describe(key, pins[0])}: its graph "
                                 "reads another state buffer")
            try:
                with span("ecfft.replay"):
                    _replay(device, rec.graph)
            except Exception as e:
                raise GraphError(f"replay of {describe(key, pins[0])} "
                                 f"failed: {e}") from e
            for w, c in rec.counts:
                w.launches.update(c)
            for w, c in rec.shapes:
                w.shapes.update(c)
            rec.replays += 1
            return rec
        t0 = time.perf_counter()
        with span("ecfft.warmup"):
            body(state)  # the warm-up: this call's answer
        warmup_s = time.perf_counter() - t0
        pool = _pool(device)
        before = _counts_now()
        try:
            with span("ecfft.capture"):
                graph, capture_s, inst_s, grown = _capture(device, pool, body,
                                                            state)
        except Exception as e:
            raise GraphError(f"capture of {describe(key, pins[0])} "
                             f"failed: {e}") from e
        finally:
            counts, shapes = _take_back(before)
        rec = Captured(graph, state, pins, counts, shapes, warmup_s,
                       capture_s, inst_s)
        pool.bytes += grown
        pool.live.add(rec)
        self.graphs[key] = rec
        return rec


def loop_key(executor: tuple, pins: tuple) -> tuple:
    """The part of a key that the chunks of one call share: the executor
    with its parameters, and the ids of the schedule and of what else the
    loop reads (``pins``)."""
    return (executor, *(id(p) for p in pins))


def describe(key: tuple, sched) -> str:
    """A key as an error names it."""
    (executor, *_), lanes, device = key
    return (f"the {executor[0]} step loop of a schedule of "
            f"{len(sched.xs[0])} steps (W {sched.W}, A {sched.A}; "
            f"{', '.join(map(str, executor[1:])) or 'no parameters'}) at "
            f"{lanes} lanes on {device}")
