"""Profiling and timing utilities, and the port's spans and call record.

The port's counterpart of ``ecfft_tpu/utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler`` that writes
  a Chrome trace of the host and (where a card is present) its kernels to
  ``log_dir``;
- :func:`time_op`: wall timing with warm-up, fenced by
  ``torch.cuda.synchronize()`` when a card holds the result;
- ``python -m ecfft_tpu_torch.bench_suite``: the per-op benchmark CLI
  (``ecfft_tpu_torch/bench_suite.py``).

And the measurement inside the program:

- :class:`span`: a named phase of a call. While a profiler session is
  active it opens a ``torch.profiler.record_function``, so the phase lies
  on the profiler's timeline beside the device's records and names what
  the host did in each idle gap; otherwise it costs one flag check, and
  two host stamps where a call record is open. The spans, with their
  parents: ``ecfft.call`` (``FFTree._run_sched``, one a call) holds one
  ``ecfft.chunk`` a lane chunk (``ops.schedule.run_chunks``), which holds
  ``ecfft.pack``, ``ecfft.to_mont`` and ``ecfft.from_mont`` (Montgomery
  residents only), ``ecfft.unpack``, and exactly one of ``ecfft.replay``,
  ``ecfft.warmup`` with ``ecfft.capture`` (``ops.graphs.GraphCache.run``),
  or ``ecfft.steps`` (the eager loop). A call that makes a schedule's
  step plan has ``ecfft.plan`` (``ops.schedule.step_plan``) before its
  chunks. No span lies inside a step loop.
- the call record, always on: :func:`recorded` returns the last
  :data:`RING` calls, each a :class:`Call` with its algorithm, size,
  batch, lane chunks (:class:`Chunk`: lanes, lanes computed, replay,
  capture or eager loop, the captured graph's record, the step launches
  by shape, whether the loop read a kept step plan and its bytes, and
  with Montgomery residents each conversion's rows, lanes and launches:
  :class:`Convert`; and those of its step launches that ran in the pair
  form, by shape), flags
  (a kernel library built or loaded, a profiler active) and spans on
  ``time.perf_counter_ns``'s clock, the clock of a caller's
  ``time.perf_counter``. On a card, one call in :data:`EVERY` (its id a
  multiple) also records CUDA events on the call's stream at the call's
  entry, before and after each chunk's step loop and each Montgomery
  conversion, and at its end (never inside a capture), drawn from a pool
  that a call that captures a graph fills (set-up) and the ring refills,
  and read only by :meth:`Call.device_ns`, so that :meth:`Call.idle_ns`
  gives the card's idle in a call that ran without a profiler, and
  :meth:`Call.convert_ns` the device time of its conversions. The other
  calls keep the host stamps alone: an event costs the host about 20 µs
  in the call path, two of them before the graph's launch while the card
  waits.
- :func:`_recording`: a private context that switches the record off, to
  measure what it costs, and for tests.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch

RING = 1024  # calls the record keeps
EVERY = 8  # one call in EVERY records CUDA events
EVENTS = 4 * RING // EVERY  # events made ahead, at a call that captures

# the flag a profiler session sets (a bool of that module)
_PROFILER = torch.autograd.profiler
_RECORDING = True
_local = threading.local()  # .call: the open Call of this thread
_ring: collections.deque = collections.deque(maxlen=RING)
_lock = threading.Lock()
_ids = itertools.count()
_free_events: dict = {}  # device → events made ahead or freed by the ring
_loads = 0  # kernel libraries built or loaded (``ops.step.load_kernels``)

# spans that launch device work, and where that work can start: a graph's
# at the end of its launch, the others' at the span's start
WORK = ("ecfft.pack", "ecfft.to_mont", "ecfft.warmup", "ecfft.steps",
        "ecfft.from_mont", "ecfft.unpack")
REPLAY = "ecfft.replay"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profile: ``with trace("prof"): run()`` writes
    ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _on_card(x) -> bool:
    """Whether ``x`` (a tensor, or a tuple, list or dict of them) holds a
    CUDA tensor."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return any(_on_card(v) for v in x)
    return False


def _block(x):
    if _on_card(x):
        torch.cuda.synchronize()
    return x


def time_op(fn, *args, reps: int = 3, warmup: int = 1):
    """(best_seconds, result): times ``fn(*args)`` with device sync."""
    result = None
    for _ in range(warmup):
        result = _block(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        result = _block(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, result


# ------------------------------------------------------------------ spans


class span:
    """``with span(name):`` a phase of a call: a ``record_function`` while
    a profiler session is active, and (name, parent, start, end) in the
    open call record."""

    __slots__ = ("name", "_rf", "_call", "_i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = None
        if _PROFILER._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._call = call = getattr(_local, "call", None)
        if call is not None:
            self._i = call._open(self.name)
        return self

    def __exit__(self, *exc):
        if self._call is not None:
            self._call._close(self._i)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


# ------------------------------------------------------------- the record


# how: "replay", "capture" (the warm-up, then the capture) or "steps" (the
# eager loop); graph: a weak reference to the ``ops.graphs.Captured``
# record (its set-up seconds and replays), None for the eager loop;
# shapes: [(wrapper, Counter of (form, rows, lanes))], the step launches
# the chunk made (a replay's and a capture's are the capture's own); plan:
# whether its step loop read a step plan that its owner keeps
# (``ops.schedule.StepPlan``), and plan_bytes the plan's device bytes (0
# without one); converts: the chunk's conversions into and out of
# Montgomery form (:class:`Convert`; none for a canonical field); pairs:
# [(pair wrapper, Counter of (form, rows, lanes))], those of the step
# launches in shapes that ran in the pair form (``ops.step.PAIR_WRAPPERS``:
# x2 read from the window's partner rows, no gather)
Chunk = collections.namedtuple(
    "Chunk",
    "lanes graph_lanes how graph shapes plan plan_bytes converts pairs",
    defaults=(False, 0, (), ()))

# one conversion of a chunk's state into or out of Montgomery form
# (``ops.schedule.run_chunks``): its span (``ecfft.to_mont`` or
# ``ecfft.from_mont``), the state rows it converted, the state's lanes, the
# ``aff1s_ip`` launches its wrapper counted (one on a card, none on the
# plain path), and the indices in the call's marks of the events placed
# before and after it
Convert = collections.namedtuple("Convert", "span rows lanes launches marks")


class Call:
    """The record of one call: ``id``, ``alg``, ``m`` (the points of the
    input), ``batch``, ``chunks`` (:class:`Chunk`), ``built`` (a kernel
    library was built or loaded during the call), ``profiled`` (a profiler
    session was active at its entry), ``spans`` ([name, parent's index or
    None, start ns, end ns]; the first is ``ecfft.call``) and ``marks``
    (the host stamps of its CUDA events, or of where they would be on the
    CPU or in a call that records none)."""

    __slots__ = ("id", "alg", "m", "batch", "profiled", "built", "chunks",
                 "spans", "marks", "_events", "_stream", "_device",
                 "_stack", "_loads")

    def __init__(self, alg: str, m: int, batch: int, device=None):
        self.id = next(_ids)
        self.alg, self.m, self.batch = alg, m, batch
        self.profiled = bool(_PROFILER._is_profiler_enabled)
        self.built = False
        self.chunks, self.spans, self.marks = [], [], []
        if self.id % EVERY:
            device = None  # host stamps alone
        self._device = device
        self._stream = (None if device is None
                        else torch.cuda.current_stream(device))
        self._events = None if device is None else []
        self._stack = []
        self._loads = _loads

    def _open(self, name: str) -> int:
        i = len(self.spans)
        self.spans.append([name, self._stack[-1] if self._stack else None,
                           time.perf_counter_ns(), None])
        self._stack.append(i)
        return i

    def _close(self, i: int) -> None:
        self.spans[i][3] = time.perf_counter_ns()
        self._stack.pop()

    def mark(self) -> None:
        """A CUDA event on the call's stream (on a card, in one call in
        :data:`EVERY`), and its host stamp."""
        if self._stream is not None:
            free = _free_events.get(self._device)
            ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            self._events.append(ev)
        self.marks.append(time.perf_counter_ns())

    @property
    def start_ns(self) -> int:
        return self.spans[0][2]

    @property
    def end_ns(self) -> int:
        return self.spans[0][3]

    def span_ns(self, name: str) -> int:
        """Host ns in the spans named ``name``."""
        return sum(e - s for n, _, s, e in self.spans if n == name)

    def launches(self) -> collections.Counter:
        """The call's step launches by (wrapper's name, rows, lanes): its
        step loops' and its Montgomery conversions'."""
        out = collections.Counter()
        for ch in self.chunks:
            for w, c in ch.shapes:
                for (_, rows, lanes), k in c.items():
                    out[(w.__name__, rows, lanes)] += k
            for cv in ch.converts:
                if cv.launches:
                    out[("aff1s_ip", cv.rows, cv.lanes)] += cv.launches
        return out

    def converts(self) -> list:
        """The call's conversions into and out of Montgomery form
        (:class:`Convert`), chunk by chunk."""
        return [cv for ch in self.chunks for cv in ch.converts]

    def convert_ns(self):
        """Device ns between the events before and after each of the
        call's Montgomery conversions, summed. None without events or
        without a conversion. Waits for the last event."""
        cvs = self.converts()
        dev = self.device_ns() if cvs else None
        if dev is None:
            return None
        return sum(dev[j] - dev[i] for i, j in (cv.marks for cv in cvs))

    def device_ns(self):
        """Where each event completed, on the host's clock: the entry
        event, recorded while the card is idle (as a caller that waited on
        its last call leaves it), at its host stamp, the others by their
        device time after it. None without events (a CPU call, a call
        that records none, or one that the ring has dropped). Waits for
        the last event."""
        ev = self._events
        if not ev:
            return None
        ev[-1].synchronize()
        h0 = self.marks[0]
        return [h0 + round(ev[0].elapsed_time(e) * 1e6) for e in ev]

    def idle_ns(self, t0: int, t1: int):
        """The card's idle in the call, on the host's clock, between a
        caller's ``t0`` (the card idle) and ``t1`` (after it synchronized):
        see :func:`idle_between`. None without events."""
        dev = self.device_ns()
        if dev is None:
            return None
        return idle_between(self.marks, dev, self.spans, t0, t1)


def idle_between(marks, device, spans, t0: int, t1: int) -> int:
    """The card's idle ns from ``t0`` to ``t1``, from events recorded at
    host stamps ``marks`` that completed at ``device`` (the host's clock;
    ``device[0] == marks[0]``) and the host's ``spans``.

    Between two events the card runs the work the host launched between
    their stamps, back to back once it has started: it is idle from where
    the earlier event completed until that work can start (the start of
    the first span in :data:`WORK`, or the end of a graph's launch, in
    that stretch; the later stamp where none is), at most until the later
    event completed. Before the entry event it is idle from ``t0``, and
    after the last event until ``t1``. Without a profiler a graph starts
    as its launch returns; under one the launch returns long after the
    graph began, so this overstates a profiled call's idle."""
    idle = max(0, marks[0] - t0)
    for k in range(len(marks) - 1):
        lo, hi = marks[k], marks[k + 1]
        ready = min((e if n == REPLAY else s for n, _, s, e in spans
                     if lo <= s < hi and (n == REPLAY or n in WORK)),
                    default=hi)
        idle += max(0, min(ready, device[k + 1]) - device[k])
    return idle + max(0, t1 - device[-1])


def current():
    """The open call record of this thread, or None."""
    return getattr(_local, "call", None)


@contextlib.contextmanager
def call(alg: str, m: int, batch):
    """The ``ecfft.call`` span of one call on the (B, m, L) tensor
    ``batch``, and (unless :func:`_recording` is off) its :class:`Call`,
    kept in the ring once the call returns. Yields the record, or None."""
    if not _RECORDING:
        with span("ecfft.call"):
            yield None
        return
    device = batch.device if batch.is_cuda else None
    rec = Call(alg, m, batch.shape[0], device)
    outer = getattr(_local, "call", None)
    _local.call = rec
    try:
        with span("ecfft.call"):
            rec.mark()
            yield rec
            rec.mark()
    finally:
        _local.call = outer
    rec.built = _loads != rec._loads
    if device is not None and any(ch.how == "capture" for ch in rec.chunks):
        _make_events(device, EVENTS)  # set-up, so that calls make none
    rec._stream = rec._stack = None
    with _lock:
        if len(_ring) == RING:
            old = _ring[0]
            if old._events:
                _free_events.setdefault(old._device, []).extend(old._events)
            old._events = None
        _ring.append(rec)


def _make_events(device, n: int) -> None:
    """Fill the pool of ``device`` to ``n`` events, each recorded once on
    its current stream (which creates it on the card)."""
    free = _free_events.setdefault(device, [])
    stream = torch.cuda.current_stream(device)
    while len(free) < n:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        free.append(ev)


def recorded() -> list:
    """The calls in the ring, oldest first."""
    with _lock:
        return list(_ring)


def loaded() -> None:
    """Note a kernel library built or loaded (``ops.step.load_kernels``)."""
    global _loads
    _loads += 1


@contextlib.contextmanager
def _recording(on: bool):
    """Keep the call record (``on``) or not while active; the spans open
    ``record_function`` under a profiler either way."""
    global _RECORDING
    saved, _RECORDING = _RECORDING, on
    try:
        yield
    finally:
        _RECORDING = saved
