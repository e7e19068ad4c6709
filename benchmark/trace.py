"""What the traced calls of a run did, read from ``torch.profiler``.

The benchmark wraps each traced call in a span of its own
(``record_function(SPAN)``, opened before the call and closed after the
card has synchronized), so the device operations and host events of a
call are those inside its span, and the harness's own work between calls
(making the next input, keeping a sample) lies outside every span.

The arithmetic is copied from ``tools/profile_torch_enter.py``: the busy
time is the length of the union of the device operations' intervals, so
overlapping operations count once, and the host's launches are the CUDA
runtime's launch calls by name. The trace is read from the profiler's
Chrome export, the one form that keeps each kernel's grid.

Under the profiler a graph launch holds the host for milliseconds (CUPTI
sets up a record for each of the graph's nodes) while the card waits: an
idle that untraced calls do not have. The idle inside a call is
therefore split in two: what lies under a graph launch on the host
(:data:`HELD`), and the rest. CUPTI also loses a call's
device records now and then (the busy time then reads short and the
idle long), so a share is read call by call, and the median taken.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

SPAN = "benchmark.call"
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel",
                   "cudaLaunchKernelExC", "cuLaunchKernelEx")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
COPY_LAUNCHES = ("cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
                 "cudaMemset", "cuMemcpyAsync", "cuMemsetD8Async",
                 "cuMemsetD32Async")
LAUNCH_APIS = frozenset(KERNEL_LAUNCHES + GRAPH_LAUNCHES + COPY_LAUNCHES)
HELD = "cudaGraphLaunch, held by the profiler"


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def minus(iv, cover) -> list:
    """The parts of interval ``iv`` outside ``cover`` (sorted disjoint
    intervals, as :func:`merged` gives them)."""
    s, e = iv
    out = []
    for cs, ce in cover:
        if ce <= s:
            continue
        if cs >= e:
            break
        if cs > s:
            out.append((s, cs))
        s = max(s, ce)
    if s < e:
        out.append((s, e))
    return out


def within(spans, recs) -> list:
    """Per span of ``spans`` (sorted), the records of ``recs`` that start
    in it."""
    starts = [s for s, _ in spans]
    out = [[] for _ in spans]
    for rec in recs:
        i = bisect.bisect_right(starts, rec[1]) - 1
        if i >= 0 and rec[1] <= spans[i][1]:
            out[i].append(rec)
    return out


class Trace:
    """The traced calls: ``spans`` (start, end) µs on the host's clock, and
    per call its device operations (name, start µs, end µs, grid or None)
    and host events (name, start µs, end µs).

    A device record's time is the card's clock mapped onto the host's,
    off by up to a fraction of a millisecond, enough to put the inputs'
    kernels made just before a call inside its span, or its last kernels
    after it. Where the trace has each call's span on the device too
    (``device_spans``: the profiler's ``gpu_user_annotation``, one a
    call), device records are put in calls by those; ``by_device`` says
    which."""

    def __init__(self, spans, device_ops, host_events, device_spans=()):
        self.spans = sorted(spans)
        dspans = sorted(device_spans)
        self.by_device = len(dspans) == len(self.spans) > 0
        self.ops = within(dspans if self.by_device else self.spans,
                          device_ops)
        self.host = within(self.spans, host_events)

    @property
    def calls(self) -> int:
        return len(self.spans)

    def all_ops(self):
        return [r for ops in self.ops for r in ops]

    def window_us(self) -> float:
        return sum(e - s for s, e in self.spans)

    def busy_us(self) -> float:
        return sum(busy_us((r[1], r[2]) for r in ops) for ops in self.ops)

    def launches(self) -> int:
        return sum(1 for h in self.host for r in h if r[0] in LAUNCH_APIS)

    def idle(self, i: int):
        """Call ``i``'s idle stretches outside any graph launch on the
        host, and its idle µs under one (:data:`HELD`)."""
        edge, e = self.spans[i]
        free, held = [], 0.0
        cover = merged((r[1], r[2]) for r in self.host[i]
                       if r[0] in GRAPH_LAUNCHES)
        for bs, be in merged((r[1], r[2]) for r in self.ops[i]) + [[e, e]]:
            if bs > edge:
                parts = minus((edge, bs), cover)
                free += parts
                held += bs - edge - sum(b - a for a, b in parts)
            edge = max(edge, be)
        return free, held

    def idle_share(self, i: int) -> float | None:
        """Call ``i``'s share of its span in which the card was idle, both
        less the idle under a graph launch; None for a call held all
        through."""
        s, e = self.spans[i]
        free, held = self.idle(i)
        span = e - s - held
        return sum(b - a for a, b in free) / span if span > 0 else None

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        idle time inside the calls by what the host was doing meanwhile
        (:data:`HELD` under a graph launch, elsewhere the innermost host
        event over each gap's middle), each in seconds, at most ``top``
        of each."""
        by_name = collections.Counter()
        for r in self.all_ops():
            by_name[short(r[0])] += (r[2] - r[1]) / 1e6
        idle = collections.Counter()
        for i, host in enumerate(self.host):
            host = sorted(host, key=lambda r: r[1])
            hstarts = [r[1] for r in host]
            free, held = self.idle(i)
            if held:
                idle[HELD] += held / 1e6
            for a, b in free:
                idle[_doing(host, hstarts, (a + b) / 2)] += (b - a) / 1e6
        return {"device_ops": [[k, v] for k, v in by_name.most_common(top)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}


def _doing(host, starts, t) -> str:
    """The host event over time ``t`` that started last: a launch inside
    an operator, the operator otherwise."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        if host[j][2] >= t:
            return short(host[j][0])
    return "host, outside any traced event"


def short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:  # drop the outermost (...) groups: argument lists
        if ch == "(" and not (out and out[-1] == "<"):
            depth += 1
        if depth == 0:
            out.append(ch)
        if ch == ")" and depth:
            depth -= 1
    return "".join(out).replace("anonymous namespace", "").strip()[:120]


DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def collect(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``, read
    from its Chrome trace (written to a temporary file and deleted): the
    one export that carries each kernel's grid."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    return from_events(events)


def from_events(events) -> Trace:
    """A :class:`Trace` from Chrome trace events: the device's kernels,
    copies and fills (with their grids), the benchmark's spans on the host
    and on the device, and every other complete event on the host."""
    spans, dspans, ops, host = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = str(ev.get("cat", "")).lower(), ev.get("name", "")
        start = float(ev["ts"])
        end = start + float(ev.get("dur", 0))
        if cat in DEVICE:
            grid = (ev.get("args") or {}).get("grid")
            ops.append((name, start, end, tuple(grid) if grid else None))
        elif name == SPAN and cat in ("user_annotation",
                                      "gpu_user_annotation"):
            (spans if cat == "user_annotation" else dspans).append(
                (start, end))
        elif cat != "gpu_user_annotation":
            host.append((name, start, end))
    return Trace(spans, ops, host, dspans)
