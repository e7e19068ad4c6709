"""call_p95_ms: the 95th percentile of the latencies of all the window's
calls, each from its start to its output synchronized on the device."""

from benchmark.harness import percentile


def read(run):
    if not run.calls:
        return None
    return percentile([(end - start) * 1e3 for start, end, _ in run.calls],
                      95)
