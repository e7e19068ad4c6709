"""host_launches_per_call: the CUDA runtime's launch calls (kernel, graph,
memcpy, memset) the host made inside the traced calls' spans, a call."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    return run.trace.launches() / run.trace.calls
