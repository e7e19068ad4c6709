"""torch_ops_pct: the share of the traced calls' device time spent in
PyTorch's own operations (kernels of the ``at::native`` namespace, and
memcpy and memset): the executor's gathers, index synthesis, packing and
unpacking, and the D-engine's bookkeeping, whatever port kernel sits
beside them."""


def torch_op(name: str) -> bool:
    return "at::native" in name or name.startswith(("Memcpy", "Memset"))


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.all_ops()
    total = sum(e - s for _, s, e, _ in ops)
    if not total:
        return None
    return 100 * sum(e - s for name, s, e, _ in ops if torch_op(name)) / total
