"""peak_mem_gb: the most device memory the run's allocator held allocated
(``torch.cuda.max_memory_allocated``) plus what the step loops' graph pool
holds (``ops.graphs.pool_bytes``), in 10^9 bytes, read when the window
closes."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
