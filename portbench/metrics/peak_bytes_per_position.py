"""``torch.cuda.max_memory_allocated()`` over the window, after its
``reset_peak_memory_stats()``, per BWT position of one sample."""


def read(run):
    return run["peak_bytes"] / run["positions"] if run["peak_bytes"] else None
