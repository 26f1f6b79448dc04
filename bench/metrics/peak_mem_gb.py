"""peak_mem_gb: ``torch.cuda.max_memory_allocated()`` over set-up and
both windows, read before the check, in 1e9 bytes."""


def read(w):
    return w["peak_bytes"] / 1e9 if w["peak_bytes"] > 0 else None
