"""Peak device memory over the window: `torch.cuda.max_memory_allocated()`
after `reset_peak_memory_stats()` at the window's start, in GiB."""


def read(art):
    b = art["memory_peak_bytes"]
    return b / 2 ** 30 if b else None
