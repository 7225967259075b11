"""The allocator's peak (``torch.cuda.max_memory_allocated``) over the
window, after the set-up's peak was reset: the served model and the
window's work, the headroom a larger batch needs."""


def read(r):
    return None if r.window_peak_bytes is None else r.window_peak_bytes / 2 ** 30
