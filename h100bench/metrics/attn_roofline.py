"""Share (%) of the attention entry's roofline: the summed least time of
its calls in the traced part (max of operations over the bf16 peak and
bytes over HBM bandwidth, from each call's live extents) over the summed
device time of every kernel launched inside the entry's span. The
kernel's name does not enter it."""


def read(r):
    part = r.part
    if part is None or part.attn_device_s <= 0 or not r.attn_least_s:
        return None
    return 100.0 * r.attn_least_s / part.attn_device_s
