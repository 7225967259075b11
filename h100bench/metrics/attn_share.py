"""Share (%) of the device's busy time in the traced part that the kernels
launched inside the attention entry's span take."""


def read(r):
    part = r.part
    if part is None or part.busy_s <= 0 or part.attn_device_s <= 0:
        return None
    return 100.0 * part.attn_device_s / part.busy_s
