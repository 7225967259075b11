"""Share (%) of the traced part in which no operation ran on the device:
1 - (the union of the device operations' intervals) / (the part's span)."""


def read(r):
    part = r.part
    if part is None or part.busy_s <= 0 or part.window_s <= 0:
        return None
    return 100.0 * (1.0 - part.busy_s / part.window_s)
