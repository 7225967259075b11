"""Share (%) of the dense bf16 peak (989 TFLOP/s, whatever the precision)
that the traced part's needed operations make of its seconds: the
operations the protocol needs for the part's work, counted from the
configuration's shapes (not from the rows the program ran), over the
part's length times the peak."""

from h100bench.peaks import PEAK_BF16_FLOPS


def read(r):
    part = r.part
    if part is None or part.busy_s <= 0 or part.window_s <= 0 or not r.needed_flops:
        return None
    return 100.0 * r.needed_flops / (part.window_s * PEAK_BF16_FLOPS)
