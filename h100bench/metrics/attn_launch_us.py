"""Host microseconds of one call into the port's attention entry: the
seconds of the spans ``pgym.launch.grouped_attention*`` (the entry's host
side from its checks to the foreign call: extents, masks, RoPE tables,
allocations, the launch) over their count. The spans come from the port's
own record (``pipeline.profiler.span_totals``), which holds what ran while
a profiler was on: in a run, the traced part. A port without that record,
or a part with no such launch, reads nothing."""

PREFIX = "pgym.launch.grouped_attention"


def _span_totals():
    from proteingym_tpu_torch.pipeline import profiler

    totals = getattr(profiler, "span_totals", None)
    return totals() if totals is not None else {}


def read(r):
    if r.part is None:
        return None
    found = [v for name, v in _span_totals().items() if name.startswith(PREFIX)]
    count = sum(n for n, _, _ in found)
    if not count:
        return None
    return 1e6 * sum(seconds for _, seconds, _ in found) / count
