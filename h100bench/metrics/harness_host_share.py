"""Share (%) of the traced part that the host spends in the port's scoring
harness: the self seconds of its spans ``pgym.harness.plan``, ``.rows``,
``.gather`` and ``.parse`` over the part's seconds. Self seconds leave out
the spans opened inside them: ``pgym.harness.readback``, the host's wait
for the device's results, and ``pgym.harness.upload``, a copy to the
device that waits for the forward before. The spans come from the port's
own record (``pipeline.profiler.span_totals``), which holds what ran while
a profiler was on: in a run, the traced part. A port without that record,
or a part in which no harness span closed, reads nothing."""

SPANS = ("pgym.harness.plan", "pgym.harness.rows", "pgym.harness.gather",
         "pgym.harness.parse")


def _span_totals():
    from proteingym_tpu_torch.pipeline import profiler

    totals = getattr(profiler, "span_totals", None)
    return totals() if totals is not None else {}


def read(r):
    part = r.part
    if part is None or part.window_s <= 0:
        return None
    totals = _span_totals()
    found = [totals[name][2] for name in SPANS if name in totals]
    if not found:
        return None
    return 100.0 * sum(found) / part.window_s
