"""The 95th percentile over every call of the window of the seconds from
the call to its scores in host memory; a call that failed counts as
slower than any."""

from h100bench.stats import percentile


def read(r):
    if not r.records:
        return None
    times = [c["seconds"] if c.get("answers") is not None else float("inf") for c in r.records]
    return percentile(times, 0.95)
