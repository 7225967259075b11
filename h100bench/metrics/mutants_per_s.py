"""Mutants scored per second over the whole window: the mutants of every
call that started before the window's end and returned its scores, over
the seconds from the first call's start to the last one's end."""


def read(r):
    done = sum(c["mutants"] for c in r.records if c.get("answers") is not None)
    return done / r.window_s if done and r.window_s > 0 else None
