"""Share (%) of the tokens handed to the model in the traced part that the
protocol does not need: 1 - needed / handed. Handed tokens are counted by
the wrapper around the callable the harness gets; needed ones from the
assays (each kind's ``needed``)."""


def read(r):
    if not r.handed_tokens:
        return None
    return 100.0 * (1.0 - r.needed_tokens / r.handed_tokens)
