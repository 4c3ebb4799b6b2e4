"""step_ms (ms): the whole measured window on the host's clock over the
steps completed in it (a decode step: one token for each stream, logits
on the host).  End-to-end."""


def read(rec):
    return 1e3 * rec["window_s"] / rec["steps"] if rec["steps"] else None
