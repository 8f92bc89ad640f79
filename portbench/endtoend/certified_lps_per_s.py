"""LPs solved and certified through solve_batch and the single solves
around it, over the window's seconds (a batch's fallbacks count with the
batch)."""

UNIT, BETTER, SOURCE = "LPs/s", "higher", "host_clock"


def read(record):
    done = sum(c.certified for c in record.calls if c.kind in ("single", "batch"))
    return done / record.seconds if done else None
