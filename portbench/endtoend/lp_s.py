"""Seconds of the window over the certified LPs it completed (a stream's
requests)."""

UNIT, BETTER, SOURCE = "s/LP", "lower", "host_clock"


def read(record):
    done = sum(c.certified for c in record.calls if c.kind == "request")
    return record.seconds / done if done else None
