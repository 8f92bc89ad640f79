"""The device's idle share in the traced part of a stream's window: 1 less
the union of its operations' intervals over that part."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("device", "%", "lower", "device_trace", "lp_s")


def read(record):
    t = record.trace
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])
