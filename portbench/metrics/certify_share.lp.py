"""Exact certification's share of a stream's window: SolveStats.certify_time_s
summed over the requests, over the window."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("certification", "%", "lower", "program_counter",
                                      "lp_s")


def read(record):
    calls = [c for c in record.calls if c.kind == "request"]
    return 100.0 * sum(c.certify_s for c in calls) / record.seconds if calls else None
