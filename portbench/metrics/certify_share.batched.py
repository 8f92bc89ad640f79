"""Exact certification's share of the window where solve_batch carries the
LPs: SolveStats.certify_time_s summed over every LP that solve_batch and
the single solves around it returned, over the window."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("certification", "%", "lower", "program_counter",
                                      "certified_lps_per_s")


def read(record):
    calls = [c for c in record.calls if c.kind in ("single", "batch")]
    return 100.0 * sum(c.certify_s for c in calls) / record.seconds if calls else None
