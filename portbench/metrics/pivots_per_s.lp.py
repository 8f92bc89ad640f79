"""The single-LP driver's pivot rate: SolveStats.iterations over the time of
its solve_relaxation calls less their certification (the harness's spans)."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("single-LP driver and chunk loop", "pivots/s",
                                      "higher", "program_span", "lp_s")


def read(record):
    pivots = sum(c.iterations for c in record.solves)
    seconds = sum(c.t1 - c.t0 - c.certify_s for c in record.solves)
    return pivots / seconds if pivots and seconds > 0 else None
