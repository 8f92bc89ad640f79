"""The batch driver's pivot rate: the pivots (dual ones included) that
solve_batch returned, over the time inside its calls less their
certification (the harness's spans)."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("batch driver", "pivots/s", "higher", "program_span",
                                      "certified_lps_per_s")


def read(record):
    calls = [c for c in record.calls if c.kind == "batch"]
    pivots = sum(c.iterations for c in calls)
    seconds = sum(c.t1 - c.t0 - c.certify_s for c in calls)
    return pivots / seconds if pivots and seconds > 0 else None
