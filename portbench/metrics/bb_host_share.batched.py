"""Branch and bound's own host work: the window less the time inside the
calls to solve_batch and the single solves (the harness's spans), over the
window."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("branch and bound", "%", "lower", "program_span",
                                      "certified_lps_per_s")


def read(record):
    calls = [c for c in record.calls if c.kind in ("single", "batch")]
    if not calls:
        return None
    return 100.0 * (record.seconds - sum(c.t1 - c.t0 for c in calls)) / record.seconds
