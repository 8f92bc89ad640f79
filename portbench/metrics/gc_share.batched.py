"""The Python garbage collector's share of a branch-and-bound window: the durations of
the port's gc spans (relp_tpu_torch.utils.logging: one for each collection
of the oldest generation), clipped to the window's program calls, over the
window.  Nothing is read where the program records no spans there, or
where its ring lost spans of the window."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("host runtime (Python garbage collector)", "%",
                                      "lower", "program_span", "certified_lps_per_s")


def read(record):
    from relp_tpu_torch.utils import logging

    window = getattr(logging, "window", None)
    if window is None or not record.calls:
        return None
    spans = window(int(record.calls[0].t0 * 1e9), int(record.calls[-1].t1 * 1e9))
    if not spans:
        return None
    return 100.0 * sum(s.end - s.start for s in spans if s.name == "gc") / 1e9 / record.seconds
