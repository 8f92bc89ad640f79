"""The host work at the single-LP driver's chunk exits, as a share of a
stream's window: the durations of the port's chunk.exit spans
(relp_tpu_torch.utils.logging: from the loop's first host read of a
chunk's state to the next chunk or the phase's return; stall logic,
refactorization, the gamma refresh, status reads), clipped to the window's
program calls, over the window.  Nothing is read where the program records
no spans there, or where its ring lost spans of the window."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("single-LP driver and chunk loop", "%", "lower",
                                      "program_span", "lp_s")


def read(record):
    from relp_tpu_torch.utils import logging

    window = getattr(logging, "window", None)
    if window is None or not record.calls:
        return None
    spans = window(int(record.calls[0].t0 * 1e9), int(record.calls[-1].t1 * 1e9))
    if not spans:
        return None
    return 100.0 * sum(s.end - s.start for s in spans if s.name == "chunk.exit") / 1e9 / (
        record.seconds)
