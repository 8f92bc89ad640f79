"""The single-LP chunk loop's pivot rate: the pivots of the port's chunk
spans (relp_tpu_torch.utils.logging: from run_chunk's call to the loop's
first host read of its state) over their self time (graph captures and
garbage collections inside them left out), within the window's program
calls.  Nothing is read where the program records no chunk spans there,
or where its ring lost spans of the window."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("single-LP driver and chunk loop", "pivots/s",
                                      "higher", "program_span", "lp_s")


def read(record):
    from relp_tpu_torch.utils import logging

    window = getattr(logging, "window", None)
    if window is None or not record.calls:
        return None
    spans = window(int(record.calls[0].t0 * 1e9), int(record.calls[-1].t1 * 1e9))
    if not spans:
        return None
    own = logging.self_ns(spans)
    chunks = [s for s in spans if s.name == "chunk"]
    pivots = sum(s.counts.get("pivots", 0) for s in chunks)
    seconds = sum(own[s.id] for s in chunks) / 1e9
    return pivots / seconds if pivots and seconds > 0 else None
