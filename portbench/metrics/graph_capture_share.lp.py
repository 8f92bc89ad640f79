"""The share of a stream's window spent capturing CUDA graphs
(relp_tpu_torch.simplex.graphs.CAPTURE_SECONDS, the counter behind
chip_smoke's graphs= field): each single solve keeps its own cache, so every
request captures its chunks anew.  A window that captured nothing reads 0."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("chunk loop (graphs)", "%", "lower",
                                      "program_counter", "lp_s")


def read(record):
    return 100.0 * record.capture_s / record.seconds
