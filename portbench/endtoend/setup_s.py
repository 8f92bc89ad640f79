"""Seconds from the start of the process to the window's start: imports,
the CUDA library's build or load, the inputs and the warm-up."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(record):
    return record.setup_s
