"""torch.cuda.max_memory_reserved() over set-up and window, after a reset
at the start of the process."""

UNIT, BETTER, SOURCE = "GiB", "lower", "host_clock"


def read(record):
    return record.peak_reserved_bytes / 2**30 if record.peak_reserved_bytes else None
