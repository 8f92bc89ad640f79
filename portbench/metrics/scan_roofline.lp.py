"""fused_price_scan's share of its bound in the traced part of the window:
the bound of each traced launch (portbench.bounds.scan_bound_s at the
published 3.35 TB/s and 67 TFLOP/s; state the card's power.limit beside
it) over the launches' device time.  The shape is the one the run gave the
scan from its warm-up to the window's close (its graphs may have been
captured before the traced part).  Nothing is read when the traced part
ran no scan, or when the run gave the scan more than one shape."""

from portbench.bounds import scan_bound_s

LAYER, UNIT, BETTER, SOURCE, MOVES = ("kernels", "%", "higher", "device_trace", "lp_s")


def read(record):
    trace = record.trace
    if trace is None or len(record.scan_shapes) != 1:
        return None
    launches = seconds = 0
    for name, (count, s) in trace["kernels"].items():
        if "price_scan_kernel" in name:
            launches += count
            seconds += s
    if not launches or seconds <= 0:
        return None
    (M, N, itemsize), = record.scan_shapes
    return 100.0 * launches * scan_bound_s(M, N, itemsize)[0] / seconds
