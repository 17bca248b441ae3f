"""The share of the traced window in which no operation ran on the card:
one minus the union of the device's kernels, copies and fills (from the
profiler's trace) over the window's host seconds, in percent."""


def read(rec):
    if not rec["device"] or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
