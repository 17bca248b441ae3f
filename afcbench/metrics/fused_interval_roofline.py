"""The fused interval kernel's share of its roofline: the frozen
yardstick's bound for one interval of the cell (its float32 operations at
67 TFLOP/s or its bytes at 3.35 TB/s, whichever is longer) over the
kernel's mean device time a launch, in percent."""
from afcbench import yardstick

KERNEL = "fused_interval"


def read(rec):
    times = [e - s for name, s, e in rec["device"] if KERNEL in name]
    if not times:
        return None
    bound = yardstick.bound_s(rec["interval_flops"], rec["interval_bytes"])
    return 100.0 * bound / (sum(times) / len(times))
