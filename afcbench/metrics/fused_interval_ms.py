"""Milliseconds of device time a launch of the fused interval kernel
(``kernels/actuation/ops.fused_interval_cuda`` -> ``csrc/fused_interval.cu``:
the cluster, resident and global-memory instantiations), from the
profiler's trace of the whole traced window; one launch an interval."""

KERNEL = "fused_interval"


def read(rec):
    times = [e - s for name, s, e in rec["device"] if KERNEL in name]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
