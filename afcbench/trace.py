"""Reading the traced window: the device's activity from the profiler's
trace (kernels, copies and fills, each with its start and length on the
card), its union (``busy_s``), the operations that took most time, and the
idle gaps by the benchmark's span (collect, postprocess, update, env step)
that was open while the card waited.  The profiler records the card's
activity only (``ProfilerActivity.CUDA``): recording every host operation
as well slows the host-bound update about twofold."""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

Interval = Tuple[str, float, float]     # name, start s, end s
# the prefix of the benchmark's own spans (torch.profiler.record_function)
SPAN = "afcbench."


def _start_end(ev) -> Tuple[float, float]:
    if hasattr(ev, "start_ns"):
        s = ev.start_ns() * 1e-9
        return s, s + ev.duration_ns() * 1e-9
    s = ev.start_us() * 1e-6
    return s, s + ev.duration_us() * 1e-6


def events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device activity, spans) of a finished profiler, each a list of
    (name, start, end) in seconds on the profiler's clock: the kernels,
    copies and fills that ran on the card, and the ranges of the
    benchmark's spans (``record_function``), on the card's timeline where
    the profiler puts them there, else on the host's."""
    dev, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s, e = _start_end(ev)
        if name.startswith(SPAN):
            spans.append((name, s, e))
        elif (ev.device_type() == torch.autograd.DeviceType.CUDA
              and not ev.is_user_annotation()):
            dev.append((name, s, e))
    dev.sort(key=lambda x: x[1])
    spans.sort(key=lambda x: x[1])
    return dev, spans


def merged(dev: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the device's intervals, as sorted disjoint spans."""
    spans: List[List[float]] = []
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return [(s, e) for s, e in spans]


def busy_s(dev: List[Interval]) -> float:
    return sum(e - s for s, e in merged(dev))


def top_ops(dev: List[Interval], k: int = 10) -> List[list]:
    """The ``k`` device operations that took most time, summed by name."""
    tot: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        tot[name] += e - s
    return [[n, t] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def _innermost(host: List[Interval], mids: List[float]) -> List[str]:
    """For each of the ascending ``mids``, the name of the host operation
    with the latest start that still runs there, or None: one sweep, the
    operations in a heap by start, an ended one dropped for good (the mids
    only grow)."""
    out, heap, i = [], [], 0
    for mid in mids:
        while i < len(host) and host[i][1] <= mid:
            heapq.heappush(heap, (-host[i][1], host[i][2], host[i][0]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def idle_gaps(dev: List[Interval], spans: List[Interval], k: int = 10
              ) -> List[list]:
    """The device's idle time between its first and last operation, summed
    by the innermost of the benchmark's spans at each gap's middle: what
    the host was doing while the card waited."""
    merged_dev = merged(dev)
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(merged_dev[:-1],
                                                 merged_dev[1:])]
    mids = [0.5 * (a + b) for a, b in gaps]
    tot: Dict[str, float] = defaultdict(float)
    for (a, b), label in zip(gaps, _innermost(spans, mids)):
        tot[label or "(between spans)"] += b - a
    return [[n, t] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:k]]
