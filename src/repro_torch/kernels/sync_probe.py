"""The synchronisation floor of the CFD kernels' chains
(``csrc/sync_probe.cu``).

The fused interval and the SOR slab kernels are chains of phases, each of
which waits for rows its neighbouring blocks wrote in the phase before
(PERF.md's "second floor").  :func:`sync_probe` runs such a chain with no
arithmetic: a group of blocks hands its neighbours a phase at a time, by
one of the kernels' four handoffs (:data:`MODES`), so that a phase's
time on the card is the least any kernel with that handoff can take.  It
replaces no TPU kernel and runs on no path; ``chip_smoke.py`` times it.
"""
from __future__ import annotations

import ctypes

import torch

# the handoffs (csrc/sync_probe.cu mode): the global-memory kernels' flags,
# rows through L2 ordered by flags, the resident kernels' tagged rows
# through L2 at a cluster edge, the cluster kernels' DSMEM push counted on
# an mbarrier
MODES = {"l2_flags": 0, "l2_rows": 1, "l2_tagged": 2, "dsmem": 3}

# the res-48 interval's chain (4 envs, 50 dt): G 32 blocks (clusters of 16
# for "dsmem", each cluster a chain of its own), 6100 phases in sequence,
# rows of 528 packed columns, 544 threads a block
BLOCKS, CLUSTER, HANDOFFS, THREADS, WIDTH = 32, 16, 6100, 544, 528


def _load():
    from repro_torch.kernels import build
    lib = build.load("sync_probe")
    if lib.sync_probe_launch.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.sync_probe_launch.argtypes = [i] * 6 + [p, p]
        lib.sync_probe_launch.restype = ctypes.c_int
        lib.sync_probe_workspace_floats.argtypes = [i, i]
        lib.sync_probe_workspace_floats.restype = ctypes.c_longlong
    return lib


def sync_probe(mode: str, device):
    """A function that launches one chain of :data:`HANDOFFS` phases of the
    handoff ``mode`` at the res-48 interval's shape (:data:`BLOCKS` blocks
    of :data:`THREADS` threads, each phase moving a row of :data:`WIDTH`
    floats to each neighbour in "l2_rows", "l2_tagged" and "dsmem") on
    ``device``'s current stream.  ``.launches`` counts its launches."""
    from repro_torch.kernels.build import check_launch
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"sync_probe measures the card, got {dev}")
    lib = _load()
    ws = torch.zeros(lib.sync_probe_workspace_floats(BLOCKS, WIDTH),
                     dtype=torch.float32, device=dev)

    def run():
        with torch.cuda.device(dev):
            err = lib.sync_probe_launch(
                MODES[mode], BLOCKS, CLUSTER, HANDOFFS, THREADS, WIDTH,
                ws.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch(lib, err, f"sync_probe ({mode})")
        sync_probe.launches += 1

    return run


sync_probe.launches = 0
