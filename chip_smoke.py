"""On-card smoke run of the PyTorch/CUDA port (src/repro_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); builds the five
hand-written kernel libraries from src/repro_torch/kernels/csrc into
build/repro_torch_kernels/ (one nvcc process each, in parallel).
Phases (any failure exits non-zero):

1. kernel checks: each kernel against its plain PyTorch twin on the card at
   the shape its path gives it (res 16 and 4 envs for the CFD kernels;
   B=1, S=4096 at phi4-mini's and rwkv6-3b's widths in bf16 for flash
   attention and WKV6; flash attention's bf16 tensor-core kernel also
   against the tile-exact oracle flash_attention_tiled, its float32
   CUDA-core kernel at the same shape, and a small sliding-window case,
   held by measures scaled to its output, which must reject two
   deliberately wrong variants; the SASS of the flash library must hold
   HGMMA instructions, that of WKV6 HMMA), with the stated tolerance,
   timed with CUDA events; the fused kernel also at 1 dt, at 32 envs
   (timed, with the cluster size chosen there) and at res 18 (held only),
   the two SOR slab kernels also at res 18 (held only), each cluster
   kernel's cluster size, blocks, the distinct SMs they ran on and its time
   per SOR half-sweep reported, the fused kernel's per-body instantiation
   on a mixed bank batch (cylinder jets, pinball and tandem rotary at
   distinct per-body speeds; res 16, 4 envs, 50 dt; each body's C_D / C_L
   held) and timed beside the scalar one, WKV6's blocks and SMs as its launch
   recorded them and each of its two passes timed, WKV6 also at a head of
   40 and a chunk of 64 and bf16 flash attention at a head dim of 96
   (both padded by their wrappers, held only); the three cluster kernels'
   checks must reject variants built with a planted fault in their shared
   half-sweep (SOR halo rows one half-sweep stale);
2. the main path: ``train()`` on the card at full width (res 16, 50 dt per
   action, 60 SOR iterations, 2x512 MLP, 149 probes, 4 envs,
   backend="fused"), depth cut to 2 episodes; the fused kernel must run;
   then the multi-body path: ``train(scenarios=("cyl_re100",
   "pinball_re100"))`` at the same widths (act_dim 3, the pinball's 59
   probes padded to 149), 1 episode; the fused kernel's per-body
   instantiation must launch once per interval, its scalar one once per
   warmup group;
3. the second path: one short episode with backend="pallas"; the
   packed-SOR kernel must run, one launch per pressure solve;
4. the language-model paths: ``lm_loss(backend="pallas")`` of
   phi4-mini-3.8b and of rwkv6-3b at full width and depth (random bf16
   params from a seed), B=1, S=4096, timed at the first and a second
   (steady) call; one launch per layer of the bf16 flash-attention kernel,
   two (its chunk and state passes) of the WKV6 kernel, and none of any
   other, logits and loss held against backend="reference";
5. the full-grid drop-in solve ``rb_sor(packed=False)``: res 16, 4 grids,
   iters=50, one launch of its kernel, the residual reduced;
6. golden physics through the fused kernel: the res-8 fixtures' Strouhal
   number, mean C_D and C_L amplitude within the reference's tolerances,
   the cylinder's through the scalar instantiation, the pinball's through
   the scalar one and through the per-body one (total forces);
7. the attention policy and the robust training path, every run on the
   card at the main path's widths (res 16, 50 dt per action, 4 envs of
   ``scenarios=("cyl_re100", "pinball_re100")``, 149 probes, act_dim 3,
   the attention policy at its own widths: d_model 64, 4 heads over 2 KV
   heads, 2 layers) under ``torch.use_deterministic_algorithms``: (a) 2
   episodes checkpointed every episode; 1 episode then a resume to 2 must
   equal (a) bit for bit (params, Adam moments, generator state, history)
   and the resume must launch no warmup; (b) ``nan_env`` on env 1 at step 4:
   exactly 1 quarantine, the other envs' final fields equal to (a)'s first
   episode's; (c) ``grad_nan`` at PPO step 7: 1 skip, params unchanged
   across that minibatch; (d) a ``watchdog`` fault at episode 1: one
   rollback, the completed run equal to (a).  The per-body instantiation
   must launch once per interval of every run, the scalar one once per
   warmup group; each run's wall time, the attention episode beside the
   MLP one, and the checkpoint's bytes and caller-visible time are printed;
8. the paper's I/O layer at the main path's widths (res 16, 50 dt per
   action, 4 envs, 2x512 MLP, backend="fused"), under
   ``torch.use_deterministic_algorithms``: (a) ``train()`` of 2 episodes
   with ``SinkSpec(kind="dataset")``: 201 fused launches, episodes 0..1
   recorded, the run fingerprint in the manifest; (b) ``replay_sync`` of
   the dataset from the seed: params, Adam moments, PPO step, generator
   state and returns equal to the live run's bit for bit, no fused
   launch; (c) a copy with its last shard cut by 8 bytes and one with a
   payload byte flipped raise ``DatasetError`` and never replay; (d)
   ``MultiEnvInterface.exchange`` of the second episode's batch in each
   mode (bytes and host seconds printed, every record read back), then 1
   episode of ``train(interface=..., sink=...)`` with the optimized
   interface and a binary sink whose file must read back equal to the
   episode's trajectory;
9. one JSON line listing the five kernels, then the card's line and the
   result.

Imports nothing of jax or of the reference package.
"""
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# golden tolerances, the reference's (tests/test_golden_physics.py and, for
# the pinball, tests/test_golden_pinball.py)
TOL_ST, TOL_CD, TOL_AMP = 0.015, 0.01, 0.05
TOL_PINBALL = {"strouhal": 0.015, "cd_mean": 0.01, "cl_amp": 0.06}
# kernel vs twin: the kernel contracts a*b+c into FMAs, multiplies by
# float32 reciprocals of the grid constants where the twin divides, and sums
# forces in another order than the twin's op-by-op float32; over 50 dt x 60
# SOR pairs that stays well inside these (u, v are O(1), p and C_D O(5))
TOL_FUSED = {"u": 1e-4, "v": 1e-4, "p": 1e-3, "cd": 1e-3, "cl": 1e-3}
TOL_SOR = 1e-5                 # 52 pairs on unit-variance planes
# flash attention.  An output row averages v over up to S keys, so |o|
# falls as 1/sqrt(keys) along the sequence (about 1 at the first row, 0.02
# at the last of 4096): an absolute limit would be loose for most rows.  So
# the kernel is held by two measures scaled to the output, (rel-RMS: the
# RMS of kernel - plain over the RMS of plain, worst row: the largest
# max|kernel - plain| of a row over max|plain| of that row).  bfloat16: p
# is rounded at the running max in the kernel and after normalising in the
# twin, the twin's scores are rounded, and both round the output, each
# 2^-9 relative at most: 4.3e-3 rel-RMS and 1.7e-2 in the worst of 98304
# rows on the H100.  float32: only the order of the sums differs, 4.6e-7
# and 5.5e-6.  The limits are 2-10x those readings; the wrong variants of
# flash_wrong_kernels read 0.36 and 1.4 rel-RMS
TOL_FLASH = {"bfloat16": (1e-2, 5e-2), "float32": (5e-6, 5e-5)}
# the bf16 tensor-core kernel against flash_attention_tiled, which rounds p
# at the same running max: the two fp32 results differ by the order of the
# sums and by exp2f against exp (~1 fp32 ulp of p), so a bf16 output
# differs by one rounding step, one ulp of its row's largest |o| (2^-7 of
# it), and by at most one more where a p lands on the other side of a bf16
# boundary in the two: two steps, 2^-6 (the H100 reads 7.75e-3, a row
# whose largest |o| sits just above a power of two).  Few outputs straddle
# a boundary: rel-RMS 1.2e-4 on the H100, 2e-3 allowed.  The wrong
# variants of flash_wrong_kernels read 0.36 and 1.4
TOL_FLASH_TILED = (2e-3, 2 ** -6)
# WKV6, bf16 in and out: both compute the float32 recurrence on the same
# values (the chunked algebra against the sequential one), ~1e-6 apart, so
# the float32 state agrees to 2e-5 of its scale; the bf16 outputs differ by
# at most one rounding step where the two float32 values straddle a bf16
# boundary: one ulp, at most 2^-7 of the largest |out|.  Relative to the
# largest |x|
TOL_WKV_OUT, TOL_WKV_STATE = 2 ** -7, 2e-5
# lm_loss at full width in bf16, backend "pallas" against "reference".  The
# kernels round p and the attention / WKV output to bf16 (8 bits, 2^-8
# relative) at other points than the plain mixers.  Layer by layer, on the
# same input, a block's update then differs by a few bf16 ulps of its RMS:
# 3e-2 allowed, and the logits of the last block likewise.  Through all 32
# random layers those differences grow (the reference package's own two
# backends differ by ~30% of the logits' RMS after 32 bf16 layers at
# reduced width), so the full-depth logits are reported, not held; the loss
# of near-uniform predictions (~ln V) moves little: 5e-2 allowed
TOL_LM_LAYER, TOL_LM_LOSS = 3e-2, 5e-2
FP32_PEAK = 67e12              # H100 SXM, FLOP/s outside the tensor cores
BF16_PEAK = 989e12             # H100 SXM, dense bf16 tensor-core FLOP/s
TF32_PEAK = 495e12             # H100 SXM, dense TF32 tensor-core FLOP/s
HBM_RATE = 3.35e12             # bytes/s
# float32 operations per point, counted from the kernels' source
FLOP_SOR_POINT = 10            # one point of one half-sweep
FLOP_MOMENTUM_POINT = 51       # predictor + penalization + force, per face
FLOP_RHS_POINT = 6             # divergence / dt
FLOP_CORRECT_POINT = 4         # projection correction, per face
# the per-body instantiation, per face and body: the target's multiply-add
# and the force split's
FLOP_BODY_POINT = 4
# a mixed bank batch: (geometry, act_mode, per-body speeds) per env; the
# cylinder's jets ride slot 0, tandem's third slot meets zero planes
BANK_ENVS = (("cylinder", 0.0, (0.3, 0.0, 0.0)),
             ("pinball", 1.0, (0.6, -0.3, 0.1)),
             ("tandem", 1.0, (-0.5, 0.8, 0.4)),
             ("pinball", 1.0, (1.0, 0.2, -0.7)))
# ~0.1 s of the card's clock, long enough for the host to queue a timed loop
SLEEP_CYCLES = 200_000_000


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps):
    """ms per call of ``fn`` on the card: after a warm-up, ``reps`` calls
    queued behind a sleep kernel, so the events time the card's work and
    not the host's pace of launching it."""
    import torch
    fn()                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_paced_ms(fn, reps):
    """ms per call of ``fn`` in a loop the host paces (events around
    back-to-back calls): the card's time or the host's, whichever is
    longer."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound(nbytes, *work):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over their peaks, ``work`` being (operations, peak
    FLOP/s) pairs of the unit each runs on."""
    t_ops = sum(flops / peak for flops, peak in work)
    t_bytes = nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def fused_case(dev, cfg, n_env, n_steps):
    """Inputs of a fused-kernel check and its two realizations: n_env
    perturbed impulsive starts mixing jets and rotary."""
    import numpy as np
    import torch
    from repro_torch.cfd import grid, solver
    from repro_torch.kernels.actuation import ops
    geom = grid.build_geometry(cfg)
    ga = solver.geom_to_arrays(geom, dev)
    rng = np.random.default_rng(0)
    flow = solver.init_state(cfg, geom, dev)
    flow = solver.FlowState(*(
        a.expand(n_env, *a.shape) + torch.tensor(
            0.01 * rng.standard_normal((n_env,) + tuple(a.shape)),
            dtype=torch.float32, device=dev) for a in flow))
    reps = -(-n_env // 4)
    jet = torch.tensor([0.3, -0.5, 0.0, 1.0] * reps, device=dev)[:n_env]
    mode = torch.tensor([0.0, 0.0, 1.0, 1.0] * reps, device=dev)[:n_env]

    def kernel():
        return ops.fused_interval_cuda(cfg, ga, flow, jet, n_steps,
                                       act_mode=mode)

    def plain():
        return ops.fused_interval_plain(cfg, ga, flow, jet, n_steps,
                                        act_mode=mode)

    return kernel, plain


def bank_case(dev, cfg, n_env, n_steps):
    """Inputs of a per-body kernel check and its two realizations: the bank
    of every geometry, ``n_env`` envs cycling through BANK_ENVS, each from
    its geometry's perturbed impulsive start."""
    import numpy as np
    import torch
    from repro_torch.cfd import grid, solver
    from repro_torch.kernels.actuation import ops
    names = grid.geometry_names()
    geoms = {n: grid.build_geometry(cfg, n) for n in names}
    bank = solver.geometry_bank(
        [solver.geom_to_arrays(geoms[n], dev) for n in names],
        grid.max_bodies())
    envs = [BANK_ENVS[i % len(BANK_ENVS)] for i in range(n_env)]
    rng = np.random.default_rng(1)
    flows = [solver.init_state(cfg, geoms[g], dev) for g, _, _ in envs]
    flow = solver.FlowState(*(
        torch.stack(xs) + torch.tensor(
            0.01 * rng.standard_normal((n_env,) + tuple(xs[0].shape)),
            dtype=torch.float32, device=dev) for xs in zip(*flows)))
    gid = torch.tensor([names.index(g) for g, _, _ in envs], device=dev)
    mode = torch.tensor([m for _, m, _ in envs], device=dev)
    amp = torch.tensor([a for _, _, a in envs], device=dev)

    def kernel():
        return ops.fused_interval_cuda(cfg, bank, flow, amp, n_steps,
                                       act_mode=mode, geom_id=gid)

    def plain():
        return ops.fused_interval_plain(cfg, bank, flow, amp, n_steps,
                                        act_mode=mode, geom_id=gid)

    return kernel, plain


def fused_errors(kernel, plain):
    """max |kernel - twin| of u, v, p, C_D and C_L."""
    import torch
    (ka, ko), (pa, po) = kernel(), plain()
    torch.cuda.synchronize()
    errs = {n: float((x - y).abs().max())
            for n, x, y in zip("uvp", ka, pa)}
    errs["cd"] = float((ko.cd - po.cd).abs().max())
    errs["cl"] = float((ko.cl - po.cl).abs().max())
    return errs


def fused_report(what, errs):
    """Print the errors beside TOL_FUSED; True when every one is within."""
    print(f"[kernels] {what}: max|kernel - plain| " + ", ".join(
        f"{k} {v:.3e} (tol {TOL_FUSED[k]:.0e})" for k, v in errs.items()))
    return all(v <= TOL_FUSED[k] for k, v in errs.items())


def hold_fused(dev, cfg, n_env, n_steps, case=fused_case, what=""):
    """The kernel against its twin (TOL_FUSED) on ``case``'s inputs;
    returns (errors, kernel, plain)."""
    kernel, plain = case(dev, cfg, n_env, n_steps)
    errs = fused_errors(kernel, plain)
    if not fused_report(f"fused_interval{what} res {cfg.res} N={n_env} "
                        f"{n_steps} dt", errs):
        fail(f"fused_interval{what} res {cfg.res}, {n_env} envs, {n_steps} "
             f"dt differs from its twin: {errs}")
    return errs, kernel, plain


# The planted fault of the cluster kernels' shared half-sweep
# (csrc/sor_packed.cuh, used by the fused kernel and the two SOR slab
# kernels): the edge rows send their neighbours the value from before the
# half-sweep, so every SOR halo row lags one half-sweep, which is what an
# edge row reads when its wait on the halo exchange is missing or waits on
# the wrong phase.
STALE_HALO = ("st_async(to_prev + 4 * k, val, link.prev_bar)",
              "st_async(to_next + 4 * k, val, link.next_bar)")
STALE_HALO_HEADER = "sor_packed.cuh"
STALE_HALO_KERNELS = ("fused_interval", "poisson_sor", "poisson_sor_full")


def start_stale_halo_build():
    """Start nvcc on copies of the three cluster kernels built with the
    planted fault in their shared half-sweep, beside the other builds;
    returns {kernel: (library path, process)}."""
    from repro_torch.kernels import build
    text = (build.CSRC / STALE_HALO_HEADER).read_text()
    for line in STALE_HALO:
        if text.count(line) != 1:
            fail(f"{STALE_HALO_HEADER} no longer holds {line!r} once: the "
                 f"stale-halo variant cannot be planted")
        text = text.replace(line, line.replace(", val,", ", self,"))
    out = build.BUILD_DIR / "stale_halo"
    out.mkdir(parents=True, exist_ok=True)
    for name in {src for k in STALE_HALO_KERNELS for src in build.SOURCES[k]}:
        (out / name).write_bytes((build.CSRC / name).read_bytes())
    (out / STALE_HALO_HEADER).write_text(text)
    jobs = {}
    for kernel in STALE_HALO_KERNELS:
        lib = out / f"lib{kernel}_stale_halo.so"
        jobs[kernel] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(out / build.SOURCES[kernel][0])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return jobs


def stale_halo_libraries(jobs):
    """Wait for the stale-halo builds; {kernel: loaded library}."""
    import ctypes
    libs = {}
    for kernel, (path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"the stale-halo variant of {kernel} did not build:\n{out}")
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[kernel] = lib
    return libs


@contextlib.contextmanager
def library_swapped(kernel, wrong):
    """Run the kernel's wrapper on the library ``wrong`` in the block."""
    from repro_torch.kernels import build
    right = build.load(kernel)
    build._LIBS[kernel] = wrong
    try:
        yield
    finally:
        build._LIBS[kernel] = right


def stale_halo_rejected(dev, wrong, cfg, n_env, cases, case=fused_case,
                        what=""):
    """The fused kernel's checks, taken together, must reject the
    stale-halo variant: each ``(n_steps, errors of the right kernel)`` of
    ``cases`` is run through the variant on ``case``'s inputs, and at
    least one must fall outside TOL_FUSED.  Returns the variant's errors
    by case."""
    readings, rejected = {}, False
    with library_swapped("fused_interval", wrong):
        for n_steps, right_errs in cases:
            errs = fused_errors(*case(dev, cfg, n_env, n_steps))
            readings[f"{n_steps}_dt"] = errs
            held = fused_report(f"wrong kernel{what}, SOR halo rows one "
                                f"half-sweep stale, res {cfg.res} "
                                f"N={n_env} {n_steps} dt", errs)
            rejected = rejected or not held
            print(f"[kernels]   the right kernel there: " + ", ".join(
                f"{k} {v:.3e}" for k, v in right_errs.items()))
    if not rejected:
        fail("TOL_FUSED cannot tell a fused kernel whose SOR halo rows lag "
             "one half-sweep from a right one")
    return readings


def blocks_ran(block_sms):
    """(blocks, distinct SMs) of a launch from its record of the SM each
    block ran on, -1 where no block ran."""
    ran = block_sms.cpu()
    ran = ran[ran >= 0]
    return int(ran.numel()), int(ran.unique().numel())


def fused_launch():
    """(cluster size, blocks, distinct SMs) of the fused wrapper's last
    launch, as the launch recorded them."""
    from repro_torch.kernels.actuation import ops
    return (ops.fused_interval_cuda.last_cluster,
            *blocks_ran(ops.fused_interval_cuda.last_block_sms))


def fused_work(cfg, n_env, n_steps, n_bodies=0, n_geoms=1):
    """(float32 operations, bytes) of one fused interval: every input read
    once (the fields, the geometry of each of ``n_geoms`` geometries the
    batch uses, the per-env scalars) and every output written once.  The
    per-body instantiation (``n_bodies``) reads the per-body planes in
    place of the summed rotary target and does FLOP_BODY_POINT more
    operations per face and body."""
    ny, nx = cfg.ny, cfg.nx
    nu, nv, npts = ny * (nx + 1), (ny + 1) * nx, ny * nx
    flops = n_env * n_steps * (
        cfg.poisson_iters * npts * FLOP_SOR_POINT
        + (nu + nv) * (FLOP_MOMENTUM_POINT + FLOP_BODY_POINT * n_bodies)
        + npts * FLOP_RHS_POINT + (nu + nv) * FLOP_CORRECT_POINT)
    if not n_bodies:
        return flops, 4 * (2 * n_env * (nu + nv + npts) + 6 * nu + 6 * nv
                           + ny + 3 * n_env + 2 * n_env * n_steps)
    planes = 5 + 2 * n_bodies     # chi, 2 jet, jmask, rmask, rotb, own
    return flops, 4 * (2 * n_env * (nu + nv + npts)
                       + n_geoms * (planes * (nu + nv) + ny)
                       + n_env * (n_bodies + 3)
                       + 2 * n_env * n_steps * n_bodies)


def check_fused(dev, cfg, n_env, n_steps):
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.kernels.actuation import ops
    errs, kernel, plain = hold_fused(dev, cfg, n_env, n_steps)
    ms = cuda_ms(kernel, 5)
    cluster, blocks, sms_busy = fused_launch()
    plain_ms = cuda_ms(plain, 2)
    ny, nx = cfg.ny, cfg.nx
    flops, nbytes = fused_work(cfg, n_env, n_steps)
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    # the card's occupancy for this launch shape and the others that fit
    active = ops.active_clusters(dev, cfg, cluster)
    by_size = {c: ops.active_clusters(dev, cfg, c) for c in (16, 8, 4)
               if ops.smem_bytes(ny, nx, c) <= ops.SMEM_PER_BLOCK}
    # a half-sweep's time: the interval at 60 and at 20 SOR pairs per dt,
    # the difference over the 40 pairs' half-sweeps
    few = GridConfig(res=cfg.res, poisson_iters=cfg.poisson_iters - 40)
    few_ms = cuda_ms(fused_case(dev, few, n_env, n_steps)[0], 5)
    sweep_us = 1e3 * (ms - few_ms) / (n_steps * 2 * 40)
    # derived, for the text only: the second floor is the phases of an
    # interval in sequence, each waiting for rows other blocks wrote (a
    # neighbour exchange after each SOR half-sweep, a cluster barrier after
    # the predictor and after the correction)
    chain = n_steps * (2 * cfg.poisson_iters + 2)
    sor_share = n_steps * 2 * cfg.poisson_iters * sweep_us / (1e3 * ms)
    print(f"[kernels] fused_interval: kernel {ms:.4f} ms, plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB); clusters of "
          f"{cluster} blocks, {blocks} blocks ran on {sms_busy} distinct SMs "
          f"({active} such clusters resident at once; by cluster size "
          f"{by_size}); {chain} synchronisations in sequence, "
          f"{1e3 * ms / chain:.4f} us each on average; at "
          f"{few.poisson_iters} SOR pairs {few_ms:.4f} ms, so "
          f"{sweep_us:.4f} us per half-sweep, the SOR {sor_share:.3f} of "
          f"the kernel's time")
    return {"name": "fused_interval", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_interval.cu",
            "replaces": "src/repro/kernels/actuation/kernel.py:39",
            "max_abs_err": max(errs.values()), "errors": errs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library": "no single PyTorch call computes this",
            "cluster": cluster, "blocks": blocks, "sms_busy": sms_busy,
            "active_clusters": active,
            f"ms_at_{few.poisson_iters}_sor_pairs": few_ms,
            "half_sweep_us": sweep_us,
            "shape": f"res {cfg.res} (ny {ny}, nx {nx}), {n_env} envs, "
                     f"{n_steps} dt, {cfg.poisson_iters} SOR pairs per dt"}


def fused_batch_reading(dev, cfg, n_env, n_steps):
    """The kernel at a larger env batch: held against its twin, timed, and
    the launch the wrapper chose there."""
    from repro_torch.kernels.actuation import ops
    errs, kernel, _ = hold_fused(dev, cfg, n_env, n_steps)
    ms = cuda_ms(kernel, 3)
    cluster, blocks, sms_busy = fused_launch()
    active = ops.active_clusters(dev, cfg, cluster)
    print(f"[kernels] fused_interval res {cfg.res}, {n_env} envs, {n_steps} "
          f"dt: {ms:.4f} ms per interval in clusters of {cluster} blocks "
          f"({blocks} blocks ran on {sms_busy} distinct SMs; {active} "
          f"clusters resident at once, so {-(-n_env // active)} waves)")
    return {"envs": n_env, "ms": ms, "cluster": cluster, "blocks": blocks,
            "sms_busy": sms_busy, "active_clusters": active,
            "max_abs_err": max(errs.values())}


def check_fused_bodies(dev, cfg, n_env, n_steps, scalar_ms):
    """The per-body instantiation on a mixed bank batch: held against its
    twin (u, v, p and each body's C_D / C_L), timed beside the scalar
    instantiation's ``scalar_ms`` on the same grid, env count and dt."""
    from repro_torch.cfd import grid
    from repro_torch.kernels.actuation import ops
    errs, kernel, plain = hold_fused(dev, cfg, n_env, n_steps, bank_case,
                                     " per-body (mixed bank)")
    if ops.fused_interval_cuda.last_n_bodies != grid.max_bodies():
        fail(f"the per-body check launched the instantiation for "
             f"{ops.fused_interval_cuda.last_n_bodies} bodies")
    ms = cuda_ms(kernel, 5)
    cluster, blocks, sms_busy = fused_launch()
    plain_ms = cuda_ms(plain, 2)
    nb = grid.max_bodies()
    n_geoms = len({BANK_ENVS[i % len(BANK_ENVS)][0] for i in range(n_env)})
    flops, nbytes = fused_work(cfg, n_env, n_steps, nb, n_geoms)
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    active = ops.active_clusters(dev, cfg, cluster, nb)
    print(f"[kernels] fused_interval per-body ({nb} bodies, a bank of "
          f"{len(grid.geometry_names())} geometries, {n_geoms} in the batch):"
          f" kernel {ms:.4f} ms ({ms / scalar_ms:.4f} of the scalar "
          f"instantiation's {scalar_ms:.4f} ms), plain twin {plain_ms:.4f} "
          f"ms, bound {bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.4f} GFLOP"
          f", {nbytes / 1e6:.4f} MB); clusters of {cluster} blocks, {blocks} "
          f"blocks ran on {sms_busy} distinct SMs ({active} such clusters "
          f"resident at once)")
    return {"max_abs_err": max(errs.values()), "errors": errs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "ms_over_scalar": ms / scalar_ms,
            "cluster": cluster,
            "blocks": blocks, "sms_busy": sms_busy,
            "active_clusters": active,
            "shape": f"res {cfg.res}, {n_env} envs of a mixed bank batch "
                     f"(cylinder jets, pinball and tandem rotary), "
                     f"{n_steps} dt, {cfg.poisson_iters} SOR pairs per dt"}


# the two SOR slab kernels: (name, library, source, the TPU kernel it
# replaces, the solve that drives it), by whether it takes the full grid
SOR_KERNELS = {
    False: ("rb_sor_slabs_packed", "poisson_sor",
            "src/repro_torch/kernels/csrc/poisson_sor.cu",
            "src/repro/kernels/poisson/kernel.py:106", "rb_sor_planes"),
    True: ("rb_sor_slabs", "poisson_sor_full",
           "src/repro_torch/kernels/csrc/poisson_sor_full.cu",
           "src/repro/kernels/poisson/kernel.py:37", "rb_sor(packed=False)")}


def sor_wrapper(full):
    from repro_torch.kernels.poisson import ops
    return ops.rb_sor_slabs_cuda if full else ops.rb_sor_slabs_packed_cuda


def sor_case(dev, cfg, n_env, iters, seed=1, full=False):
    """Random inputs of ``n_env`` res-``cfg.res`` grids and the two
    realizations of a solve on them, each a tuple of tensors: an
    ``rb_sor_planes`` solve on packed planes, or (``full``) an
    ``rb_sor(packed=False)`` solve on the grid from a warm start."""
    import numpy as np
    import torch
    from repro_torch.kernels.poisson import ops
    rng = np.random.default_rng(seed)
    nslabs = ops._pick_nslabs(cfg.nx)
    kw = dict(dx=cfg.dx, dy=cfg.dy, omega=cfg.poisson_omega, nslabs=nslabs,
              inner_iters=4)
    if full:
        rhs, p0 = (torch.tensor(s * rng.standard_normal((n_env, cfg.ny,
                                                         cfg.nx)),
                                dtype=torch.float32, device=dev)
                   for s in (1.0, 0.1))

        def kernel(iters=iters):
            return (ops.rb_sor(rhs, cfg.dx, cfg.dy, iters=iters,
                               omega=cfg.poisson_omega, p0=p0,
                               packed=False),)

        def plain():
            p = p0
            for _ in range(-(-iters // 4)):
                p = ops.rb_sor_slabs_plain(p, rhs, **kw)
            return (p,)

        return kernel, plain
    planes = [torch.tensor(rng.standard_normal((n_env, cfg.ny, cfg.nx // 2)),
                           dtype=torch.float32, device=dev)
              for _ in range(4)]

    def kernel(iters=iters):
        return ops.rb_sor_planes(*planes, cfg.dx, cfg.dy, iters=iters,
                                 omega=cfg.poisson_omega)

    def plain():
        red, black = planes[:2]
        for _ in range(-(-iters // 4)):
            red, black = ops.rb_sor_slabs_packed_plain(red, black,
                                                       *planes[2:], **kw)
        return red, black

    return kernel, plain


def sor_error(kernel, plain):
    import torch
    ka, pa = kernel(), plain()
    torch.cuda.synchronize()
    return max(float((x - y).abs().max()) for x, y in zip(ka, pa))


def sor_launch(full):
    """(cluster size, blocks, distinct SMs) of a slab wrapper's last
    launch, as the launch recorded them."""
    fn = sor_wrapper(full)
    return (fn.last_cluster, *blocks_ran(fn.last_block_sms))


def check_sor(dev, cfg, n_env, iters, full=False, wrong=None):
    """An SOR slab kernel (``full``: the full-grid one) against its twin:
    one launch per one-slab solve over more than one block per grid, its
    time, its time per half-sweep, the res-18 grid held, and the planted
    stale halo (the library ``wrong``) rejected."""
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.kernels.poisson import ops
    name, lib, source, replaces, solve = SOR_KERNELS[full]
    wrapper = sor_wrapper(full)
    ny, nx = cfg.ny, cfg.nx
    inner, rounds = 4, -(-iters // 4)
    kernel, plain = sor_case(dev, cfg, n_env, iters, 2 if full else 1, full)
    n0 = wrapper.launches
    err = sor_error(kernel, plain)
    per_solve = wrapper.launches - n0
    cluster, blocks, sms_busy = sor_launch(full)
    print(f"[kernels] {name} res {cfg.res} N={n_env} {solve} at iters="
          f"{iters} = {rounds} rounds x {inner} pairs in {per_solve} "
          f"launch(es): max|kernel - plain| {err:.3e} (tol {TOL_SOR:.0e})")
    if not err <= TOL_SOR:
        fail(f"{name} differs from its twin by {err:.3e}")
    if per_solve != 1 or blocks <= n_env:
        fail(f"{solve} took {per_solve} launches of {blocks} blocks for "
             f"{n_env} grids: expected 1, over more than {n_env} blocks")
    ms = cuda_ms(kernel, 20)
    paced_ms = host_paced_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 3)
    # a half-sweep's time: the solve at iters and at 10 (3 rounds), the
    # difference over the rounds' half-sweeps
    few_ms = cuda_ms(lambda: kernel(10), 20)
    sweep_us = 1e3 * (ms - few_ms) / (2 * inner * (rounds - 3))
    active = ops.active_clusters(dev, ny, nx // 2, cluster, full)
    flops = n_env * rounds * inner * ny * nx * FLOP_SOR_POINT
    nbytes = 4 * n_env * ny * nx * 3     # p and rhs read, p written
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    print(f"[kernels] {name}: solve {ms:.4f} ms (1 launch; {paced_ms:.4f} "
          f"ms a call when the host paces the calls), plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.4f} MB); clusters of "
          f"{cluster} blocks, {blocks} blocks ran on {sms_busy} distinct SMs "
          f"({active} such clusters resident at once); at iters=10 "
          f"{few_ms:.4f} ms, so {sweep_us:.4f} us per half-sweep")
    res18 = GridConfig(res=18)
    err18 = sor_error(*sor_case(dev, res18, n_env, iters, 4 if full else 3,
                                full))
    c18 = sor_launch(full)[0]
    print(f"[kernels] {name} res 18 N={n_env} (grid ({res18.ny}, "
          f"{res18.nx}), over one block's shared memory) in clusters of "
          f"{c18}: max|kernel - plain| {err18:.3e} (tol {TOL_SOR:.0e})")
    if not err18 <= TOL_SOR:
        fail(f"{name} at res 18 differs from its twin by {err18:.3e}")
    stale = None
    if wrong is not None:
        with library_swapped(lib, wrong):
            stale = sor_error(kernel, plain)
        print(f"[kernels] wrong kernel, SOR halo rows one half-sweep stale, "
              f"res {cfg.res} N={n_env}: max|kernel - plain| {stale:.3e} "
              f"(tol {TOL_SOR:.0e}; the right kernel {err:.3e})")
        if stale <= TOL_SOR:
            fail(f"TOL_SOR cannot tell a {name} kernel whose halo rows lag "
                 f"one half-sweep from a right one")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library": "no single PyTorch call computes this",
            "host_paced_ms": paced_ms,
            "launches_per_solve": per_solve, "cluster": cluster,
            "blocks": blocks, "sms_busy": sms_busy, "active_clusters": active,
            "ms_at_iters_10": few_ms, "half_sweep_us": sweep_us,
            "res_18_max_abs_err": err18, "res_18_cluster": c18,
            "stale_halo_variant_max_abs_err": stale,
            "shape": f"one {solve} solve: res {cfg.res}, grid ({ny}, {nx}), "
                     f"{n_env} grids, {rounds} rounds"}


def flash_measures(out, ref):
    """(rel-RMS, worst row, max abs) of out against ref, (B, S, H, dh)."""
    d = (out.float() - ref.float()).abs()
    row = d.amax(-1) / ref.float().abs().amax(-1).clamp_min(1e-30)
    return rel_rms(out, ref), float(row.max()), float(d.max())


def flash_held(what, measures, dtype):
    """Print the measures against their limits (TOL_FLASH[dtype], or
    TOL_FLASH_TILED for dtype "tiled"); False if one is over."""
    rel, row, err = measures
    tol_rel, tol_row = (TOL_FLASH_TILED if dtype == "tiled"
                        else TOL_FLASH[dtype])
    print(f"[kernels] flash_attention {what}: rel-RMS {rel:.3e} (tol "
          f"{tol_rel:.0e}), worst row {row:.3e} (tol {tol_row:.0e}), "
          f"max abs {err:.3e}")
    return rel <= tol_rel and row <= tol_row


def flash_case(dev, B, S, H, Hkv, dh, window, seed, dtype="bfloat16"):
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.standard_normal((B, S, h, dh)),
                            dtype=torch.float32, device=dev
                            ).to(getattr(torch, dtype)) for h in (H, Hkv, Hkv))

    def kernel():
        return ops.flash_attention_cuda(q, k, v, causal=True,
                                        sliding_window=window)

    def plain():
        return ops.flash_attention_plain(q, k, v, causal=True,
                                         sliding_window=window)

    ref = plain()
    measures = flash_measures(kernel(), ref)
    if not flash_held(f"{dtype} B={B} S={S} H={H} Hkv={Hkv} dh={dh} causal "
                      f"window={window}, kernel vs plain", measures, dtype):
        fail("flash_attention differs from its twin")
    return measures, (q, k, v), kernel, plain, ref


def flash_wrong_kernels(q, k, v, refs):
    """The held measures must reject two wrong kernels at the path's shape:
    one that maps the query heads to the wrong KV head, one that masks out
    the diagonal key; against each (limits, reference) of ``refs``."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    S = q.shape[1]
    nodiag = ops.causal_mask(S, S, device=q.device) & ~torch.eye(
        S, dtype=torch.bool, device=q.device)[None]
    for what, out in (
            ("KV heads mismapped", ops.flash_attention_plain(
                q, k.roll(1, 2), v.roll(1, 2))),
            ("diagonal key dropped", ops.gqa_attend(q, k, v, nodiag))):
        for limits, ref in refs:
            if flash_held(f"wrong kernel, {what}, vs {limits}",
                          flash_measures(out, ref), limits):
                fail(f"the flash_attention check cannot tell a kernel with "
                     f"the {what} from a right one")


def sass_count(lib, op):
    """How many ``op`` instructions the SASS of a built library holds."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass {lib} exited {sass.returncode}: "
             f"{sass.stderr.strip()}")
    return len(re.findall(rf"\b{op}\b", sass.stdout))


def check_flash(dev, cfg, S):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    hgmma = sass_count(build.library_path("flash_attention"), "HGMMA")
    print(f"[kernels] flash_attention: {hgmma} HGMMA instructions in the "
          f"SASS of {build.library_path('flash_attention').name}")
    if hgmma == 0:
        fail("the flash_attention library holds no HGMMA instruction: the "
             "bf16 kernel is not on the tensor cores")
    # one small sliding-window case, the phi4-mini shape in float32 (the
    # CUDA-core kernel), where only the order of the sums differs, then the
    # path's bf16 (the tensor-core kernel)
    small = flash_case(dev, 2, 256, 4, 2, 64, 96, 3)[0]
    # a head dim the kernels are not built for, zero-padded to 128 by the
    # wrapper (held only)
    padded = flash_case(dev, 1, 1024, 8, 2, 96, 0, 6)[0]
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    fp32, _, fp32_kernel, _, _ = flash_case(dev, 1, S, H, Hkv, dh, 0, 4,
                                            "float32")
    fp32_ms = cuda_ms(fp32_kernel, 3)
    del fp32_kernel
    torch.cuda.empty_cache()
    bf16, (q, k, v), kernel, plain, ref = flash_case(dev, 1, S, H, Hkv, dh,
                                                     0, 4)
    tiled = ops.flash_attention_tiled(q, k, v, causal=True)
    exact = flash_measures(kernel(), tiled)
    if not flash_held(f"bfloat16 B=1 S={S} H={H} Hkv={Hkv} dh={dh} causal, "
                      f"kernel vs tiled", exact, "tiled"):
        fail("flash_attention differs from the tile-exact oracle")
    flash_wrong_kernels(q, k, v, (("bfloat16", ref), ("tiled", tiled)))
    del tiled
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    flops = 2 * H * S * S * dh           # QK^T and PV over the causal half
    nbytes = 2 * S * dh * (2 * H + 2 * Hkv)
    bound_ms, bound_by = bound(nbytes, (flops, BF16_PEAK))
    tflops = flops / ms / 1e9
    print(f"[kernels] flash_attention: kernel {ms:.4f} ms ({tflops:.1f} "
          f"TFLOP/s, {bound_ms / ms:.3f} of the bound), plain twin "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f}"
          f" ms, bound {bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.3f} "
          f"GFLOP bf16, {nbytes / 1e6:.4f} MB); the float32 CUDA-core "
          f"kernel {fp32_ms:.4f} ms")
    return {"name": "flash_attention", "route": "cuda (wgmma, TMA)",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:20",
            "max_abs_err": bf16[2], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bound_share": bound_ms / ms,
            "tflops": tflops, "hgmma_in_sass": hgmma,
            "held_by": {"bf16_rel_rms": bf16[0], "bf16_worst_row": bf16[1],
                        "bf16_vs_tiled_rel_rms": exact[0],
                        "bf16_vs_tiled_worst_row": exact[1],
                        "fp32_rel_rms": fp32[0], "fp32_worst_row": fp32[1],
                        "fp32_max_abs": fp32[2],
                        "small_window_rel_rms": small[0],
                        "bf16_dh_96_rel_rms": padded[0],
                        "bf16_dh_96_worst_row": padded[1]},
            "fp32_kernel": {"route": "cuda (CUDA cores)", "ms": fp32_ms},
            "library": "F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True), timed only",
            "shape": f"{cfg.name}: bf16, B=1, S={S}, H={H}, Hkv={Hkv}, "
                     f"dh={dh}, causal"}


def wkv6_flops(B, S, H, N, C):
    """(products, elementwise): float32 operations of the chunked algebra
    per call.  Per chunk and head the products r~S (2CN^2), the strictly
    lower r~k~^T and its product with v (2 x C(C-1)N) and k~^T v (2CN^2);
    the state update (2N^2) and ~11 elementwise operations per (token,
    channel)."""
    chunks = B * H * (S // C)
    return (chunks * (4 * C * N * N + 2 * C * (C - 1) * N),
            chunks * (11 * C * N + 2 * N * N))


def wkv6_case(dev, cfg, S, B=1, seed=5, N=None, chunk=None):
    """rwkv6 inputs at a layer's shape and decays (or at a head of ``N``),
    bf16, zero state, and the two realizations of a WKV6 call on them (the
    kernel at ``chunk`` tokens a chunk, by default its own)."""
    import numpy as np
    import torch
    from repro_torch.kernels.rwkv6 import ops
    H, N = cfg.num_heads, N or cfg.ssm.head_dim
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.bfloat16):
        return torch.tensor(a, dtype=torch.float32, device=dev).to(dtype)

    r, k, v = (t(rng.standard_normal((B, S, H, N))) for _ in range(3))
    # the layer's decays: exp(-exp(w0 + d)), w0 = -6 (models/ssm.py)
    w = t(np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal((B, S, H, N)))),
          torch.float32)
    u = t(0.1 * rng.standard_normal((H, N)))
    s0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=dev)
    inputs = (r, k, v, w, u, s0)

    def kernel():
        return ops.wkv6_cuda(*inputs, chunk=chunk or ops.CHUNK)

    def plain():
        return ops.wkv6_plain(*inputs)

    return inputs, kernel, plain


def wkv6_errors(what, kernel, plain):
    """max |kernel - twin| of the output and the state, each over its
    scale, printed beside TOL_WKV_OUT and TOL_WKV_STATE; fails if one is
    over.  Returns (out error, its scale, state error, its scale)."""
    (ko, ks), (po, ps) = kernel(), plain()
    scale, s_scale = float(po.float().abs().max()), float(ps.abs().max())
    err = float((ko.float() - po.float()).abs().max())
    s_err = float((ks - ps).abs().max())
    print(f"[kernels] wkv6 {what}: max|kernel - plain| out {err:.3e} (of "
          f"max |out| {scale:.3e}, tol {TOL_WKV_OUT:.0e} of it), state "
          f"{s_err:.3e} (of {s_scale:.3e}, tol {TOL_WKV_STATE:.0e} of it)")
    if not (err <= TOL_WKV_OUT * scale and s_err <= TOL_WKV_STATE * s_scale):
        fail(f"wkv6 {what} differs from its twin: out {err:.3e}, state "
             f"{s_err:.3e}")
    return err, scale, s_err, s_scale


def check_wkv6(dev, cfg, S):
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import ops
    hmma = sass_count(build.library_path("wkv6"), "HMMA")
    print(f"[kernels] wkv6: {hmma} HMMA instructions in the SASS of "
          f"{build.library_path('wkv6').name}")
    if hmma == 0:
        fail("the wkv6 library holds no HMMA instruction: its products are "
             "not on the tensor cores")
    B, H, N = 1, cfg.num_heads, cfg.ssm.head_dim
    # a head the kernel is not built for, zero-padded to 48 by the wrapper,
    # and a chunk of 64 asked for, run at 32 (held only)
    padded = wkv6_errors(f"bf16 B=1 S=1024 H={H} N=40 chunk 64",
                         *wkv6_case(dev, cfg, 1024, N=40, chunk=64)[1:])
    inputs, kernel, plain = wkv6_case(dev, cfg, S, B)
    err, _, s_err, _ = wkv6_errors(f"bf16 B={B} S={S} H={H} N={N}", kernel,
                                   plain)
    blocks, sms_busy = blocks_ran(ops.wkv6_cuda.last_block_sms)
    if blocks <= B * H or blocks != ops.grid_blocks(B, H, N):
        fail(f"wkv6's state pass ran {blocks} blocks: expected "
             f"{ops.grid_blocks(B, H, N)}, more than B*H = {B * H}")
    ms = cuda_ms(kernel, 10)
    call = ops.prepare(*inputs)
    chunk_ms = cuda_ms(lambda: ops.chunk_pass(call), 10)
    state_ms = cuda_ms(lambda: ops.state_pass(call), 10)
    plain_ms = cuda_ms(plain, 1)
    C = ops.pick_chunk(S)
    products, elementwise = wkv6_flops(B, S, H, N, C)
    # r, k, v, w (cast to bf16 by the wrapper) and out in bf16, u, the
    # float32 state in and out; the products run as three TF32 products on
    # the tensor cores (3xTF32), the rest on the CUDA cores
    nbytes = 2 * (5 * B * S * H * N + H * N) + 4 * 2 * B * H * N * N
    bound_ms, bound_by = bound(nbytes, (3 * products, TF32_PEAK),
                               (elementwise, FP32_PEAK))
    print(f"[kernels] wkv6: kernel {ms:.4f} ms (chunk pass {chunk_ms:.4f} "
          f"ms, state pass {state_ms:.4f} ms, {1e3 * state_ms / (S // C):.3f}"
          f" us a link of its chain of {S // C} chunks), plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{products / 1e9:.4f} GFLOP of products, x3 in TF32, "
          f"{elementwise / 1e9:.4f} GFLOP fp32 elementwise, "
          f"{nbytes / 1e6:.4f} MB); a chunk pass of {B * H * (S // C)} "
          f"blocks, then a state pass whose launch recorded {blocks} blocks "
          f"on {sms_busy} distinct SMs (B*H = {B * H}, "
          f"{N // ops.COLUMNS_PER_BLOCK} groups of {ops.COLUMNS_PER_BLOCK} "
          f"state columns a head)")
    return {"name": "wkv6", "route": "cuda (mma.sync 3xTF32)",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:27",
            "max_abs_err": err, "state_max_abs_err": s_err,
            "n_40_chunk_64_errors": {"out": padded[0],
                                     "state": padded[2]}, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library": "no single PyTorch call computes this",
            "chunk_pass_ms": chunk_ms, "state_pass_ms": state_ms,
            "state_pass_blocks": blocks, "state_pass_sms_busy": sms_busy,
            "hmma_in_sass": hmma,
            "shape": f"{cfg.name}: bf16, B={B}, S={S}, H={H}, N={N}, "
                     f"chunk {C}; launches count both passes"}


def wrappers():
    """Each kernel's launching wrapper, by kernel name."""
    from repro_torch.kernels.actuation import ops as aops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.poisson import ops as pops
    from repro_torch.kernels.rwkv6 import ops as wops
    return {"fused_interval": aops.fused_interval_cuda,
            "rb_sor_slabs_packed": pops.rb_sor_slabs_packed_cuda,
            "rb_sor_slabs": pops.rb_sor_slabs_cuda,
            "flash_attention": fops.flash_attention_bf16_cuda,
            "flash_attention_fp32": fops.flash_attention_fp32_cuda,
            "wkv6": wops.wkv6_cuda}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0
    wrappers()["fused_interval"].launches_per_body = 0


def counts():
    """Launches by kernel since reset_counts, the fused kernel's per-body
    instantiation also on its own (``fused_interval_per_body``)."""
    out = {name: fn.launches for name, fn in wrappers().items()}
    out["fused_interval_per_body"] = \
        wrappers()["fused_interval"].launches_per_body
    return out


def run_train(backend, env_kw, episodes, grid_kw, scenarios=None):
    import numpy as np
    import torch
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.drl.train import TrainConfig, train
    cfg = TrainConfig(env=EnvConfig(grid=GridConfig(**grid_kw), **env_kw),
                      n_envs=4, episodes=episodes, seed=0, backend=backend,
                      scenarios=scenarios, device="cuda")
    tag = backend if scenarios is None else f"{backend} {'+'.join(scenarios)}"
    reset_counts()
    (hist, model), secs = wall(lambda: train(
        cfg, log_fn=lambda s: print(f"[train {tag}] {s}")))
    launched = counts()
    for k, v in hist.items():
        if len(v) != episodes or not np.isfinite(v).all():
            fail(f"train({tag}) history {k} = {v}")
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        fail(f"train({tag}) left non-finite params")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train {tag}] {episodes} episodes in {secs:.3f} s, "
          f"{n_params} params finite (act_dim {model.log_std.numel()}), "
          f"rewards {hist['reward'].tolist()}, episode walls "
          f"{hist['wall'].tolist()}, kernel launches {launched}")
    return launched, hist


def leaves(tree):
    """The tensors of a nested dict of parameters."""
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def rel_rms(a, b):
    """RMS of a - b over the RMS of b."""
    a, b = a.float(), b.float()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def hold_layers(cfg, params, tokens):
    """The two backends block by block on the reference's hidden states:
    (worst block-update difference, difference of the last block's logits,
    free-running full-depth logits difference, the logits' RMS), each
    relative to the reference's RMS."""
    import torch
    from repro_torch.models import model
    h_ref = model._embed(cfg, params, tokens)
    h_free = h_ref
    pos = model._positions(cfg, tokens)
    worst = 0.0
    for i in range(cfg.num_layers):
        bp = model.layer(params["blocks"], i)
        k = model._block_body(cfg, h_ref, bp, positions=pos,
                              backend="pallas")
        r = model._block_body(cfg, h_ref, bp, positions=pos,
                              backend="reference")
        worst = max(worst, rel_rms(k - h_ref, r - h_ref))
        h_free = model._block_body(cfg, h_free, bp, positions=pos,
                                   backend="pallas")
        h_ref = r
    logits_r = model._unembed(cfg, params, h_ref)
    if not (bool(torch.isfinite(logits_r).all())
            and logits_r.shape == (*tokens.shape, cfg.vocab_padded)):
        fail(f"{cfg.name}: logits {tuple(logits_r.shape)} not finite or "
             f"not {(*tokens.shape, cfg.vocab_padded)}")
    rms = float(logits_r.float().square().mean().sqrt())
    d_last = rel_rms(model._unembed(cfg, params, k), logits_r)
    d_free = rel_rms(model._unembed(cfg, params, h_free), logits_r)
    return worst, d_last, d_free, rms


def run_lm(dev, name, S, kernel, per_layer=1):
    """lm_loss(backend="pallas") of a full-width config at B=1, S tokens:
    the kernel must launch ``per_layer`` times a layer; logits and loss
    held against backend="reference" on the same params and tokens."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    cfg = get_config(name)
    (params, secs) = wall(lambda: model.init_params(cfg, seed=0,
                                                    device=dev))
    n_params = sum(x.numel() for x in leaves(params))
    rng = np.random.default_rng(7)
    tokens, labels = (torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                                   device=dev) for _ in range(2))
    batch = {"tokens": tokens, "labels": labels}
    print(f"[lm {name}] {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_padded}, {n_params / 1e9:.3f} B params "
          f"({cfg.param_dtype}) drawn on the card in {secs:.3f} s; B=1, "
          f"S={S} (train_4k's length, batch cut from 256 to 1)")
    with torch.inference_mode():
        reset_counts()
        (loss, _), secs = wall(lambda: model.lm_loss(cfg, params, batch,
                                                     backend="pallas"))
        launched = counts()
        _, steady = wall(lambda: model.lm_loss(cfg, params, batch,
                                               backend="pallas"))
        print(f"[lm {name}] lm_loss(backend='pallas') = {float(loss):.6f} "
              f"in {secs:.3f} s (first call), {steady:.3f} s (second call, "
              f"steady), kernel launches {launched}")
        if not math.isfinite(float(loss)):
            fail(f"{name}: lm_loss is {float(loss)}")
        others = sum(n for k, n in launched.items() if k != kernel)
        if launched[kernel] != per_layer * cfg.num_layers or others:
            fail(f"{name}: {launched[kernel]} {kernel} launches in one "
                 f"forward, expected {per_layer * cfg.num_layers}, and "
                 f"{others} of the other kernels, expected 0")
        (ref_loss, _), ref_secs = wall(lambda: model.lm_loss(
            cfg, params, batch, backend="reference"))
        d_loss = abs(float(loss) - float(ref_loss))
        worst, d_last, d_free, rms = hold_layers(cfg, params, tokens)
    print(f"[lm {name}] backend='reference' loss {float(ref_loss):.6f} in "
          f"{ref_secs:.3f} s; pallas vs reference: loss {d_loss:.3e} (tol "
          f"{TOL_LM_LOSS:.0e}); on the reference's input to each layer, the "
          f"block update {worst:.3e} of its RMS at worst, the last block's "
          f"logits {d_last:.3e} of their RMS (tol {TOL_LM_LAYER:.0e}); "
          f"free-running through {cfg.num_layers} layers the logits differ "
          f"by {d_free:.3e} of their RMS {rms:.4f} (reported)")
    if not (d_loss <= TOL_LM_LOSS and worst <= TOL_LM_LAYER
            and d_last <= TOL_LM_LAYER):
        fail(f"{name}: backend 'pallas' disagrees with 'reference'")
    del params
    torch.cuda.empty_cache()
    return launched[kernel], secs, steady


def run_sor_full(dev, cfg, n_env, iters):
    """The drop-in full-grid solve on random right-hand sides: one launch
    per solve (the grid is one slab), a finite result of the grid's shape,
    the residual cut."""
    import numpy as np
    import torch
    from repro_torch.cfd.poisson import residual
    from repro_torch.kernels.poisson import ops
    rng = np.random.default_rng(8)
    rhs = torch.tensor(rng.standard_normal((n_env, cfg.ny, cfg.nx)),
                       dtype=torch.float32, device=dev)
    reset_counts()
    p, secs = wall(lambda: ops.rb_sor(rhs, cfg.dx, cfg.dy, iters=iters,
                                      omega=cfg.poisson_omega,
                                      packed=False))
    launched = counts()["rb_sor_slabs"]
    r0 = float(residual(torch.zeros_like(rhs), rhs, cfg.dx, cfg.dy
                        ).abs().max())
    r1 = float(residual(p, rhs, cfg.dx, cfg.dy).abs().max())
    print(f"[rb_sor full] res {cfg.res}, {n_env} grids, iters={iters}: "
          f"{launched} launches in {secs:.4f} s, max residual {r0:.4e} -> "
          f"{r1:.4e}")
    if ops._pick_nslabs(cfg.nx) != 1 or launched != 1:
        fail(f"rb_sor(packed=False) launched its kernel {launched} times, "
             f"expected 1 on a one-slab grid")
    if not (bool(torch.isfinite(p).all()) and p.shape == rhs.shape
            and r1 < r0):
        fail("rb_sor(packed=False) gave a non-finite, misshapen or "
             "unconverging result")
    return launched


def golden(dev):
    import numpy as np
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.cfd.validation import measure_shedding, run_uncontrolled
    from repro_torch.convert import flow_state_from_numpy
    ref = np.load(ROOT / "tests" / "golden" / "cyl_re100_res8.npz")
    cfg = GridConfig(res=int(ref["res"]), dt=float(ref["dt"]),
                     poisson_iters=int(ref["poisson_iters"]))
    state = flow_state_from_numpy(ref["u"], ref["v"], ref["p"], device=dev)
    reset_counts()
    (_, cds, cls), secs = wall(lambda: run_uncontrolled(
        cfg, state, int(ref["meas_steps"]), backend="fused"))
    launched = counts()
    stats = measure_shedding(cds, cls, cfg.dt)
    print(f"[golden] res 8, {int(ref['meas_steps'])} dt through the fused "
          f"kernel in {secs:.3f} s, launches {launched}")
    if launched["fused_interval"] < 1:
        fail("the golden run did not go through the fused kernel")
    for key, tol in (("strouhal", TOL_ST), ("cd_mean", TOL_CD),
                     ("cl_amp", TOL_AMP)):
        want, got = float(ref[key]), stats[key]
        rel = abs(got - want) / abs(want)
        print(f"[golden] {key}: {got:.6f} vs fixture {want:.6f} "
              f"(rel {rel:.2e}, tol {tol})")
        if not (math.isfinite(got) and rel <= tol):
            fail(f"golden {key} {got} vs {want} outside rel {tol}")


def golden_pinball(dev):
    """The pinball fixture through the card: its 2000-dt window through the
    scalar instantiation (the scalar zero amplitude, as the reference
    measures it) and through the per-body one (a zero (3,) vector at
    act_mode 0, the per-body forces summed), each one launch, each within
    the reference's pinball tolerances."""
    import numpy as np
    import torch
    from repro_torch.cfd import grid, solver
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.cfd.validation import measure_shedding, run_uncontrolled
    from repro_torch.convert import flow_state_from_numpy
    ref = np.load(ROOT / "tests" / "golden" / "pinball_re100_res8.npz")
    cfg = GridConfig(res=int(ref["res"]), dt=float(ref["dt"]),
                     poisson_iters=int(ref["poisson_iters"]))
    state = flow_state_from_numpy(ref["u"], ref["v"], ref["p"], device=dev)
    n = int(ref["meas_steps"])
    ga = solver.geom_to_arrays(grid.build_geometry(cfg, "pinball"), dev)

    def per_body():
        _, outs = solver.step_interval(
            cfg, ga, state, torch.zeros(3, device=dev), n, act_mode=0.0,
            backend="fused")
        return (None, outs.cd.sum(-1).cpu().numpy(),
                outs.cl.sum(-1).cpu().numpy())

    routes = {"scalar": (lambda: run_uncontrolled(
        cfg, state, n, backend="fused", geometry="pinball"), 0),
              "per_body": (per_body, grid.max_bodies())}
    for name, (run, n_bodies) in routes.items():
        reset_counts()
        (_, cds, cls), secs = wall(run)
        launched = counts()
        from repro_torch.kernels.actuation import ops
        print(f"[golden pinball {name}] res 8, {n} dt through the fused "
              f"kernel in {secs:.3f} s, launches {launched}")
        if (launched["fused_interval"] != 1
                or ops.fused_interval_cuda.last_n_bodies != n_bodies):
            fail(f"the pinball golden run ({name}) did not go through the "
                 f"fused kernel's instantiation for {n_bodies} bodies")
        stats = measure_shedding(cds, cls, cfg.dt)
        for key, tol in TOL_PINBALL.items():
            want, got = float(ref[key]), stats[key]
            rel = abs(got - want) / abs(want)
            print(f"[golden pinball {name}] {key}: {got:.6f} vs fixture "
                  f"{want:.6f} (rel {rel:.2e}, tol {tol})")
            if not (math.isfinite(got) and rel <= tol):
                fail(f"pinball golden ({name}) {key} {got} vs {want} "
                     f"outside rel {tol}")


@contextlib.contextmanager
def observed(module, name, before=None, after=None):
    """Wrap ``module.name`` for the duration: ``before(*args)`` sees each
    call's arguments, ``after(out)`` its result; the call itself is
    unchanged (the phase reads what the path computed, it alters
    nothing)."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        if before is not None:
            before(*args)
        out = fn(*args, **kw)
        if after is not None:
            after(out)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def robust_path(mlp_episode_s):
    """Phase 7: the attention policy and the robust training path on the
    card, at full width, every run under torch.use_deterministic_algorithms
    (an op without a deterministic implementation raises).  Returns the
    per-body instantiation's launches over the phase's runs."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.drl import engine as engine_mod
    from repro_torch.drl import ppo, rollout
    from repro_torch.drl import train_state as ts_mod
    from repro_torch.drl.train import TrainConfig, train
    from repro_torch.testing import faults
    scenarios = ("cyl_re100", "pinball_re100")
    intervals, groups = 100, 2
    base = ROOT / "build" / "robust_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    print("[robust] full width: res 16, 50 dt per action, 60 SOR "
          "iterations, 4 envs of cyl_re100+pinball_re100 (149 probes, the "
          "pinball's 59 padded; act_dim 3), attention policy d_model 64, 4 "
          "heads over 2 KV heads, 2 layers; 100 actions per episode after a "
          "30 t.u. warmup per group; deterministic algorithms on")
    per_body_launches = 0

    def run(tag, episodes, ckpt=None, fault=None, policy="attention", **kw):
        nonlocal per_body_launches
        cfg = TrainConfig(
            env=EnvConfig(grid=GridConfig(res=16), steps_per_action=50,
                          actions_per_episode=intervals, warmup_time=30.0),
            n_envs=4, episodes=episodes, seed=0, scenarios=scenarios,
            policy=policy, backend="fused", device="cuda",
            ckpt_dir=None if ckpt is None else str(base / ckpt),
            ckpt_every=1, **kw)
        health = {}
        faults.configure(fault)
        reset_counts()
        try:
            (hist, model), secs = wall(lambda: train(
                cfg, log_fn=lambda m: print(f"[robust {tag}] {m}"),
                health=health))
        finally:
            faults.reset()
        launched = counts()
        per_body_launches += launched["fused_interval_per_body"]
        print(f"[robust {tag}] to episode {episodes} in {secs:.3f} s, episode "
              f"walls {hist['wall'].tolist()}, health {health}, fused "
              f"launches {launched['fused_interval']} (per-body "
              f"{launched['fused_interval_per_body']})")
        for k, v in hist.items():
            if len(v) != episodes or not np.isfinite(v).all():
                fail(f"robust {tag}: history {k} = {v}")
        return hist, model, health, launched

    def expect_launches(tag, launched, episodes, warmups):
        want = (episodes * intervals + warmups, episodes * intervals)
        got = (launched["fused_interval"], launched["fused_interval_per_body"])
        if got != want:
            fail(f"robust {tag}: fused launches (all, per-body) {got}, "
                 f"expected {want}: one per-body launch per interval and "
                 f"{warmups} scalar warmup launches")

    def same_model(tag, a, b):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            if not torch.equal(x, y):
                fail(f"robust {tag}: param {k} differs from the "
                     f"uninterrupted run")

    def same_hist(tag, a, b, n=None):
        for f in ("reward", "cd", "cl", "quarantines", "grad_skips"):
            if not np.array_equal(a[f][:n], b[f][:n]):
                fail(f"robust {tag}: history {f} {b[f]} differs from the "
                     f"uninterrupted run's {a[f]}")

    finals = []

    def final_flow(out):
        finals.append([x.clone() for x in out[0].flow])

    def split_run(tag, episodes, ckpt=None, **kw):
        """run() with each episode's rollout (policy + env steps) and PPO
        update timed on the host clock between synchronisations."""
        split = {"rollout": [], "update": []}
        t0 = [0.0]

        def start(*_):
            torch.cuda.synchronize()
            t0[0] = time.perf_counter()

        def stop(key):
            def after(out):
                torch.cuda.synchronize()
                split[key].append(time.perf_counter() - t0[0])
                if key == "rollout":
                    final_flow(out)
            return after

        with observed(rollout, "rollout_batch", start, stop("rollout")), \
                observed(engine_mod, "ppo_update", start, stop("update")):
            out = run(tag, episodes, ckpt, **kw)
        rest = [float(w - r - u) for w, r, u in zip(out[0]["wall"],
                                             split["rollout"],
                                             split["update"])]
        print(f"[robust {tag}] per episode: rollout {split['rollout']} s, "
              f"PPO update {split['update']} s, the rest (values, GAE, "
              f"history, checkpoint) {rest} s")
        return out

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        # (a) the uninterrupted run, its first episode's final fields kept
        hist_a, model_a, health_a, launched = split_run("a", 2, "A")
        expect_launches("a", launched, 2, groups)
        clean_final = finals[0]
        if not all(torch.isfinite(x).all() for x in clean_final):
            fail("robust a: non-finite fields after the first episode")
        path = ck.latest_checkpoint(str(base / "A"))
        ckpt_bytes = Path(path).stat().st_size
        print(f"[robust a] checkpoint {path}: {ckpt_bytes} bytes; "
              f"{health_a['ckpt_saves']} saves, "
              f"{health_a['ckpt_bytes']} bytes written, time_blocked "
              f"{health_a['ckpt_time_blocked']:.6f} s in all "
              f"({health_a['ckpt_time_waited']:.6f} s of it waiting for the "
              f"previous write), "
              f"{health_a['ckpt_time_blocked'] / health_a['ckpt_saves']:.6f} "
              f"s a save")
        print(f"[robust] attention episode {hist_a['wall'][-1]:.3f} s "
              f"(steady, the second), MLP episode {mlp_episode_s:.3f} s "
              f"(phase 2, the second)")

        # 1 episode, then a resume to 2: bit-equal, no warmup on resume
        _, _, _, launched = run("b1", 1, "B")
        expect_launches("b1", launched, 1, groups)
        hist_b, model_b, _, launched = run("resume", 2, "B", resume=True)
        expect_launches("resume", launched, 1, 0)
        same_model("resume", model_a, model_b)
        same_hist("resume", hist_a, hist_b)
        ts_a, _ = ts_mod.load_train_state(path, "cuda")
        ts_b, _ = ts_mod.load_train_state(
            ck.latest_checkpoint(str(base / "B")), "cuda")
        if not torch.equal(ts_a.rng, ts_b.rng) or ts_a.step != ts_b.step:
            fail("robust resume: generator state or PPO step differs")
        for k in ("m", "v"):
            if not all(torch.equal(x, y) for x, y in
                       zip(ts_a.opt_state[k], ts_b.opt_state[k])):
                fail(f"robust resume: Adam {k} differs")
        print("[robust resume] params, Adam m/v, generator state, step "
              f"{ts_b.step} and history equal to the uninterrupted run's, "
              "bit for bit")

        # (b) NaN in env 1's u at step 4: one quarantine, the other envs'
        # final fields those of (a)'s first episode
        finals.clear()
        with observed(rollout, "rollout_batch", after=final_flow):
            hist, _, health, launched = run(
                "nan_env", 1, fault={"nan_env": {"env": 1, "step": 4}})
        expect_launches("nan_env", launched, 1, groups)
        if hist["quarantines"].tolist() != [1.0] or \
                health["quarantines"] != 1:
            fail(f"robust nan_env: quarantines {hist['quarantines']}, "
                 f"expected exactly 1")
        keep = [0, 2, 3]
        for x, y in zip(finals[0], clean_final):
            if not torch.equal(x[keep], y[keep]):
                fail("robust nan_env: the unpoisoned envs' final fields "
                     "differ from the clean run's")
        if not all(torch.isfinite(x).all() for x in finals[0]):
            fail("robust nan_env: non-finite fields after the quarantine")
        print("[robust nan_env] 1 quarantine; envs 0, 2, 3 final u, v, p "
              "equal to the clean run's first episode, bit for bit")

        # (c) a NaN gradient at PPO step 7: skipped, params unchanged across
        # that minibatch (and changed across the next)
        snaps, calls = {}, [0]

        def at_minibatch(cfg, model, batch):
            if calls[0] in (7, 8, 9):
                snaps[calls[0]] = [q.detach().clone()
                                   for q in model.parameters()]
            calls[0] += 1

        with observed(ppo, "ppo_loss", before=at_minibatch):
            hist, _, health, launched = run(
                "grad_nan", 1, fault={"grad_nan": {"step": 7}})
        expect_launches("grad_nan", launched, 1, groups)
        if hist["grad_skips"].tolist() != [1.0] or health["grad_skips"] != 1:
            fail(f"robust grad_nan: grad_skips {hist['grad_skips']}, "
                 f"expected 1")
        if not all(torch.equal(x, y) for x, y in zip(snaps[7], snaps[8])):
            fail("robust grad_nan: the skipped minibatch changed params")
        if all(torch.equal(x, y) for x, y in zip(snaps[8], snaps[9])):
            fail("robust grad_nan: the next minibatch left params unchanged")
        print("[robust grad_nan] 1 update skipped; params equal before and "
              "after minibatch 7, changed by minibatch 8")

        # (d) the watchdog trips at episode 1: one rollback to the episode-1
        # checkpoint, then the run completes as (a)
        hist, model, health, launched = run(
            "watchdog", 2, "D", fault={"watchdog": {"episode": 1}})
        expect_launches("watchdog", launched, 3, groups)
        if health["rollbacks"] != 1:
            fail(f"robust watchdog: {health['rollbacks']} rollbacks, "
                 f"expected 1")
        same_model("watchdog", model_a, model)
        same_hist("watchdog", hist_a, hist)
        print("[robust watchdog] 1 rollback; completed equal to the "
              "uninterrupted run, bit for bit")

        # where an episode's time goes: the MLP on the same batch under the
        # same instrumentation, and the attention policy without
        # deterministic algorithms
        hist, _, _, _ = split_run("mlp", 2, policy="mlp")
        torch.use_deterministic_algorithms(False)
        hist_n, model_n, _, _ = split_run("nondeterministic", 2)
        same = all(torch.equal(x, y) for x, y in
                   zip(model_a.parameters(), model_n.parameters()))
        print(f"[robust] steady episode: attention {hist_a['wall'][-1]:.3f} s"
              f", MLP {hist['wall'][-1]:.3f} s (both deterministic), "
              f"attention without deterministic algorithms "
              f"{hist_n['wall'][-1]:.3f} s (params "
              f"{'equal' if same else 'not equal'} to the deterministic "
              f"run's)")
    finally:
        torch.use_deterministic_algorithms(prev)
        shutil.rmtree(base, ignore_errors=True)
    return per_body_launches


def io_path(card):
    """Phase 8: the paper's I/O layer on the card at the main path's width.
    (a) ``train()`` recording into a dataset sink; (b) ``replay_sync`` of
    that dataset from the seed, bit-equal to the live run under
    deterministic algorithms and launching no fused kernel; (c) a
    truncated and a byte-flipped copy refused; (d) the CFD<->DRL file
    interface in each mode on the second episode's batch, then an episode
    of ``train(interface=..., sink=...)`` spilling to a binary file.
    Returns the fused kernel's launches while recording."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.core.interface import MultiEnvInterface
    from repro_torch.data.trajectory_dataset import (DatasetError,
                                                     TrajectoryReader)
    from repro_torch.drl import engine as engine_mod
    from repro_torch.drl import networks
    from repro_torch.drl import train_state as ts_mod
    from repro_torch.drl.train import TrainConfig, train
    base = ROOT / "build" / "io_path"
    shutil.rmtree(base, ignore_errors=True)
    intervals, episodes = 100, 2
    env_cfg = EnvConfig(grid=GridConfig(res=16), steps_per_action=50,
                        actions_per_episode=intervals, warmup_time=30.0)
    print(f"[io] full width: res 16 (ny 66, nx 352), 50 dt per action, 60 "
          f"SOR iterations, 2x512 MLP, 149 probes, 4 envs, "
          f"backend='fused'; depth cut: {episodes} episodes of {intervals} "
          f"actions after a 30 t.u. warmup; deterministic algorithms on; "
          f"card {card}")

    def cfg_for(n, **kw):
        return TrainConfig(env=env_cfg, n_envs=4, episodes=n, seed=0,
                           backend="fused", device="cuda", **kw)

    def same(what, a, b):
        if not torch.equal(a, b):
            fail(f"io replay: {what} differs from the live run")

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        # (a) record
        built, batches = [], []
        cfg = cfg_for(episodes,
                      sink=engine_mod.SinkSpec(kind="dataset",
                                               root=str(base / "ds")),
                      ckpt_dir=str(base / "ck"), ckpt_every=episodes)
        reset_counts()
        with observed(engine_mod.SinkSpec, "build", after=built.append), \
                observed(engine_mod, "ppo_update",
                         before=lambda *a: batches.append(a[4])):
            (hist, model), secs = wall(lambda: train(
                cfg, log_fn=lambda m: print(f"[io record] {m}")))
        launched = counts()["fused_interval"]
        sink = built[0]
        per_ep = sink.bytes_written / sink.episodes
        print(f"[io record] train() with a dataset sink: {episodes} episodes "
              f"in {secs:.3f} s, episode walls {hist['wall'].tolist()}, "
              f"fused launches {launched}; dataset appends: "
              f"{sink.bytes_written} bytes in {sink.episodes} records "
              f"({per_ep:.0f} bytes a record), {sink.time_spent:.6f} s "
              f"caller-visible ({sink.time_spent / sink.episodes:.6f} s an "
              f"episode: the copy to the host, pack, write, fsync, "
              f"manifest), {sink.retries} retries")
        if launched != episodes * intervals + 1:
            fail(f"io record: the fused kernel launched {launched} times, "
                 f"expected {episodes * intervals + 1} (one per interval "
                 f"and the warmup's)")
        reader = TrajectoryReader(str(base / "ds"))
        if reader.episodes != list(range(episodes)):
            fail(f"io record: the dataset holds episodes {reader.episodes}")
        want_meta = json.loads(json.dumps(ts_mod.run_metadata(
            n_envs=4, obs_dim=149, seed=0, grid=env_cfg.grid,
            horizon=intervals, steps_per_action=env_cfg.steps_per_action,
            scenarios=None,
            policy={"policy": "mlp", "obs_dim": 149, "act_dim": 1}),
            default=str))
        if reader.metadata != want_meta:
            fail(f"io record: the manifest's metadata {reader.metadata} is "
                 f"not the run fingerprint {want_meta}")
        live, _ = ts_mod.load_train_state(
            ck.latest_checkpoint(str(base / "ck")), "cuda")

        # (b) replay from the seed, through the same update
        meta = reader.metadata
        engine = engine_mod.RolloutEngine(None, engine_mod.EngineConfig(
            n_envs=meta["n_envs"], horizon=meta["horizon"],
            gamma=cfg.ppo.gamma, lam=cfg.ppo.lam, timing=True))
        pcfg = networks.PolicyConfig(obs_dim=meta["obs_dim"],
                                     act_dim=meta["policy"]["act_dim"])
        rmodel, optimizer, opt_state, gen = engine.init(
            pcfg, cfg.ppo, meta["seed"], "cuda")
        steps = []
        reset_counts()
        (rmodel, opt_state, returns), rsecs = wall(lambda: engine.replay_sync(
            reader, rmodel, opt_state, cfg.ppo, optimizer, len(reader),
            generator=gen, on_state=lambda c: steps.append(c.step)))
        if counts()["fused_interval"] != 0:
            fail("io replay launched the fused kernel")
        for (k, a), b in zip(rmodel.state_dict().items(),
                             model.state_dict().values()):
            same(f"param {k}", a, b)
        for k in ("m", "v"):
            for a, b in zip(opt_state[k], live.opt_state[k]):
                same(f"Adam {k}", a, b)
        same("the generator state", gen.get_state(), live.rng)
        if steps[-1] != live.step:
            fail(f"io replay: PPO step {steps[-1]}, live {live.step}")
        if not np.array_equal(returns, hist["reward"]):
            fail(f"io replay: returns {returns} != live {hist['reward']}")
        print(f"[io replay] replay_sync of {len(reader)} episodes in "
              f"{rsecs:.3f} s (PPO update {engine.stats['update_s']:.3f} s "
              f"of it), no fused launch; params, Adam m/v, PPO step "
              f"{steps[-1]}, generator state and returns {returns.tolist()} "
              f"equal to the live run's, bit for bit")

        # (c) damaged copies are refused, never replayed
        shard = sorted((base / "ds").glob("shard_*.bin"))[-1]
        cut = base / "truncated"
        shutil.copytree(base / "ds", cut)
        with open(cut / shard.name, "r+b") as f:
            f.truncate(shard.stat().st_size - 8)
        flip = base / "flipped"
        shutil.copytree(base / "ds", flip)
        rec = json.loads((flip / "manifest.json").read_text())["episodes"]["1"]
        with open(flip / rec["shard"], "r+b") as f:
            f.seek(rec["offset"] + 8 + rec["length"] // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        for what, root, match in (("truncated", cut, "truncated shard"),
                                  ("flipped", flip, "crc32 mismatch")):
            try:
                engine.replay_sync(TrajectoryReader(str(root)), rmodel,
                                   opt_state, cfg.ppo, optimizer, 2,
                                   generator=gen, start=1 if what ==
                                   "flipped" else 0)
            except DatasetError as e:
                if match not in str(e):
                    fail(f"io {what}: refused with {e}, expected "
                         f"{match!r}")
                print(f"[io durability] {what} copy refused: {e}")
            else:
                fail(f"io {what}: the damaged dataset replayed")
    finally:
        torch.use_deterministic_algorithms(prev)

    # (d) the paper's interface on the second episode's PPO batch
    batch = batches[-1]
    for mode in ("file_baseline", "optimized", "disabled"):
        iface = MultiEnvInterface(mode, str(base / "iface" / mode), 4)
        _, secs = wall(lambda: iface.exchange(batch))
        obs = batch.obs.cpu().numpy().reshape(4, intervals, -1)
        acts = batch.act.cpu().numpy().reshape(4, -1)
        for i, fi in enumerate(iface.envs if mode != "disabled" else ()):
            back = fi.read_actuation(0)
            # the ASCII dump prints 10 significant digits (float32 needs 9)
            # and the config text the action to 8 decimals; binary is exact
            want = obs[i].ravel().astype(np.float64)
            act = float(acts[i, 0])
            if mode == "file_baseline":
                ok = np.allclose(back.obs, want, rtol=1e-9, atol=0.0)
                act = float(f"{act:.8f}")
            else:
                ok = np.array_equal(back.obs, obs[i].ravel())
            if not ok:
                fail(f"io interface {mode}: env {i}'s probes did not read "
                     f"back")
            if back.action != act:
                fail(f"io interface {mode}: env {i}'s action read back "
                     f"{back.action}, wrote {act}")
        print(f"[io interface {mode}] {iface.bytes_moved} bytes per exchange "
              f"({iface.bytes_moved / 4:.0f} per env), {secs:.6f} s host "
              f"per exchange (timed {iface.time_spent:.6f} s inside), every "
              f"record read back; card {card}")
        iface.cleanup()

    fsink = engine_mod.SinkSpec(kind="binary",
                                root=str(base / "spill")).build()
    iface = MultiEnvInterface("optimized", str(base / "iface" / "train"), 4)
    trajs = []
    reset_counts()
    (hist, _), secs = wall(lambda: train(
        cfg_for(1), log_fn=lambda m: print(f"[io train] {m}"),
        interface=iface, sink=fsink,
        on_episode=lambda traj, m: trajs.append(traj)))
    launched = counts()["fused_interval"]
    if launched != intervals + 1 or iface.period != 1:
        fail(f"io train: {launched} fused launches, {iface.period} "
             f"exchanges")
    back = fsink.read(0)
    for f, a, b in zip(back._fields, trajs[0], back):
        if (a is None) != (b is None) or (
                a is not None and not np.array_equal(a.cpu().numpy(), b)):
            fail(f"io train: the binary file's {f} differs from the "
                 f"episode's trajectory")
    print(f"[io train] 1 episode in {secs:.3f} s with the optimized "
          f"interface ({iface.bytes_moved} bytes, {iface.time_spent:.6f} s) "
          f"and a binary sink: {fsink.bytes_written} bytes, "
          f"{fsink.time_spent:.6f} s caller-visible; the file reads back "
          f"equal to the episode's trajectory; fused launches {launched}; "
          f"card {card}")
    shutil.rmtree(base, ignore_errors=True)
    return dict(io_path_launches=episodes * intervals + 1,
                io_path=("train(sink=SinkSpec(kind='dataset')), warmup + 2 "
                         "episodes; replay_sync launches none"),
                io_record_bytes=per_ep, io_replay_s=rsecs)


def main():
    sys.path.insert(0, str(ROOT / "src"))
    import os
    # cuBLAS is repeatable under torch.use_deterministic_algorithms (phase
    # 7) only with a fixed workspace, set before its first handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    stale_halo_jobs = start_stale_halo_build()
    _, secs = wall(lambda: build.build(verbose=True))
    print(f"[build] {len(build.SOURCES)} kernels built in {secs:.2f} s -> "
          f"{build.BUILD_DIR}")
    stale_halo = stale_halo_libraries(stale_halo_jobs)
    dev = torch.device("cuda")

    # 1. each kernel against its plain twin at the training shape
    res16 = GridConfig(res=16)
    fused = check_fused(dev, res16, n_env=4, n_steps=50)
    short = hold_fused(dev, res16, n_env=4, n_steps=1)[0]
    fused["stale_halo_variant"] = stale_halo_rejected(
        dev, stale_halo["fused_interval"], res16, 4,
        ((50, fused["errors"]), (1, short)))
    fused["envs_32"] = fused_batch_reading(dev, res16, n_env=32, n_steps=50)
    fused["res_18_max_abs_err"] = max(hold_fused(
        dev, GridConfig(res=18), n_env=4, n_steps=10)[0].values())
    bodies = check_fused_bodies(dev, res16, n_env=4, n_steps=50,
                                scalar_ms=fused["ms"])
    bodies_short = hold_fused(dev, res16, 4, 1, bank_case,
                              " per-body (mixed bank)")[0]
    bodies["stale_halo_variant"] = stale_halo_rejected(
        dev, stale_halo["fused_interval"], res16, 4,
        ((50, bodies["errors"]), (1, bodies_short)), bank_case,
        " per-body (mixed bank)")
    fused["per_body"] = bodies
    sor = check_sor(dev, res16, n_env=4, iters=50,
                    wrong=stale_halo["poisson_sor"])
    sor_full = check_sor(dev, res16, n_env=4, iters=50, full=True,
                         wrong=stale_halo["poisson_sor_full"])
    flash = check_flash(dev, get_config("phi4-mini-3.8b"), S=4096)
    wkv = check_wkv6(dev, get_config("rwkv6-3b"), S=4096)

    # 2. the main path: training at full width, depth cut to 2 episodes
    main_env = dict(steps_per_action=50, actions_per_episode=100,
                    warmup_time=30.0)
    print("[train fused] full width: res 16 (ny 66, nx 352), 50 dt per "
          "action, 60 SOR iterations, 2x512 MLP, 149 probes, 4 envs; depth "
          "cut: 2 episodes of 100 actions after a 30 t.u. warmup")
    launched, main_hist = run_train("fused", main_env, 2, dict(res=16))
    if launched["fused_interval"] < 1:
        fail("the main path did not launch the fused_interval kernel")
    fused["launches"] = launched["fused_interval"]
    fused["path"] = "train(backend='fused'), warmup + 2 episodes"

    # the multi-body path: a mixed cylinder + pinball batch, per-body
    # actuation through the per-body instantiation
    scenarios = ("cyl_re100", "pinball_re100")
    print("[train fused cyl_re100+pinball_re100] full width: res 16, 50 dt "
          "per action, 60 SOR iterations, 2x512 MLP, 149 probes (the "
          "pinball's 59 padded), act_dim 3, 4 envs (2 cylinder jets, 2 "
          "pinball rotary); depth cut: 1 episode of 100 actions after a "
          "30 t.u. warmup per (Re, actuation, geometry) group")
    launched, _ = run_train("fused", main_env, 1, dict(res=16), scenarios)
    intervals = main_env["actions_per_episode"]
    groups = 2                    # (100, jets, cylinder), (100, rotary, pinball)
    if (launched["fused_interval_per_body"] != intervals
            or launched["fused_interval"] != intervals + groups):
        fail(f"the multi-body path launched the per-body instantiation "
             f"{launched['fused_interval_per_body']} times (expected one "
             f"per interval, {intervals}) and the fused kernel "
             f"{launched['fused_interval']} times in all (expected "
             f"{intervals + groups}: the warmups' {groups} scalar launches)")
    bodies["launches"] = launched["fused_interval_per_body"]
    bodies["path"] = ("train(scenarios=('cyl_re100', 'pinball_re100'), "
                      "backend='fused'), warmup + 1 episode")

    # 3. the second path: one short episode with the packed-SOR kernel
    print("[train pallas] res 16, 4 envs; depth cut: 1 episode of 2 actions "
          "after a 1 t.u. warmup")
    launched, _ = run_train("pallas", dict(steps_per_action=50,
                                        actions_per_episode=2,
                                        warmup_time=1.0), 1, dict(res=16))
    if launched["rb_sor_slabs_packed"] < 1:
        fail("the pallas path did not launch the rb_sor_slabs_packed kernel")
    # one pressure solve per dt: the 1 t.u. warmup's dt and 2 actions' 50
    solves = max(1, round(1.0 / GridConfig(res=16).dt)) + 2 * 50
    print(f"[train pallas] {launched['rb_sor_slabs_packed']} packed-SOR "
          f"launches for the path's {solves} pressure solves")
    if launched["rb_sor_slabs_packed"] != solves:
        fail(f"the pallas path launched rb_sor_slabs_packed "
             f"{launched['rb_sor_slabs_packed']} times, expected one per "
             f"solve ({solves})")
    sor["launches"] = launched["rb_sor_slabs_packed"]
    sor["path"] = "train(backend='pallas'), warmup + 1 episode"

    # 4. the language-model loss paths at full width
    flash["launches"], flash["lm_first_s"], flash["lm_steady_s"] = run_lm(
        dev, "phi4-mini-3.8b", 4096, "flash_attention")
    flash["path"] = "lm_loss(phi4-mini-3.8b, backend='pallas'), B=1, S=4096"
    wkv["launches"], wkv["lm_first_s"], wkv["lm_steady_s"] = run_lm(
        dev, "rwkv6-3b", 4096, "wkv6", per_layer=2)
    wkv["path"] = "lm_loss(rwkv6-3b, backend='pallas'), B=1, S=4096"

    # 5. the full-grid drop-in solve
    sor_full["launches"] = run_sor_full(dev, res16, n_env=4, iters=50)
    sor_full["path"] = "rb_sor(packed=False), res 16, 4 grids, iters=50"

    # 6. golden physics through the fused kernel
    golden(dev)
    golden_pinball(dev)

    # 7. the attention policy and the robust training path
    bodies["robust_path_launches"] = robust_path(float(main_hist["wall"][-1]))
    bodies["robust_path"] = (
        "train(policy='attention', scenarios=('cyl_re100', 'pinball_re100'),"
        " ckpt_dir=..., resume=..., watchdog=True): 2 + 1 + resumed 1 + "
        "nan_env 1 + grad_nan 1 + watchdog 3 episodes, then 2 of the MLP "
        "and 2 without deterministic algorithms")
    if bodies["robust_path_launches"] < 1:
        fail("the robust path did not launch the per-body instantiation")

    # 8. the I/O path: record, replay, durability, the file interface
    fused.update(io_path(card))

    # 9. the kernels, the card, the result
    print(json.dumps({"kernels": [fused, sor, sor_full, flash, wkv]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
