"""On-card smoke run of the PyTorch/CUDA port (src/repro_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); builds the hand-written
kernels from src/repro_torch/kernels/csrc into build/repro_torch_kernels/.
Phases (any failure exits non-zero):

1. kernel checks: each kernel against its plain PyTorch twin on the card at
   the training shape (res 16, 4 envs), with the stated tolerance, timed
   with CUDA events;
2. the main path: ``train()`` on the card at full width (res 16, 50 dt per
   action, 60 SOR iterations, 2x512 MLP, 149 probes, 4 envs,
   backend="fused"), depth cut to 2 episodes; the fused kernel must run;
3. the second path: one short episode with backend="pallas"; the
   packed-SOR kernel must run;
4. golden physics through the fused kernel: the res-8 fixture's Strouhal
   number, mean C_D and C_L amplitude within the reference's tolerances;
5. one JSON line listing both kernels, then the card's line and the result.

Imports nothing of jax or of the reference package.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# golden tolerances, the reference's (tests/test_golden_physics.py)
TOL_ST, TOL_CD, TOL_AMP = 0.015, 0.01, 0.05
# kernel vs twin: the kernel contracts a*b+c into FMAs and sums forces in
# another order than the twin's op-by-op float32; over 50 dt x 60 SOR pairs
# that stays well inside these (u, v are O(1), p and C_D O(5))
TOL_FUSED = {"u": 1e-4, "v": 1e-4, "p": 1e-3, "cd": 1e-3, "cl": 1e-3}
TOL_SOR = 1e-5                 # 52 pairs on unit-variance planes
FP32_PEAK = 67e12              # H100 SXM, FLOP/s outside the tensor cores
HBM_RATE = 3.35e12             # bytes/s
# float32 operations per point, counted from the kernels' source
FLOP_SOR_POINT = 10            # one point of one half-sweep
FLOP_MOMENTUM_POINT = 51       # predictor + penalization + force, per face
FLOP_RHS_POINT = 6             # divergence / dt
FLOP_CORRECT_POINT = 4         # projection correction, per face


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps):
    import torch
    fn()                                  # warm-up
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


def bound(flops, nbytes):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def check_fused(dev, cfg, n_env, n_steps):
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
    jet = torch.tensor([0.3, -0.5, 0.0, 1.0][:n_env], device=dev)
    mode = torch.tensor([0.0, 0.0, 1.0, 1.0][:n_env], device=dev)

    def kernel():
        return ops.fused_interval_cuda(cfg, ga, flow, jet, n_steps,
                                       act_mode=mode)

    def plain():
        return ops.fused_interval_plain(cfg, ga, flow, jet, n_steps,
                                        act_mode=mode)

    (ka, ko), (pa, po) = kernel(), plain()
    torch.cuda.synchronize()
    errs = {n: float((x - y).abs().max())
            for n, x, y in zip("uvp", ka, pa)}
    errs["cd"] = float((ko.cd - po.cd).abs().max())
    errs["cl"] = float((ko.cl - po.cl).abs().max())
    print(f"[kernels] fused_interval res {cfg.res} N={n_env} "
          f"{n_steps} dt: max|kernel - plain| " + ", ".join(
              f"{k} {v:.3e} (tol {TOL_FUSED[k]:.0e})"
              for k, v in errs.items()))
    for k, v in errs.items():
        if not v <= TOL_FUSED[k]:
            fail(f"fused_interval {k} differs from its twin by {v:.3e}")
    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, 2)
    ny, nx = cfg.ny, cfg.nx
    nu, nv, npts = ny * (nx + 1), (ny + 1) * nx, ny * nx
    flops = n_env * n_steps * (
        cfg.poisson_iters * npts * FLOP_SOR_POINT
        + (nu + nv) * FLOP_MOMENTUM_POINT + npts * FLOP_RHS_POINT
        + (nu + nv) * FLOP_CORRECT_POINT)
    nbytes = 4 * (2 * n_env * (nu + nv + npts) + 6 * nu + 6 * nv + ny
                  + 3 * n_env + 2 * n_env * n_steps)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[kernels] fused_interval: kernel {ms:.4f} ms, plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB)")
    return {"name": "fused_interval", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_interval.cu",
            "replaces": "src/repro/kernels/actuation/kernel.py:39",
            "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library": "no single PyTorch call computes this",
            "shape": f"res {cfg.res} (ny {ny}, nx {nx}), {n_env} envs, "
                     f"{n_steps} dt, {cfg.poisson_iters} SOR pairs per dt"}


def check_sor(dev, cfg, n_env, iters):
    import numpy as np
    import torch
    from repro_torch.kernels.poisson import ops
    rng = np.random.default_rng(1)
    ny, w = cfg.ny, cfg.nx // 2
    planes = [torch.tensor(rng.standard_normal((n_env, ny, w)),
                           dtype=torch.float32, device=dev)
              for _ in range(4)]
    inner, nslabs = 4, ops._pick_nslabs(cfg.nx)
    rounds = -(-iters // inner)

    def kernel():
        return ops.rb_sor_planes(*planes, cfg.dx, cfg.dy, iters=iters,
                                 omega=cfg.poisson_omega)

    def plain():
        red, black = planes[:2]
        for _ in range(rounds):
            red, black = ops.rb_sor_slabs_packed_plain(
                red, black, *planes[2:], dx=cfg.dx, dy=cfg.dy,
                omega=cfg.poisson_omega, nslabs=nslabs, inner_iters=inner)
        return red, black

    ka, pa = kernel(), plain()
    torch.cuda.synchronize()
    err = max(float((x - y).abs().max()) for x, y in zip(ka, pa))
    print(f"[kernels] rb_sor_slabs_packed res {cfg.res} N={n_env} "
          f"rb_sor_planes(iters={iters}) = {rounds} rounds x {inner} pairs:"
          f" max|kernel - plain| {err:.3e} (tol {TOL_SOR:.0e})")
    if not err <= TOL_SOR:
        fail(f"rb_sor_slabs_packed differs from its twin by {err:.3e}")
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 3)
    flops = n_env * rounds * inner * ny * cfg.nx * FLOP_SOR_POINT
    nbytes = 4 * n_env * ny * w * (4 + 2)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[kernels] rb_sor_slabs_packed: solve {ms:.4f} ms ({rounds} "
          f"launches), plain twin {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}: {flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.4f} MB)")
    return {"name": "rb_sor_slabs_packed", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/poisson_sor.cu",
            "replaces": "src/repro/kernels/poisson/kernel.py:106",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library": "no single PyTorch call computes this",
            "shape": f"one rb_sor_planes solve: res {cfg.res} planes "
                     f"({ny}, {w}), {n_env} envs, {rounds} launches"}


def reset_counts():
    from repro_torch.kernels.actuation import ops as aops
    from repro_torch.kernels.poisson import ops as pops
    aops.fused_interval_cuda.launches = 0
    pops.rb_sor_slabs_packed_cuda.launches = 0


def counts():
    from repro_torch.kernels.actuation import ops as aops
    from repro_torch.kernels.poisson import ops as pops
    return {"fused_interval": aops.fused_interval_cuda.launches,
            "rb_sor_slabs_packed": pops.rb_sor_slabs_packed_cuda.launches}


def run_train(backend, env_kw, episodes, grid_kw):
    import numpy as np
    import torch
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.drl.train import TrainConfig, train
    cfg = TrainConfig(env=EnvConfig(grid=GridConfig(**grid_kw), **env_kw),
                      n_envs=4, episodes=episodes, seed=0, backend=backend,
                      device="cuda")
    reset_counts()
    (hist, model), secs = wall(lambda: train(
        cfg, log_fn=lambda s: print(f"[train {backend}] {s}")))
    launched = counts()
    for k, v in hist.items():
        if len(v) != episodes or not np.isfinite(v).all():
            fail(f"train({backend}) history {k} = {v}")
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        fail(f"train({backend}) left non-finite params")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train {backend}] {episodes} episodes in {secs:.3f} s, "
          f"{n_params} params finite, rewards {hist['reward'].tolist()}, "
          f"kernel launches {launched}")
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


def main():
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    _, secs = wall(lambda: build.build(verbose=True))
    print(f"[build] both kernels built in {secs:.2f} s -> {build.BUILD_DIR}")
    dev = torch.device("cuda")

    # 1. each kernel against its plain twin at the training shape
    res16 = GridConfig(res=16)
    fused = check_fused(dev, res16, n_env=4, n_steps=50)
    sor = check_sor(dev, res16, n_env=4, iters=50)

    # 2. the main path: training at full width, depth cut to 2 episodes
    main_env = dict(steps_per_action=50, actions_per_episode=100,
                    warmup_time=30.0)
    print("[train fused] full width: res 16 (ny 66, nx 352), 50 dt per "
          "action, 60 SOR iterations, 2x512 MLP, 149 probes, 4 envs; depth "
          "cut: 2 episodes of 100 actions after a 30 t.u. warmup")
    launched = run_train("fused", main_env, 2, dict(res=16))
    if launched["fused_interval"] < 1:
        fail("the main path did not launch the fused_interval kernel")
    fused["launches"] = launched["fused_interval"]
    fused["path"] = "train(backend='fused'), warmup + 2 episodes"

    # 3. the second path: one short episode with the packed-SOR kernel
    print("[train pallas] res 16, 4 envs; depth cut: 1 episode of 2 actions "
          "after a 1 t.u. warmup")
    launched = run_train("pallas", dict(steps_per_action=50,
                                        actions_per_episode=2,
                                        warmup_time=1.0), 1, dict(res=16))
    if launched["rb_sor_slabs_packed"] < 1:
        fail("the pallas path did not launch the rb_sor_slabs_packed kernel")
    sor["launches"] = launched["rb_sor_slabs_packed"]
    sor["path"] = "train(backend='pallas'), warmup + 1 episode"

    # 4. golden physics through the fused kernel
    golden(dev)

    # 5. the kernels, the card, the result
    print(json.dumps({"kernels": [fused, sor]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
