"""The paper's contribution as a 5-minute demo: given a worker budget, the
hybrid planner picks (N_envs, N_ranks) and shows why.

Port of the reference's ``examples/hybrid_scaling_demo.py``.  Two modes:

    # paper mode: the cost model calibrated to the paper's Table II
    python -m repro_torch.examples.hybrid_scaling_demo --workers 60

    # measured mode: time the card's solver / fused interval / PPO / sink
    # components (core.autotune), refit the model and pick the executable
    # plan (JSON artifact included); --device cpu measures the CPU
    python -m repro_torch.examples.hybrid_scaling_demo --auto

The chosen plan is directly executable:  ``train(TrainConfig(plan="auto"))``
resolves it and runs its backend.
"""
import argparse

from repro_torch.core.plan import CostModel, ParallelPlan, enumerate_plans, \
    optimize_plan
from repro_torch.core.scaling_model import calibrate_to_paper


def show_lattice(m: CostModel, workers: int, episodes: int,
                 io_bytes: float) -> ParallelPlan:
    print(f"\nall full-utilization splits of {workers} workers "
          f"({episodes} episodes, io={io_bytes / 1e6:.1f} MB):")
    print(f"  {'n_envs':>7s} {'n_ranks':>8s} {'T_hours':>9s} "
          f"{'speedup':>8s} {'eff':>6s}")
    ref = m.t_training(ParallelPlan(1, 1, 1), episodes, io_bytes)
    for p in enumerate_plans(workers):
        if p.utilization < 1.0:
            continue
        t = m.t_training(p, episodes, io_bytes)
        print(f"  {p.n_envs:7d} {p.n_ranks:8d} {t / 3600:9.1f} "
              f"{ref / t:8.1f} {ref / t / workers * 100:5.1f}%")
    best = optimize_plan(workers, m, episodes, io_bytes)
    print(f"\noptimal: n_envs={best.n_envs}, n_ranks={best.n_ranks} "
          f"(utilization {best.utilization:.0%})")
    print(f"device mapping: data axis = {best.n_envs} (env batch), "
          f"model axis = {best.n_ranks} (spatial CFD shards)")
    return best


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=60)
    ap.add_argument("--episodes", type=int, default=3000)
    ap.add_argument("--io-bytes", type=float, default=None,
                    help="interface bytes per env per actuation "
                         "(default: paper baseline 5.0 MB; in --auto mode "
                         "the measured per-actuation volume)")
    ap.add_argument("--auto", action="store_true",
                    help="measure the device (core.autotune) instead of "
                         "using the paper-calibrated constants; the worker "
                         "budget becomes the device count")
    ap.add_argument("--res", type=int, default=6,
                    help="--auto mode: the grid resolution measured")
    ap.add_argument("--smoke", action="store_true",
                    help="--auto mode: one timing iteration, short horizon")
    ap.add_argument("--artifact", default="artifacts/autotune_demo.json",
                    help="--auto mode: measured-vs-predicted JSON record")
    ap.add_argument("--device", default="cuda",
                    help="--auto mode: 'cuda' (the default; no card "
                         "raises) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the demo; returns the optimal plan (and, with --auto, the
    ResolvedPlan as its second element)."""
    args = parse_args(argv)
    if args.auto:
        from repro_torch.cfd.grid import GridConfig
        from repro_torch.core.autotune import autotune
        rp = autotune(grid=GridConfig(res=args.res), n_episodes=args.episodes,
                      io_bytes=args.io_bytes, artifact=args.artifact,
                      smoke=args.smoke, device=args.device)
        rec = rp.measurements
        m = rec["measured"]
        print(f"measured on {m['device']['name']} (median of "
              f"{1 if args.smoke else 3}):")
        for r, t in sorted(m["t_step_ranks"].items(),
                           key=lambda kv: int(kv[0])):
            pred = rec["predicted"]["t_step_ranks"][r]
            err = rec["predicted"]["rel_err_t_step"][r]
            print(f"  t_step(n_ranks={r}) = {t * 1e3:7.3f} ms   "
                  f"refit model: {pred * 1e3:7.3f} ms ({err:+.1%})")
        print(f"  {m['interval_probe_steps']}-dt interval: " + ", ".join(
            f"{b} {t * 1e3:.3f} ms"
            for b, t in m["t_interval_backends"].items()))
        print(f"  t_update = {m['t_update'] * 1e3:.1f} ms   sink write = "
              f"{m['io']['write_seconds'] * 1e3:.2f} ms")
        io_bytes = (args.io_bytes if args.io_bytes is not None
                    else rp.model.io_bytes_per_actuation)
        best = show_lattice(rp.model, rec["plan"]["n_total"], args.episodes,
                            io_bytes)
        print(f"\n{rp.describe()}")
        print(f"artifact -> {args.artifact}")
        print("execute it:  train(TrainConfig(plan='auto', ...))  "
              "or plan=ParallelPlan"
              f"({best.n_total}, {best.n_envs}, {best.n_ranks})")
        return best, rp

    m = calibrate_to_paper()
    io_bytes = 5.0e6 if args.io_bytes is None else args.io_bytes
    print("cost model (calibrated to the paper's Table II):")
    print(f"  t_step(1) = {m.t_step_1 * 1e3:.1f} ms   "
          f"CFD eff @16 ranks = {m.cfd_efficiency(16) * 100:.0f}%")
    best = show_lattice(m, args.workers, args.episodes, io_bytes)
    if (best.n_envs, best.n_ranks) == (60, 1) and args.workers == 60:
        print("paper: 60 x 1: matches")
    opt = m.t_training(best, args.episodes, io_bytes=1.2e6)
    ref = m.t_training(ParallelPlan(1, 1, 1), args.episodes, io_bytes)
    print(f"with optimized 1.2 MB interface: {opt / 3600:.1f} h "
          f"({ref / opt:.1f}x vs single worker; paper: 47x)")
    return best


if __name__ == "__main__":
    main()
