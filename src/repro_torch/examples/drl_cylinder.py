"""End-to-end training script: PPO learns active flow control on the
cylinder (the paper's Fig. 5 experiment at reduced scale).

Port of the reference's ``examples/drl_cylinder.py``.  Runs on the card
(``--device cuda``, the default: the actuation intervals go through the
fused-interval kernel) or on the CPU (``--device cpu``: the kernels' plain
versions).  Increase --res/--episodes to approach the paper's setup.

    python -m repro_torch.examples.drl_cylinder --episodes 60
    python -m repro_torch.examples.drl_cylinder --device cpu --episodes 2 \\
        --n-envs 2 --res 6 --actions 3 --steps-per-action 5 --warmup 1.0
"""
import argparse
import json
from pathlib import Path

import numpy as np

from repro_torch.cfd.env import EnvConfig
from repro_torch.cfd.grid import GridConfig
from repro_torch.drl.engine import SinkSpec
from repro_torch.drl.ppo import PPOConfig
from repro_torch.drl.train import TrainConfig, train


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=60)
    ap.add_argument("--n-envs", type=int, default=4)
    ap.add_argument("--res", type=int, default=8)
    ap.add_argument("--actions", type=int, default=40)
    ap.add_argument("--steps-per-action", type=int, default=25)
    ap.add_argument("--warmup", type=float, default=20.0)
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated scenario names (see "
                         "repro_torch.cfd.scenarios.list_scenarios(), e.g. "
                         "'cyl_re100,cyl_re200,cyl_re100_rotary') assigned "
                         "round-robin over the env batch; default: the "
                         "single Re=100 jets case")
    ap.add_argument("--policy", default="mlp", choices=["mlp", "attention"],
                    help="policy architecture: 'mlp' (the paper's 2x512 "
                         "tanh MLP, default) or 'attention' (permutation-"
                         "invariant set encoder over (coord, value) probe "
                         "tokens, for mixed or multi-body batches)")
    ap.add_argument("--list-scenarios", action="store_true",
                    help="print the scenario registry and exit")
    ap.add_argument("--plan", default=None,
                    help="hybrid placement: 'auto' (measure the device and "
                         "optimize, core.autotune) or 'N_ENVSxN_RANKS' "
                         "(e.g. '1x1'); default: the configured backend")
    ap.add_argument("--sink", default=None,
                    help="trajectory sink spec 'kind[:root]': 'none', "
                         "'memory', 'binary:/path', 'zstd:/path' (one file "
                         "per episode, paper §IV I/O), or 'dataset:/path' "
                         "(sharded files + manifest, replayable)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: save the full TrainState "
                         "(params, optimizer, generator state, env batch, "
                         "history) every --ckpt-every episodes with "
                         "background writes; required for --resume")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="retain only the newest N checkpoints")
    ap.add_argument("--resume", nargs="?", const="auto", default=None,
                    help="resume training: bare --resume restarts from the "
                         "latest valid checkpoint in --ckpt-dir (fresh run "
                         "when none exists yet); or pass an explicit .ckpt "
                         "path / checkpoint directory.  --episodes is the "
                         "TOTAL target")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; no card raises) or 'cpu'")
    ap.add_argument("--out", default="artifacts/drl_cylinder.json")
    return ap.parse_args(argv)


def main(argv=None, **train_kw):
    """Run the script; ``train_kw`` goes to ``train()`` (a caller injecting
    a model, rollout noise or PPO permutations).  Returns the history."""
    args = parse_args(argv)
    if args.list_scenarios:
        from repro_torch.cfd.scenarios import get_scenario, list_scenarios
        for name in list_scenarios():
            s = get_scenario(name)
            print(f"{name:22s} Re={s.re:<6g} {s.actuation:7s} "
                  f"{s.geometry:9s} {s.probes:9s} {s.description}")
        return None

    plan = args.plan
    if plan and plan != "auto":
        n_envs, n_ranks = (int(v) for v in plan.lower().split("x"))
        plan = (n_envs, n_ranks)
    spec = SinkSpec.parse(args.sink)
    cfg = TrainConfig(
        env=EnvConfig(
            grid=GridConfig(res=args.res, dt=0.01, poisson_iters=50),
            steps_per_action=args.steps_per_action,
            actions_per_episode=args.actions,
            warmup_time=args.warmup),
        ppo=PPOConfig(lr=3e-4, epochs=6, minibatches=4,
                      entropy_coef=0.005),
        n_envs=args.n_envs,
        episodes=args.episodes,
        scenarios=(tuple(s.strip() for s in args.scenarios.split(",")
                         if s.strip())
                   if args.scenarios else None),
        policy=args.policy,
        plan=plan,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        ckpt_keep=args.ckpt_keep,
        resume=args.resume,
        sink=spec,
        device=args.device)
    sink = spec.build()
    hist, _ = train(cfg, sink=sink, **train_kw)
    if sink is not None:
        print(f"sink[{spec.kind}]: {sink.episodes} episodes, "
              f"{sink.bytes_written / 1e6:.2f} MB, "
              f"{sink.time_spent:.2f}s interface time")
    # drag reduction: mean CD of the last episodes vs the first
    first5 = float(np.mean(hist["cd"][:5]))
    last5 = float(np.mean(hist["cd"][-5:]))
    r_first = float(np.mean(hist["reward"][:5]))
    r_last = float(np.mean(hist["reward"][-5:]))
    print(f"\nreturn: {r_first:+.2f} -> {r_last:+.2f}")
    print(f"tail CD: {first5:.3f} -> {last5:.3f} "
          f"({100 * (last5 - first5) / first5:+.1f}% change; paper: -8%)")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({k: np.asarray(v).tolist()
                               for k, v in hist.items()}, indent=1))
    print(f"history -> {out}")
    return hist


if __name__ == "__main__":
    main()
