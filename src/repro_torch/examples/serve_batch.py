"""Batched policy-inference front end: the serving half of a deployed AFC
controller.

Port of the reference's ``examples/serve_batch.py``.  Loads a trained
checkpoint of this package (``repro_torch.drl.train``'s layout; without
one, freshly initialized params from ``--seed`` so the demo runs
standalone) and serves batched probe-observation -> jet-action requests:
many cylinder instances stream probe readings, one host answers with
actuation commands inside the actuation deadline.

Reports per-request p50 / p99 latency (the card synchronised before each
request's clock starts and before it stops) and actions/s over a burst of
requests.

    python -m repro_torch.examples.serve_batch [--ckpt runs/ckpt] \\
        [--batch 16] [--requests 200] [--deterministic] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.cfd.probes import layout_size
from repro_torch.device import resolve_device
from repro_torch.drl import networks


def load_model(ckpt, obs_dim: int, device, seed: int = 0):
    """(model, description) from the newest valid checkpoint, or fresh
    params (demo mode)."""
    if ckpt:
        from repro_torch.ckpt.checkpoint import latest_checkpoint
        from repro_torch.drl.train_state import load_train_state
        path = latest_checkpoint(ckpt) if not ckpt.endswith(".ckpt") \
            else ckpt
        if path is None:
            raise SystemExit(f"no valid checkpoint under {ckpt!r}")
        ts, meta = load_train_state(path, device)
        pol = meta.get("policy") or {}
        pcfg = networks.PolicyConfig(
            obs_dim=int(pol.get("obs_dim", meta.get("obs_dim", obs_dim))),
            act_dim=int(pol.get("act_dim", 1)),
            policy=pol.get("policy", "mlp"))
        model = networks.init_actor_critic(
            pcfg, torch.Generator().manual_seed(seed), device)
        model.load_state_dict(ts.params)
        return model, f"checkpoint {path} (episode {meta['episode']})"
    pcfg = networks.PolicyConfig(obs_dim=obs_dim)
    model = networks.init_actor_critic(
        pcfg, torch.Generator().manual_seed(seed), device)
    return model, "fresh params (no --ckpt given)"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (newest valid is served) or a "
                         "specific .ckpt file; default: fresh params")
    ap.add_argument("--batch", type=int, default=16,
                    help="envs per inference request")
    ap.add_argument("--requests", type=int, default=200,
                    help="timed requests after warmup")
    ap.add_argument("--probe-layout", default="ring149",
                    help="probe layout naming the obs dim (cfd.probes)")
    ap.add_argument("--deterministic", action="store_true",
                    help="serve the policy mean (deployment), not samples "
                         "(training-style exploration)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; no card raises) or 'cpu'")
    return ap.parse_args(argv)


@torch.no_grad()
def main(argv=None):
    """Serve the burst; returns the latency / throughput summary."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model, src = load_model(args.ckpt, layout_size(args.probe_layout), dev,
                            args.seed)
    obs_dim = model.cfg.obs_dim
    gen = torch.Generator().manual_seed(args.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def infer(obs):
        if args.deterministic:
            return networks.policy_dist(model, obs)[0]
        return networks.sample_action(model, obs, generator=gen)[0]

    def request():
        return torch.randn((args.batch, obs_dim), generator=gen).to(dev)

    act = infer(request())                              # warmup
    sync()
    lat = []
    t_all = time.perf_counter()
    for _ in range(args.requests):
        obs = request()
        sync()
        t0 = time.perf_counter()
        act = infer(obs)
        sync()
        lat.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all

    act = act.cpu().numpy()
    if act.shape[0] != args.batch or np.isnan(act).any():
        raise SystemExit(f"bad actions: shape {act.shape}, "
                         f"{int(np.isnan(act).sum())} NaN")
    p50, p99 = np.percentile(lat, [50, 99])
    rate = args.requests * args.batch / wall
    print(f"serving {src} on {dev}")
    print(f"batch {args.batch} x obs_dim {obs_dim} "
          f"({'mean' if args.deterministic else 'sampled'} actions)")
    print(f"latency: p50 {p50 * 1e3:.3f} ms  p99 {p99 * 1e3:.3f} ms  "
          f"({args.requests} requests)")
    print(f"throughput: {rate:.0f} actions/s")
    print("OK")
    return {"p50_s": float(p50), "p99_s": float(p99),
            "actions_per_s": rate, "act_shape": list(act.shape)}


if __name__ == "__main__":
    main()
