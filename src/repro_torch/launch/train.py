"""LM training script: ``python -m repro_torch.launch.train --arch <id>``.

Port of ``repro.launch.train``: trains any config the port has (full or
``--reduced``) on one device with ``launch.steps.make_train_step`` on the
synthetic token stream, logs every ``--log-every`` steps, optionally
saves the parameters as a checkpoint, and fails unless the loss fell.
There is no mesh yet (``ROADMAP.md`` §1 item 5.8): one card, or the CPU
with ``--device cpu``.

    python -m repro_torch.launch.train --arch phi4-mini-3.8b --reduced \\
        [--steps 20] [--batch 8] [--seq 64] [--ckpt-dir runs/lm] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import LMDataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.models import model as M


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer smoke variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    B = args.batch or (8 if args.reduced else 32)
    S = args.seq or (64 if args.reduced else 1024)
    device = resolve_device(args.device)

    print(f"init {cfg.name}: L={cfg.num_layers} d={cfg.d_model} "
          f"V={cfg.vocab_size} devices=1 ({device})")
    params = M.init_params(cfg, seed=args.seed, device=device)
    n_params = sum(p.numel() for p in steps.param_leaves(params))
    print(f"params: {n_params/1e6:.2f} M")
    opt = steps.make_opt(cfg)
    opt_state = opt.init(steps.param_leaves(params))
    train_step = steps.make_train_step(cfg)

    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                        seed=args.seed)
    step = 0
    losses = []
    for i in range(args.steps):
        t0 = time.time()
        batch = synthetic_batch(dcfg, i, cfg)
        params, opt_state, step, metrics = train_step(params, opt_state,
                                                      step, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % args.log_every == 0:
            print(f"step {i:5d}  loss {loss:8.4f}  {time.time()-t0:6.2f}s",
                  flush=True)
    if args.ckpt_dir:
        p = Path(args.ckpt_dir) / f"step_{step:08d}.ckpt"
        n = ckpt_mod.save(str(p), {"params": params}, step=step)
        print(f"checkpoint -> {p} ({n/1e6:.1f} MB)")
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not decrease")


if __name__ == "__main__":
    main()
