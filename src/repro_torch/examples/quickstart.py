"""Quickstart: train a reduced language model for a few steps, checkpoint
it, restore it, and greedy-decode a short continuation.

Port of the reference's ``examples/quickstart.py``, through the port's
public API (``launch.steps``, ``ckpt.checkpoint``, ``models.model``'s
``prefill`` / ``decode_step``).

    python -m repro_torch.examples.quickstart [--arch phi4-mini-3.8b] \\
        [--steps 10] [--device cpu]
"""
import argparse
import tempfile

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import LMDataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.models import model as M


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def tree_from(arrays, like, prefix=""):
    """The tree ``like`` with each leaf replaced by ``arrays[path]`` (the
    ``{path: array}`` of ``ckpt.restore``) on that leaf's device."""
    return {k: tree_from(arrays, v, f"{prefix}{k}/") if isinstance(v, dict)
            else torch.as_tensor(arrays[prefix + k]).to(v.device)
            for k, v in like.items()}


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    print(f"arch {cfg.name}: {cfg.num_layers}L d{cfg.d_model} "
          f"V{cfg.vocab_size}")
    params = M.init_params(cfg, seed=0, device=device)
    n = sum(p.numel() for p in steps.param_leaves(params))
    print(f"params {n/1e6:.2f}M")

    opt = steps.make_opt(cfg)
    opt_state = opt.init(steps.param_leaves(params))
    train_step = steps.make_train_step(cfg)
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                        global_batch=8)
    step = 0
    first = last = None
    for i in range(args.steps):
        batch = synthetic_batch(dcfg, i, cfg)
        params, opt_state, step, metrics = train_step(params, opt_state,
                                                      step, batch)
        last = float(metrics["loss"])
        first = first if first is not None else last
        print(f"step {i}: loss {last:.4f}")
    if not last < first:
        raise AssertionError("loss did not decrease")

    with tempfile.TemporaryDirectory() as td:
        nb = ckpt.save(f"{td}/model.ckpt", params, step=step)
        print(f"checkpointed {nb/1e6:.1f} MB; restoring...")
        params = tree_from(ckpt.restore(f"{td}/model.ckpt", params), params)

    # greedy decode a few tokens
    prompt = torch.as_tensor(
        synthetic_batch(dcfg, 999, cfg)["tokens"][:1, :16], device=device)
    with torch.inference_mode():
        logits, cache = M.prefill(cfg, params, prompt, cache_len=32)
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
        out = [int(tok[0, 0])]
        for t in range(8):
            logits, cache = M.decode_step(cfg, params, cache, tok, 16 + t)
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
            out.append(int(tok[0, 0]))
    print("greedy continuation:", out)
    print("OK")


if __name__ == "__main__":
    main()
