"""The readings the limits are set from: a cell's numbers on many seeds
for sound runs of the program, for the control (the reference in the
program's place in the lower precision) and for each planted fault, read
in one process (the warmup run once).

    python3 -m afcbench.readings --workload <cell> --seeds 1,2,3 \\
        [--faults interval_unchanged,half_batch] [--control 3] \\
        [--fault-seeds 3]

Prints one JSON line a seed and mode.  Needs no measured window: the
numbers come from the set-up's first episodes.
"""
import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m afcbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--control", type=int, default=3,
                    help="the control on this many of the first seeds")
    ap.add_argument("--fault-seeds", type=int, default=3,
                    help="the faults on this many of the first seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    repo = Path(__file__).resolve().parents[1]
    if str(repo / "src") not in sys.path:
        sys.path.insert(0, str(repo / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from afcbench import bench, cells, check, faults, program
    cell = cells.load_cell(args.workload, root=repo)
    dev = torch.device(args.device)
    cfg, mix = cell.config, cell.traffic
    env, st_b, obs_b = program.build_env(cfg, mix, dev)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    modes = ["sound"] + [f for f in args.faults.split(",") if f]
    for n, seed in enumerate(seeds):
        for mode in modes if n < args.fault_seeds else modes[:1]:
            t0 = time.perf_counter()
            prog = program.build_program(env, st_b, obs_b, cfg, mix, seed,
                                         dev)
            inputs = program.Inputs(seed, int(mix["n_envs"]),
                                    env.cfg.actions_per_episode,
                                    prog.act_dim, prog.ppo_cfg.epochs, dev)
            plant = (faults.FAULTS[mode]() if mode != "sound"
                     else _nothing())
            with plant:
                rec = bench.setup_episodes(prog, inputs, seed)
            del prog, inputs
            runs = [(mode, False)]
            if mode == "sound" and n < args.control:
                runs.append(("control", True))
            for name, control in runs:
                found = check.compare(rec, cfg, mix, dev, control=control)
                ok, _ = check.judge(found, cell.limits)
                print(json.dumps({"workload": cell.name, "seed": seed,
                                  "mode": name, "correct": ok,
                                  "seconds": time.perf_counter() - t0,
                                  **found}), flush=True)
            del rec
    return 0


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


if __name__ == "__main__":
    sys.exit(main())
