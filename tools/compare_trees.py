"""Time the packed-SOR solve and the WKV6 call of the ``repro_torch``
package of a checkout with this checkout's ``chip_smoke.py`` yardsticks,
so that two commits are read the same way.

    python3 tools/compare_trees.py TREE

TREE is the root of a checkout (``.`` for this one, or an older commit
unpacked with ``git archive``); its kernels are built into its own
``build/``.  One process reads one tree, since a process imports one
``repro_torch``: to compare two commits, run it in turns on the older,
the newer, the newer and the older tree in one call on one card.  Reads,
on one CUDA card:

* the packed-SOR solve of ``chip_smoke.py``'s phase 1, ``rb_sor_planes``
  at res 16, 4 envs, iters=50: its launches per solve, its device time
  (the calls queued behind a sleep kernel, ``chip_smoke.cuda_ms``) and its
  time when the host paces the calls (``chip_smoke.host_paced_ms``);
* the WKV6 call of the same phase, rwkv6-3b, bf16, B=1, S=4096: both
  times.

Prints the card's name and power limit, then one JSON line.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    tree = Path(sys.argv[1]).resolve()
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_trees: needs a CUDA card")
    import chip_smoke as smoke
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.poisson import ops as pops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    sor, _ = smoke.sor_case(dev, GridConfig(res=16), 4, 50)
    n0 = pops.rb_sor_slabs_packed_cuda.launches
    sor()
    per_solve = pops.rb_sor_slabs_packed_cuda.launches - n0
    _, wkv6, _ = smoke.wkv6_case(dev, get_config("rwkv6-3b"), 4096)
    reading = {"tree": str(tree), "kind": torch.cuda.get_device_name(0)}
    for name, fn, reps, extra in (
            ("sor_res16_4env_iters50", sor, 20,
             {"launches_per_solve": per_solve}),
            ("wkv6_rwkv6_3b_bf16_S4096", wkv6, 10, {})):
        reading[name] = {"device_ms": smoke.cuda_ms(fn, reps),
                         "host_paced_ms": smoke.host_paced_ms(fn, reps),
                         **extra}
    print(json.dumps(reading))


if __name__ == "__main__":
    main()
