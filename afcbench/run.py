"""Run one cell of the benchmark on the card this process is started on.

    python3 -m afcbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as one JSON object on the last line of standard output,
and each number compared beside its limit as the last lines of standard
error.  The result's ``kernels_built`` names the kernel libraries that the
run built in its set-up (a checkout's first run), so that run's
``setup_s`` stands apart.  Exits non-zero, printing no result, without enough CUDA devices
for the cell, and when ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` was loaded.
"""
import time

T_ORIGIN = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# top-level module names a run may not load: the JAX package and JAX
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is forbidden."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def _log(msg: str) -> None:
    print(f"[afcbench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m afcbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    repo = Path(__file__).resolve().parents[1]
    src = repo / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    from afcbench import cells
    cell = cells.load_cell(args.workload, root=repo)

    import torch
    if not torch.cuda.is_available():
        _log("no CUDA device: the benchmark measures the card and reports "
             "nothing from the CPU")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _log(f"{cell.name} needs {cell.chips} CUDA devices, "
             f"{torch.cuda.device_count()} present")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from afcbench import bench
    res = bench.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                    T_ORIGIN, log=_log)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        _log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if args.trace:
        device["busy_s"], device["window_s"] = res["busy_s"], res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    # the kernel libraries this run built: its set-up_s holds their build
    line["kernels_built"] = res["kernels_built"]
    line["compared"] = res["compared"]
    for name, c in res["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
