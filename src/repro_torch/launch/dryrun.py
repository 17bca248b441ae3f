"""Dry run of the language model on the production meshes:
``python -m repro_torch.launch.dryrun``.

Port of ``repro.launch.dryrun``.  For every (architecture x input shape x
production mesh) it builds the step's arguments with
``launch.steps.lowering_for`` as meta tensors, each with its spec on the
abstract mesh (``launch.mesh.make_production_mesh``), and records:

* the spec trees of the parameters, the optimizer state (train), the data
  arguments and the decode cache;
* ``memory.argument_bytes``: one device's bytes of every argument (each
  leaf's ``sharding.shard_shape`` times its itemsize), the counterpart of
  the compiled step's ``argument_size_in_bytes``, with its parts;
* ``params``, ``params_active`` and ``model_flops``
  (``launch/roofline.py``); ``status``.

It touches no device: no tensor leaves the meta device and no kernel is
built.  Torch has no compiled-HLO cost analysis, so there is no
``hlo_analysis``, ``xla_cost_analysis`` or ``roofline`` in a record and
no temporary or peak bytes; nothing is priced against a hardware preset.

    python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
        --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes \\
        [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch.configs.base import INPUT_SHAPES, get_config, list_configs
from repro_torch.launch import roofline, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.sharding import shard_shape

DEFAULT_OUT = "build/dryrun"


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, steps.Struct):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def device_bytes(tree, mesh) -> int:
    """One device's bytes of a tree of ``steps.Struct``."""
    return sum(math.prod(shard_shape(s.meta.shape, s.spec, mesh))
               * s.meta.element_size() for s in _leaves(tree))


def _spec_json(tree):
    """A tree of Structs as its specs, each a list of entries (None, an
    axis name, or a list of names)."""
    if isinstance(tree, steps.Struct):
        return [list(e) if isinstance(e, tuple) else e for e in tree.spec]
    if isinstance(tree, dict):
        return {k: _spec_json(v) for k, v in tree.items()}
    return [_spec_json(v) for v in tree]


def argument_parts(cfg, shape, mesh) -> dict:
    """The arguments of ``shape``'s step on ``mesh`` by part (params,
    opt_state, step, cache, batch), each a tree of ``steps.Struct``."""
    _, args = steps.lowering_for(cfg, shape, mesh)
    if shape.kind == "train":
        return {"params": args[0], "opt_state": args[1], "step": args[2],
                "batch": args[3]}
    if shape.kind == "prefill":
        return {"params": args[0], "batch": list(args[1:])}
    return {"params": args[0], "cache": args[1], "batch": [args[2], args[3]]}


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: str = DEFAULT_OUT, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    t0 = time.time()
    parts = argument_parts(cfg, shape, mesh)
    part_bytes = {k: device_bytes(v, mesh) for k, v in parts.items()}
    params_shape = steps.abstract_params(cfg)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_devices": mesh.size, "status": "ok",
        "t_specs_s": time.time() - t0,
        "memory": {"argument_bytes": sum(part_bytes.values()),
                   **{f"{k}_bytes": v for k, v in part_bytes.items()}},
        "specs": {k: _spec_json(v) for k, v in parts.items()},
        "params": roofline.param_count(cfg, params_shape),
        "params_active": roofline.active_param_count(cfg, params_shape),
        "model_flops": roofline.model_flops(cfg, shape, params_shape),
    }
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{arch}__{shape_name}__{mesh_name}.json").write_text(
        json.dumps(rec, indent=1))
    if verbose:
        print(f"OK {arch:24s} {shape_name:12s} {mesh_name:10s} "
              f"args/dev {rec['memory']['argument_bytes'] / 2**30:8.3f} GiB  "
              f"params {rec['params'] / 1e9:8.3f} B  "
              f"model {rec['model_flops']:.3e} flop", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                path = Path(args.out) / f"{arch}__{shape}__{mesh_name}.json"
                if args.skip_existing and path.exists():
                    rec = json.loads(path.read_text())
                    if rec.get("status") == "ok":
                        print(f"SKIP {arch} {shape} {mesh_name} (cached)")
                        continue
                try:
                    run_one(arch, shape, multi_pod=mp, out_dir=args.out)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mp, repr(e)))
                    Path(args.out).mkdir(parents=True, exist_ok=True)
                    path.write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh_name,
                        "status": "fail", "error": repr(e),
                        "traceback": traceback.format_exc()}, indent=1))
                    print(f"FAIL {arch} {shape} {mesh_name}: {e}",
                          flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f[:3], f[3][:120])
        raise SystemExit(1)
    print("\nall dry-runs OK")


if __name__ == "__main__":
    main()
