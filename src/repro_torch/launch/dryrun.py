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
* ``cost_analysis``: the step run once on its meta arguments under
  ``launch/cost_analysis.CostCounter`` (the counterpart of the
  reference's ``hlo_analysis``: ``flops``, ``bytes``, ``coll_bytes``,
  ``coll_<kind>``, ``kernels``), each stack of blocks walked at a few
  layers and scaled to its depth (``cost_analysis.scaled_by_depth``).
  The counts are global, one controller running every shard, and the
  record splits them evenly over the mesh's devices (``per_device``
  says so).  The collectives are one device's: those of the partition
  pass (``launch/partition.py``: the step again on meta DTensors over a
  fake process group of the mesh, DTensor's sharding propagation in
  place of XLA's partitioner, each stack walked and scaled alike), by
  kind, beside the expert-parallel all-to-all the port performs itself
  (its global count split evenly).  ``coll_partition`` holds the pass's
  own counts (and the ops it ran replicated), ``coll_status`` says
  "counted", or "not counted: <reason>" where the step could not be
  partitioned (its collectives are then the all-to-all alone);
* ``memory.output_bytes``, ``memory.temp_bytes`` (the count's, split
  evenly) and ``memory.peak_per_device_bytes`` (the exact argument
  bytes plus those two);
* ``roofline``: ``roofline.build`` on those per-device counts, priced
  against ``h100_sxm``, the port's card (the reference prices its
  production meshes against ``tpu_v5e``), its collective term the
  partition pass's bytes and the all-to-all's;
* ``params``, ``params_active`` and ``model_flops``
  (``launch/roofline.py``); ``status``.

The op counts depend on the architecture and the shape, not on the
mesh: ``main`` counts each (arch, shape) once, on the first mesh it
records, and reuses the count for the other (``counted_on``); the
partition pass runs on each mesh.  A step the counter
cannot walk gives its record ``status: "fail"`` with the error.  Torch has
no XLA cost analysis, so there is no ``xla_cost_analysis`` and no
``alias_bytes`` (the steps update their donated arguments in place).

It touches no device: no tensor leaves the meta device and no kernel is
built.

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
from repro_torch.launch import cost_analysis, partition, roofline, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.sharding import shard_shape

DEFAULT_OUT = "build/dryrun"
# the card the port prices a step against
HW = "h100_sxm"
PER_DEVICE = ("flops, bytes and memory: the global count of one "
              "controller split evenly over n_devices; collectives: one "
              "device's, those of the partition pass (DTensor's sharding "
              "propagation on a fake process group of the mesh, in place "
              "of the collectives XLA inserts for the reference) plus the "
              "expert-parallel all-to-all the port performs, split evenly")


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


def _metas(tree):
    """A tree of Structs as its meta tensors."""
    if isinstance(tree, steps.Struct):
        return tree.meta
    if isinstance(tree, dict):
        return {k: _metas(v) for k, v in tree.items()}
    return [_metas(v) for v in tree]


def step_counts(cfg, shape, mesh) -> dict:
    """The global counts of ``shape``'s step of ``cfg`` under ``mesh``:
    ``cost`` (``cost_analysis.analyze``'s dict) and ``memory``
    (``output_bytes``, ``temp_bytes``), each stack walked at a few layers
    on meta arguments and scaled to its depth."""
    def count_at(c):
        fn, args = steps.lowering_for(c, shape, mesh)
        cost, mem = cost_analysis.count(fn, *_metas(args))
        return {"cost": cost, "memory": {"output_bytes": mem["output_bytes"],
                                         "temp_bytes": mem["temp_bytes"]}}
    return cost_analysis.scaled_by_depth(cfg, count_at)


def partition_counts(cfg, shape, mesh) -> dict:
    """``coll_status`` and the partition pass's per-device counts
    (``partition.step_collectives``) of ``shape``'s step on ``mesh``, or
    the reason it could not be partitioned."""
    try:
        got = partition.step_collectives(cfg, shape, mesh)
    except Exception as e:  # noqa: BLE001 -- recorded, never a silent 0
        return {"coll_status": f"not counted: {type(e).__name__}: {e}"}
    return {"coll_status": "counted", "coll_partition": got}


def with_collectives(cost: dict, part: dict) -> dict:
    """Per-device ``cost`` with the partition pass's collectives added to
    ``coll_bytes`` and each ``coll_<kind>``."""
    out = dict(cost)
    for k, v in part.get("coll_partition", {}).items():
        if k.startswith("coll_"):
            out[k] = out.get(k, 0) + v
    return out


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: str = DEFAULT_OUT, verbose: bool = True,
            counts: dict = None, counted_on: str = None) -> dict:
    """The record of one (arch, shape, mesh); ``counts`` (as
    :func:`step_counts` gives them, taken on the mesh ``counted_on``) are
    reused where given, else counted here; the partition pass runs on
    this mesh."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    n_dev = mesh.size
    t0 = time.time()
    parts = argument_parts(cfg, shape, mesh)
    part_bytes = {k: device_bytes(v, mesh) for k, v in parts.items()}
    params_shape = steps.abstract_params(cfg)
    t_specs = time.time() - t0
    if counts is None:
        counts, counted_on = step_counts(cfg, shape, mesh), mesh_name
    per_dev = cost_analysis.per_device(counts, n_dev)
    mf = roofline.model_flops(cfg, shape, params_shape)
    t0 = time.time()
    part = partition_counts(cfg, shape, mesh)
    t_partition = time.time() - t0
    cost = with_collectives(per_dev["cost"], part)
    rl = roofline.build(arch, shape_name, mesh_name, n_dev, cost, mf, hw=HW)
    arg_bytes = sum(part_bytes.values())
    mem = per_dev["memory"]
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_devices": n_dev, "status": "ok",
        "t_specs_s": t_specs,
        "memory": {"argument_bytes": arg_bytes,
                   **{f"{k}_bytes": v for k, v in part_bytes.items()},
                   "output_bytes": mem["output_bytes"],
                   "temp_bytes": mem["temp_bytes"],
                   "peak_per_device_bytes": (arg_bytes + mem["temp_bytes"]
                                             + mem["output_bytes"])},
        "cost_analysis": cost,
        **part, "t_partition_s": t_partition,
        "per_device": PER_DEVICE,
        "counted_on": counted_on,
        "roofline": rl.to_dict(),
        "specs": {k: _spec_json(v) for k, v in parts.items()},
        "params": roofline.param_count(cfg, params_shape),
        "params_active": roofline.active_param_count(cfg, params_shape),
        "model_flops": mf,
    }
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{arch}__{shape_name}__{mesh_name}.json").write_text(
        json.dumps(rec, indent=1))
    if verbose:
        m = rec["memory"]
        print(f"OK {arch:24s} {shape_name:12s} {mesh_name:10s} "
              f"counted on {counted_on:10s} "
              f"mem/dev {m['peak_per_device_bytes'] / 2**30:8.2f} GiB  "
              f"dom={rl.dominant:10s} "
              f"C/M/X = {rl.compute_s * 1e3:.1f}/{rl.memory_s * 1e3:.1f}/"
              f"{rl.collective_s * 1e3:.1f} ms  collectives "
              f"{rec['coll_status']}", flush=True)
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
    counted = {}      # (arch, shape) -> (counts, the mesh counted on)
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
                    if (arch, shape) not in counted:
                        counted[(arch, shape)] = (step_counts(
                            get_config(arch), INPUT_SHAPES[shape],
                            make_production_mesh(multi_pod=mp)), mesh_name)
                    counts, on = counted[(arch, shape)]
                    run_one(arch, shape, multi_pod=mp, out_dir=args.out,
                            counts=counts, counted_on=on)
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
