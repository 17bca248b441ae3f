"""The port's dry run (``launch/dryrun.py``) and ``launch/roofline.py``'s
``Roofline`` / ``build`` against the reference's.

The reference's per-device argument bytes come from compiling its steps
(``lowering_for(...).lower().compile().memory_analysis()``) for reduced
phi4-mini on a (2, 4) mesh of forced host devices, in one child process
(``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``)
at a small train, prefill and decode shape; the port counts the same
arguments from their specs (``sharding.shard_shape``) on meta tensors,
and the two must be equal.  The whole dry run (10 configs x 4 shapes x 2
production meshes) touches no device."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import roofline as jroof
from repro.models import model as jmodel
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as troof
from repro_torch.launch.mesh import make_abstract_mesh

SRC = str(Path(__file__).resolve().parent.parent / "src")
SHAPES = {"train": ("t", 64, 8, "train"), "prefill": ("p", 64, 8, "prefill"),
          "decode": ("d", 64, 8, "decode")}

_CHILD = """
import json, sys
import numpy as np
import jax
from repro.configs.base import InputShape, get_config
from repro.launch import steps
cfg = get_config("phi4-mini-3.8b").reduced()
mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                         ("data", "model"))
out = {{}}
for kind, args in {shapes!r}.items():
    with mesh:
        fn, a = steps.lowering_for(cfg, InputShape(*args), mesh)
        mem = fn.lower(*a).compile().memory_analysis()
    out[kind] = int(mem.argument_size_in_bytes)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_bytes(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC,
           "PATH": "/usr/bin:/bin", "HOME": str(d)}
    out = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(_CHILD.format(shapes=SHAPES))],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_argument_bytes_match_compiled_reference(reference_bytes, kind):
    """One device's bytes of the step's arguments (params, optimizer state,
    step, batch / cache, token, position) equal the reference's compiled
    ``argument_size_in_bytes``."""
    cfg = tbase.get_config("phi4-mini-3.8b").reduced()
    mesh = make_abstract_mesh((2, 4), ("data", "model"))
    parts = dryrun.argument_parts(cfg, tbase.InputShape(*SHAPES[kind]), mesh)
    got = sum(dryrun.device_bytes(v, mesh) for v in parts.values())
    assert got == reference_bytes[kind]


ANALYZED = [{"flops": 3.2e12, "bytes": 4.5e10, "coll_bytes": 2.0e9,
             "coll_all-gather": 1.5e9, "coll_all-reduce": 5e8},
            {"flops": 1e9, "bytes": 8e11},
            {}]


@pytest.mark.parametrize("hw", ["tpu_v5e", "cpu_generic"])
@pytest.mark.parametrize("i", range(len(ANALYZED)))
def test_roofline_build_matches_reference(i, hw):
    """The same dict from the same per-device counts and hardware preset
    (the presets both packages have)."""
    args = ("phi4-mini-3.8b", "train_4k", "pod16x16", 256, ANALYZED[i],
            2.5e15)
    want = jroof.build(*args, hw=hw).to_dict()
    got = troof.build(*args, hw=hw).to_dict()
    assert got == want


def test_roofline_takes_a_spec_and_resolves_none(monkeypatch):
    spec = troof.HARDWARE_PRESETS["h100_sxm"]
    r = troof.build("a", "s", "m", 1, ANALYZED[0], 1e12, hw=spec)
    assert r.hw is spec and r.dominant == "collective"
    assert r.compute_s == ANALYZED[0]["flops"] / spec.peak_flops
    monkeypatch.setenv(troof.HW_SPEC_ENV, "cpu_generic")
    assert troof.Roofline("a", "s", "m", 1, 1.0, 1.0, 0.0, 1.0,
                          {}).hw.name == "cpu_generic"


def test_dryrun_writes_every_record_without_a_device(tmp_path,
                                                     monkeypatch):
    """``--all --both-meshes``: 10 configs x 4 shapes x 2 meshes, 80 ``ok``
    records, each with its specs, per-device argument bytes, parameter
    counts and model flops; no tensor is made on a device (the CPU
    allocator is refused), and the records match the reference's counts
    (``param_count``, ``active_param_count``, ``model_flops``)."""
    made = []
    for fn in ("empty", "zeros"):
        def meta_only(*a, _real=getattr(torch, fn), device=None, **kw):
            assert str(device) == "meta", device
            made.append(device)
            return _real(*a, device=device, **kw)
        monkeypatch.setattr(torch, fn, meta_only)
    dryrun.main(["--all", "--both-meshes", "--out", str(tmp_path)])
    assert made
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 80 and all(r["status"] == "ok" for r in recs)
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    r = by[("llama3-405b", "train_4k", "pod2x16x16")]
    assert r["n_devices"] == 512 and r["memory"]["opt_state_bytes"] > 0
    assert "hlo_analysis" not in r and "roofline" not in r
    assert r["specs"]["params"]["embed"] == ["model", ["pod", "data"]]
    assert r["memory"]["argument_bytes"] == sum(
        v for k, v in r["memory"].items() if k.endswith("_bytes")
        and k != "argument_bytes")
    for name in ("deepseek-v3-671b", "qwen2-vl-2b"):
        jcfg = jbase.get_config(name)
        ps = jax.eval_shape(lambda: jmodel.init_params(
            jcfg, jax.random.PRNGKey(0)))
        rec = by[(name, "prefill_32k", "pod16x16")]
        assert rec["params"] == jroof.param_count(jcfg, ps)
        assert rec["params_active"] == jroof.active_param_count(jcfg, ps)
        assert rec["model_flops"] == jroof.model_flops(
            jcfg, jbase.INPUT_SHAPES["prefill_32k"], ps)
    dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "train_4k",
                 "--skip-existing", "--out", str(tmp_path)])
    assert len(list(tmp_path.glob("*.json"))) == 80
