"""The port stands alone: importing repro_torch (every module) and
chip_smoke loads neither jax nor the reference package, and no source of
the port names them in an import.  Its checkpoints need only the standard
library and numpy: neither msgpack nor zstandard is loaded or imported."""
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                    "zstandard"))
print(json.dumps({{"modules": names, "bad": bad}}))
"""


def test_import_loads_no_jax_and_no_reference():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    assert "repro_torch.kernels.actuation.ops" in res["modules"]
    assert "repro_torch.drl.train" in res["modules"]
    assert "repro_torch.models.model" in res["modules"]
    for name in ("testing.faults", "ckpt.io", "ckpt.checkpoint",
                 "drl.health", "drl.train_state", "core.interface",
                 "data.trajectory_dataset", "data.pipeline", "core.plan",
                 "core.scaling_model", "core.autotune", "drl.async_train",
                 "launch.distributed", "launch.fleet", "examples.drl_cylinder",
                 "examples.serve_batch", "examples.hybrid_scaling_demo"):
        assert f"repro_torch.{name}" in res["modules"], name


def test_sources_import_no_jax_and_no_reference():
    pat = re.compile(r"^\s*(import\s+(jax|jaxlib|repro|msgpack|zstandard)"
                     r"\b|from\s+(jax|jaxlib|repro|msgpack|zstandard)"
                     r"(\.|\s))", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
