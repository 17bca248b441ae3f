"""The harness on the CPU: discovery by name, the result line, the refusal
without a card, and the check on loaded modules."""
import copy
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from afcbench import bench, cells, run


def _tiny(cell):
    """A cell cut to a size the CPU runs in seconds (tests only)."""
    cell.config = copy.deepcopy(cell.config)
    cell.config["env"].update(steps_per_action=2, actions_per_episode=4,
                              warmup_time=0.05)
    cell.traffic = dict(cell.traffic, res=4, n_envs=3)
    return cell


def _record(episodes):
    """A traced window's record, as ``bench.run`` hands it to the readers,
    with no device activity and no program timers in it."""
    return {"episodes": episodes, "intervals": 100 * (episodes or 0),
            "stats": {}, "device": [], "window_s": 1.0, "busy_s": 0.0,
            "interval_flops": 1.0, "interval_bytes": 1.0,
            "policy_flops": 1.0}


def test_new_cell_mix_and_metric_are_found_from_new_files(tmp_path):
    bench_json = json.loads((cells.REPO / "BENCHMARK.json").read_text())
    pkg = tmp_path / "pkg"
    shutil.copytree(cells.PACKAGE / "traffic", pkg / "traffic")
    shutil.copytree(cells.PACKAGE / "metrics", pkg / "metrics")
    (pkg / "limits").mkdir()
    (pkg / "traffic" / "res8.envs2.json").write_text(json.dumps(
        {"res": 8, "n_envs": 2, "policy": "mlp", "engine": "sync",
         "backend": "fused", "scenarios": ["cyl_re100", "pinball_re100"]}))
    (pkg / "metrics" / "episodes.train.py").write_text(
        "def read(rec):\n    return rec['episodes']\n")
    (pkg / "limits" / "mixed.res8.envs2.json").write_text('{"state": 1}')
    shutil.copytree(cells.PACKAGE / "configs",
                    tmp_path / "afcbench" / "configs")
    conf = tmp_path / "configs"
    conf.mkdir()
    shutil.copy(cells.PACKAGE / "configs" / "cyl_re100.json",
                conf / "mixed.json")
    bench_json["configs"].append({"name": "mixed", "source": "x",
                                  "file": "configs/mixed.json",
                                  "reduced": [], "why": "x"})
    bench_json["workloads"].append({"name": "mixed.res8.envs2",
                                    "config": "mixed", "traffic": "res8.envs2",
                                    "chips": 1, "why": "x"})
    bench_json["per_layer"].append({
        "name": "episodes.train", "unit": "1", "better": "higher",
        "source": "host_clock", "layer": "x", "moves": "env_steps_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    cell = cells.load_cell("mixed.res8.envs2", root=tmp_path, package=pkg)
    assert cell.traffic["scenarios"] == ["cyl_re100", "pinball_re100"]
    assert cell.limits == {"state": 1}
    assert "episodes.train" in [m["name"] for m in cell.per_layer]
    got = cells.read_per_layer(cell, _record(episodes=7))
    assert got["episodes.train"] == {"value": 7.0, "unit": "1"}
    # every cell takes every metric; one whose reader finds nothing there
    # leaves it out of its line
    other = cells.load_cell("cyl_re100.res16.envs32", root=tmp_path,
                            package=pkg)
    assert "episodes.train" in [m["name"] for m in other.per_layer]
    assert "episodes.train" not in cells.read_per_layer(
        other, _record(episodes=None))


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    cell = cells.load_cell("cyl_re100.res16.envs32")
    assert cells.read_per_layer(cell, _record(episodes=0)) == {}


def test_without_a_card_a_run_fails_and_prints_no_result(capsys,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "cyl_re100.res16.envs32", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_fail(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "cyl_re100.res16.envs32", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_module_check_compares_whole_top_level_names():
    names = ["repro_torch", "repro_torch.cfd.env", "reprox", "jaxtyping",
             "repro", "repro.cfd", "jax.numpy", "jaxlib", "flax.linen",
             "numpy"]
    assert run.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.cfd"]


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(trace, capsys, monkeypatch):
    """The CLI on a faked card with the run itself replaced: the last line
    of standard output is one JSON object with the contract's keys, the
    numbers compared last; standard error ends with them."""
    res = {"correct": True, "attempted": 3, "failed": 0,
           "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
           "memory_peak_bytes": 10, "busy_s": 0.5, "window_s": 1.0,
           "kernels_built": [],
           "compared": {"state": {"value": 1e-6, "limit": 1e-4}}}
    if trace:
        res["breakdown"] = {"device_ops": [["k", 0.1]], "idle_gaps": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(bench, "run", lambda *a, **kw: dict(res))
    rc = run.main(["--workload", "cyl_re100.res16.envs32", "--seed",
                   str(2 ** 31 + 11), "--seconds", "1", "--trace",
                   str(trace)])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] * trace + ["kernels_built", "compared"]
    assert list(line) == want
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["kind"] == "card"
    assert dev["count"] == 1 and dev["memory_peak_bytes"] == 10
    assert ("busy_s" in dev) == bool(trace)
    assert err.strip().splitlines()[-1].startswith("state 1e-06 limit")


def test_a_sound_run_on_the_cpu_is_correct():
    """The whole run but the look for a card, at a tiny size on the CPU:
    the window counts its episodes and the comparison passes."""
    cell = _tiny(cells.load_cell("cyl_re100.res16.envs32"))
    res = bench.run(cell, 2 ** 31 + 3, 0.5, False, "cpu",
                    time.perf_counter())
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["metrics"]["env_steps_per_s"]["value"] > 0
    assert res["kernels_built"] == []      # the CPU loads no kernel library
    assert res["correct"], res["compared"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run at a tiny size in a fresh process, its loaded modules
    checked as ``run`` checks them once the window has closed."""
    code = ("import sys, time\n"
            "from afcbench import bench, cells, run\n"
            "from afcbench.tests.test_afcbench_harness import _tiny\n"
            "cell = _tiny(cells.load_cell('pinball_re100.res16.envs32'))\n"
            "bench.run(cell, 11, 0.1, True, 'cpu', time.perf_counter())\n"
            "print(run.forbidden_modules(list(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(cells.REPO), str(cells.REPO / "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
