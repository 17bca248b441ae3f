"""The port's planner against the reference's: ``core.plan``
(``ParallelPlan``, ``CostModel``, ``enumerate_plans``, ``optimize_plan``),
``core.scaling_model`` (the paper calibration and its four table
generators) and ``core.autotune.refit_cost_model``.

Both packages hold the same float64 Python, so plans and modeled times are
held exactly (the cost terms to 1e-12 relative, which they meet with 0).
The calibration is a Levenberg-Marquardt fit through scipy from the same
start: its constants and every row built on them are held to 1e-9
relative, the room a different scipy build's last-bit rounding would
need."""
import dataclasses

import pytest

from repro.core import autotune as jat
from repro.core import plan as jplan
from repro.core import scaling_model as jsm
from repro_torch.core import autotune as tat
from repro_torch.core import plan as tplan
from repro_torch.core import scaling_model as tsm

REL_COST = 1e-12
REL_FIT = 1e-9


def _fields(p):
    return (p.n_total, p.n_envs, p.n_ranks, p.n_processes)


def _close(a, b, rel):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


@pytest.fixture(scope="module")
def calibrated():
    return jsm.calibrate_to_paper(), tsm.calibrate_to_paper()


@pytest.mark.parametrize("args", [
    (0, 1, 1), (4, 0, 1), (4, 1, 0), (4, 1, 1, 0),     # a field below 1
    (4, 3, 2),                                          # over-subscribed
    (6, 6, 1, 4),                                       # hosts do not divide
    (8, 4, 2, 8),                                       # a host splits an env
])
def test_parallel_plan_rejects_as_the_reference(args):
    with pytest.raises(ValueError) as ref:
        jplan.ParallelPlan(*args)
    with pytest.raises(ValueError) as out:
        tplan.ParallelPlan(*args)
    assert str(out.value) == str(ref.value)


@pytest.mark.parametrize("max_processes", [1, 2, 3, 4])
def test_enumerate_plans_matches(max_processes):
    for n_total in range(1, 65):
        ref = jplan.enumerate_plans(n_total, max_processes)
        out = tplan.enumerate_plans(n_total, max_processes)
        assert [_fields(p) for p in out] == [_fields(p) for p in ref]
        assert [p.mesh_shape for p in out] == [p.mesh_shape for p in ref]
        assert [p.utilization for p in out] == [p.utilization for p in ref]


@pytest.mark.parametrize("model", ["default", "paper"])
@pytest.mark.parametrize("max_processes", [1, 2, 3, 4])
def test_cost_model_terms_match(calibrated, model, max_processes):
    """Every term of the cost model on every plan of the lattice, with the
    default volume, none and the paper's optimized one."""
    if model == "default":
        jm, tm = jplan.CostModel(), tplan.CostModel()
    else:
        jm, tm = calibrated
    for n_total in range(1, 65):
        for jp in jplan.enumerate_plans(n_total, max_processes):
            tp = tplan.ParallelPlan(*_fields(jp))
            for io in (None, 0.0, 1.2e6):
                pairs = [
                    (jm.t_interhost(jp, io), tm.t_interhost(tp, io)),
                    (jm.t_io_per_actuation(jp.n_envs, io),
                     tm.t_io_per_actuation(tp.n_envs, io)),
                    (jm.t_episode(jp, io), tm.t_episode(tp, io)),
                    (jm.t_training(jp, 3000, io), tm.t_training(tp, 3000, io)),
                    (jm.speedup(jp, 3000, io_bytes=io),
                     tm.speedup(tp, 3000, io_bytes=io)),
                    (jm.efficiency(jp, 100, io_bytes=io),
                     tm.efficiency(tp, 100, io_bytes=io))]
                for a, b in pairs:
                    assert _close(a, b, REL_COST), (jp, io, a, b)
        for r in (1, 2, 3, 8, 64):
            assert _close(jm.t_step(r), tm.t_step(r), REL_COST)
            assert _close(jm.cfd_efficiency(r), tm.cfd_efficiency(r),
                          REL_COST)


@pytest.mark.parametrize("model", ["default", "paper", "comm-heavy"])
@pytest.mark.parametrize("max_processes", [1, 2, 4])
def test_optimize_plan_matches(calibrated, model, max_processes):
    jm, tm = {"default": (jplan.CostModel(), tplan.CostModel()),
              "paper": calibrated,
              "comm-heavy": (jplan.CostModel(serial_frac=0.0,
                                             comm_frac_log2=0.0,
                                             mgmt_log_s=500.0),
                             tplan.CostModel(serial_frac=0.0,
                                             comm_frac_log2=0.0,
                                             mgmt_log_s=500.0))}[model]
    picks = set()
    for n_total in range(1, 65):
        for io in (None, 0.0):
            ref = jplan.optimize_plan(n_total, jm, io_bytes=io,
                                      max_processes=max_processes)
            out = tplan.optimize_plan(n_total, tm, io_bytes=io,
                                      max_processes=max_processes)
            assert _fields(out) == _fields(ref), (n_total, io)
            picks.add(out.n_ranks)
    assert 1 in picks


def test_calibrate_to_paper_constants(calibrated):
    jm, tm = calibrated
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        assert _close(a, b, REL_FIT), (f.name, a, b)
    assert tm.t_step_1 != tplan.CostModel().t_step_1     # the fit moved it


@pytest.mark.parametrize("table", ["table1_rows", "table2_rows", "fig7_rows",
                                   "fig10_breakdown"])
def test_paper_tables_match(calibrated, table):
    jm, tm = calibrated
    ref = getattr(jsm, table)(jm)
    out = getattr(tsm, table)(tm)
    assert len(out) == len(ref) > 0
    for r, o in zip(ref, out):
        assert set(o) == set(r)
        for k, v in r.items():
            if isinstance(v, float):
                assert _close(v, o[k], REL_FIT), (table, k, v, o[k])
            else:
                assert o[k] == v, (table, k)


def _measured(ranks, estimated=True):
    """A fixed measurement dict (the artifact's ``measured`` fields)."""
    steps = {1: 4.1e-3, 2: 2.3e-3, 4: 1.5e-3, 8: 1.2e-3}
    return {
        "t_step_ranks": {r: steps[r] for r in ranks},
        "t_policy": 5.2e-4, "t_update": 0.3126,
        "io": {"bytes_per_episode_env": 20351.5,
               "bytes_per_actuation": 635.984375,
               "stream_bandwidth": 1.094e8, "write_seconds": 7.4e-4},
        "t_interhost": {"processes": 1 if estimated else 2,
                        "bytes": 81406.0, "seconds": 2.8e-4,
                        "bandwidth": 1e9 if estimated else 3.1e8,
                        "estimated": estimated},
    }


@pytest.mark.parametrize("ranks,estimated", [
    ((1,), True), ((1, 2), True), ((1, 2, 4, 8), True), ((1, 2, 4), False)])
def test_refit_cost_model_matches(ranks, estimated):
    m = _measured(ranks, estimated)
    ref = jat.refit_cost_model(m)
    out = tat.refit_cost_model(m)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(out, f.name)
        rel = REL_FIT if len(ranks) >= 3 else REL_COST
        assert _close(a, b, rel), (f.name, a, b)
    assert out.t_update == m["t_update"]
    assert (out.interhost_bandwidth == 3.1e8) == (not estimated)
