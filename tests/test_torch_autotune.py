"""The port's autotuner on one device: plan resolution and its errors, the
backend rules, multi-rank plans resolved to the halo backend as the
reference's, fleet plans resolved as the reference's, a measured
``smoke=True`` autotune on the CPU whose artifact validates under both
packages' ``validate_artifact`` (and the reference's under the port's),
and damaged artifacts refused by both."""
import copy
import json

import pytest
import torch

from repro.cfd.grid import GridConfig as JGridConfig
from repro.core import autotune as jat
from repro.core.plan import ParallelPlan as JParallelPlan
from repro_torch.cfd.grid import GridConfig
from repro_torch.core import autotune as tat
from repro_torch.core.plan import CostModel, ParallelPlan
from repro_torch.drl.engine import EngineConfig, RolloutEngine
from tests import _torch_parity  # noqa: F401  (one thread, TF32 off)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("autotune")
    port = tat.autotune(grid=GridConfig(res=6), smoke=True, device="cpu",
                        artifact=str(d / "port.json"))
    ref = jat.autotune(grid=JGridConfig(res=6), smoke=True,
                       artifact=str(d / "ref.json"))
    return dict(port=port, ref=ref,
                port_record=json.loads((d / "port.json").read_text()),
                ref_record=json.loads((d / "ref.json").read_text()))


def test_resolve_explicit_plans():
    rp = tat.resolve_plan(ParallelPlan(4, 4, 1), device="cpu")
    assert isinstance(rp, tat.ResolvedPlan)
    assert (rp.source, rp.backend, rp.layout) == ("explicit", "reference",
                                                  "packed")
    assert rp.mesh_shape == (4, 1) and rp.n_processes == 1
    assert tat.resolve_plan((3, 1), device="cpu").plan == \
        ParallelPlan(3, 3, 1)
    assert tat.resolve_plan((2, 1), n_total=5, device="cpu").plan == \
        ParallelPlan(5, 2, 1)
    assert tat.resolve_plan(rp) is rp
    # the grid decides "pallas" on the card, as the reference does on a TPU
    on_card = tat.resolve_plan((1, 1), grid=GridConfig(res=6))
    assert on_card.backend == "pallas"
    assert "plan[explicit]: n_envs x n_ranks = 1 x 1" in on_card.describe()


@pytest.mark.parametrize("spec,match", [
    ("fastest", "unknown plan spec"), (3.14, "cannot resolve plan"),
    ((4, 2, 1), "too many values|not enough values|unpack")])
def test_resolve_rejects(spec, match):
    with pytest.raises(ValueError, match=match):
        tat.resolve_plan(spec, device="cpu")


@pytest.mark.parametrize("nx,device,want", [
    (88, "cpu", "reference"), (88, "cuda", "pallas"),
    (87, "cuda", "reference"), (None, "cuda", "reference")])
def test_default_backend(nx, device, want):
    assert tat.default_backend(1, nx, device) == want
    if device == "cpu":        # the reference off a TPU
        assert jat.default_backend(1, nx) == want


def _resolves_to_halo(plan, jplan):
    rp, ref = tat.resolve_plan(plan, device="cpu"), jat.resolve_plan(jplan)
    assert (rp.backend, ref.backend) == ("halo", "halo")
    assert rp.describe() == ref.describe()


def _engine_with_two_ranks():
    eng = RolloutEngine(None, EngineConfig(n_envs=2, horizon=3, n_ranks=2),
                        device="cpu")
    assert eng.cfg.n_ranks == 2 and eng.mesh is None


def _engine_plan_needs_two_workers(mp):
    """On one device the plan's mesh refuses, with the reference's
    ValueError; two forced workers on the CPU run it."""
    from repro.drl import engine as jengine
    for make in (lambda: RolloutEngine(None, EngineConfig(
            n_envs=2, horizon=3, plan=(1, 2)), device="cpu"),
                 lambda: jengine.RolloutEngine(None, jengine.EngineConfig(
                     n_envs=2, horizon=3, plan=(1, 2)))):
        with pytest.raises(ValueError, match=r"plan needs n_envs \* n_ranks "
                                             r"= 2 devices but this host "
                                             r"has 1"):
            make()
    mp.setenv(tat.FORCE_DEVICE_COUNT, "2")
    eng = RolloutEngine(None, EngineConfig(n_envs=2, horizon=3, plan=(1, 2)),
                        device="cpu")
    assert eng.cfg.n_ranks == 2 and eng.resolved_plan.backend == "halo"
    assert dict(eng.mesh.shape) == {"data": 1, "model": 2}


@pytest.mark.parametrize("make", [
    lambda mp: _equal(tat.default_backend(2, 88), "halo",
                      jat.default_backend(2, 88)),
    lambda mp: _resolves_to_halo(ParallelPlan(4, 2, 2),
                                 JParallelPlan(4, 2, 2)),
    lambda mp: _resolves_to_halo((1, 4), (1, 4)),
    lambda mp: _engine_with_two_ranks(),
    lambda mp: _engine_plan_needs_two_workers(mp)])
def test_multi_rank_plans_raise_naming_the_halo_backend(make, monkeypatch):
    """Multi-rank plans resolve to the halo backend (``cfd/decomp.py``) as
    the reference's do, and an engine adopts their n_ranks; the only
    refusal left is the reference's, a plan needing more devices than the
    host has."""
    make(monkeypatch)


def _equal(*values):
    assert len(set(values)) == 1, values


def test_fleet_plans_resolve_as_the_reference():
    """A fleet plan (n_processes > 1) resolves like the reference's; outside
    a fleet its 4 workers need 4 devices, and one device refuses it as the
    reference's mesh does."""
    rp = tat.resolve_plan(ParallelPlan(4, 4, 1, 2), device="cpu")
    ref = jat.resolve_plan(JParallelPlan(4, 4, 1, 2))
    assert rp.n_processes == ref.n_processes == 2
    assert (rp.backend, rp.source) == (ref.backend, ref.source)
    assert rp.describe() == ref.describe()
    for build in (lambda: rp.build_mesh("cpu"), ref.build_mesh):
        with pytest.raises(ValueError, match="devices but this host has 1"):
            build()


def test_build_mesh_counts_devices():
    one = tat.resolve_plan((1, 1), device="cpu")
    assert one.build_mesh("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match=r"plan needs n_envs \* n_ranks = 2 "
                                         r"devices but this host has 1"):
        tat.resolve_plan((2, 1), device="cpu").build_mesh("cpu")
    with pytest.raises(ValueError, match="devices but this host has 1"):
        RolloutEngine(None, EngineConfig(n_envs=2, horizon=3, plan=(2, 1)),
                      device="cpu")
    engine = RolloutEngine(None, EngineConfig(n_envs=2, horizon=3,
                                              plan=(1, 1)), device="cpu")
    assert engine.resolved_plan.backend == "reference"
    assert engine.cfg.n_ranks == 1


def test_candidate_ranks_match():
    for n_total in range(1, 17):
        for nx in (87, 88, 352):
            for n_dev in (1, 2, 8):
                assert tat.candidate_ranks(n_total, nx, n_dev) == \
                    jat.candidate_ranks(n_total, nx, n_dev)


def test_autotune_asked_for_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tat.autotune(grid=GridConfig(res=6), smoke=True)


def test_smoke_autotune_picks_a_single_rank_plan(artifacts):
    rp, rec = artifacts["port"], artifacts["port_record"]
    assert rp.source == "auto" and rp.plan == ParallelPlan(1, 1, 1)
    assert rp.backend in ("packed", "full", "fused")
    assert rec["plan"]["backend"] == rp.backend
    assert rec["plan"]["layout"] == rp.layout
    m = rec["measured"]
    assert m["device"] == {"type": "cpu", "count": 1, "name": "cpu"}
    assert set(m["t_step_ranks"]) == {"1"}
    assert m["t_step_backends"] == {"1": "reference"}
    assert set(m["t_interval_backends"]) == {"reference", "fused"}
    assert m["interval_probe_steps"] == tat.INTERVAL_PROBE_STEPS == \
        jat.INTERVAL_PROBE_STEPS
    assert all(v > 0 for v in m["t_poisson_layouts"].values())
    assert m["t_interhost"]["estimated"] is True
    assert rp.model.t_update == m["t_update"]
    assert rp.model.t_step_1 == m["t_step_ranks"]["1"]
    # the measured record holds the same fields as the reference's
    ref = artifacts["ref_record"]
    assert set(rec) == set(ref)
    assert set(rec["plan"]) == set(ref["plan"])
    assert set(ref["measured"]) <= set(m)


@pytest.mark.parametrize("side", ["port", "ref"])
def test_artifact_validates_in_both_packages(artifacts, side):
    rec = artifacts[f"{side}_record"]
    assert rec["schema"] == tat.AUTOTUNE_SCHEMA == jat.AUTOTUNE_SCHEMA
    tat.validate_artifact(rec)
    jat.validate_artifact(rec)


def _drop(path):
    def corrupt(rec):
        node = rec
        for k in path[:-1]:
            node = node[k]
        del node[path[-1]]
    return corrupt


@pytest.mark.parametrize("corrupt,match", [
    (lambda r: r.update(schema="repro.autotune/v3"), "bad schema tag"),
    (_drop(("fitted",)), "artifact missing 'fitted'"),
    (_drop(("measured", "t_interval_backends")),
     "artifact.measured missing 't_interval_backends'"),
    (_drop(("plan", "layout")), "artifact.plan missing 'layout'"),
    (lambda r: r["plan"].update(n_envs=2), "over-subscribed plan"),
    (lambda r: r.update(candidates=[]), "no candidate plans")])
@pytest.mark.parametrize("side", ["port", "ref"])
def test_damaged_artifacts_refused_by_both(artifacts, side, corrupt, match):
    rec = copy.deepcopy(artifacts[f"{side}_record"])
    corrupt(rec)
    for validate in (tat.validate_artifact, jat.validate_artifact):
        with pytest.raises(ValueError, match=match):
            validate(rec)


def test_refit_of_the_port_measurement_matches_the_reference(artifacts):
    m = artifacts["port_record"]["measured"]
    assert tat.refit_cost_model(m) == \
        CostModel(**vars(jat.refit_cost_model(m)))
