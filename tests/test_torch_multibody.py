"""Parity of the port's multi-body layer with the reference (repro, JAX):
the pinball and tandem geometries, per-body (vector) actuation through the
solver and the fused kernel's plain twin, the geometry bank, and pinball
and mixed cylinder+pinball(+tandem) env batches."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import env as jenv
from repro.cfd import grid as jgrid
from repro.cfd import solver as jsolver
from repro_torch._warn import reset_warning_caches
from repro_torch.cfd import env as tenv
from repro_torch.cfd import grid as tgrid
from repro_torch.cfd import solver as tsolver
from repro_torch.convert import flow_state_from_numpy, geom_arrays_from_numpy
from repro_torch.kernels.actuation import ops as tops
from tests._torch_parity import assert_close, max_diff, to_np
from tests.test_torch_solver import ATOL_CD, ATOL_P, ATOL_UV

GEOMETRIES = ("cylinder", "pinball", "tandem")


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res", [4, 6, 8])
@pytest.mark.parametrize("name", GEOMETRIES)
def test_geometry_identical_to_reference(res, name):
    """Every field of the multi-body build (the union chi, jets on the
    cylinder only, per-body rotary targets, their sum, the max of the
    masks, the ownership) and the probes, bit for bit."""
    gj = jgrid.build_geometry(jgrid.GridConfig(res=res), name)
    gt = tgrid.build_geometry(tgrid.GridConfig(res=res), name)
    assert len(tsolver.GeomArrays._fields) == 15
    for f in tsolver.GeomArrays._fields + ("probe_ij",):
        assert np.array_equal(getattr(gj, f), getattr(gt, f)), f
    assert gj.cell_volume == gt.cell_volume and gj.name == gt.name == name
    assert gj.n_bodies == gt.n_bodies == len(tgrid.GEOMETRIES[name])
    assert gt.rotb_u.shape[0] == gt.n_bodies
    ga_j = jsolver.geom_to_arrays(gj)
    ga_t = tsolver.geom_to_arrays(gt, "cpu")
    carried = geom_arrays_from_numpy([np.asarray(a) for a in ga_j],
                                     device="cpu")
    for f in tsolver.GeomArrays._fields:      # same order, same float32
        assert np.array_equal(np.asarray(getattr(ga_j, f)),
                              getattr(ga_t, f).numpy()), f
        assert torch.equal(getattr(carried, f), getattr(ga_t, f)), f


def test_registry_and_max_bodies_match():
    assert tgrid.geometry_names() == jgrid.geometry_names()
    assert tgrid.max_bodies() == jgrid.max_bodies() == 3
    for name in GEOMETRIES:
        assert tgrid.geometry_index(name) == jgrid.geometry_index(name)
        assert tgrid.GEOMETRIES[name] == tuple(
            tgrid.Body(b.x, b.y, b.r) for b in jgrid.GEOMETRIES[name])


def test_geom_arrays_from_numpy_field_counts():
    """The eleven single-field arrays (per-body fields absent) or all
    fifteen; any other count raises."""
    ga = jsolver.geom_to_arrays(jgrid.build_geometry(jgrid.GridConfig(res=4),
                                                     "pinball"))
    eleven = geom_arrays_from_numpy([np.asarray(a) for a in ga[:11]],
                                    device="cpu")
    assert eleven.rotb_u is None and eleven.own_v is None
    assert torch.equal(eleven.rmask_u, torch.tensor(np.asarray(ga.rmask_u)))
    with pytest.raises(ValueError, match="11 or 15"):
        geom_arrays_from_numpy([np.asarray(a) for a in ga[:12]],
                               device="cpu")


# ---------------------------------------------------------------------------
# solver: the per-body branch
# ---------------------------------------------------------------------------

# The pinball golden fixture's developed flow (res 8), stepped with 20 SOR
# pairs a dt to keep the reference's compile and the CPU time short.
GOLDEN = "tests/golden/pinball_re100_res8.npz"
CFG_J = jgrid.GridConfig(res=8, dt=0.01, poisson_iters=20)
CFG_T = tgrid.GridConfig(res=8, dt=0.01, poisson_iters=20)
SPEEDS = np.array([[0.6, -0.3, 0.1], [0.0, 1.0, 0.0]], np.float32)
# Per-body C_D / C_L of a developed flow: each is a sum over the cells a
# body owns, in another order in each package, so it agrees to float32
# rounding of the largest coefficient: 1e-5 of the largest |coefficient|
# of the call (a body's lift can be O(1e-3) beside drags of O(10)).
RTOL_BODY = 1e-5


@pytest.fixture(scope="module")
def pinball_flow():
    ref = np.load(GOLDEN)
    return tuple(ref[k].astype(np.float32) for k in "uvp")


def _geoms(name):
    return (jsolver.geom_to_arrays(jgrid.build_geometry(CFG_J, name)),
            tsolver.geom_to_arrays(tgrid.build_geometry(CFG_T, name), "cpu"))


def _check_bodies(ref, out, what):
    ref, out = to_np(ref), to_np(out)
    scale = np.abs(ref).max()
    assert np.all(np.abs(ref - out) <= RTOL_BODY * scale), (what, ref, out)


def test_pinball_per_body_step_matches_reference(pinball_flow):
    """Two envs at different per-body speeds (act_mode 1) in one batched
    step against the reference's step of each: u, v, p within the solver
    tolerances, each body's C_D / C_L within RTOL_BODY."""
    ga_j, ga_t = _geoms("pinball")
    flow = tsolver.FlowState(*(torch.tensor(np.stack([a, a]))
                               for a in pinball_flow))
    out, o_t = tsolver.step(CFG_T, ga_t, flow, torch.tensor(SPEEDS),
                            act_mode=torch.tensor([1.0, 1.0]))
    assert o_t.cd.shape == o_t.cl.shape == (2, 3)
    for i, speeds in enumerate(SPEEDS):
        ref, o_j = jsolver.step(CFG_J, ga_j, jsolver.FlowState(*pinball_flow),
                                jnp.asarray(speeds), act_mode=jnp.float32(1.0))
        for name, r, o, tol in zip("uvp", ref, out,
                                   (ATOL_UV, ATOL_UV, ATOL_P)):
            assert_close(r, o[i], tol, f"env {i} {name}")
        _check_bodies(o_j.cd, o_t.cd[i], f"env {i} cd")
        _check_bodies(o_j.cl, o_t.cl[i], f"env {i} cl")
    # the speeds act per body: the two envs' flows differ
    assert float((out.u[0] - out.u[1]).abs().max()) > 1e-6


def test_tandem_per_body_interval_matches_reference():
    """Tandem cylinders (two bodies) from an impulsive start, a 3-slot
    vector (the third slot meets no body), 3 dt: per-dt (3, 2) forces,
    held as the solver tests hold the scalar ones (the start's transient
    moves the lift from 0 to O(0.5) in two dt)."""
    ga_j, ga_t = _geoms("tandem")
    geom = jgrid.build_geometry(CFG_J, "tandem")
    st = tuple(np.asarray(a) for a in jsolver.init_state(CFG_J, geom))
    speeds = np.array([0.7, -0.4, 0.9], np.float32)
    ref, o_j = jsolver.step_interval(CFG_J, ga_j, jsolver.FlowState(*st),
                                     jnp.asarray(speeds), 3,
                                     act_mode=jnp.float32(1.0))
    out, o_t = tsolver.step_interval(CFG_T, ga_t,
                                     flow_state_from_numpy(*st, device="cpu"),
                                     torch.tensor(speeds), 3, act_mode=1.0)
    assert o_t.cd.shape == np.shape(o_j.cd) == (3, 2)
    for name, r, o, tol in zip("uvp", ref, out, (ATOL_UV, ATOL_UV, ATOL_P)):
        assert_close(r, o, tol, name)
    assert_close(o_j.cd, o_t.cd, ATOL_CD, "cd")
    assert_close(o_j.cl, o_t.cl, ATOL_CD, "cl")


def test_vector_action_matches_scalar_on_cylinder(pinball_flow):
    """A length-1 vector through the per-body branch reproduces the scalar
    rotary step to summation order, in the port as in the reference."""
    geom = tgrid.build_geometry(CFG_T)
    ga = tsolver.geom_to_arrays(geom, "cpu")
    st = tsolver.init_state(CFG_T, geom, "cpu")
    st_s, out_s = tsolver.step(CFG_T, ga, st, 0.7, act_mode=1.0)
    st_v, out_v = tsolver.step(CFG_T, ga, st, torch.tensor([0.7]),
                               act_mode=1.0)
    assert out_v.cd.shape == (1,)
    assert_close(st_s.u, st_v.u, 1e-5, "u")
    assert abs(float(out_s.cd) - float(out_v.cd.sum())) <= 1e-5 * abs(
        float(out_s.cd))
    ga_j = jsolver.geom_to_arrays(jgrid.build_geometry(CFG_J))
    ref, o_j = jsolver.step(CFG_J, ga_j,
                            jsolver.init_state(CFG_J, jgrid.build_geometry(
                                CFG_J)),
                            jnp.array([0.7], jnp.float32),
                            act_mode=jnp.float32(1.0))
    for name, r, o, tol in zip("uvp", ref, st_v, (ATOL_UV, ATOL_UV, ATOL_P)):
        assert_close(r, o, tol, name)
    _check_bodies(o_j.cd, out_v.cd, "cd")


def test_vector_without_per_body_fields_raises(pinball_flow):
    _, ga_t = _geoms("pinball")
    flow = flow_state_from_numpy(*pinball_flow, device="cpu")
    eleven = tsolver.GeomArrays(*ga_t[:11])
    with pytest.raises(ValueError, match="per-body"):
        tsolver.step(CFG_T, eleven, flow, torch.tensor([0.5, 0.0, 0.0]),
                     act_mode=1.0)


def test_bank_gather_equals_each_geometry_alone():
    """A batch reading its geometries from the padded bank steps each env
    exactly as that geometry alone does (padded bodies are zero)."""
    names = tgrid.geometry_names()
    gas = [tsolver.geom_to_arrays(tgrid.build_geometry(CFG_T, n), "cpu")
           for n in names]
    bank = tsolver.geometry_bank(gas, tgrid.max_bodies())
    assert bank.rotb_u.shape[:2] == (len(names), 3)
    flows = [tsolver.init_state(CFG_T, tgrid.build_geometry(CFG_T, n), "cpu")
             for n in names]
    flow = tsolver.FlowState(*(torch.stack(xs) for xs in zip(*flows)))
    speeds = torch.tensor([[0.4, 0.0, 0.0], [0.6, -0.3, 0.1],
                           [-0.5, 0.8, 0.0]])
    mode = torch.tensor([0.0, 1.0, 1.0])
    out, o = tsolver.step_interval(CFG_T, bank, flow, speeds, 2,
                                   act_mode=mode, backend="reference",
                                   geom_id=torch.arange(3))
    assert o.cd.shape == (3, 2, 3)
    for i, ga in enumerate(gas):
        alone, oa = tsolver.step_interval(CFG_T, ga, flows[i], speeds[i], 2,
                                          act_mode=float(mode[i]),
                                          backend="reference")
        for a, b in zip(alone, out):
            assert torch.equal(a, b[i]), names[i]
        nb = len(tgrid.GEOMETRIES[names[i]])
        assert torch.equal(oa.cd, o.cd[i, :, :nb])
        assert int(torch.count_nonzero(o.cd[i, :, nb:])) == 0


# ---------------------------------------------------------------------------
# the fused kernel's plain twin on a per-body amplitude
# ---------------------------------------------------------------------------

def test_fused_twin_per_body_matches_reference_fallback(pinball_flow,
                                                        monkeypatch):
    """On a CPU state backend="fused" runs the plain twin with a vector
    amplitude: no warning, no reference loop.  It is held against the
    reference's own fallback (its megakernel is scalar-only and warns)
    and against the port's reference loop."""
    ga_j, ga_t = _geoms("pinball")
    flow = flow_state_from_numpy(*pinball_flow, device="cpu")
    speeds = SPEEDS[0]
    loops = []
    real_step = tsolver.step
    with monkeypatch.context() as mp:
        mp.setattr(tsolver, "step",
                   lambda *a, **k: loops.append(1) or real_step(*a, **k))
        reset_warning_caches()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out, o_t = tsolver.step_interval(
                CFG_T, ga_t, flow, torch.tensor(speeds), 4, act_mode=1.0,
                backend="fused")
    assert not loops                  # the twin, not the reference loop
    assert o_t.cd.shape == (4, 3)
    with pytest.warns(RuntimeWarning, match="per-body"):
        ref, o_j = jsolver.step_interval(
            CFG_J, ga_j, jsolver.FlowState(*pinball_flow),
            jnp.asarray(speeds), 4, act_mode=jnp.float32(1.0),
            backend="fused")
    for name, r, o, tol in zip("uvp", ref, out, (ATOL_UV, ATOL_UV, ATOL_P)):
        assert_close(r, o, tol, name)
    _check_bodies(o_j.cd, o_t.cd, "cd")
    _check_bodies(o_j.cl, o_t.cl, "cl")
    loop, o_l = tsolver.step_interval(CFG_T, ga_t, flow,
                                      torch.tensor(speeds), 4, act_mode=1.0,
                                      backend="reference")
    for name, r, o, tol in zip("uvp", loop, out, (ATOL_UV, ATOL_UV, ATOL_P)):
        assert_close(r, o, tol, f"port loop {name}")
    _check_bodies(o_l.cd, o_t.cd, "port loop cd")


def test_fused_twin_bank_batch_equals_reference_loop():
    """A mixed bank batch through the twin (``geom_id``) against the port's
    reference loop on the same bank: the same iteration."""
    names = tgrid.geometry_names()
    bank = tsolver.geometry_bank(
        [tsolver.geom_to_arrays(tgrid.build_geometry(CFG_T, n), "cpu")
         for n in names], tgrid.max_bodies())
    flows = [tsolver.init_state(CFG_T, tgrid.build_geometry(CFG_T, n), "cpu")
             for n in ("pinball", "cylinder", "tandem", "pinball")]
    flow = tsolver.FlowState(*(torch.stack(xs) for xs in zip(*flows)))
    gid = torch.tensor([names.index(n) for n in
                        ("pinball", "cylinder", "tandem", "pinball")])
    speeds = torch.tensor([[0.6, -0.3, 0.1], [0.3, 0.0, 0.0],
                           [-0.5, 0.8, 0.0], [1.0, 0.2, -0.7]])
    mode = torch.tensor([1.0, 0.0, 1.0, 1.0])
    a, oa = tops.fused_interval(CFG_T, bank, flow, speeds, 3, act_mode=mode,
                                geom_id=gid)
    b, ob = tsolver.step_interval(CFG_T, bank, flow, speeds, 3,
                                  act_mode=mode, backend="reference",
                                  geom_id=gid)
    assert oa.cd.shape == (4, 3, 3)
    for x, y in zip((*a, oa.cd, oa.cl), (*b, ob.cd, ob.cl)):
        assert max_diff(y, x)[0] <= 1e-5


# ---------------------------------------------------------------------------
# env: pinball-native and mixed-geometry batches
# ---------------------------------------------------------------------------

ENV_GRID = dict(res=5, dt=0.015, poisson_iters=20)
ENV_KW = dict(steps_per_action=4, actions_per_episode=3, warmup_time=1.0)
# The pinball's warmup starts impulsively, with drags of O(30): float32
# rounding in another order per package leaves C_D0 and the flow ~1e-5
# relative apart after its 67 dt.  The reward is C_D0 - <C_D> - 0.1
# sum|<C_L>|, a difference of such terms, so rewards are held to 1e-4 of
# C_D0 and drags to 1e-4 of themselves; probes (O(1-10)) to 2e-3.
RTOL_ENV, ATOL_OBS = 1e-4, 2e-3


@pytest.fixture(scope="module")
def envs():
    """Reference (its default backend) and port (fused -> the plain twin)
    envs on the cylinder config and on the pinball scenario."""
    gj, gt = jgrid.GridConfig(**ENV_GRID), tgrid.GridConfig(**ENV_GRID)
    return {
        "cyl": (jenv.CylinderEnv(jenv.EnvConfig(grid=gj, **ENV_KW)),
                tenv.CylinderEnv(tenv.EnvConfig(grid=gt, **ENV_KW),
                                 backend="fused", device="cpu")),
        "pinball": (jenv.CylinderEnv(jenv.EnvConfig.for_scenario(
                        "pinball_re100", grid=gj, **ENV_KW)),
                    tenv.CylinderEnv(tenv.EnvConfig.for_scenario(
                        "pinball_re100", grid=gt, **ENV_KW),
                        backend="fused", device="cpu"))}


def _hold_steps(ej_step, st_j, et, st_t, actions, cd0):
    for _ in range(3):
        st_j, out_j = ej_step(st_j, jnp.asarray(actions))
        st_t, out_t = et.env_step(st_t, torch.tensor(actions))
        for f, scale in (("reward", np.abs(to_np(cd0))),
                         ("cd", np.abs(np.asarray(out_j.cd)))):
            err = np.abs(np.asarray(getattr(out_j, f))
                         - to_np(getattr(out_t, f)))
            assert np.all(err <= RTOL_ENV * scale), (f, err, scale)
        assert_close(out_j.obs, out_t.obs, ATOL_OBS, "obs")
        assert_close(st_j.jet_vel, st_t.jet_vel, 1e-6, "jet_vel")
    return st_t, out_t


def test_pinball_env_matches_reference(envs):
    ej, et = envs["pinball"]
    assert et.cfg.obs_dim == ej.cfg.obs_dim == 59
    assert et.cfg.act_dim == ej.cfg.act_dim == 3
    st_j, obs_j = ej.reset()
    st_t, obs_t = et.reset()
    assert obs_t.shape == (59,) and st_t.jet_vel.shape == (3,)
    assert abs(et.cfg.cd0 - ej.cfg.cd0) <= RTOL_ENV * abs(ej.cfg.cd0)
    assert_close(obs_j, obs_t, ATOL_OBS, "obs")
    st_t, out = _hold_steps(ej.env_step, st_j, et, st_t,
                            np.array([0.6, -0.3, 0.1], np.float32),
                            ej.cfg.cd0)
    assert float(out.valid) == 1.0 and int(st_t.t) == 3


@pytest.mark.parametrize("scenarios", [
    ("cyl_re100", "pinball_re100"),
    ("cyl_re100", "pinball_re100", "tandem_re100")])
def test_mixed_batch_matches_reference(envs, scenarios):
    """A mixed reset_batch: padded obs and action widths, per-env C_D0, and
    rewards over 3 steps, against the reference's vmapped program."""
    ej, et = envs["cyl"]
    n = len(scenarios)
    st_j, obs_j = ej.reset_batch(list(scenarios), n)
    st_t, obs_t = et.reset_batch(list(scenarios), n)
    assert obs_t.shape == (n, 149) and st_t.jet_vel.shape == (n, 3)
    assert_close(obs_j, obs_t, ATOL_OBS, "obs")
    cd0_j = np.asarray(st_j.scn.cd0)
    assert np.all(np.abs(cd0_j - to_np(st_t.scn.cd0))
                  <= RTOL_ENV * np.abs(cd0_j))
    for f in ("geom_id", "act_mask", "probe_mask", "act_mode"):
        assert np.array_equal(np.asarray(getattr(st_j.scn, f)),
                              to_np(getattr(st_t.scn, f))), f
    actions = np.array([[0.2, 0.5, -0.5], [0.6, -0.3, 0.1],
                        [-0.4, 0.7, 0.3]], np.float32)[:n]
    _hold_steps(jax.jit(jax.vmap(ej.env_step)), st_j, et, st_t, actions,
                cd0_j)


def test_cylinder_masked_action_slots_are_inert(envs):
    """Garbage in the cylinder env's padded action slots changes nothing
    of it, bit for bit."""
    _, et = envs["cyl"]
    outs = []
    for junk in (0.0, 99.0):
        st, _ = et.reset_batch(["cyl_re100", "pinball_re100"], 2)
        acts = torch.tensor([[0.4, junk, -junk], [0.4, 0.2, -0.2]])
        st, out = et.env_step(st, acts)
        outs.append((st, out))
    (st_a, out_a), (st_b, out_b) = outs
    for f in ("reward", "cd", "cl", "obs"):
        assert torch.equal(getattr(out_a, f)[0], getattr(out_b, f)[0]), f
    assert torch.equal(st_a.flow.u[0], st_b.flow.u[0])
    assert torch.equal(st_a.jet_vel, st_b.jet_vel)
    assert float(st_a.jet_vel[0, 1:].abs().max()) == 0.0


def test_cylinder_only_batch_keeps_scalar_amplitude(envs):
    _, et = envs["cyl"]
    st, obs = et.reset_batch(["cyl_re100", "cyl_re200"], 2)
    assert st.jet_vel.shape == (2,) and obs.shape == (2, 149)
    _, out = et.env_step(st, torch.tensor([0.3, -0.3]))
    assert out.cd.shape == (2,) and torch.isfinite(out.reward).all()


def test_scalar_batch_over_the_bank_matches_a_cylinder_env(envs):
    """A pinball env's cylinder-only batch: the scalar amplitude over the
    bank, each env's geometry gathered by ``geom_id``, steps exactly as the
    cylinder env's own batch does."""
    _, ep = envs["pinball"]
    _, ec = envs["cyl"]
    st_p, obs_p = ep.reset_batch(["cyl_re100", "cyl_re200"], 2)
    st_c, obs_c = ec.reset_batch(["cyl_re100", "cyl_re200"], 2)
    assert ep._bank is not None and st_p.jet_vel.shape == (2,)
    assert torch.equal(obs_p, obs_c)
    acts = torch.tensor([0.5, -0.7])
    _, out_p = ep.env_step(st_p, acts)
    _, out_c = ec.env_step(st_c, acts)
    for f in ("reward", "cd", "cl", "obs"):
        assert torch.equal(getattr(out_p, f), getattr(out_c, f)), f


def test_obs_aux_exposes_mixed_layouts(envs):
    _, et = envs["cyl"]
    st, _ = et.reset_batch(["cyl_re100", "pinball_re100"], 2)
    aux = et.obs_aux(st)
    assert aux["xy"].shape == (2, 149, 2) and aux["mask"].shape == (2, 149)
    assert aux["mask"].sum(dim=1).tolist() == [149.0, 59.0]
    assert float(aux["xy"].abs().max()) <= 1.0


# ---------------------------------------------------------------------------
# the per-body kernel's wrapper, as far as it runs without a card
# ---------------------------------------------------------------------------

def test_per_body_kernel_budget():
    """The per-body instantiation's shared memory: the scalar one's plus
    its 2 NB + 1 partial sums (8 slots) and their reduction slots (232),
    in place of 4 and 128; it serves the same grids (res <= 38) on the
    card, and a CPU state takes the twin."""
    res16, res38, res48 = (tgrid.GridConfig(res=r) for r in (16, 38, 48))
    nb = tops.N_BODIES
    assert nb == tgrid.max_bodies() == 3
    assert tops.scratch_floats() == 136 and tops.scratch_floats(nb) == 244
    assert tops.smem_bytes(res16.ny, res16.nx, 16, nb) == (
        tops.smem_bytes(res16.ny, res16.nx, 16) + 4 * (244 - 136))
    assert tops.select_tier(res38, "cuda", nb) == "cuda"
    with pytest.raises(ValueError, match="shared memory"):
        tops.select_tier(res48, "cuda", nb)
    assert tops.select_tier(res48, "cpu", nb) == "plain"


def test_per_body_launch_operands():
    """What fused_interval_cuda hands the per-body instantiation: a
    geometry without a bank becomes a bank of one, its bodies padded with
    zero planes to N_BODIES; a bank keeps its G geometries and takes each
    env's int32 index; amplitudes are padded or cut to N_BODIES."""
    ga = tsolver.geom_to_arrays(tgrid.build_geometry(CFG_T, "tandem"), "cpu")
    fields, gid, nb = tops._bank(ga, None, 2, "cpu")
    assert nb == 2 and len(fields) == 15
    assert fields[0].shape == (1,) + tuple(ga.chi_u.shape)
    assert fields[11].shape == (1, 3) + tuple(ga.rotb_u.shape[1:])
    assert torch.equal(fields[11][0, :2], ga.rotb_u)
    assert int(torch.count_nonzero(fields[13][0, 2])) == 0
    assert gid.dtype == torch.int32 and gid.tolist() == [0, 0]
    bank = tsolver.geometry_bank(
        [tsolver.geom_to_arrays(tgrid.build_geometry(CFG_T, n), "cpu")
         for n in tgrid.geometry_names()], 3)
    fields, gid, nb = tops._bank(bank, torch.tensor([2, 0, 1]), 3, "cpu")
    assert nb == 3 and fields[0].shape[0] == 3 and gid.tolist() == [2, 0, 1]
    assert all(f.is_contiguous() for f in fields)
    assert tops._amplitudes(torch.tensor([0.5, -1.0]), 1, "cpu").tolist() \
        == [[0.5, -1.0, 0.0]]
    assert tops._amplitudes(torch.ones(2, 4), 2, "cpu").shape == (2, 3)
    with pytest.raises(ValueError, match="per-body geometry fields"):
        tops._bank(tsolver.GeomArrays(*ga[:11]), None, 1, "cpu")
