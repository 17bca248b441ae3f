"""Parity of the port's solver layer (repro_torch.cfd.grid/solver and the
fused-interval kernel's plain twin) with the reference (repro, JAX)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import grid as jgrid
from repro.cfd import solver as jsolver
from repro.kernels.actuation import ops as jops
from repro_torch._warn import reset_warning_caches
from repro_torch.cfd import grid as tgrid
from repro_torch.cfd import solver as tsolver
from repro_torch.convert import flow_state_from_numpy, geom_arrays_from_numpy
from repro_torch.kernels.actuation import ops as tops
from tests._torch_parity import assert_close

CFG_J = jgrid.GridConfig(res=6, dt=0.01, poisson_iters=16)
CFG_T = tgrid.GridConfig(res=6, dt=0.01, poisson_iters=16)

# Tolerances.  u, v are O(1); p is O(1-10); C_D is O(5).  Both sides are
# float32; they differ by where rounding happens (XLA fuses and may
# contract a*b+c, PyTorch rounds op by op) and by the order of the force
# sums.  Over a few dt those ulp-level differences stay ~1e-6 in u, v and
# ~1e-5 in p (a 16-pair SOR leaves the smoothest modes least converged,
# and there the two roundings differ most) -> 1e-5 / 1e-4 / 1e-4.
ATOL_UV, ATOL_P, ATOL_CD = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def developed():
    """A mildly developed flow on the res-6 grid, as numpy."""
    geom = jgrid.build_geometry(CFG_J)
    ga = jsolver.geom_to_arrays(geom)
    st = jsolver.init_state(CFG_J, geom)
    st, _ = jax.jit(lambda s: jsolver.step_interval(
        CFG_J, ga, s, jnp.float32(0.0), 20, backend="reference"))(st)
    return ga, tuple(np.asarray(a) for a in st)


@pytest.fixture(scope="module")
def ga_t():
    return tsolver.geom_to_arrays(tgrid.build_geometry(CFG_T), "cpu")


def _flow(st):
    return flow_state_from_numpy(*st, device="cpu")


def _check_flow(ref_flow, out_flow, what):
    for name, r, o, tol in zip("uvp", ref_flow, out_flow,
                               (ATOL_UV, ATOL_UV, ATOL_P)):
        assert_close(r, o, tol, f"{what} {name}")


@pytest.mark.parametrize("res", [4, 6, 8])
def test_geometry_identical_to_reference(res):
    """The port's own numpy copy builds the same masks, bit for bit."""
    gj = jgrid.build_geometry(jgrid.GridConfig(res=res))
    gt = tgrid.build_geometry(tgrid.GridConfig(res=res))
    for f in tsolver.GeomArrays._fields + ("probe_ij",):
        assert np.array_equal(getattr(gj, f), getattr(gt, f)), f
    assert gj.cell_volume == gt.cell_volume
    ga_j = jsolver.geom_to_arrays(gj)
    ga_t = tsolver.geom_to_arrays(gt, "cpu")
    carried = geom_arrays_from_numpy([np.asarray(a) for a in ga_j
                                      if a is not None], device="cpu")
    for f in tsolver.GeomArrays._fields:     # same order, same float32
        assert np.array_equal(np.asarray(getattr(ga_j, f)),
                              getattr(ga_t, f).numpy()), f
        assert torch.equal(getattr(carried, f), getattr(ga_t, f)), f


def test_grid_config_and_probes_match():
    for res in (4, 6, 8, 16):
        cj, ct = jgrid.GridConfig(res=res), tgrid.GridConfig(res=res)
        assert (cj.nx, cj.ny, cj.dx, cj.dy) == (ct.nx, ct.ny, ct.dx, ct.dy)
    assert np.array_equal(jgrid.probe_positions(), tgrid.probe_positions())
    y = np.linspace(-2.0, 2.0, 9)
    assert np.array_equal(jgrid.inlet_profile(CFG_J, y),
                          tgrid.inlet_profile(CFG_T, y))


def test_init_state_matches(developed):
    geom_j, geom_t = jgrid.build_geometry(CFG_J), tgrid.build_geometry(CFG_T)
    for r, o in zip(jsolver.init_state(CFG_J, geom_j),
                    tsolver.init_state(CFG_T, geom_t, "cpu")):
        assert np.array_equal(np.asarray(r), o.numpy())


@pytest.mark.parametrize("act_mode", [None, 0.0, 1.0])
def test_step_matches_reference(developed, ga_t, act_mode):
    ga, st = developed
    mode_j = None if act_mode is None else jnp.float32(act_mode)
    ref, out_j = jsolver.step(CFG_J, ga, jsolver.FlowState(*st),
                              jnp.float32(0.4), act_mode=mode_j)
    out, out_t = tsolver.step(CFG_T, ga_t, _flow(st), 0.4,
                              act_mode=act_mode)
    _check_flow(ref, out, "step")
    assert_close(out_j.cd, out_t.cd, ATOL_CD, "cd")
    assert_close(out_j.cl, out_t.cl, ATOL_CD, "cl")


def test_momentum_force_from_predictor(developed, ga_t):
    """The force contract: fx/fy measure the penalization against the
    predictor, before BCs; matches the reference's _momentum outputs."""
    ga, st = developed
    ref = jsolver._momentum(CFG_J, ga, jnp.asarray(st[0]),
                            jnp.asarray(st[1]), jnp.float32(0.2),
                            CFG_J.re, jnp.float32(0.0))
    out = tsolver._momentum(CFG_T, ga_t, torch.tensor(st[0]),
                            torch.tensor(st[1]), 0.2, CFG_T.re, 0.0)
    for name, r, o, tol in zip(("u_bc", "v_bc", "fx", "fy"), ref, out,
                               (ATOL_UV, ATOL_UV, ATOL_CD, ATOL_CD)):
        assert_close(r, o, tol, name)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_step_interval_matches_reference(developed, ga_t, backend):
    ga, st = developed
    ref, outs_j = jsolver.step_interval(CFG_J, ga, jsolver.FlowState(*st),
                                        jnp.float32(-0.3), 3,
                                        backend=backend)
    out, outs_t = tsolver.step_interval(CFG_T, ga_t,
                                        _flow(st), -0.3, 3,
                                        backend=backend)
    _check_flow(ref, out, backend)
    assert outs_t.cd.shape == (3,)
    assert_close(outs_j.cd, outs_t.cd, ATOL_CD, "cd")


@pytest.mark.parametrize("act_mode", [None, 1.0])
def test_fused_twin_matches_reference_jnp_tier(developed, ga_t, act_mode):
    """Jets (act_mode=None -> the 0.0 blend) and rotary (act_mode=1)."""
    ga, st = developed
    mode_j = None if act_mode is None else jnp.float32(act_mode)
    ref, outs_j = jops.fused_interval(CFG_J, ga, jsolver.FlowState(*st),
                                      jnp.float32(0.5), 4, act_mode=mode_j,
                                      tier="jnp")
    out, outs_t = tops.fused_interval(CFG_T, ga_t, _flow(st),
                                      0.5, 4, act_mode=act_mode)
    _check_flow(ref, out, "fused")
    assert_close(outs_j.cd, outs_t.cd, ATOL_CD, "cd")
    assert_close(outs_j.cl, outs_t.cl, ATOL_CD, "cl")


def test_fused_twin_matches_reference_pallas_tier(developed, ga_t):
    """Against the Pallas megakernel itself, run in interpret mode."""
    ga, st = developed
    ref, outs_j = jops.fused_interval(CFG_J, ga, jsolver.FlowState(*st),
                                      jnp.float32(0.5), 2,
                                      act_mode=jnp.float32(0.0),
                                      tier="pallas")
    out, outs_t = tops.fused_interval(CFG_T, ga_t, _flow(st),
                                      0.5, 2, act_mode=0.0)
    _check_flow(ref, out, "fused vs pallas")
    assert_close(outs_j.cd, outs_t.cd, ATOL_CD, "cd")


def test_fused_twin_batched_mixed_envs(developed, ga_t):
    """A batch with per-env jet/Re/act_mode equals each env run alone."""
    _, st = developed
    flow = _flow(st)
    batch = tsolver.FlowState(*(torch.stack([a, a, a]) for a in flow))
    jet = torch.tensor([0.5, -0.2, 0.1])
    re = torch.tensor([100.0, 200.0, 100.0])
    mode = torch.tensor([0.0, 0.0, 1.0])
    out, outs = tops.fused_interval(CFG_T, ga_t, batch, jet, 2, re=re,
                                    act_mode=mode)
    assert outs.cd.shape == (3, 2)
    for i in range(3):
        alone, o = tops.fused_interval(CFG_T, ga_t, flow, float(jet[i]), 2,
                                       re=float(re[i]),
                                       act_mode=float(mode[i]))
        _check_flow(alone, [a[i] for a in out], f"env {i}")
        assert_close(o.cd, outs.cd[i], ATOL_CD, "cd")


def test_fused_plain_equals_reference_loop(developed, ga_t):
    """The fused twin and the port's own reference loop are the same
    iteration (packed SOR, same polish) on an even grid."""
    _, st = developed
    flow = _flow(st)
    a, oa = tops.fused_interval(CFG_T, ga_t, flow, 0.3, 3)
    b, ob = tsolver.step_interval(CFG_T, ga_t, flow, 0.3, 3,
                                  act_mode=0.0, backend="reference")
    _check_flow(b, a, "plain vs reference")
    assert_close(ob.cd, oa.cd, ATOL_CD, "cd")


def test_select_tier_and_budget(monkeypatch):
    """A CUDA state the kernel cannot serve raises: the card never runs the
    plain loop in the kernel's place.  A CPU state ignores the budget."""
    reset_warning_caches()
    res16, res32 = tgrid.GridConfig(res=16), tgrid.GridConfig(res=32)
    assert tops.select_tier(CFG_T, "cpu") == "plain"
    assert tops.select_tier(res16, "cuda") == "cuda"
    # 66 rows in 16 bands of 4 or 5: the 5-row band's u, v, u_pen, v_pen
    # and four packed planes with their halo rows, and 136 slots for the
    # mbarriers and the reductions
    assert tops.smem_bytes(res16.ny, res16.nx, 16) == 4 * (
        7 * 353 + 8 * 352 + 5 * 352 + 6 * 352 + 2 * 7 * 176 + 2 * 5 * 176
        + 136)
    # a 16-block cluster holds res 18 and res 32 (ny 132, 9 rows a block);
    # res 48 (ny 198, 13 rows a block) is over one block's 232,448 bytes
    assert tops.select_tier(tgrid.GridConfig(res=17), "cuda") == "cuda"
    assert tops.smem_bytes(res32.ny, res32.nx, 16) <= tops.SMEM_PER_BLOCK
    for cfg in (tgrid.GridConfig(res=18), res32):
        assert tops.select_tier(cfg, "cuda") == "cuda"
    res48 = tgrid.GridConfig(res=48)
    assert tops.smem_bytes(res48.ny, res48.nx, 16) > tops.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        tops.select_tier(res48, "cuda")
    assert tops.select_tier(res48, "cpu") == "plain"
    monkeypatch.setattr(tops, "SMEM_PER_BLOCK", 1000)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="backend='reference'"):
            tops.select_tier(res16, "cuda")
    reset_warning_caches()


class _OddGrid:
    """select_tier duck type: GridConfig cannot express an odd width
    (nx = 22*res), but external grids can."""
    ny, nx = 8, 7


def test_fused_odd_width_warns_once_per_shape():
    """On a CPU state an odd width falls back to the reference loop,
    warning once per shape; on a CUDA state it raises."""
    reset_warning_caches()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tops.select_tier(_OddGrid, "cpu") == "reference"
        assert tops.select_tier(_OddGrid, "cpu") == "reference"
        assert len(w) == 1 and "falls back" in str(w[0].message)
        reset_warning_caches()
        assert tops.select_tier(_OddGrid, "cpu") == "reference"
        assert len(w) == 2
        with pytest.raises(ValueError, match="even grid width"):
            tops.select_tier(_OddGrid, "cuda")
        assert len(w) == 2
    reset_warning_caches()


def test_fused_plain_tier_refuses_other_devices(developed, ga_t):
    _, st = developed
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.fused_interval_cuda(CFG_T, ga_t, _flow(st),
                                 0.0, 1)
