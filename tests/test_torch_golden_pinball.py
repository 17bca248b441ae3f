"""Pinball golden physics through the port: restart the port's plain
solver on the CPU from tests/golden/pinball_re100_res8.npz and re-measure
the Strouhal number, mean C_D and C_L amplitude of the total (all-body)
forces over the fixture's full 2000-dt window, within the reference's own
tolerances (tests/test_golden_pinball.py).

Two routes through the fused kernel's plain twin: the scalar zero
amplitude (as the reference's ``run_uncontrolled`` runs it), and the
per-body branch with a zero (3,) vector at act_mode 0, its per-body forces
summed over the bodies."""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.cfd import grid, solver
from repro_torch.cfd.grid import GridConfig
from repro_torch.cfd.validation import measure_shedding, run_uncontrolled
from repro_torch.convert import flow_state_from_numpy
from tests.test_golden_pinball import TOL_AMP, TOL_CD, TOL_ST
import tests._torch_parity  # noqa: F401  (one thread, TF32 off)

GOLDEN = Path(__file__).parent / "golden" / "pinball_re100_res8.npz"


def _per_body(cfg, state, n):
    """``n`` uncontrolled dt through the per-body branch: forces per body,
    summed to the totals."""
    ga = solver.geom_to_arrays(grid.build_geometry(cfg, "pinball"), "cpu")
    _, outs = solver.step_interval(cfg, ga, state, torch.zeros(3), n,
                                   act_mode=0.0, backend="fused")
    assert outs.cd.shape == (n, 3)
    return outs.cd.sum(-1).numpy(), outs.cl.sum(-1).numpy()


@pytest.fixture(scope="module", params=["scalar", "per_body"])
def remeasured(request):
    ref = np.load(GOLDEN)
    cfg = GridConfig(res=int(ref["res"]), dt=float(ref["dt"]),
                     poisson_iters=int(ref["poisson_iters"]))
    state = flow_state_from_numpy(ref["u"], ref["v"], ref["p"],
                                  device="cpu")
    n = int(ref["meas_steps"])
    if request.param == "scalar":
        # backend="fused" on a CPU state runs the fused kernel's plain twin
        _, cds, cls = run_uncontrolled(cfg, state, n, backend="fused",
                                       geometry=str(ref["geometry"]))
    else:
        cds, cls = _per_body(cfg, state, n)
    return ref, measure_shedding(cds, cls, cfg.dt), cds, cls


def test_pinball_strouhal_number(remeasured):
    ref, stats, _, _ = remeasured
    assert stats["strouhal"] == pytest.approx(float(ref["strouhal"]),
                                              rel=TOL_ST)


def test_pinball_mean_drag_coefficient(remeasured):
    ref, stats, _, _ = remeasured
    assert stats["cd_mean"] == pytest.approx(float(ref["cd_mean"]),
                                             rel=TOL_CD)


def test_pinball_lift_oscillation_amplitude(remeasured):
    ref, stats, _, _ = remeasured
    assert stats["cl_amp"] == pytest.approx(float(ref["cl_amp"]),
                                            rel=TOL_AMP)


def test_pinball_shedding_is_developed(remeasured):
    """Saturated symmetric shedding, as the reference's test asks."""
    _, stats, cds, cls = remeasured
    assert stats["n_periods"] >= 3
    assert np.isfinite(cds).all() and np.isfinite(cls).all()
    assert abs(float(cls.mean())) < 0.1
    assert 15.0 < stats["cd_mean"] < 25.0
    assert 0.25 < stats["strouhal"] < 0.45
