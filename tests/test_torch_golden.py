"""Golden physics through the port: restart the port's plain solver on the
CPU from tests/golden/cyl_re100_res8.npz and re-measure Strouhal number,
mean C_D and C_L amplitude over the fixture's window, within the
reference's own tolerances (tests/test_golden_physics.py)."""
from pathlib import Path

import numpy as np
import pytest

from repro_torch.cfd.grid import GridConfig
from repro_torch.cfd.validation import measure_shedding, run_uncontrolled
from repro_torch.convert import flow_state_from_numpy
from tests.test_golden_physics import TOL_AMP, TOL_CD, TOL_ST
import tests._torch_parity  # noqa: F401  (one thread, TF32 off)

GOLDEN = Path(__file__).parent / "golden" / "cyl_re100_res8.npz"


@pytest.fixture(scope="module")
def remeasured():
    ref = np.load(GOLDEN)
    cfg = GridConfig(res=int(ref["res"]), dt=float(ref["dt"]),
                     poisson_iters=int(ref["poisson_iters"]))
    state = flow_state_from_numpy(ref["u"], ref["v"], ref["p"],
                                  device="cpu")
    # backend="fused" on a CPU state runs the fused kernel's plain twin
    _, cds, cls = run_uncontrolled(cfg, state, int(ref["meas_steps"]),
                                   backend="fused")
    return ref, measure_shedding(cds, cls, cfg.dt), cds, cls


def test_strouhal_number(remeasured):
    ref, stats, _, _ = remeasured
    assert stats["strouhal"] == pytest.approx(float(ref["strouhal"]),
                                              rel=TOL_ST)


def test_mean_drag_coefficient(remeasured):
    ref, stats, _, _ = remeasured
    assert stats["cd_mean"] == pytest.approx(float(ref["cd_mean"]),
                                             rel=TOL_CD)


def test_lift_oscillation_amplitude(remeasured):
    ref, stats, _, _ = remeasured
    assert stats["cl_amp"] == pytest.approx(float(ref["cl_amp"]),
                                            rel=TOL_AMP)


def test_shedding_is_developed(remeasured):
    _, stats, cds, cls = remeasured
    assert stats["n_periods"] >= 3
    assert np.isfinite(cds).all() and np.isfinite(cls).all()
