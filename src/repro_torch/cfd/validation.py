"""Physics validation: re-measure the golden shedding window.

Port of ``repro.cfd.validation``: ``run_uncontrolled`` advances the flow
with zero actuation and returns the force-coefficient series;
``measure_shedding`` computes the Strouhal number, mean C_D and C_L
amplitude with the reference's arithmetic (numpy).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.cfd import solver
from repro_torch.cfd.grid import GridConfig, build_geometry


def run_uncontrolled(cfg: GridConfig, state: solver.FlowState, n: int, *,
                     backend: Optional[str] = None, mesh=None,
                     geometry: str = "cylinder"
                     ) -> Tuple[solver.FlowState, np.ndarray, np.ndarray]:
    """Advance ``n`` uncontrolled steps on ``state``'s device as one
    interval (``backend="fused"`` on a CUDA state: one kernel launch);
    returns ``(state, cds, cls)`` with numpy series.  ``backend`` /
    ``mesh`` select the Poisson backend (``mesh`` for "halo": the golden
    window re-measured through the decomposed solve).  ``geometry`` picks
    the body set (``grid.GEOMETRIES``); the forces are the total over all
    bodies (the scalar zero amplitude), which the golden fixtures pin."""
    ga = solver.geom_to_arrays(build_geometry(cfg, geometry), state.u.device)
    state, outs = solver.step_interval(cfg, ga, state, 0.0, n,
                                       backend=backend, mesh=mesh)
    return state, outs.cd.cpu().numpy(), outs.cl.cpu().numpy()


def measure_shedding(cds: np.ndarray, cls: np.ndarray, dt: float
                     ) -> Dict[str, float]:
    """Vortex-shedding metrics over a developed window: Strouhal from the
    mean upward-zero-crossing period of the mean-removed C_L (sub-step
    linear interpolation), St = f D / U with D = U_mean = 1."""
    cl = cls - cls.mean()
    sgn = cl > 0
    idx = np.flatnonzero(~sgn[:-1] & sgn[1:])
    if len(idx) < 3:
        raise ValueError("window too short: fewer than 3 C_L zero crossings "
                         "(no developed shedding?)")
    t_cross = idx + cl[idx] / (cl[idx] - cl[idx + 1])
    period = float(np.diff(t_cross).mean()) * dt
    return {
        "strouhal": 1.0 / period,
        "cd_mean": float(cds.mean()),
        "cl_amp": float(0.5 * (cls.max() - cls.min())),
        "n_periods": float(len(idx) - 1),
    }
