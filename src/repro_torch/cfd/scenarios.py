"""Scenario registry: parameterized, batchable AFC flow cases.

Port of ``repro.cfd.scenarios``.  A ``Scenario`` is a named flow case
(Reynolds number, actuation mode, probe layout, geometry, optional fixed
reference drag ``cd0``); ``ScenarioParams`` is its per-env tensor half,
carried inside the env state so envs of one batch can integrate different
physics through the same calls; ``batch_params`` stacks scenarios along a
leading env dim, padding probe layouts to a common obs_dim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cfd import probes as probes_mod
from repro_torch.cfd.grid import (GEOMETRIES, GridConfig, geometry_index,
                                  points_to_ij)
from repro_torch.device import resolve_device

ACTUATIONS = ("jets", "rotary")


@dataclass(frozen=True)
class Scenario:
    """One flow case.  ``cd0=None`` means "calibrate from the warmup run"."""
    name: str
    re: float = 100.0
    actuation: str = "jets"        # "jets" | "rotary"
    probes: str = "ring149"        # probe layout name (cfd.probes)
    geometry: str = "cylinder"     # immersed-body set (cfd.grid)
    cd0: Optional[float] = None
    description: str = ""

    def __post_init__(self):
        if self.actuation not in ACTUATIONS:
            raise ValueError(f"unknown actuation {self.actuation!r}; "
                             f"choose from {ACTUATIONS}")
        if self.geometry not in GEOMETRIES:
            raise ValueError(f"unknown geometry {self.geometry!r}; "
                             f"choose from {sorted(GEOMETRIES)}")
        if self.actuation == "jets" and self.geometry != "cylinder":
            raise ValueError(
                f"scenario {self.name!r}: synthetic jets are only carved "
                "into the single-cylinder geometry; multi-body geometries "
                "use actuation='rotary'")
        probes_mod.layout_positions(self.probes)   # validate eagerly

    @property
    def obs_dim(self) -> int:
        return probes_mod.layout_size(self.probes)

    @property
    def act_mode(self) -> float:
        return float(ACTUATIONS.index(self.actuation))

    @property
    def n_bodies(self) -> int:
        return len(GEOMETRIES[self.geometry])

    @property
    def act_dim(self) -> int:
        """Action vector width: one rotary speed per body, one jet amplitude."""
        return self.n_bodies if self.actuation == "rotary" else 1


_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(scn: Scenario, *, overwrite: bool = False) -> Scenario:
    if scn.name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {scn.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[scn.name] = scn
    return scn


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {list_scenarios()}") from None


def list_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _builtin(name, **kw):
    register_scenario(Scenario(name=name, **kw))


_builtin("cyl_re100", re=100.0,
         description="Schäfer confined cylinder, jets, full 149-probe ring")
_builtin("cyl_re200", re=200.0,
         description="higher-Re shedding, jets, full ring")
_builtin("cyl_re500", re=500.0,
         description="strongly separated regime, jets, full ring")
_builtin("cyl_re100_rotary", re=100.0, actuation="rotary",
         description="rotary (Magnus) control at Re=100")
_builtin("cyl_re200_rotary", re=200.0, actuation="rotary",
         description="rotary control at Re=200")
_builtin("cyl_re100_sparse8", re=100.0, probes="sparse8",
         description="minimal 8-probe sensing at Re=100")
_builtin("cyl_re200_sparse24", re=200.0, probes="sparse24",
         description="reduced 24-probe sensing at Re=200")
_builtin("pinball_re100", re=100.0, actuation="rotary", probes="pinball",
         geometry="pinball",
         description="fluidic pinball: three rotating cylinders, Re=100")
_builtin("pinball_re130", re=130.0, actuation="rotary", probes="pinball",
         geometry="pinball",
         description="fluidic pinball in the chaotic regime, Re=130")
_builtin("tandem_re100", re=100.0, actuation="rotary", probes="tandem",
         geometry="tandem",
         description="tandem cylinders 1.5D apart, per-body rotary control")


class ScenarioParams(NamedTuple):
    """The per-env half of a scenario (tensors; leading env dims when
    batched):

      re         ()       Reynolds number
      act_mode   ()       0 = jets, 1 = rotary (blend of target fields)
      cd0        ()       uncontrolled reference drag for reward eq. (12)
      probe_ij   (P, 2)   fractional [row, col] probe coords (padded)
      probe_mask (P,)     1 for live probes, 0 for padded slots
      geom_id    ()       int64 index into grid.geometry_names()
      act_mask   (A,)     1 for live action slots, 0 for padding
    """
    re: torch.Tensor
    act_mode: torch.Tensor
    cd0: torch.Tensor
    probe_ij: torch.Tensor
    probe_mask: torch.Tensor
    geom_id: torch.Tensor
    act_mask: torch.Tensor


def scenario_params(scn: Scenario, grid: GridConfig, *,
                    obs_dim: Optional[int] = None,
                    act_dim: Optional[int] = None,
                    cd0: Optional[float] = None,
                    device="cuda") -> ScenarioParams:
    """The per-env tensors of one scenario, padded to ``obs_dim`` probes
    and ``act_dim`` action slots; ``cd0`` supplies the calibrated warmup
    drag when the scenario pins none."""
    device = resolve_device(device)
    pts = probes_mod.layout_positions(scn.probes)
    ij = points_to_ij(grid, pts).astype(np.float32)
    n = len(ij)
    obs_dim = n if obs_dim is None else obs_dim
    if obs_dim < n:
        raise ValueError(f"obs_dim={obs_dim} < layout {scn.probes!r} "
                         f"size {n}")
    pad = obs_dim - n
    ij = np.concatenate([ij, np.zeros((pad, 2), np.float32)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    a = scn.act_dim
    act_dim = a if act_dim is None else act_dim
    if act_dim < a:
        raise ValueError(f"act_dim={act_dim} < scenario {scn.name!r} "
                         f"action width {a}")
    act_mask = np.concatenate([np.ones(a, np.float32),
                               np.zeros(act_dim - a, np.float32)])
    # no cd0 from either the scenario or the caller is a config error:
    # every reward would be NaN
    if scn.cd0 is not None:
        cd0 = scn.cd0
    elif cd0 is None:
        raise ValueError(
            f"scenario {scn.name!r} has no cd0 (uncontrolled-drag baseline) "
            f"and no caller override: rewards would be NaN forever.  Pass "
            f"cd0=<calibrated value> (CylinderEnv warmup calibrates it) or "
            f"pin one on the Scenario")

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return ScenarioParams(re=f32(scn.re), act_mode=f32(scn.act_mode),
                          cd0=f32(cd0), probe_ij=f32(ij),
                          probe_mask=f32(mask),
                          geom_id=torch.tensor(geometry_index(scn.geometry),
                                               device=device),
                          act_mask=f32(act_mask))


def resolve(scenarios: Sequence) -> Tuple[Scenario, ...]:
    """Names and/or Scenario objects -> Scenario tuple."""
    return tuple(s if isinstance(s, Scenario) else get_scenario(s)
                 for s in scenarios)


def common_obs_dim(scenarios: Sequence) -> int:
    return max(s.obs_dim for s in resolve(scenarios))


def common_act_dim(scenarios: Sequence) -> int:
    return max(s.act_dim for s in resolve(scenarios))


def batch_params(scenarios: Sequence, grid: GridConfig, *,
                 obs_dim: Optional[int] = None,
                 act_dim: Optional[int] = None,
                 cd0s: Optional[Sequence[float]] = None,
                 device="cuda") -> ScenarioParams:
    """Stack scenarios into a batched ScenarioParams (leading dim = env),
    probe layouts and action vectors padded to a common width."""
    scns = resolve(scenarios)
    obs_dim = common_obs_dim(scns) if obs_dim is None else obs_dim
    act_dim = common_act_dim(scns) if act_dim is None else act_dim
    cd0s = [None] * len(scns) if cd0s is None else list(cd0s)
    per = [scenario_params(s, grid, obs_dim=obs_dim, act_dim=act_dim, cd0=c,
                           device=device)
           for s, c in zip(scns, cd0s)]
    return ScenarioParams(*(torch.stack(xs) for xs in zip(*per)))


def assign_envs(scenarios: Sequence, n_envs: int) -> Tuple[Scenario, ...]:
    """Round-robin scenario assignment over the env batch; raises when the
    batch cannot hold every requested scenario."""
    scns = resolve(scenarios)
    if n_envs < len(scns):
        raise ValueError(
            f"n_envs={n_envs} < {len(scns)} requested scenarios "
            f"({[s.name for s in scns]}); raise n_envs or trim the mix")
    return tuple(scns[i % len(scns)] for i in range(n_envs))
