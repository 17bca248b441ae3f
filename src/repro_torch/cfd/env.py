"""Gym-like cylinder AFC environment (the paper's DRL environment).

Port of ``repro.cfd.env``.  One ``env_step`` = one actuation period: the
smoothed actuation amplitude (eq. 11, beta = 0.4) is held while the solver
advances ``steps_per_action`` dt's; the reward is eq. (12):
r = C_D0 - <C_D> - omega_L |<C_L>|.

States carry any number of leading env dims (``reset`` returns one env,
``broadcast_env_state`` tiles it; where ``repro`` used ``vmap`` the port
batches).  Per-env physics (Re, actuation mode, probe layout, C_D0,
geometry id, live action slots) rides in ``EnvState.scn``.  The amplitude
is a scalar per env for the single cylinder and a vector of per-body
rotary speeds for the multi-body geometries; a batch that mixes
geometries reads each env's geometry from a stacked bank.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.cfd import grid as grid_mod
from repro_torch.cfd import poisson
from repro_torch.cfd import probes as probes_mod
from repro_torch.cfd import scenarios as scn_mod
from repro_torch.cfd import solver
from repro_torch.cfd.grid import GridConfig, build_geometry
from repro_torch.cfd.scenarios import Scenario, ScenarioParams
from repro_torch.device import resolve_device
from repro_torch.testing import faults


@dataclass(frozen=True)
class EnvConfig:
    """Environment configuration (the reference's fields).  ``cd0=None``
    means "calibrate from the uncontrolled warmup"; ``obs_dim`` follows the
    probe layout, ``act_dim`` the scenario (one slot per rotating body,
    one for the jets)."""
    grid: GridConfig = GridConfig()
    steps_per_action: int = 50
    actions_per_episode: int = 100
    beta: float = 0.4             # action smoothing, eq. (11)
    reward_omega: float = 0.1     # lift penalty weight, eq. (12)
    cd0: Optional[float] = None   # None -> calibrate during warmup
    warmup_time: float = 30.0     # t.u. of uncontrolled flow before training
    probe_layout: str = "ring149"
    actuation: str = "jets"
    geometry: str = "cylinder"
    guard: bool = True            # divergence sentinel + per-env quarantine
    guard_vel_limit: float = 50.0
    guard_div_limit: float = 1e3

    @property
    def obs_dim(self) -> int:
        return probes_mod.layout_size(self.probe_layout)

    @property
    def act_dim(self) -> int:
        return self.scenario().act_dim

    @property
    def action_max(self) -> float:
        return self.grid.u_max    # |V_jet| <= U_m constraint

    def scenario(self, name: str = "__cfg__") -> Scenario:
        return Scenario(name=name, re=self.grid.re, actuation=self.actuation,
                        probes=self.probe_layout, geometry=self.geometry,
                        cd0=self.cd0)

    @classmethod
    def for_scenario(cls, scn, **overrides) -> "EnvConfig":
        """EnvConfig bound to a registered scenario (or Scenario object)."""
        scn = scn if isinstance(scn, Scenario) else scn_mod.get_scenario(scn)
        grid = overrides.pop("grid", GridConfig())
        grid = dataclasses.replace(grid, re=scn.re)
        return cls(grid=grid, probe_layout=scn.probes,
                   actuation=scn.actuation, geometry=scn.geometry,
                   cd0=scn.cd0, **overrides)


class EnvState(NamedTuple):
    flow: solver.FlowState
    jet_vel: torch.Tensor         # smoothed actuation amplitude: a scalar
    #                               or (A,) per-body surface speeds per env
    t: torch.Tensor               # actuation counter
    scn: ScenarioParams           # per-env scenario parameters
    reset_flow: solver.FlowState = None   # warmup flow for quarantine resets


class EnvOutput(NamedTuple):
    obs: torch.Tensor             # (..., obs_dim) pressure probes (padded)
    reward: torch.Tensor
    cd: torch.Tensor              # mean C_D over the actuation period
    cl: torch.Tensor
    valid: torch.Tensor = None    # 1.0 healthy / 0.0 quarantined (sentinel)


def _sel(ok, healthy, fallback):
    """Per-env select: ``ok`` (...,) against fields with trailing dims."""
    cond = ok.reshape(ok.shape + (1,) * (healthy.dim() - ok.dim()))
    return torch.where(cond, healthy, fallback)


class CylinderEnv:
    """Env functions bound to a grid and a device; the config's geometry is
    built once, the others on demand (a mixed batch stacks them all into a
    bank).

    ``backend`` selects the solver backend of every actuation interval
    (warmup included): ``"fused"`` runs the fused-interval kernel on CUDA
    (its scalar instantiation for a scalar amplitude, its per-body one for
    a vector) and its plain twin on the CPU; ``"pallas"`` the packed-SOR
    kernel inside each dt; the rest are plain PyTorch.  ``cluster`` is the
    fused kernel's cluster size on the card: None, its own choice for each
    launch's env count, until :meth:`pin_cluster` fixes it."""

    def __init__(self, cfg: EnvConfig = EnvConfig(), *,
                 backend: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = poisson.resolve_backend(backend)
        self.cluster: Optional[int] = None
        self.geom = build_geometry(cfg.grid, cfg.geometry)
        self.geom_arrays = solver.geom_to_arrays(self.geom, self.device)
        self._reset_flow = None
        self._geom_cache = {cfg.geometry: (self.geom, self.geom_arrays)}
        self._bank = None        # stacked (G, ...) GeomArrays, built lazily
        self._group_cache = {}   # (re, act_mode, geometry) -> (FlowState, cd0)

    def pin_cluster(self, n_envs: int, per_body: bool) -> None:
        """Fix the fused kernel's cluster size to the size it picks for
        ``n_envs`` envs on this card: a fleet pins the whole batch's size,
        so a process's env shard runs each env as the whole batch would
        (the cluster size orders the force sums).  A no-op off the card or
        off the fused backend."""
        if self.device.type != "cuda" or self.backend != "fused":
            return
        from repro_torch.kernels.actuation import ops as actuation_ops
        self.cluster = actuation_ops.cluster_for(
            self.cfg.grid, n_envs, self.device,
            actuation_ops.N_BODIES if per_body else 0)

    # -- uncontrolled warmup to a developed shedding state ------------------

    def warmup(self, verbose: bool = False) -> solver.FlowState:
        """Run (or fetch from the cache) the uncontrolled warmup of this
        config's (Re, actuation) group and calibrate ``cd0`` from its last
        quarter when unset; ``verbose`` prints the reference's line (the
        warmup's dt count and C_D0)."""
        cfg = self.cfg
        group = (cfg.grid.re, cfg.scenario().act_mode, cfg.geometry)
        self._warmup_groups([group])
        flow, cd0 = self._group_cache[group]
        self._reset_flow = flow
        if self.cfg.cd0 is None:
            self.cfg = dataclasses.replace(self.cfg, cd0=cd0)
        if verbose:
            n = max(1, int(round(cfg.warmup_time / cfg.grid.dt)))
            print(f"warmup {n} steps: CD0={self.cfg.cd0:.3f}")
        return flow

    def _warmup_groups(self, groups) -> None:
        """Warm up every uncached (re, act_mode, geometry) group, one batch
        per geometry, with the scalar zero amplitude; C_D0 is the mean
        total C_D over the last quarter of the warmup."""
        cfg = self.cfg
        todo = [g for g in groups if g not in self._group_cache]
        if not todo:
            return
        by_geom: dict = {}
        for g in todo:
            by_geom.setdefault(g[2], []).append(g)
        n = max(1, int(round(cfg.warmup_time / cfg.grid.dt)))
        tail = max(1, n // 4)
        f32 = dict(dtype=torch.float32, device=self.device)
        for gname, gtodo in sorted(by_geom.items()):
            geom, ga = self._geometry(gname)
            flow0 = solver.init_state(cfg.grid, geom, self.device)
            flow0 = solver.FlowState(*(
                a.expand(len(gtodo), *a.shape).contiguous() for a in flow0))
            re = torch.tensor([g[0] for g in gtodo], **f32)
            mode = torch.tensor([g[1] for g in gtodo], **f32)
            flows, outs = solver.step_interval(
                cfg.grid, ga, flow0, torch.zeros(len(gtodo), **f32), n,
                re=re, act_mode=mode, backend=self.backend,
                cluster=self.cluster)
            cd0s = torch.mean(outs.cd[:, -tail:], dim=1).tolist()
            for i, g in enumerate(gtodo):
                self._group_cache[g] = (
                    solver.FlowState(*(a[i].clone() for a in flows)),
                    float(cd0s[i]))

    # -- multi-geometry support ---------------------------------------------

    def _geometry(self, name: str):
        """(Geometry, GeomArrays) of a named body set, built once."""
        if name not in self._geom_cache:
            geom = build_geometry(self.cfg.grid, name)
            self._geom_cache[name] = (geom, solver.geom_to_arrays(
                geom, self.device))
        return self._geom_cache[name]

    def _ensure_bank(self) -> None:
        """Stack every registered geometry's arrays into one (G, ...) bank,
        in ``grid.geometry_names()`` order (``scn.geom_id`` indexes it), the
        per-body fields zero-padded to ``grid.max_bodies()``."""
        if self._bank is None:
            self._bank = solver.geometry_bank(
                [self._geometry(name)[1]
                 for name in grid_mod.geometry_names()],
                grid_mod.max_bodies())

    def _env_geom(self, st: EnvState, per_body: bool):
        """``(geometry arrays, geom_id)`` of a step: the config's geometry
        (``geom_id`` None), or the bank and each env's index into it once a
        batch has mixed geometries.  A scalar amplitude means the single
        cylinder, so a cylinder config's scalar steps skip the bank."""
        if self._bank is None or (not per_body
                                  and self.cfg.geometry == "cylinder"):
            return self.geom_arrays, None
        return self._bank, st.scn.geom_id

    # -- env API -------------------------------------------------------------

    def reset(self) -> Tuple[EnvState, torch.Tensor]:
        """One env at the warmed-up flow; returns ``(state, obs)``."""
        if self._reset_flow is None:
            self.warmup()
        flow0 = solver.FlowState(*(a.clone() for a in self._reset_flow))
        scn = self.cfg.scenario()
        params = scn_mod.scenario_params(scn, self.cfg.grid,
                                         cd0=self.cfg.cd0,
                                         device=self.device)
        shape = () if scn.act_dim == 1 else (scn.act_dim,)
        st = EnvState(flow=flow0,
                      jet_vel=torch.zeros(shape, dtype=torch.float32,
                                          device=self.device),
                      t=torch.zeros((), dtype=torch.int64,
                                    device=self.device),
                      scn=params,
                      reset_flow=flow0 if self.cfg.guard else None)
        return st, self._observe(st)

    def reset_batch(self, scenarios: Sequence, n_envs: Optional[int] = None,
                    *, obs_dim: Optional[int] = None,
                    act_dim: Optional[int] = None
                    ) -> Tuple[EnvState, torch.Tensor]:
        """An (N_envs, ...) batch of scenarios assigned round-robin.

        One warmup per distinct (Re, actuation, geometry) group (cached),
        per-scenario C_D0.  Probe layouts pad to a common ``obs_dim`` and
        action vectors to a common ``act_dim`` (default: the widest in the
        batch; 1 keeps the scalar amplitude).  A batch whose geometries
        stray from the config's builds the geometry bank, from which each
        env reads its own body set."""
        cfg = self.cfg
        scns = self.batch_scenarios(scenarios, n_envs)
        groups = sorted({(s.re, s.act_mode, s.geometry) for s in scns})
        self._warmup_groups(groups)
        flows, cd0s = [], []
        for s in scns:
            flow, cd0 = self._group_cache[(s.re, s.act_mode, s.geometry)]
            flows.append(flow)
            cd0s.append(s.cd0 if s.cd0 is not None else cd0)
        flow_b = solver.FlowState(*(torch.stack(xs) for xs in zip(*flows)))
        params_b = scn_mod.batch_params(scns, cfg.grid, obs_dim=obs_dim,
                                        act_dim=act_dim, cd0s=cd0s,
                                        device=self.device)
        n = len(scns)
        a_dim = scn_mod.common_act_dim(scns) if act_dim is None else act_dim
        st_b = EnvState(flow=flow_b,
                        jet_vel=torch.zeros((n,) if a_dim == 1 else (n, a_dim),
                                            dtype=torch.float32,
                                            device=self.device),
                        t=torch.zeros(n, dtype=torch.int64,
                                      device=self.device),
                        scn=params_b,
                        reset_flow=flow_b if cfg.guard else None)
        return st_b, self._observe(st_b)

    def batch_scenarios(self, scenarios: Sequence,
                        n_envs: Optional[int] = None) -> Tuple[Scenario, ...]:
        """The scenarios of an (N_envs, ...) batch, assigned round-robin;
        builds the geometry bank when their geometries stray from the
        config's.  Runs no warmup, so a batch restored from a checkpoint
        calls it to step its own flow: each env's ``scn.geom_id`` indexes
        the bank in ``grid.geometry_names()`` order, as it did when the
        batch was reset."""
        scns = scn_mod.assign_envs(scenarios, n_envs or len(scenarios))
        if any(s.geometry != self.cfg.geometry for s in scns):
            self._ensure_bank()
        return scns

    def _observe(self, st: EnvState) -> torch.Tensor:
        return probes_mod.sample_pressure(st.scn.probe_ij, st.flow.p,
                                          st.scn.probe_mask)

    def obs_aux(self, st: EnvState) -> dict:
        """Normalized probe coordinates in [-1, 1]^2 plus the live-slot
        mask; constant over an episode."""
        g = self.cfg.grid
        ij = st.scn.probe_ij.to(torch.float32)
        y = ij[..., 0] / max(g.ny - 1, 1) * 2.0 - 1.0
        x = ij[..., 1] / max(g.nx - 1, 1) * 2.0 - 1.0
        return {"xy": torch.stack([x, y], dim=-1),
                "mask": st.scn.probe_mask.to(torch.float32)}

    def env_step(self, st: EnvState, action) -> Tuple[EnvState, EnvOutput]:
        """One actuation period; ``action`` in [-1, 1] shaped like
        ``st.jet_vel``: a scalar amplitude per env, or per-body surface
        speeds whose slots past a scenario's own act_dim are zeroed by
        ``st.scn.act_mask``."""
        cfg = self.cfg
        a = torch.clamp(torch.as_tensor(action, dtype=torch.float32,
                                        device=self.device),
                        -1.0, 1.0) * cfg.action_max
        per_body = solver.is_per_body(st.jet_vel, st.flow.u)
        if per_body:
            a = a * st.scn.act_mask
        jet = st.jet_vel + cfg.beta * (a - st.jet_vel)        # eq. (11)
        jet = torch.clamp(jet, -cfg.action_max, cfg.action_max)
        flow_in = st.flow
        fz = faults.active("nan_env")
        if fz is not None:
            # env = the index in the flattened batch, as the reference's
            # axis_index("env"); other envs' fields pass through untouched
            idx = torch.arange(st.t.numel(), device=st.t.device
                               ).reshape(st.t.shape)
            hit = ((idx == int(fz.get("env", 0)))
                   & (st.t == int(fz.get("step", 0))))
            flow_in = flow_in._replace(u=_sel(
                hit, torch.full_like(flow_in.u, float("nan")), flow_in.u))
        ga, geom_id = self._env_geom(st, per_body)
        flow, outs = solver.step_interval(cfg.grid, ga, flow_in, jet,
                                          cfg.steps_per_action,
                                          re=st.scn.re,
                                          act_mode=st.scn.act_mode,
                                          backend=self.backend,
                                          geom_id=geom_id,
                                          cluster=self.cluster)
        if per_body:
            # (..., n_steps, B): the drag term is the total, the lift is
            # penalized per body, so opposite body lifts do not cancel
            cd_b = torch.mean(outs.cd, dim=-2)
            cl_b = torch.mean(outs.cl, dim=-2)
            cd = torch.sum(cd_b, dim=-1)
            cl = torch.sum(cl_b, dim=-1)
            cl_pen = torch.sum(torch.abs(cl_b), dim=-1)
        else:
            cd = torch.mean(outs.cd, dim=-1)
            cl = torch.mean(outs.cl, dim=-1)
            cl_pen = torch.abs(cl)
        reward = st.scn.cd0 - cd - cfg.reward_omega * cl_pen   # eq. (12)
        if st.reset_flow is None:     # sentinel off
            st2 = EnvState(flow=flow, jet_vel=jet, t=st.t + 1, scn=st.scn)
            return st2, EnvOutput(obs=self._observe(st2), reward=reward,
                                  cd=cd, cl=cl)

        # -- divergence sentinel: quarantine a blown-up env in place --------
        ok = self._healthy(flow, reward)
        st2 = EnvState(
            flow=solver.FlowState(*(_sel(ok, h, q) for h, q in
                                    zip(flow, st.reset_flow))),
            jet_vel=_sel(ok, jet, torch.zeros_like(jet)),
            t=st.t + 1, scn=st.scn, reset_flow=st.reset_flow)
        zero = torch.zeros_like(reward)
        return st2, EnvOutput(obs=self._observe(st2),
                              reward=_sel(ok, reward, zero),
                              cd=_sel(ok, cd, zero), cl=_sel(ok, cl, zero),
                              valid=ok.to(torch.float32))

    def _healthy(self, flow: solver.FlowState, reward) -> torch.Tensor:
        """Per-env health: finite fields + physical ceilings (NaN/Inf fail
        the ``<`` comparisons)."""
        cfg = self.cfg
        dims = (-2, -1)
        vmax = torch.maximum(torch.amax(torch.abs(flow.u), dim=dims),
                             torch.amax(torch.abs(flow.v), dim=dims))
        divmax = torch.amax(torch.abs(solver.divergence(flow.u, flow.v,
                                                        cfg.grid)), dim=dims)
        return ((vmax < cfg.guard_vel_limit)
                & (divmax < cfg.guard_div_limit)
                & torch.isfinite(torch.amax(torch.abs(flow.p), dim=dims))
                & torch.isfinite(reward))


def broadcast_env_state(st: EnvState, obs, n_envs: int):
    """Tile a single reset state/obs into an (N_envs, ...) batch."""
    def tile(a):
        return None if a is None else a.expand(n_envs, *a.shape).contiguous()

    def tile_tree(x):
        if x is None or torch.is_tensor(x):
            return tile(x)
        return type(x)(*(tile_tree(a) for a in x))

    return tile_tree(st), tile(obs)
