"""Measured autotuning: turn the paper's advisory cost model into a plan
chosen from timings on THIS card.

Port of ``repro.core.autotune`` for one card.  The paper picks the hybrid
split ``n_total = n_envs x n_ranks`` from constants calibrated to its own
cluster (Tables I/II, Fig. 7).  This module re-measures those constants
where the code runs and makes the result executable:

  1. ``measure_components`` times the real building blocks, the card
     synchronised around each call: one single-env solver step with the
     backend a single-rank plan runs, one pressure solve per sweep layout,
     one ``INTERVAL_PROBE_STEPS``-dt actuation interval through the plain
     loop and through the fused-interval kernel, policy inference, one PPO
     update, one trajectory-sink write.
  2. ``refit_cost_model`` refits ``CostModel``'s constants to those
     measurements with the machinery that calibrates to the paper
     (``scaling_model.least_squares_fit``).
  3. The divisor lattice is brute-forced on the refit model.
  4. The result is a ``ResolvedPlan`` (n_envs, n_ranks, device grid,
     Poisson backend) plus a JSON artifact of measured-vs-predicted
     component times under the reference's schema tag, so an artifact
     written by either package validates in both.

Single-rank plans execute here, on one process or across a fleet
(``launch/distributed.py``): in a live fleet ``ResolvedPlan.build_mesh``
spans the plan's data groups over the processes, ``measure_components``
times a real gloo all-gather for ``t_interhost`` and ``autotune``'s
``max_processes`` admits fleet layouts.  ``n_ranks > 1`` needs the halo
decomposition (``cfd/decomp.py``), not ported yet; such plans raise
``NotImplementedError`` naming it.

``resolve_plan`` is the single entry point engines and training loops use
to accept ``plan="auto" | ParallelPlan | (n_envs, n_ranks) | ResolvedPlan``.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.plan import CostModel, ParallelPlan, enumerate_plans
from repro_torch.device import DeviceLike, resolve_device

# the reference's schema tag, unchanged: the artifact's fields are its own
AUTOTUNE_SCHEMA = "repro.autotune/v4"

# dt's per probe interval when timing t_interval_backends: long enough that
# the fused path's per-interval amortization shows, short enough to keep
# the probe cheap
INTERVAL_PROBE_STEPS = 10


def not_ported(what: str, module: str) -> NotImplementedError:
    """The error a plan this package cannot execute raises: ``what`` needs
    ``module`` of the reference, not ported yet."""
    return NotImplementedError(
        f"{what} needs {module}, which is not ported to repro_torch yet; "
        f"use a single-rank plan (n_ranks = 1)")


def plan_devices(device: DeviceLike = "cuda") -> List[torch.device]:
    """The devices a plan's workers map onto: every CUDA card of this host,
    or the one CPU device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


# ---------------------------------------------------------------------------
# resolved plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ResolvedPlan:
    """An executable hybrid configuration: the chosen split, the Poisson
    backend that realizes its n_ranks, and the cost model behind the
    choice.  ``measurements`` carries the JSON-artifact dict when the plan
    came from ``autotune``."""
    plan: ParallelPlan
    backend: str                       # member of cfd.poisson.BACKENDS
    model: CostModel = field(default_factory=CostModel)
    source: str = "explicit"           # "explicit" | "auto"
    measurements: Optional[Dict[str, Any]] = None
    # single-rank sweep storage layout ("packed" | "full"); autotune sets it
    # from measured timings, explicit plans keep the packed default
    layout: str = "packed"

    @property
    def n_envs(self) -> int:
        return self.plan.n_envs

    @property
    def n_ranks(self) -> int:
        return self.plan.n_ranks

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return self.plan.mesh_shape

    @property
    def n_processes(self) -> int:
        return self.plan.n_processes

    def build_mesh(self, device: DeviceLike = "cuda",
                   span_processes: Optional[bool] = None) -> List:
        """The plan's ``n_envs * n_ranks`` workers in (data, model) order.

        In a live fleet (``span_processes=None`` and
        ``launch.distributed.fleet_active()``) the data groups span the
        processes, whatever ``n_processes`` the plan modelled (the actual
        topology wins): ``n // P`` consecutive groups on every process,
        each process's on its own card, as (process, device) pairs
        (``launch.distributed.span_devices``).  Otherwise the plan's
        devices on this host; raises when it has fewer."""
        from repro_torch.launch import distributed as dist_mod
        n = self.n_envs * self.n_ranks
        if span_processes is None:
            span_processes = dist_mod.fleet_active()
        if span_processes:
            groups = dist_mod.span_devices(n, device)
            procs = len({p for p, _ in groups})
            if (n // procs) % self.n_ranks:
                raise ValueError(
                    f"plan (n_envs, n_ranks) = ({self.n_envs}, "
                    f"{self.n_ranks}) cannot span {procs} processes: each "
                    f"process's {n // procs} workers must hold whole envs "
                    f"(a multiple of n_ranks = {self.n_ranks})")
            return groups
        devices = plan_devices(device)
        if n > len(devices):
            raise ValueError(
                f"plan needs n_envs * n_ranks = {n} devices but this host "
                f"has {len(devices)}; shrink the plan")
        return devices[:n]

    def describe(self) -> str:
        fleet = (f", spanning {self.n_processes} hosts"
                 if self.n_processes > 1 else "")
        return (f"plan[{self.source}]: n_envs x n_ranks = "
                f"{self.n_envs} x {self.n_ranks} of {self.plan.n_total} "
                f"workers (utilization {self.plan.utilization:.0%}), "
                f"poisson backend '{self.backend}' "
                f"(layout '{self.layout}'), mesh "
                f"(data, model) = {self.mesh_shape}{fleet}")


def default_backend(n_ranks: int, nx: Optional[int] = None,
                    device: DeviceLike = "cuda") -> str:
    """Poisson backend implied by a split: single-rank runs use the packed
    SOR kernel (``"pallas"``) on a CUDA device with an even grid width, as
    the reference does on a TPU, and the plain ``"reference"`` elsewhere.
    With ``nx`` unknown the conservative "reference" is chosen: it is
    correct on every grid.  ``n_ranks > 1`` needs the halo decomposition,
    which is not ported: it raises."""
    if n_ranks > 1:
        raise not_ported(f"n_ranks = {n_ranks} (the halo backend)",
                          "cfd/decomp.py")
    if nx is not None and torch.device(device).type == "cuda" \
            and nx % 2 == 0:
        return "pallas"
    return "reference"


def resolve_plan(plan, *, n_total: Optional[int] = None, grid=None,
                 device: DeviceLike = "cuda", **autotune_kw) -> ResolvedPlan:
    """Normalize any plan spelling to a ResolvedPlan.

    plan: "auto" (measure + optimize on ``device``), a ParallelPlan, an
    (n_envs, n_ranks) tuple, or an existing ResolvedPlan (passed through).
    ``grid``/``autotune_kw`` parameterize the "auto" measurement; with no
    grid in scope the backend choice is conservative (never "pallas",
    whose even-nx requirement can't be checked).  A plan's modelled
    ``n_processes`` needs nothing here (the live fleet decides where its
    workers run, ``ResolvedPlan.build_mesh``); ``n_ranks > 1`` raises
    ``NotImplementedError``.
    """
    if isinstance(plan, ResolvedPlan):
        return plan
    if isinstance(plan, str):
        if plan != "auto":
            raise ValueError(f"unknown plan spec {plan!r}; expected 'auto', "
                             f"a ParallelPlan, or an (n_envs, n_ranks) pair")
        return autotune(n_total=n_total, grid=grid, device=device,
                        **autotune_kw)
    if isinstance(plan, (tuple, list)):
        n_envs, n_ranks = plan
        plan = ParallelPlan(n_total or n_envs * n_ranks, n_envs, n_ranks)
    if not isinstance(plan, ParallelPlan):
        raise ValueError(f"cannot resolve plan from {plan!r}")
    nx = grid.nx if grid is not None else None
    return ResolvedPlan(plan=plan,
                        backend=default_backend(plan.n_ranks, nx, device),
                        source="explicit")


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, device: torch.device, warmup: int = 1, iters: int = 3,
          **kw) -> float:
    """Median wall time (s) of ``fn``, the device synchronised before the
    clock starts and before it stops."""
    for _ in range(warmup):
        fn(*args, **kw)
    _sync(device)
    ts = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def candidate_ranks(n_total: int, nx: int, n_devices: int) -> List[int]:
    """Rank counts worth timing: divide the worker budget AND the grid
    width, and fit on the host's devices.  Only ``1`` executes in this
    package (``default_backend``)."""
    return [r for r in range(1, n_total + 1)
            if n_total % r == 0 and nx % r == 0 and r <= n_devices]


def measure_components(grid=None, *, n_total: Optional[int] = None,
                       ppo_cfg=None, horizon: int = 32, n_envs_probe: int = 4,
                       iters: int = 3, seed: int = 0,
                       sink_dir: Optional[str] = None,
                       device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Time the real components of one training episode on ``device``.

    Returns a dict with per-component times (seconds), the reference's:
      t_step_ranks   {1: solver-step time} with the backend a single-rank
                     plan runs (``t_step_backends``); one card has no
                     multi-rank point of the paper's Fig. 7
      t_poisson_layouts  {layout: time} for one pressure solve in packed vs
                     full-grid checkerboard storage (plain PyTorch)
      t_interval_backends  {backend: time} for one
                     ``INTERVAL_PROBE_STEPS``-dt actuation interval through
                     ``solver.step_interval``: the plain loop ("reference")
                     vs the fused-interval kernel ("fused", even widths)
      t_policy       one policy inference (single obs)
      t_update       one PPO update on an (n_envs_probe * horizon) batch
      io             bytes + seconds for one episode spill through the
                     binary FileSink -> per-actuation volume and
                     single-stream bandwidth
      t_interhost    one episode-sized trajectory all-gather across the
                     fleet: a real gloo timing when this process is part of
                     one (``estimated: false``), otherwise the estimate
                     from the CostModel's loopback defaults
                     (``estimated: true``)
    plus ``device``: the type, name and count of the devices measured.
    ``n_devices`` counts the fleet's devices (each process's, summed), as
    the reference's ``jax.devices()``.
    """
    import tempfile

    from repro_torch.cfd import poisson, solver
    from repro_torch.cfd.grid import GridConfig, build_geometry
    from repro_torch.cfd.probes import layout_size
    from repro_torch.drl import networks
    from repro_torch.drl.engine import FileSink
    from repro_torch.drl.ppo import Batch, PPOConfig, make_optimizer, \
        ppo_update
    from repro_torch.drl.rollout import Trajectory
    from repro_torch.launch.distributed import all_gather_rows, fleet_info

    dev = resolve_device(device)
    grid = grid or GridConfig()
    procs = fleet_info().num_processes
    n_devices = procs * len(plan_devices(dev))
    n_total = n_total or n_devices
    ppo_cfg = ppo_cfg or PPOConfig()
    geom = build_geometry(grid)
    ga = solver.geom_to_arrays(geom, dev)
    st = solver.init_state(grid, geom, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(seed)

    def timed(fn, *args):
        return _time(fn, *args, device=dev, iters=iters)

    # -- one solver step, with the backend a single-rank plan executes ------
    step_backends = {1: default_backend(1, grid.nx, dev)}
    t_step_ranks = {1: timed(lambda: solver.step(
        grid, ga, st, zero, backend=step_backends[1]))}

    # -- sweep storage layout: packed checkerboard vs full grid -------------
    rhs = torch.randn((grid.ny, grid.nx), generator=gen).to(dev)
    t_poisson_layouts: Dict[str, float] = {}
    for layout in ("packed", "full"):
        if layout == "packed" and grid.nx % 2:
            continue
        t_poisson_layouts[layout] = timed(
            lambda b=layout: poisson.solve(rhs, grid.dx, grid.dy,
                                           iters=grid.poisson_iters,
                                           omega=grid.poisson_omega,
                                           backend=b))

    # -- the actuation interval: plain loop vs the fused kernel -------------
    t_interval_backends: Dict[str, float] = {}
    for b in ["reference"] + (["fused"] if grid.nx % 2 == 0 else []):
        t_interval_backends[b] = timed(lambda b=b: solver.step_interval(
            grid, ga, st, zero, INTERVAL_PROBE_STEPS, backend=b))

    # -- policy inference + PPO update --------------------------------------
    obs_dim = layout_size("ring149")
    pcfg = networks.PolicyConfig(obs_dim=obs_dim)
    model = networks.init_actor_critic(pcfg, gen, device=dev)
    obs = torch.zeros((obs_dim,), device=dev)
    with torch.no_grad():
        t_policy = timed(lambda: networks.sample_action(model, obs,
                                                        generator=gen))

    n_rows = n_envs_probe * horizon
    batch = Batch(obs=torch.zeros((n_rows, obs_dim), device=dev),
                  act=torch.zeros((n_rows, 1), device=dev),
                  logp_old=torch.zeros((n_rows,), device=dev),
                  adv=torch.ones((n_rows,), device=dev),
                  ret=torch.zeros((n_rows,), device=dev))
    optimizer = make_optimizer(ppo_cfg)
    opt_state = optimizer.init(list(model.parameters()))
    t_update = timed(lambda: ppo_update(ppo_cfg, optimizer, model, opt_state,
                                        batch, 0, generator=gen))

    # -- trajectory spill (the paper's file-interface axis) ------------------
    own_dir = sink_dir is None
    root = sink_dir or tempfile.mkdtemp(prefix="autotune_io_")
    sink = FileSink(root, codec="binary")
    zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    traj = Trajectory(obs=zeros(n_envs_probe, horizon, obs_dim),
                      act=zeros(n_envs_probe, horizon, 1),
                      logp=zeros(n_envs_probe, horizon),
                      reward=zeros(n_envs_probe, horizon),
                      cd=zeros(n_envs_probe, horizon),
                      cl=zeros(n_envs_probe, horizon),
                      last_obs=zeros(n_envs_probe, obs_dim))
    t0 = time.perf_counter()
    nbytes = sink.write(0, traj)
    t_io = max(time.perf_counter() - t0, 1e-9)
    if own_dir:
        sink.cleanup()

    # -- inter-host all-gather (the fleet cost term) -------------------------
    # traffic: one probe episode's trajectory payload, what the fleet engine
    # all-gathers after every rollout, from host tensors over gloo as it does
    if procs > 1:
        host = torch.zeros((1, max(1, int(nbytes) // (4 * procs))))
        t_gather = _time(all_gather_rows, host, device=torch.device("cpu"),
                         iters=iters)
        t_interhost = {"processes": procs, "bytes": float(nbytes),
                       "seconds": t_gather,
                       "bandwidth": float(nbytes) * (procs - 1) / procs
                       / max(t_gather, 1e-9),
                       "estimated": False}
    else:
        base = CostModel()
        t_interhost = {"processes": 1, "bytes": float(nbytes),
                       "seconds": base.interhost_latency
                       + float(nbytes) / base.interhost_bandwidth,
                       "bandwidth": base.interhost_bandwidth,
                       "estimated": True}

    return {
        "n_total": n_total,
        "n_devices": n_devices,
        "device": {"type": dev.type, "count": n_devices,
                   "name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")},
        "grid": {"res": grid.res, "nx": grid.nx, "ny": grid.ny},
        "horizon": horizon,
        "n_envs_probe": n_envs_probe,
        "t_step_ranks": t_step_ranks,
        "t_step_backends": step_backends,
        "t_poisson_layouts": t_poisson_layouts,
        "t_interval_backends": t_interval_backends,
        "interval_probe_steps": INTERVAL_PROBE_STEPS,
        "t_policy": t_policy,
        "t_update": t_update,
        "io": {"bytes_per_episode_env": nbytes / n_envs_probe,
               "bytes_per_actuation": nbytes / (n_envs_probe * horizon),
               "stream_bandwidth": nbytes / t_io,
               "write_seconds": t_io},
        "t_interhost": t_interhost,
    }


# ---------------------------------------------------------------------------
# refit
# ---------------------------------------------------------------------------

def refit_cost_model(measured: Dict[str, Any],
                     base: Optional[CostModel] = None) -> CostModel:
    """CostModel with constants refit to measurements, as the reference's.

    The CFD scaling constants (t_step_1, serial_frac, comm_frac_log2) come
    from a least-squares fit of the Amdahl + halo-cost shape to the measured
    per-rank step times (``scaling_model.least_squares_fit``); with one
    rank measured only t_step_1 moves.  Directly measured components
    (t_policy, t_update, I/O volume and stream bandwidth) replace their
    constants outright; the aggregate disk bandwidth and the per-episode
    management overhead keep the paper-calibrated *ratios*, scaled by the
    measured stream bandwidth and update time respectively.
    """
    from repro_torch.core.scaling_model import least_squares_fit

    base = base or CostModel()
    steps = {int(k): float(v) for k, v in measured["t_step_ranks"].items()}
    t1 = steps.get(1, base.t_step_1)

    if len(steps) >= 3:
        def resid(x):
            t1_, s, c = np.abs(x)
            s = min(s, 0.9)
            m = dataclasses.replace(base, t_step_1=t1_, serial_frac=s,
                                    comm_frac_log2=c)
            return [m.t_step(r) / t - 1.0 for r, t in steps.items()]
        x0 = [t1, base.serial_frac, base.comm_frac_log2]
        t1_f, s_f, c_f = least_squares_fit(resid, x0)
        fit = dict(t_step_1=float(t1_f),
                   serial_frac=float(min(s_f, 0.9)),
                   comm_frac_log2=float(c_f))
    elif len(steps) == 2:
        # two points: pin serial_frac, solve the comm coefficient exactly
        r2 = max(r for r in steps if r > 1)
        m1 = dataclasses.replace(base, t_step_1=t1)
        comm = max(0.0, (steps[r2] - m1.t_step(r2)) / (t1 * np.log2(r2))
                   + base.comm_frac_log2)
        fit = dict(t_step_1=t1, serial_frac=base.serial_frac,
                   comm_frac_log2=float(comm))
    else:
        fit = dict(t_step_1=t1)

    io = measured["io"]
    bw_scale = io["stream_bandwidth"] / base.io_stream_bandwidth
    mgmt_scale = measured["t_update"] / base.t_update
    # a measured cross-process gather refits the inter-host bandwidth; the
    # flagged single-process estimate keeps the model's loopback default
    ih = measured.get("t_interhost") or {}
    interhost = ({"interhost_bandwidth": float(ih["bandwidth"])}
                 if ih and not ih.get("estimated", True) else {})
    return dataclasses.replace(
        base,
        t_policy=measured["t_policy"],
        t_update=measured["t_update"],
        io_bytes_per_actuation=io["bytes_per_actuation"],
        io_stream_bandwidth=io["stream_bandwidth"],
        io_bandwidth=base.io_bandwidth * bw_scale,
        mgmt_log_s=base.mgmt_log_s * mgmt_scale,
        **interhost, **fit)


# ---------------------------------------------------------------------------
# the autotuner
# ---------------------------------------------------------------------------

def autotune(n_total: Optional[int] = None, *, grid=None, ppo_cfg=None,
             n_episodes: int = 3000, io_bytes: Optional[float] = None,
             horizon: int = 32, iters: int = 3, seed: int = 0,
             artifact: Optional[str] = None, base: Optional[CostModel] = None,
             max_processes: Optional[int] = None, smoke: bool = False,
             device: DeviceLike = "cuda") -> ResolvedPlan:
    """Measure -> refit -> optimize -> ResolvedPlan (+ JSON artifact).

    ``n_total`` defaults to the fleet's device count (the executable
    budget).  ``max_processes`` caps the fleet layouts the optimizer may
    pick (default: however many processes this fleet has, so a standalone
    run never plans processes it cannot execute); a layout is feasible
    when each process's share of the workers fits its local devices.
    ``artifact`` writes the measured-vs-predicted record; ``smoke`` shrinks
    the probe (1 timing iteration, short horizon).  ``device`` is where the
    components are measured: ``"cuda"`` raises on a host without a card.
    Only single-rank plans are candidates (one card measures no multi-rank
    step, and the halo backend is not ported).  In a multi-process fleet
    every process measures (the all-gather needs them all) and all adopt
    process 0's plan, so the replicated learners run one backend; process
    0 writes the artifact.
    """
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.launch.distributed import fleet_info

    dev = resolve_device(device)
    grid = grid or GridConfig(res=6)
    if smoke:
        iters, horizon = 1, 8
    if max_processes is None:
        max_processes = fleet_info().num_processes
    measured = measure_components(grid, n_total=n_total, ppo_cfg=ppo_cfg,
                                  horizon=horizon, iters=iters, seed=seed,
                                  device=dev)
    n_total = measured["n_total"]
    model = refit_cost_model(measured, base=base)
    # optimize over the EXECUTABLE lattice only: single-rank plans whose
    # per-process share of the n_total workers fits one process's devices
    # (a budget that fits one process keeps n_processes = 1: inter-process
    # comms are pure cost)
    local = len(plan_devices(dev))
    plans = [p for p in enumerate_plans(n_total, max_processes)
             if p.n_ranks == 1 and n_total // p.n_processes <= local]
    if not plans:
        raise ValueError(
            f"no executable plan: n_total = {n_total} workers cannot be "
            f"placed on {max_processes} host(s) x {local} local devices")
    best = min(plans, key=lambda p: (model.t_training(p, n_episodes,
                                                      io_bytes),
                                     -p.utilization, p.n_ranks,
                                     p.n_processes))
    backend = default_backend(best.n_ranks, grid.nx, dev)
    # the measured layout pick: on single-rank plans without the kernel the
    # chosen layout IS the backend (both are poisson.solve backends)
    layouts = measured["t_poisson_layouts"]
    layout = min(layouts, key=layouts.get) if layouts else "full"
    if backend == "reference":
        backend = layout
    # single-rank plans upgrade to the fused actuation-interval path when
    # its measured interval time beats the plain loop
    intervals = measured.get("t_interval_backends", {})
    if "fused" in intervals and intervals["fused"] <= min(intervals.values()):
        backend = "fused"

    steps = {int(k): float(v) for k, v in measured["t_step_ranks"].items()}
    predicted = {r: model.t_step(r) for r in steps}
    record = {
        "schema": AUTOTUNE_SCHEMA,
        "measured": measured,
        "fitted": {f.name: getattr(model, f.name)
                   for f in dataclasses.fields(model)},
        "predicted": {
            "t_step_ranks": predicted,
            "rel_err_t_step": {r: predicted[r] / steps[r] - 1.0
                               for r in steps},
            "t_episode_s": model.t_episode(best, io_bytes),
        },
        "plan": {
            "n_total": n_total,
            "n_envs": best.n_envs,
            "n_ranks": best.n_ranks,
            "n_processes": best.n_processes,
            "mesh_shape": list(best.mesh_shape),
            "utilization": best.utilization,
            "backend": backend,
            "layout": layout,
        },
        "candidates": [
            {"n_envs": p.n_envs, "n_ranks": p.n_ranks,
             "n_processes": p.n_processes,
             "utilization": p.utilization,
             "t_training_s": model.t_training(p, n_episodes, io_bytes)}
            for p in plans
        ],
    }
    resolved = ResolvedPlan(plan=best, backend=backend, model=model,
                            source="auto", measurements=record, layout=layout)
    info = fleet_info()
    if info.num_processes > 1:
        # one plan for the fleet: process 0's measurement decides
        box = [resolved]
        torch.distributed.broadcast_object_list(box, src=0)
        resolved = box[0]
    if artifact and info.is_coordinator:      # one writer in a fleet
        path = Path(artifact)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(resolved.measurements, indent=1,
                                   default=float))
    return resolved


def validate_artifact(record: Dict[str, Any]) -> None:
    """Raise ValueError unless ``record`` matches the artifact schema (the
    reference's checks, so either package's artifact passes both)."""
    if record.get("schema") != AUTOTUNE_SCHEMA:
        raise ValueError(f"bad schema tag: {record.get('schema')!r} != "
                         f"{AUTOTUNE_SCHEMA!r}")
    for key in ("measured", "fitted", "predicted", "plan", "candidates"):
        if key not in record:
            raise ValueError(f"artifact missing {key!r}")
    for key in ("t_step_ranks", "t_poisson_layouts", "t_interval_backends",
                "t_policy", "t_update", "io", "t_interhost"):
        if key not in record["measured"]:
            raise ValueError(f"artifact.measured missing {key!r}")
    plan = record["plan"]
    for key in ("n_total", "n_envs", "n_ranks", "n_processes", "mesh_shape",
                "utilization", "backend", "layout"):
        if key not in plan:
            raise ValueError(f"artifact.plan missing {key!r}")
    if plan["n_envs"] * plan["n_ranks"] > plan["n_total"]:
        raise ValueError(f"over-subscribed plan in artifact: {plan}")
    if not record["candidates"]:
        raise ValueError("artifact has no candidate plans")
