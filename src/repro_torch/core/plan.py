"""Hybrid parallelization planner: the paper's central contribution.

Port of ``repro.core.plan`` (pure float64 Python, kept as its own copy).

A DRL x CFD job on ``n_total`` workers can split into ``n_envs`` parallel
environments x ``n_ranks`` workers per CFD instance (paper §II.D):

    n_total = n_envs * n_ranks

``CostModel`` predicts the wall time of one training episode for any split
from a handful of calibrated constants; ``optimize_plan`` brute-forces the
divisor lattice.  The paper's empirical finding — *the optimum is n_ranks = 1
(favor the environment axis) until I/O saturates* — falls out of the model.
A plan's workers are devices: n_envs -> the "data" axis, n_ranks -> the
"model" axis (``core.autotune.ResolvedPlan.build_mesh``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class ParallelPlan:
    n_total: int
    n_envs: int
    n_ranks: int
    # hosts (processes) the "data" axis spans; 1 = the classic
    # single-host plan.  Each host holds n_total // n_processes workers and
    # whole envs only (the halo axis never crosses a host boundary).
    n_processes: int = 1

    def __post_init__(self):
        if min(self.n_total, self.n_envs, self.n_ranks,
               self.n_processes) < 1:
            raise ValueError(f"ParallelPlan fields must all be >= 1: {self}")
        if self.n_envs * self.n_ranks > self.n_total:
            raise ValueError(
                f"over-subscribed plan: n_envs * n_ranks = "
                f"{self.n_envs * self.n_ranks} exceeds the worker budget "
                f"n_total = {self.n_total}: {self}")
        if self.n_processes > 1:
            if self.n_total % self.n_processes:
                raise ValueError(
                    f"n_processes = {self.n_processes} must divide n_total "
                    f"= {self.n_total} (equal worker shards per host): "
                    f"{self}")
            if (self.n_total // self.n_processes) % self.n_ranks:
                raise ValueError(
                    f"each host's {self.n_total // self.n_processes} "
                    f"workers must hold whole envs (a multiple of n_ranks "
                    f"= {self.n_ranks}) so halo exchanges stay intra-host: "
                    f"{self}")

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        """(data, model) axis sizes of the plan's device grid."""
        return (self.n_envs, self.n_ranks)

    @property
    def utilization(self) -> float:
        """Fraction of the worker budget actually busy (1.0 = no idle
        workers; < 1 when n_ranks does not divide n_total)."""
        return self.n_envs * self.n_ranks / self.n_total


@dataclass(frozen=True)
class CostModel:
    """Calibrated per-component costs (seconds unless noted).

    CFD intra-instance scaling (paper Fig. 7): Amdahl serial fraction +
    per-exchange halo cost: per-shard compute shrinks ~1/n while halo
    exchanges per Poisson sweep are ~flat.
    """
    # single-worker compute time of one CFD solver step
    t_step_1: float = 5.4e-3
    # serial (non-parallelizable) fraction of a step (setup, reductions, BCs)
    serial_frac: float = 0.06
    # communication cost coefficient (fraction of t_step_1 per log2(n_ranks)):
    # halo exchanges + pressure-solver reductions grow with rank count.
    # Fitted to the paper's Fig. 7 (eff ~90% @2 ranks, <20% @16 ranks).
    comm_frac_log2: float = 0.053
    # DRL policy update cost per episode (amortized over envs: one update)
    t_update: float = 2.0
    # policy inference + misc per actuation period
    t_policy: float = 2.0e-3
    # I/O: bytes written+read per env per actuation period, and shared bw
    io_bytes_per_actuation: float = 5.0e6       # paper: 5.0 MB baseline
    io_bandwidth: float = 6.0e8                 # shared disk, bytes/s (aggregate)
    io_stream_bandwidth: float = 1.5e8          # single-stream ceiling, bytes/s
    io_serial: float = 1.0e-3                   # per-file open/parse overhead
    # multi-env management overhead per episode-round (thread scheduling,
    # batching, sync barriers).  Paper Table II's io-DISABLED column still
    # degrades with n_envs — this term captures it; ~log growth fits.
    mgmt_log_s: float = 38.0
    # episode structure (paper: 100 actuation periods x 50 solver steps)
    steps_per_actuation: int = 50
    actuations_per_episode: int = 100
    # inter-host comms (fleet plans, n_processes > 1): the per-episode
    # trajectory all-gather — the replicated learner exchanges trajectories,
    # never gradients, so traffic is the recorded episode volume.  Latency
    # is per collective (one all-gather per episode), bandwidth the
    # host-to-host link.  Defaults model localhost loopback; autotune
    # refits them from a measured cross-process gather when one exists.
    interhost_latency: float = 2.0e-4
    interhost_bandwidth: float = 1.0e9          # bytes/s

    # ---- component models --------------------------------------------------

    def t_interhost(self, plan: "ParallelPlan",
                    io_bytes: Optional[float] = None) -> float:
        """Per-episode inter-host cost: all-gathering every other host's
        env-shard trajectories (zero for single-host plans)."""
        import math
        p = plan.n_processes
        if p <= 1:
            return 0.0
        v = self.io_bytes_per_actuation if io_bytes is None else io_bytes
        remote = (self.actuations_per_episode * v * plan.n_envs
                  * (p - 1) / p)
        return (self.interhost_latency * math.log2(p)
                + remote / self.interhost_bandwidth)

    def t_step(self, n_ranks: int) -> float:
        """One CFD solver step on n_ranks workers (paper Fig. 7 shape)."""
        import math
        if n_ranks <= 1:
            return self.t_step_1
        par = self.t_step_1 * (1 - self.serial_frac) / n_ranks
        ser = self.t_step_1 * self.serial_frac
        comm = self.t_step_1 * self.comm_frac_log2 * math.log2(n_ranks)
        return par + ser + comm

    def cfd_efficiency(self, n_ranks: int) -> float:
        return self.t_step(1) / (n_ranks * self.t_step(n_ranks))

    def t_io_per_actuation(self, n_envs: int, io_bytes: Optional[float] = None
                           ) -> float:
        """File interface cost per actuation per env.

        All envs dump concurrently into shared storage: below saturation the
        cost is per-env volume/bandwidth + serial overhead; past saturation
        the shared bandwidth is divided (paper Fig. 10's blow-up at
        N_envs > 30)."""
        v = self.io_bytes_per_actuation if io_bytes is None else io_bytes
        if v <= 0:
            return 0.0
        per_env_bw = min(self.io_stream_bandwidth,
                         self.io_bandwidth / max(1, n_envs))
        return v / per_env_bw + self.io_serial

    def t_episode(self, plan: ParallelPlan,
                  io_bytes: Optional[float] = None) -> float:
        """Wall time for ALL envs to finish one episode each + one update.

        Envs run concurrently, so episode wall time is per-env time; the
        number of episodes needed for a fixed training volume shrinks with
        n_envs (handled in t_training)."""
        import math
        t_act = (self.steps_per_actuation * self.t_step(plan.n_ranks)
                 + self.t_policy
                 + self.t_io_per_actuation(plan.n_envs, io_bytes))
        mgmt = self.mgmt_log_s * math.log(max(1, plan.n_envs))
        return (self.actuations_per_episode * t_act + self.t_update + mgmt
                + self.t_interhost(plan, io_bytes))

    def t_training(self, plan: ParallelPlan, n_episodes: int,
                   io_bytes: Optional[float] = None) -> float:
        """Total time to train n_episodes (paper Table I: 3000)."""
        rounds = -(-n_episodes // plan.n_envs)
        return rounds * self.t_episode(plan, io_bytes)

    def speedup(self, plan: ParallelPlan, n_episodes: int = 3000,
                reference: Optional[ParallelPlan] = None,
                io_bytes: Optional[float] = None) -> float:
        ref = reference or ParallelPlan(1, 1, 1)
        return (self.t_training(ref, n_episodes, io_bytes)
                / self.t_training(plan, n_episodes, io_bytes))

    def efficiency(self, plan: ParallelPlan, n_episodes: int = 3000,
                   reference: Optional[ParallelPlan] = None,
                   io_bytes: Optional[float] = None) -> float:
        return (self.speedup(plan, n_episodes, reference, io_bytes)
                / (plan.n_envs * plan.n_ranks))


def enumerate_plans(n_total: int,
                    max_processes: int = 1) -> List[ParallelPlan]:
    """All (n_envs = n_total // n_ranks, n_ranks) splits of the budget,
    ordered full-utilization first (then by n_ranks) so that downstream
    stable min()/sort() calls resolve cost ties toward busy workers.

    ``max_processes > 1`` additionally enumerates fleet layouts: every
    process count that divides ``n_total`` with whole envs per host (the
    intra-host halo constraint), fewest hosts first within each split —
    a tie on modeled cost resolves toward not paying inter-host comms."""
    out = []
    for r in range(1, n_total + 1):
        procs = [1] + [p for p in range(2, max(1, max_processes) + 1)
                       if n_total % p == 0 and (n_total // p) % r == 0]
        out.extend(ParallelPlan(n_total, n_total // r, r, p) for p in procs)
    out.sort(key=lambda pl: (-pl.utilization, pl.n_ranks, pl.n_processes))
    return out


def optimize_plan(n_total: int, model: CostModel, n_episodes: int = 3000,
                  io_bytes: Optional[float] = None,
                  max_processes: int = 1) -> ParallelPlan:
    """Brute-force the (n_envs, n_ranks[, n_processes]) divisor lattice;
    minimize train time, breaking exact cost ties toward full utilization
    (no idle workers), then toward fewer ranks per env (the paper's
    default axis), then toward fewer hosts (no inter-host comms)."""
    plans = enumerate_plans(n_total, max_processes)
    return min(plans, key=lambda p: (model.t_training(p, n_episodes,
                                                      io_bytes),
                                     -p.utilization, p.n_ranks,
                                     p.n_processes))
