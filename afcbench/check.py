"""The comparison that decides ``correct``.

The set-up drives the training object through its first episodes with the
window's own call (``run_sync``, one episode a call, on inputs that differ
every episode) and keeps what they produced.  Once the window has closed,
the plain reference (``afcbench.reference``) follows them:

- the CFD interval, at intervals drawn from the seed, each from the state
  the program's step started from and with the program's action: the
  flow after it (``state``), the probes (``probes``), C_D, C_L and the
  reward (``forces``);
- the policy: the first episode's log-probabilities of the program's
  actions under the benchmark's weights (``logp``);
- the PPO update's first three optimizer steps, on the first episode's
  trajectories: each step's loss, the largest gap over the largest loss
  (``loss``), and its gradient as the optimizer got it (``grads``, by the
  worst leaf), each from the parameters the program held before the
  step; the parameters' change over the three steps, the reference's own
  steps from the benchmark's weights (``change3``, by the worst leaf);
- the first episode's whole update (40 steps): the parameters' change by
  the median leaf (``change_med``).  Past its first steps the update
  parts from the reference's by rounding alone (Adam's first steps are
  sign-like and the clipped surrogate is discontinuous), so no worst-leaf
  number holds over the whole update.

The same code judges the control: the reference in the program's place,
its interval in bfloat16 and its products in TF32.
"""
from __future__ import annotations

import contextlib
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from afcbench.reference import cfd as ref_cfd
from afcbench.reference import ppo as ref_ppo

NUMBERS = ("state", "probes", "forces", "logp", "loss", "grads", "change3",
           "change_med")
# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (it moves under Adam by round-off alone)
LEAF_FLOOR = 1e-3
# the optimizer steps the reference follows
STEPS = 3


@dataclass
class SetupRecord:
    """What the program produced in the set-up's first episodes, and the
    benchmark's inputs to them."""
    params0: Dict[str, torch.Tensor]
    perms: List[torch.Tensor]
    trajs: List[object] = field(default_factory=list)
    params: List[Dict[str, torch.Tensor]] = field(default_factory=list)
    # the optimizer's first calls: the parameters it was handed and the
    # gradients as it got them; the losses of the first STEPS
    steps: List[dict] = field(default_factory=list)
    losses: List[torch.Tensor] = field(default_factory=list)
    intervals: Dict[Tuple[int, int], dict] = field(default_factory=dict)


def ref_grid(config: dict, traffic: dict) -> ref_cfd.Grid:
    e = config["env"]
    return ref_cfd.Grid(res=int(traffic["res"]), dt=float(e["dt"]),
                        poisson_iters=int(e["poisson_iters"]),
                        poisson_omega=float(e["poisson_omega"]))


def ref_ppo_cfg(config: dict) -> ref_ppo.PPO:
    return ref_ppo.PPO(**config["ppo"])


def env_scenarios(config: dict, traffic: dict) -> List[str]:
    mix = list(traffic.get("scenarios") or [config["scenario"]])
    return [mix[i % len(mix)] for i in range(int(traffic["n_envs"]))]


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products on the card while ``on`` (the control's precision)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> Dict[str, float]:
    """Each kept leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's."""
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = statistics.median(rn.values())
    return {k: abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
            for k in keep}


def moving_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: a
    norm of at least ``LEAF_FLOOR`` of the median leaf's."""
    norms = _norms(grads)
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= LEAF_FLOOR * med]


# ---------------------------------------------------------------------------
# the CFD interval
# ---------------------------------------------------------------------------

def interval_side(rec: SetupRecord, config: dict, traffic: dict, device,
                  dtype=torch.float32) -> Dict[Tuple[int, int], dict]:
    """The reference's env step at each recorded interval, from the
    program's state before it, computed in ``dtype``."""
    grid = ref_grid(config, traffic)
    batch = ref_cfd.make_batch(grid, env_scenarios(config, traffic), device,
                               dtype)
    e = config["env"]
    out = {}
    for key, r in sorted(rec.intervals.items()):
        pre = r["pre"]
        flow = ref_cfd.Flow(*(pre[k].to(device, dtype) for k in "uvp"))
        with torch.no_grad():
            s = ref_cfd.env_step(
                grid, batch, flow, pre["amp"].to(device, dtype),
                pre["action"].to(device), pre["cd0"].to(device, dtype),
                steps_per_action=int(e["steps_per_action"]),
                beta=float(e["beta"]), omega_l=float(e["reward_omega"]))
        f32 = torch.float32
        out[key] = {"u": s.flow.u.to(f32), "v": s.flow.v.to(f32),
                    "p": s.flow.p.to(f32), "obs": s.obs.to(f32),
                    "reward": s.reward.to(f32), "cd": s.cd.to(f32),
                    "cl": s.cl.to(f32)}
    return out


def interval_numbers(prog_iv: Dict, ref_iv: Dict) -> Dict[str, float]:
    out = {"state": 0.0, "probes": 0.0, "forces": 0.0}
    for key, r in ref_iv.items():
        q = prog_iv[key]
        out["state"] = max(out["state"], *(_rel(q[k], r[k]) for k in "uvp"))
        out["probes"] = max(out["probes"], _rel(q["obs"], r["obs"]))
        scale = r["cd"].double().abs().max().clamp_min(1e-30)
        out["forces"] = max(out["forces"], *(
            float((q[k].double() - r[k].double()).abs().max() / scale)
            for k in ("cd", "cl", "reward")))
    return out


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------

def learning_side(rec: SetupRecord, config: dict, use_tf32: bool = False
                  ) -> dict:
    """The reference's agent on the first episode's trajectories: the
    log-probabilities and the update's batch under the benchmark's
    weights; the loss and the gradient of each of the first steps at the
    parameters the program held before it; its own first steps and whole
    update from the benchmark's weights."""
    cfg = ref_ppo_cfg(config)
    depth = int(config["policy"]["depth"])
    traj = rec.trajs[0]
    mask = (traj.probe_mask if traj.probe_mask is not None
            else torch.ones_like(traj.obs[:, 0]))
    with tf32(use_tf32):
        batch, logp = ref_ppo.episode_batch(
            cfg, rec.params0, traj.obs, mask, traj.act, traj.reward,
            traj.last_obs, traj.valid, depth, use_tf32)
        perm = rec.perms[0][0].to(batch["obs"].device)
        mb = batch["obs"].shape[0] // cfg.minibatches
        minis = [{k: v[perm][i * mb:(i + 1) * mb] for k, v in batch.items()}
                 for i in range(STEPS)]
        at_prog = [ref_ppo.gradient(cfg, s["params"], m, depth, use_tf32)
                   for s, m in zip(rec.steps, minis)]
        losses = [ref_ppo.loss(cfg, s["params"], m, depth, use_tf32)
                  for s, m in zip(rec.steps, minis)]
        p, opt, own = dict(rec.params0), ref_ppo.adam_init(rec.params0), []
        for i, m in enumerate(minis):
            g = ref_ppo.gradient(cfg, p, m, depth, use_tf32)
            own.append(g)
            p, opt = ref_ppo.adam_step(cfg, p, opt, g, i)
        whole, _, _ = ref_ppo.update(cfg, rec.params0,
                                     ref_ppo.adam_init(rec.params0), batch,
                                     rec.perms[0], 0, depth, use_tf32)
    return {"logp": logp, "loss": losses, "grads": at_prog,
            "own_grads": own, "after3": p, "after_update": whole}


def program_learning(rec: SetupRecord) -> dict:
    """The program's own readings of the same quantities."""
    return {"logp": rec.trajs[0].logp, "loss": rec.losses[:STEPS],
            "grads": [s["grads"] for s in rec.steps[:STEPS]],
            "after3": rec.steps[STEPS]["params"],
            "after_update": rec.params[0]}


def learning_numbers(rec: SetupRecord, prog_l: dict, ref_l: dict
                     ) -> Dict[str, float]:
    keep = moving_leaves(ref_l["own_grads"][0])
    out = {"logp": float((prog_l["logp"].double()
                          - ref_l["logp"].double()).abs().max())}
    ref_loss = [float(r) for r in ref_l["loss"]]
    out["loss"] = max(abs(float(p) - r) for p, r in zip(prog_l["loss"],
                                                         ref_loss)) / max(
        max(abs(r) for r in ref_loss), 1e-30)
    out["grads"] = max(max(leaf_gaps(p, r, keep).values())
                       for p, r in zip(prog_l["grads"], ref_l["grads"]))
    d = {s: {k: ref_l[s][k] - rec.params0[k] for k in keep}
         for s in ("after3", "after_update")}
    q = {s: {k: prog_l[s][k] - rec.params0[k] for k in keep}
         for s in ("after3", "after_update")}
    out["change3"] = max(leaf_gaps(q["after3"], d["after3"], keep).values())
    out["change_med"] = statistics.median(
        leaf_gaps(q["after_update"], d["after_update"], keep).values())
    return out


def compare(rec: SetupRecord, config: dict, traffic: dict, device,
            control: bool = False) -> Dict[str, float]:
    """The numbers of the program's run, or with ``control`` those of the
    reference put in its place in the lower precision."""
    ref_iv = interval_side(rec, config, traffic, device)
    ref_l = learning_side(rec, config)
    if control:
        prog_iv = interval_side(rec, config, traffic, device, torch.bfloat16)
        prog_l = learning_side(rec, config, use_tf32=True)
    else:
        prog_iv = {k: r["post"] for k, r in rec.intervals.items()}
        prog_l = program_learning(rec)
    return {**interval_numbers(prog_iv, ref_iv),
            **learning_numbers(rec, prog_l, ref_l)}


def judge(found: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, each number beside its limit): every number at or under
    its limit; a number without a limit fails."""
    shown, ok = {}, True
    for k in NUMBERS:
        lim = limits.get(k)
        v = found[k]
        ok = ok and lim is not None and v == v and v <= lim
        shown[k] = {"value": v, "limit": lim}
    return ok, shown
