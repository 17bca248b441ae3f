"""One run of a cell: set-up, the measured window, the traced window's
reading, and the comparison with the reference.

Set-up (``setup_s``, from the process's start to the window's): the
imports and the CUDA context, the kernel libraries (built on a
checkout's first run, loaded from ``build/repro_torch_kernels/`` after),
the env batch with its warmup and C_D0 calibration, the engine and the
model with the benchmark's weights, and the first episodes, which warm up
this cell's shapes and which the reference follows once the window has
closed.

The window drives ``RolloutEngine.run_sync``, one episode a call (collect,
postprocess, PPO update), until ``seconds`` have passed; every episode
begun runs to its end.  ``env_steps_per_s`` is the env-steps (envs x
actions) of every episode over the seconds from the window's start to the
end of the last one.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from afcbench import check, program, trace, yardstick
from afcbench.cells import Cell, read_per_layer

# the first episodes, run in set-up through the window's own call; the
# intervals of each that the reference recomputes
SETUP_EPISODES = 2
INTERVALS_PER_EPISODE = 2


def setup_episodes(prog: program.Program, inputs: program.Inputs, seed: int,
                   episodes: int = SETUP_EPISODES) -> check.SetupRecord:
    """Drive the fresh training object through its first episodes with
    ``run_sync``, keeping what the reference needs: the sampled intervals
    (the env step wrapped while they run), the optimizer's first calls
    (the optimizer wrapped likewise) and the losses they step on, the
    trajectories and the parameters after each episode."""
    horizon = prog.env.cfg.actions_per_episode
    rec = check.SetupRecord(params0=program.params_of(prog.model), perms=[])
    recorder = program.Recorder(
        prog.engine.env_step_fn, horizon,
        program.sample_intervals(seed, episodes, horizon,
                                 min(INTERVALS_PER_EPISODE, horizon)))
    opt_rec = program.OptimizerRecorder(prog.optimizer, list(rec.params0),
                                        check.STEPS + 1)
    own_step, own_opt = prog.engine.env_step_fn, prog.optimizer
    prog.engine.env_step_fn, prog.optimizer = recorder, opt_rec.wrapped
    try:
        with program.recording_losses(check.STEPS) as losses:
            for _ in range(episodes):
                noise, perms = inputs.next()
                ep = prog.episode(noise, perms)
                rec.perms.append(perms)
                rec.trajs.append(ep.traj)
                rec.params.append(program.params_of(prog.model))
    finally:
        prog.engine.env_step_fn, prog.optimizer = own_step, own_opt
    rec.intervals = recorder.records
    rec.steps = opt_rec.steps
    rec.losses = losses
    return rec


def _spans(prog: program.Program) -> list:
    """Wrap the engine's layers in the benchmark's own spans (traced runs
    only): collect, postprocess, update and each env step, each a profiler
    range and a (name, start, end) on the host's wall clock, the clock the
    profiler's timestamps follow, in the list returned."""
    engine = prog.engine
    rf = torch.profiler.record_function
    kept = []

    def wrap(name: str, fn: Callable) -> Callable:
        label = f"{trace.SPAN}{name}"

        def spanned(*a, **kw):
            t0 = time.time()
            with rf(label):
                out = fn(*a, **kw)
            kept.append((label, t0, time.time()))
            return out
        return spanned

    engine.collect = wrap("collect", engine.collect)
    engine.postprocess = wrap("postprocess", engine.postprocess)
    engine._update = wrap("update", engine._update)
    engine.env_step_fn = wrap("env_step", engine.env_step_fn)
    return kept


def window(prog: program.Program, inputs: program.Inputs, seconds: float,
           device) -> dict:
    """Episodes until ``seconds`` have passed.  Keeps of each episode only
    what the failure count reads once the window has closed: its skipped
    updates and its validity mask (0 where an env was quarantined)."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    outcomes, ends = [], []
    sync()
    t0 = t_end = time.perf_counter()
    while t_end - t0 < seconds:
        noise, perms = inputs.next()
        ep = prog.episode(noise, perms)
        outcomes.append((ep.metrics.get("grad_skips"), ep.traj.valid))
        sync()
        t_end = time.perf_counter()
        ends.append(t_end)
    return {"t0": t0, "t_end": t_end, "outcomes": outcomes, "ends": ends}


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_origin: float, log: Callable[[str], None] = lambda s: None
        ) -> dict:
    """One run; returns the result line's fields and the numbers compared
    (``compared``)."""
    device = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    unbuilt = program.unbuilt_kernels()
    env, st_b, obs_b = program.build_env(cfg, mix, device)
    prog = program.build_program(env, st_b, obs_b, cfg, mix, seed, device,
                                 timing=traced)
    horizon = env.cfg.actions_per_episode
    n_envs = int(mix["n_envs"])
    inputs = program.Inputs(seed, n_envs, horizon, prog.act_dim,
                            prog.ppo_cfg.epochs, device)
    rec = setup_episodes(prog, inputs, seed)
    counters0 = program.kernel_counters()
    prog.engine.stats.update(collect_s=0.0, update_s=0.0, episodes=0)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_origin
    built = program.kernels_built(unbuilt)
    log(f"setup {setup_s:.3f} s, kernel libraries built in it: "
        f"{built or 'none'}")

    prof = None
    if traced:
        host_spans = _spans(prog)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU])
        prof.__enter__()
    try:
        w = window(prog, inputs, seconds, device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    counters = {k: v - counters0[k]
                for k, v in program.kernel_counters().items()}
    span = w["t_end"] - w["t0"]
    episodes = len(w["outcomes"])
    failed = sum(int((skips is not None and float(skips) > 0)
                     or (valid is not None and float(valid.min()) < 1.0))
                 for skips, valid in w["outcomes"])
    steps = episodes * n_envs * horizon
    result: Dict[str, object] = {"attempted": episodes, "failed": failed,
                                 "kernels_built": built}
    lengths = [b - a for a, b in zip([w["t0"]] + w["ends"], w["ends"])]
    ordered = sorted(lengths)
    log(f"window {span:.3f} s, {episodes} episodes of {ordered[0]:.4f} / "
        f"{ordered[len(ordered) // 2]:.4f} / {ordered[-1]:.4f} s (min / "
        f"median / max), launches {counters}")
    log("episode seconds " + " ".join(f"{x:.4f}" for x in lengths))

    if traced:
        dev_ev, spans = trace.events(prof)
        spans = spans or sorted(host_spans, key=lambda x: x[1])
        del prof
        busy = trace.busy_s(dev_ev)
        n_bodies = 3 if prog.act_dim > 1 else 0
        grid = env.cfg.grid
        flops, nbytes = yardstick.interval_work(
            grid.ny, grid.nx, grid.poisson_iters, n_envs,
            env.cfg.steps_per_action, n_bodies, 1)
        pol = cfg["policy"]
        record = {
            "episodes": episodes, "intervals": episodes * horizon,
            "window_s": span, "busy_s": busy, "device": dev_ev,
            "stats": dict(prog.engine.stats), "counters": counters,
            "interval_flops": flops, "interval_bytes": nbytes,
            "policy_flops": yardstick.policy_flops(
                prog.obs_dim, prog.act_dim, int(pol["hidden"]),
                int(pol["depth"]), n_envs, horizon, prog.ppo_cfg.epochs),
        }
        result["metrics"] = read_per_layer(cell, record)
        result["breakdown"] = {"device_ops": trace.top_ops(dev_ev),
                               "idle_gaps": trace.idle_gaps(dev_ev, spans)}
        result["busy_s"], result["window_s"] = busy, span
        del dev_ev, spans
    else:
        taken = {"env_steps_per_s": steps / span, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": taken[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["memory_peak_bytes"] = memory_peak

    # the program's state goes before the reference runs: the trajectories
    # and parameters the comparison needs are held by ``rec``
    del prog, env, st_b, obs_b, inputs, w
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    found = check.compare(rec, cfg, mix, device)
    correct, shown = check.judge(found, cell.limits)
    log(f"reference {time.perf_counter() - t_check:.3f} s")
    result["correct"] = correct
    result["compared"] = shown
    return result
