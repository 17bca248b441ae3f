"""Single-command local fleet launcher with elastic shrink + resume.

Port of the reference's ``tools/launch_fleet.py``.  Forks N runner
processes on this host, each one process of a gloo ``torch.distributed``
fleet (``repro_torch.launch.distributed``): each rolls out its shard of the
env batch on its card, the trajectories are all-gathered over gloo, and
every runner trains the replicated learner on the full batch.  Every runner
gets the same pinned CPU thread count and cuBLAS workspace, and runs under
``torch.use_deterministic_algorithms``: runs of every fleet size write the
same checkpoints bit for bit.

The launcher doubles as the elastic supervisor: runners heartbeat once per
episode, and when one dies (child exit) or hangs (heartbeat older than
``--heartbeat-timeout``), the supervisor kills the survivors, shrinks the
fleet to the next process count that still divides the plan, and
relaunches with ``resume="auto"``: training continues from the latest
checkpoint on the smaller fleet, same plan, same bits.

    python -m repro_torch.launch.fleet --processes 2 --episodes 4
    python -m repro_torch.launch.fleet --device cpu --smoke

On the card every runner of a one-card host shares it (kernels from
different processes time-slice; nothing here assumes MPS).  The kernels
are built once, by the supervisor, before the runners start.  ``--device
cpu`` runs the kernels' plain versions.  Runners rendezvous through a file
under the workdir, one per fleet generation.

Machine-readable lines on stdout (tests parse these):
    FLEET_SHRINK gen=<g> procs=<old>-><new> reason=<exit|stale>
    FLEET_STATS {json}          (from process 0: bench throughput in
                                 --mode bench; train health counters in
                                 --mode train)
    FLEET_TIMING process=<p> rollout_s=<s> gather_s=<s> gather_bytes=<b>
                 fused_launches=<n> sor_launches=<n> fused_cluster=<c>
                 fused_resident_launches=<n>
                                (every runner in --mode train, and in
                                 --mode bench with REPRO_FLEET_TIMING=1;
                                 process 0's on stdout, the others' in
                                 their logs)
    FLEET_DONE episodes=<E>     (supervisor, after the fleet finishes)
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2])

# the test hook: a runner whose env carries this SIGKILLs ITSELF after that
# many episodes, a deterministic stand-in for a preempted or killed host
ENV_DIE_AFTER = "REPRO_TEST_DIE_AFTER"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=2,
                    help="fleet size to start with")
    ap.add_argument("--plan", default="4,4,1", metavar="NT,NE,NR",
                    help="ParallelPlan n_total,n_envs,n_ranks, or 'auto': "
                         "every runner measures (core.autotune with "
                         "max_processes = the fleet's size, its t_interhost a "
                         "real gloo all-gather) and the fleet adopts process "
                         "0's plan; the worker budget is then one card per "
                         "process")
    ap.add_argument("--n-envs", type=int, default=None,
                    help="env batch size (default: the plan's n_envs)")
    ap.add_argument("--episodes", type=int, default=4)
    ap.add_argument("--mode", choices=("train", "bench"), default="train")
    ap.add_argument("--measure-episodes", type=int, default=3,
                    help="bench mode: timed collects after one warmup")
    ap.add_argument("--no-gather", action="store_true",
                    help="bench mode: time the distributed rollout WITHOUT "
                         "the trajectory all-gather (the no-comms baseline)")
    ap.add_argument("--res", type=int, default=6, help="grid resolution")
    ap.add_argument("--dt", type=float, default=0.012)
    ap.add_argument("--poisson-iters", type=int, default=30)
    ap.add_argument("--steps-per-action", type=int, default=3)
    ap.add_argument("--actions-per-episode", type=int, default=3)
    ap.add_argument("--warmup", type=float, default=1.0,
                    help="uncontrolled warmup before training (t.u.)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (every runner on its card; no card raises) "
                         "or 'cpu'")
    ap.add_argument("--workdir", default=None,
                    help="heartbeats/checkpoints/logs root (default: tmp)")
    ap.add_argument("--sink-root", default=None,
                    help="dataset sink root: each runner writes its env "
                         "shard into part{NNN}/ (trajectory_dataset)")
    ap.add_argument("--heartbeat-timeout", type=float, default=120.0,
                    help="seconds without a heartbeat before a runner "
                         "counts as hung")
    ap.add_argument("--launch-timeout", type=float, default=900.0,
                    help="hard wall-clock cap per fleet generation")
    ap.add_argument("--max-generations", type=int, default=4,
                    help="shrink-and-resume attempts before giving up")
    ap.add_argument("--smoke", action="store_true",
                    help="CI preset: tiny 2-process train, asserts "
                         "completion (overrides the knobs above)")
    ap.add_argument("--kill-process", type=int, default=None,
                    help="test hook: this runner id self-SIGKILLs ...")
    ap.add_argument("--kill-episode", type=int, default=None,
                    help="... after completing this many episodes")
    ap.add_argument("--role", choices=("supervisor", "runner"),
                    default="supervisor", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.smoke:
        args.processes = min(args.processes, 2)
        args.mode = "train"
        args.episodes = 2
    if args.plan == "auto":
        args.plan_tuple = None
        if args.n_envs is None:
            ap.error("--plan auto needs --n-envs")
    else:
        args.plan_tuple = tuple(int(x) for x in args.plan.split(","))
        if len(args.plan_tuple) != 3:
            ap.error(f"--plan must be n_total,n_envs,n_ranks or 'auto' "
                     f"(got {args.plan!r})")
        if args.n_envs is None:
            args.n_envs = args.plan_tuple[1]
    return args


# ---------------------------------------------------------------------------
# runner role: executes inside each fleet process
# ---------------------------------------------------------------------------

def _train_config(args, info):
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.core.autotune import ResolvedPlan
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.drl.engine import SinkSpec
    from repro_torch.drl.ppo import PPOConfig
    from repro_torch.drl.train import TrainConfig

    workdir = Path(args.workdir)
    if args.plan_tuple is None:
        plan = "auto"
        plan_args = {"max_processes": info.num_processes,
                     "artifact": str(workdir / "autotune.json")}
    else:
        # an explicit single-rank plan's intervals run the fused kernel, a
        # multi-rank one's the halo decomposition
        plan = ParallelPlan(*args.plan_tuple)
        plan = ResolvedPlan(plan=plan, backend="fused" if plan.n_ranks == 1
                            else "halo")
        plan_args = None
    sink = None
    if args.sink_root:
        sink = SinkSpec(kind="dataset", root=args.sink_root)
    return TrainConfig(
        env=EnvConfig(grid=GridConfig(res=args.res, dt=args.dt,
                                      poisson_iters=args.poisson_iters),
                      steps_per_action=args.steps_per_action,
                      actions_per_episode=args.actions_per_episode,
                      warmup_time=args.warmup),
        ppo=PPOConfig(epochs=2, minibatches=2),
        n_envs=args.n_envs, episodes=args.episodes, seed=args.seed,
        plan=plan, plan_args=plan_args, ckpt_dir=str(workdir / "ckpt"),
        ckpt_every=1, ckpt_async=False, resume="auto", sink=sink,
        fleet=True, device=args.device)


def _print_timing(info, rollout_s, gather_s, gather_bytes) -> None:
    """This runner's FLEET_TIMING line: its rollout / gather split, its
    launches of the fused-interval and packed-SOR kernels, the fused
    kernel's last cluster size (or G) and its launches of the resident
    kernel (0s on the CPU, where their plain versions run)."""
    from repro_torch.kernels.actuation import ops as aops
    from repro_torch.kernels.poisson import ops as pops
    print(f"FLEET_TIMING process={info.process_id} "
          f"rollout_s={rollout_s:.6f} gather_s={gather_s:.6f} "
          f"gather_bytes={gather_bytes} "
          f"fused_launches={aops.fused_interval_cuda.launches} "
          f"sor_launches={pops.rb_sor_slabs_packed_cuda.launches} "
          f"fused_cluster={aops.fused_interval_cuda.last_cluster or 0} "
          f"fused_resident_launches="
          f"{aops.fused_interval_cuda.launches_resident}", flush=True)


def run_runner(args) -> None:
    import torch

    from repro_torch.launch import distributed as dist

    info = dist.initialize_fleet()       # from the REPRO_* env vars
    if args.device == "cuda":
        # raises without a card: a runner never falls back to the CPU
        torch.cuda.set_device(dist.local_device("cuda", info.process_id))
    torch.use_deterministic_algorithms(True)

    from repro_torch.drl.train import train

    die_after = int(os.environ.get(ENV_DIE_AFTER, "0"))
    hb = dist.HeartbeatReporter(info.process_id)

    def on_episode(traj, metrics):
        hb(traj, metrics)
        if die_after and hb.episodes >= die_after:
            os.kill(os.getpid(), signal.SIGKILL)    # never returns

    cfg = _train_config(args, info)
    if args.mode == "bench":
        run_runner_bench(args, cfg, info, on_episode)
        return
    health = {}
    hist, _ = train(cfg, log_fn=print if info.is_coordinator else None,
                    on_episode=on_episode, health=health)
    _print_timing(info, health["fleet_rollout_s"], health["fleet_gather_s"],
                  health["fleet_gather_bytes"])
    if info.is_coordinator:
        print("FLEET_STATS " + json.dumps({
            "mode": "train",
            "processes": info.num_processes,
            "episodes": len(hist["reward"]),
            "wall": hist["wall"].tolist(),
            "health": health,
        }), flush=True)
    print(f"RUNNER_DONE process={info.process_id} "
          f"episodes={len(hist['reward'])}", flush=True)
    _leave(info)


def _leave(info) -> None:
    """Wait for every runner, then leave the process group."""
    import torch
    if info.num_processes > 1:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


def run_runner_bench(args, cfg, info, on_episode) -> None:
    """Rollout-throughput probe: one warmup collect, then
    ``--measure-episodes`` timed collects (the card synchronised at both
    ends).  Process 0 prints FLEET_STATS."""
    import torch

    from repro_torch.cfd.env import CylinderEnv, broadcast_env_state
    from repro_torch.core.autotune import resolve_plan
    from repro_torch.drl import networks
    from repro_torch.drl.engine import (EngineConfig, RolloutEngine,
                                        place_env_batch)
    from repro_torch.launch.mesh import mesh_for_plan

    dev = torch.device(args.device)
    resolved = resolve_plan(cfg.plan, grid=cfg.env.grid, device=dev,
                            **{"smoke": True, **(cfg.plan_args or {})})
    mesh = mesh_for_plan(resolved, device=dev)
    env = CylinderEnv(cfg.env, backend=resolved.backend, mesh=mesh,
                      device=dev)
    st0, obs0 = env.reset()
    st_b, obs_b = broadcast_env_state(st0, obs0, cfg.n_envs)
    st_b = place_env_batch(mesh, st_b, resolved.n_ranks)
    env.pin_cluster(cfg.n_envs, per_body=False)
    engine = RolloutEngine.for_env(
        env, EngineConfig(n_envs=cfg.n_envs,
                          horizon=cfg.env.actions_per_episode,
                          n_ranks=resolved.n_ranks, plan=resolved,
                          fleet=True), mesh=mesh)
    pcfg = networks.PolicyConfig(obs_dim=int(obs_b.shape[-1]))
    model, _, _, gen = engine.init(pcfg, cfg.ppo, cfg.seed, dev)

    def episode():
        if args.no_gather:
            traj = engine.rollout_local(model, st_b, obs_b, generator=gen)
        else:
            _, traj = engine.collect(model, st_b, obs_b, generator=gen,
                                     record=False)
        on_episode(traj, None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    episode()                                       # warmup
    for k in ("rollout_s", "gather_s", "gather_bytes"):
        engine.stats.pop(k, None)
    t0 = time.perf_counter()
    for _ in range(args.measure_episodes):
        episode()
    elapsed = time.perf_counter() - t0
    if os.environ.get("REPRO_FLEET_TIMING"):
        _print_timing(info, engine.stats.get("rollout_s", 0.0),
                      engine.stats.get("gather_s", 0.0),
                      engine.stats.get("gather_bytes", 0))
    env_steps = (args.measure_episodes * cfg.n_envs
                 * cfg.env.actions_per_episode * cfg.env.steps_per_action)
    if info.is_coordinator:
        print("FLEET_STATS " + json.dumps({
            "processes": info.num_processes,
            "episodes": args.measure_episodes,
            "n_envs": cfg.n_envs,
            "gather": not args.no_gather,
            "env_steps": env_steps,
            "elapsed_s": elapsed,
            "env_steps_per_sec": env_steps / elapsed,
        }), flush=True)
    _leave(info)


# ---------------------------------------------------------------------------
# supervisor role: fork, watch, shrink, resume
# ---------------------------------------------------------------------------

def _shrink(n_total: int, n_ranks: int, procs: int) -> int:
    """Next viable fleet size below ``procs``: must divide n_total with
    each process holding whole envs."""
    for p in range(procs - 1, 0, -1):
        if n_total % p == 0 and (n_total // p) % n_ranks == 0:
            return p
    return 0


def _spawn(args, procs: int, gen: int, workdir: Path):
    from repro_torch.launch.distributed import fleet_env
    rendezvous = workdir / f"rdzv_gen{gen}"
    rendezvous.unlink(missing_ok=True)
    hb_dir = workdir / f"hb_gen{gen}"
    hb_dir.mkdir(parents=True, exist_ok=True)
    runner_argv = [
        sys.executable, "-m", "repro_torch.launch.fleet", "--role", "runner",
        "--plan", args.plan, "--n-envs", str(args.n_envs),
        "--episodes", str(args.episodes), "--mode", args.mode,
        "--measure-episodes", str(args.measure_episodes),
        "--res", str(args.res), "--dt", str(args.dt),
        "--poisson-iters", str(args.poisson_iters),
        "--steps-per-action", str(args.steps_per_action),
        "--actions-per-episode", str(args.actions_per_episode),
        "--warmup", str(args.warmup), "--seed", str(args.seed),
        "--device", args.device, "--workdir", str(workdir),
    ]
    if args.sink_root:
        runner_argv += ["--sink-root", args.sink_root]
    if args.no_gather:
        runner_argv += ["--no-gather"]
    n_total = args.plan_tuple[0] if args.plan_tuple else procs
    children = []
    for pid in range(procs):
        env = fleet_env(coordinator=rendezvous.resolve().as_uri(),
                        num_processes=procs, process_id=pid,
                        n_total_devices=n_total,
                        heartbeat_dir=str(hb_dir))
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        env.setdefault("PYTHONUNBUFFERED", "1")
        if (gen == 0 and args.kill_process == pid
                and args.kill_episode is not None):
            env[ENV_DIE_AFTER] = str(args.kill_episode)
        log = open(workdir / f"runner_gen{gen}_p{pid:03d}.log", "wb")
        children.append((subprocess.Popen(
            runner_argv, env=env,
            stdout=subprocess.PIPE if pid == 0 else log,
            stderr=subprocess.STDOUT if pid == 0 else log), log))
    return children, hb_dir


def _drain_proc0(children, sink):
    """Forward process 0's buffered stdout lines (its pipe is drained after
    exit; FLEET_STATS and the train log are small)."""
    p0 = children[0][0]
    out, _ = p0.communicate()
    for line in (out or b"").decode(errors="replace").splitlines():
        print(line, flush=True)
        sink.append(line)


def run_supervisor(args) -> int:
    import tempfile

    from repro_torch.launch.distributed import stale_processes

    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="fleet_"))
    workdir.mkdir(parents=True, exist_ok=True)
    args.workdir = str(workdir)
    procs, gen = args.processes, 0
    n_total, n_ranks = ((args.plan_tuple[0], args.plan_tuple[2])
                        if args.plan_tuple else (procs, 1))
    if n_total % procs or (n_total // procs) % n_ranks:
        sys.exit(f"--processes {procs} does not divide plan {args.plan} "
                 f"with whole envs per process; viable sizes divide "
                 f"n_total={n_total}")
    if args.device == "cuda":
        # one build before the fleet starts: the runners load the libraries
        from repro_torch.kernels import build
        build.build(["fused_interval", "poisson_sor"])
    lines: list = []

    while True:
        print(f"fleet gen={gen}: {procs} process(es), plan {args.plan}, "
              f"mode {args.mode}, device {args.device} -> {workdir}",
              flush=True)
        children, hb_dir = _spawn(args, procs, gen, workdir)
        deadline = time.time() + args.launch_timeout
        reason, exited = None, {}
        while reason is None:
            states = [c.poll() for c, _ in children]
            if all(s == 0 for s in states):
                break                                   # clean finish
            exited = {i: s for i, s in enumerate(states) if s not in (None, 0)}
            if exited:
                reason = "exit"
            elif stale_processes(str(hb_dir), procs,
                                 args.heartbeat_timeout):
                reason = "stale"
            elif time.time() > deadline:
                reason = "timeout"
            else:
                time.sleep(0.2)
        if reason is None:                              # success
            _drain_proc0(children, lines)
            for _, log in children:
                log.close()
            break
        for c, log in children:                         # kill survivors
            if c.poll() is None:
                c.kill()
            c.wait()
            log.close()
        dead = [i for i, (c, _) in enumerate(children) if c.returncode != 0]
        # the injected kill: its runner had SIGKILLed itself before the
        # supervisor killed anyone; any other death is a failure
        injected = (gen == 0 and args.kill_process is not None
                    and exited.get(args.kill_process) == -signal.SIGKILL)
        if reason == "exit" and not injected:
            out = children[0][0].stdout.read().decode(errors="replace") \
                if children[0][0].stdout else ""
            sys.exit(f"fleet failed: runner(s) {dead} exited "
                     f"{[children[i][0].returncode for i in dead]}; logs in "
                     f"{workdir}\n{out[-4000:]}")
        nxt = _shrink(n_total, n_ranks, procs)
        gen += 1
        if nxt == 0 or gen >= args.max_generations or reason == "timeout":
            sys.exit(f"fleet failed (reason={reason}, dead runners {dead}) "
                     f"and cannot shrink further; logs in {workdir}")
        print(f"FLEET_SHRINK gen={gen} procs={procs}->{nxt} "
              f"reason={reason}", flush=True)
        procs = nxt
        # resume="auto" in every runner picks up the latest checkpoint

    done = [line for line in lines if line.startswith("RUNNER_DONE")]
    episodes = (int(done[-1].rsplit("=", 1)[1]) if done
                else args.episodes if args.mode == "train" else 0)
    print(f"FLEET_DONE episodes={episodes}", flush=True)
    if args.smoke:
        if episodes < args.episodes:
            sys.exit(f"smoke fleet finished {episodes} of {args.episodes} "
                     f"episodes")
        print("FLEET_SMOKE_OK", flush=True)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.role == "runner":
        run_runner(args)
        return 0
    return run_supervisor(args)


if __name__ == "__main__":
    sys.exit(main())
