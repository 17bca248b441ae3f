"""Multi-process fleet bootstrap: span the engine's "data" axis over
processes.

Port of ``repro.launch.distributed``.  One coordinator/runner shape
(drlfoam's ``LocalBuffer`` / ``SlurmBuffer`` split): every runner process
calls :func:`initialize_fleet` before it trains, which joins a
``torch.distributed`` process group over gloo.  Each process rolls out its
own shard of the env batch on its own card; the trajectories are copied to
the host and all-gathered over gloo (gloo's collectives on CUDA tensors are
not dependable, and NCCL puts no two ranks on one card), and the PPO
learner then runs replicated on every process over the full batch
(``drl/engine.py``).

Two launch paths share this module:

* ``python -m repro_torch.launch.fleet``: the single-command local
  launcher and elastic supervisor; forks N runner processes with the
  environment :func:`fleet_env` builds.
* a cluster scheduler: each task exports the same ``REPRO_*`` variables and
  runs the same entry point.

Bitwise-parity contract (across fleet sizes): ``fleet_env`` pins the CPU
thread count to one value in every runner at every fleet size
(``OMP_NUM_THREADS``, applied with ``torch.set_num_threads`` by
:func:`initialize_fleet`), since the order of a CPU reduction depends on
it, and fixes ``CUBLAS_WORKSPACE_CONFIG`` so cuBLAS is repeatable under
``torch.use_deterministic_algorithms``.  The engine's fleet path does the
rest (the same policy chunks, the same noise draws, the fused kernel's
cluster fixed at every fleet size).

Heartbeats: runners stamp a per-process JSON file each episode, in the
reference's format (``hb_{pid:03d}.json``), so either package's
supervisor reads the other's beats.
"""
from __future__ import annotations

import datetime
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

# env vars the launcher (or a cluster scheduler) exports for every runner
ENV_COORDINATOR = "REPRO_COORDINATOR"      # host:port of process 0, or a URL
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
ENV_FLEET = "REPRO_FLEET"                  # "1": fleet engine mode, any size
ENV_HEARTBEAT_DIR = "REPRO_HEARTBEAT_DIR"

# the CPU thread count fleet_env pins in every runner
FLEET_THREADS = 1
# seconds a gloo collective (or the rendezvous) waits before it raises
FLEET_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class FleetInfo:
    """The resolved fleet topology of THIS process."""
    num_processes: int
    process_id: int
    coordinator: Optional[str] = None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def fleet_env(coordinator: str, num_processes: int, process_id: int,
              n_total_devices: int, heartbeat_dir: Optional[str] = None,
              base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The runner-process environment the launcher exports.

    Pins the CPU thread count to ``FLEET_THREADS`` in every runner
    regardless of fleet size, and cuBLAS's workspace (the bitwise contract
    in the module docstring).  ``n_total_devices`` is the plan's worker
    count, the reference's argument; the port maps a process's data groups
    onto its one card, so it pins nothing here."""
    del n_total_devices
    env = dict(os.environ if base is None else base)
    env["OMP_NUM_THREADS"] = str(FLEET_THREADS)
    env["MKL_NUM_THREADS"] = str(FLEET_THREADS)
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCESSES] = str(num_processes)
    env[ENV_PROCESS_ID] = str(process_id)
    env[ENV_FLEET] = "1"
    if heartbeat_dir:
        env[ENV_HEARTBEAT_DIR] = heartbeat_dir
    return env


def init_method(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://...``,
    ``file:///path``) passes through."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_fleet(coordinator_addr: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> FleetInfo:
    """Bootstrap this process into the fleet (idempotent).

    Arguments default to the ``REPRO_*`` env vars the launcher exports; a
    bare call outside any fleet is a single-process no-op.  With
    ``num_processes > 1`` this joins a gloo process group at the
    coordinator's address; every collective then raises after
    ``FLEET_TIMEOUT_S`` seconds instead of hanging.  Applies the thread
    count ``fleet_env`` pinned (``OMP_NUM_THREADS``) in any fleet, one
    process included."""
    coordinator_addr = coordinator_addr or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROCESS_ID, "0"))
    if os.environ.get(ENV_FLEET) == "1" and "OMP_NUM_THREADS" in os.environ:
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    if num_processes <= 1:
        return FleetInfo(1, 0, coordinator_addr)
    dist = torch.distributed
    if dist.is_initialized():
        return FleetInfo(num_processes, process_id, coordinator_addr)
    if coordinator_addr is None:
        raise ValueError(
            f"initialize_fleet(num_processes={num_processes}) needs a "
            f"coordinator address (pass coordinator_addr= or export "
            f"{ENV_COORDINATOR}=host:port)")
    dist.init_process_group(
        "gloo", init_method=init_method(coordinator_addr),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=FLEET_TIMEOUT_S))
    return FleetInfo(num_processes, process_id, coordinator_addr)


def fleet_info() -> FleetInfo:
    """The live topology (after :func:`initialize_fleet`): the process
    group's size and rank, one process outside any group."""
    dist = torch.distributed
    coordinator = os.environ.get(ENV_COORDINATOR)
    if dist.is_available() and dist.is_initialized():
        return FleetInfo(dist.get_world_size(), dist.get_rank(), coordinator)
    return FleetInfo(1, 0, coordinator)


def fleet_active() -> bool:
    """True when the engine should run its fleet path: either this process
    is part of a real multi-process fleet, or the launcher pinned
    ``REPRO_FLEET=1`` (single-process fleets keep the same code path so a
    1-process run is bitwise-comparable to an N-process one)."""
    return (fleet_info().num_processes > 1
            or os.environ.get(ENV_FLEET) == "1")


def local_device(device="cuda", process_id: Optional[int] = None
                 ) -> torch.device:
    """This process's device: on CUDA the card ``process_id`` modulo the
    host's card count (every process of a one-card host shares it), else
    the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    if process_id is None:
        process_id = fleet_info().process_id
    return torch.device("cuda", process_id % max(1,
                                                 torch.cuda.device_count()))


def span_devices(n_total: int, device="cuda",
                 num_processes: Optional[int] = None
                 ) -> List[Tuple[int, torch.device]]:
    """The plan's ``n_total`` data groups over the fleet, as (process,
    device) pairs: ``n_total // num_processes`` consecutive groups on
    EVERY process (in process order), each process's on its own device
    (:func:`local_device`), so the "data" axis tiles processes.  With one
    process every group sits on this process's device."""
    procs = fleet_info().num_processes if num_processes is None \
        else num_processes
    if n_total % procs:
        raise ValueError(
            f"plan needs n_total = {n_total} devices but the fleet has "
            f"{procs} processes; n_total must divide evenly "
            f"(got {n_total} % {procs} != 0)")
    per = n_total // procs
    return [(p, local_device(device, p)) for p in range(procs)
            for _ in range(per)]


def all_gather_rows(host: torch.Tensor) -> torch.Tensor:
    """Concatenate every process's rows of a host tensor, in process order
    (one gloo all-gather); a single process returns its own."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return host
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, host.contiguous())
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# heartbeats: the liveness signal behind elastic shrink
# ---------------------------------------------------------------------------

def heartbeat_path(root: str, process_id: int) -> Path:
    return Path(root) / f"hb_{process_id:03d}.json"


def write_heartbeat(root: str, process_id: int, episode: int) -> None:
    """Atomically (tmp + replace) stamp this runner's liveness file."""
    path = heartbeat_path(root, process_id)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"process": process_id, "episode": episode,
                               "pid": os.getpid(), "time": time.time()}))
    os.replace(tmp, path)


def read_heartbeats(root: str) -> Dict[int, Dict]:
    out = {}
    for path in sorted(Path(root).glob("hb_*.json")):
        try:
            rec = json.loads(path.read_text())
            # the supervisor's own observation of the write (its clock):
            # the skew-tolerant half of the staleness check below
            rec["_mtime"] = path.stat().st_mtime
            out[int(rec["process"])] = rec
        except (OSError, ValueError, KeyError):
            continue          # mid-replace or garbage: treat as absent
    return out


def stale_processes(root: str, num_processes: int, timeout: float,
                    now: Optional[float] = None) -> List[int]:
    """Process ids whose heartbeat is older than ``timeout`` seconds (a
    runner that never heartbeated is the supervisor's child-exit path, not
    a staleness signal).

    Clock-skew tolerant: a beat's age is measured both by the wall time the
    runner stamped into the payload and by the file mtime the supervisor's
    filesystem observed, and the beat is stale only when the smaller of
    the two exceeds the timeout.  A runner whose clock lags is saved by a
    fresh mtime, a supervisor whose clock lags by a fresh payload; a truly
    hung runner ages on both."""
    now = time.time() if now is None else now
    beats = read_heartbeats(root)

    def age(rec) -> float:
        payload_age = now - rec["time"]
        mtime_age = now - rec.get("_mtime", rec["time"])
        return min(payload_age, mtime_age)

    return [p for p in range(num_processes)
            if p in beats and age(beats[p]) > timeout]


class HeartbeatReporter:
    """An ``on_episode``-shaped hook that stamps heartbeats; inert when the
    launcher exported no heartbeat dir."""

    def __init__(self, process_id: int, root: Optional[str] = None):
        self.root = root or os.environ.get(ENV_HEARTBEAT_DIR)
        self.process_id = process_id
        self.episodes = 0

    def __call__(self, *_args, **_kw) -> None:
        self.episodes += 1
        if self.root:
            write_heartbeat(self.root, self.process_id, self.episodes)
