"""The executable form of a plan: a ("data", "model") grid of workers.

Port of ``repro.launch.mesh`` for the plan path.  A :class:`Mesh` is an
``(n_envs, n_ranks)`` grid of ``torch.device``s with the reference's axis
names, so ``mesh.shape["model"]`` reads as there.  A "model" row is one
env's x-slabs (``cfd/decomp.py``); on one process they all sit on the
env's device, side by side as a rank dimension of the same tensors.
Several workers may name the same device: ``REPRO_TORCH_FORCE_DEVICE_COUNT``
(read by ``core.autotune.plan_devices``) makes the host's devices serve N
workers, the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=N``.  In a fleet the
"data" axis spans the processes and each process holds whole envs (every
slab of an env on that process's device), the reference's intra-host halo
rule: a halo message never leaves its process.

The language model's meshes are :class:`AbstractMesh`es: a map from axis
names to sizes and nothing else (``make_abstract_mesh``,
``make_production_mesh``).  The sharding functions
(``models/sharding.py``, ``models/act_sharding.py``) read only a mesh's
``.shape``, so they take either kind.  The language model runs as a
single controller: every tensor stays on the one device its caller chose,
and where the reference's numbers depend on the mesh (the expert-parallel
dispatch of ``models/moe_shard_map.py``) the ranks are a dimension of the
port's tensors.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike

AXES = ("data", "model")


class AbstractMesh:
    """A device-less mesh: axis names and sizes (``.shape``, an
    ``OrderedDict`` as the plan-path :class:`Mesh` has), for the specs and
    the single-controller language model."""

    def __init__(self, shape, axes):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"a mesh needs one size per distinct axis, got "
                             f"{shape} over {axes}")
        self.axis_names = axes
        self.shape = OrderedDict(zip(axes, shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return "AbstractMesh(" + ", ".join(
            f"{a}={n}" for a, n in self.shape.items()) + ")"


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    """A device-less mesh of ``shape`` over ``axes``."""
    return AbstractMesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The dry run's production mesh: one pod, (16, 16) over ("data",
    "model"), or two, (2, 16, 16) over ("pod", "data", "model"), the pod
    axis pure data parallelism.  Abstract: one process cannot hold 256 or
    512 cards, so it serves the specs, the per-device byte counts of
    ``launch/dryrun.py`` and the single-controller model on one card."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


class Mesh:
    """``devices``: an ``(n_envs, n_ranks)`` object array of
    ``torch.device``; ``processes``: the fleet process of each worker
    (zeros outside a fleet)."""

    axis_names = AXES

    def __init__(self, devices, processes=None):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-D (data, model) grid, got shape "
                             f"{self.devices.shape}")
        self.processes = (np.zeros(self.devices.shape, dtype=np.int64)
                          if processes is None
                          else np.asarray(processes).reshape(
                              self.devices.shape))

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(AXES, self.devices.shape))

    @property
    def local_device(self) -> torch.device:
        """Where this process places the env batch: its first worker's
        device."""
        from repro_torch.launch.distributed import fleet_info
        mine = self.devices[self.processes == fleet_info().process_id]
        return (mine if mine.size else self.devices).flat[0]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return (f"Mesh(data={self.devices.shape[0]}, "
                f"model={self.devices.shape[1]}, devices={devs})")


def make_debug_mesh(n_data: int = 1, n_model: int = 1,
                    device: DeviceLike = "cuda") -> Mesh:
    """Small mesh over the host's workers (tests / examples)."""
    return mesh_for_plan((n_data, n_model), device=device)


def mesh_for_plan(plan, devices: Optional[Sequence[torch.device]] = None, *,
                  span_processes: Optional[bool] = None,
                  device: DeviceLike = "cuda") -> Mesh:
    """A ("data", "model") mesh shaped (n_envs, n_ranks) over the first
    ``n_envs * n_ranks`` workers; a plan smaller than the host leaves the
    rest idle.  ``plan``: a ParallelPlan, a ResolvedPlan or an (n_envs,
    n_ranks) pair.

    With ``devices`` None the workers are the plan's
    (``ResolvedPlan.build_mesh``, on ``device``): this host's workers, or
    in a live fleet (``span_processes`` None and a fleet active) the plan's
    data groups spread over the processes, each process's on its own card.
    A process must then hold whole envs, so halo exchanges stay inside it:
    a layout whose per-process share is not a multiple of ``n_ranks``
    raises ``ValueError``, as the reference's does."""
    n_envs, n_ranks = (plan.mesh_shape if hasattr(plan, "mesh_shape")
                       else tuple(plan))
    n = n_envs * n_ranks
    if devices is None:
        from repro_torch.core.autotune import resolve_plan
        from repro_torch.launch import distributed as dist_mod
        if span_processes is None:
            span_processes = dist_mod.fleet_active()
        workers = resolve_plan((n_envs, n_ranks), device=device).build_mesh(
            device, span_processes=span_processes)
        if span_processes:
            procs = [p for p, _ in workers]
            devs = [d for _, d in workers]
            return Mesh(np.asarray(devs, dtype=object).reshape(n_envs,
                                                               n_ranks),
                        np.asarray(procs).reshape(n_envs, n_ranks))
        devices = workers
    devices = list(devices)
    if n > len(devices):
        raise ValueError(
            f"plan needs n_envs * n_ranks = {n} devices but this host has "
            f"{len(devices)}; shrink the plan or force more workers per "
            f"device (REPRO_TORCH_FORCE_DEVICE_COUNT={n})")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(n_envs, n_ranks))


def slab_device(mesh: Mesh, axis: str = "model") -> torch.device:
    """The one device an env's slabs share.  Slabs on several devices are
    not ported: a "model" row naming more than one raises.  An
    :class:`AbstractMesh` names no device: its slabs are meta tensors (the
    DRL dry run, ``launch/dryrun_drl.py``)."""
    if isinstance(mesh, AbstractMesh):
        return torch.device("meta")
    rows = np.moveaxis(mesh.devices, AXES.index(axis), -1).reshape(
        -1, mesh.shape[axis])
    for row in rows:
        if len({str(d) for d in row}) > 1:
            raise NotImplementedError(
                f"the {axis!r} row {[str(d) for d in row]} spreads an env's "
                f"x-slabs over several devices: slabs on several cards are "
                f"not ported to repro_torch yet; every slab of an env runs "
                f"on one device, as a rank dimension of its tensors "
                f"(REPRO_TORCH_FORCE_DEVICE_COUNT serves the plan's workers "
                f"from one device)")
    return rows[0][0]
