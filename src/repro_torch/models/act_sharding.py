"""Activation-sharding constraints under a mesh, for one controller.

Port of ``repro.models.act_sharding``.  Model code calls ``constrain(x,
axes...)``; the step builders (``launch/steps.py``) set the mesh with
``activation_mesh(mesh)``.  Outside a mesh the call does nothing.  Under
one, the reference pins ``x`` to the spec (``with_sharding_constraint``);
the port runs every shard on one device, so ``constrain`` returns ``x``
itself, unchanged, after computing the spec as the reference does
(``models/sharding.spec_for``: an axis the mesh lacks, or that does not
divide its dim, is dropped; a spec that names an axis twice fails, as the
reference's ``NamedSharding`` does).  Inside
``record_constraints()`` every constraint is logged as ``(shape, spec)``.
Inside ``placing(layout)`` (the partition pass of ``launch/partition.py``)
a constraint returns ``layout.constrain(x, spec)`` (a DTensor
``redistribute``), and the two hooks the steps call, :func:`gathered` (a
parameter as the model reads it) and :func:`local_shards` (the
optimizer's operands), go through the layout too; outside it they return
their input.
Where the mesh changes what the reference computes (the one-hot embedding
lookup, the masked cache write, the decode attention chain, the
expert-parallel MoE), the model reads :func:`current_mesh`.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, List, Optional, Tuple

from repro_torch.models.sharding import P, spec_for

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_activation_mesh", default=None)
_RECORDERS: List[list] = []
_LAYOUT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_layout", default=None)


@contextlib.contextmanager
def activation_mesh(mesh):
    """Run the block under ``mesh`` (None: no mesh)."""
    tok = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(tok)


def current_mesh():
    return _ACTIVE_MESH.get()


@contextlib.contextmanager
def record_constraints() -> Iterator[List[Tuple[tuple, P]]]:
    """Record every constraint inside the block as ``(shape, spec)``."""
    log: List[Tuple[tuple, P]] = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


@contextlib.contextmanager
def placing(layout):
    """Run the block with ``layout`` (``constrain(x, spec)``,
    ``gather(x, spec)``, ``local(x)``) serving the constraints and the
    step hooks."""
    tok = _LAYOUT.set(layout)
    try:
        yield
    finally:
        _LAYOUT.reset(tok)


def placing_active() -> bool:
    return _LAYOUT.get() is not None


def gathered(x, spec: P):
    """A parameter as the model reads it, laid out by ``spec`` (its own
    spec less the FSDP axes) inside :func:`placing`, not recorded as a
    constraint; ``x`` itself otherwise."""
    layout = _LAYOUT.get()
    return x if layout is None else layout.gather(x, spec)


def local_shards(tree):
    """``tree`` (lists or tuples of tensors, or dicts of them) with each
    tensor as one device's shard inside :func:`placing`: an elementwise
    update, which the reference's partitioner runs on each device's shard
    without a collective; ``tree`` itself otherwise."""
    layout = _LAYOUT.get()
    if layout is None:
        return tree
    if isinstance(tree, dict):
        return {k: local_shards(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_shards(v) for v in tree)
    return layout.local(tree)


def constrain_to(x, spec: P):
    """``x`` pinned to ``spec`` on one controller: ``x`` itself (inside
    :func:`placing`, the layout's), the constraint recorded."""
    for log in _RECORDERS:
        log.append((tuple(x.shape), spec))
    layout = _LAYOUT.get()
    return x if layout is None else layout.constrain(x, spec)


def constrain(x, *axes):
    """``x`` constrained to ``P(axes...)`` (padded with None) if a mesh is
    active; ``x`` itself either way."""
    mesh = _ACTIVE_MESH.get()
    if mesh is None:
        return x
    axes = axes + (None,) * (x.dim() - len(axes))
    spec = spec_for(mesh, x.shape, *axes)
    names = [a for e in spec if e is not None
             for a in (e if isinstance(e, tuple) else (e,))]
    if len(names) != len(set(names)):
        # the reference's NamedSharding refuses an axis used twice
        raise ValueError(f"constrain: {spec} uses a mesh axis twice")
    return constrain_to(x, spec)


def dp(mesh: Optional[object] = None):
    """The batch axes: ("pod", "data") when the mesh has a pod axis."""
    mesh = mesh or _ACTIVE_MESH.get()
    if mesh is not None and "pod" in mesh.shape:
        return ("pod", "data")
    return "data"
