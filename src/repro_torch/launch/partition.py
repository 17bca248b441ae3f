"""The collectives a sharded step issues: a second pass of the step on
DTensors over a fake process group.

Counterpart of what XLA's SPMD partitioner adds to the reference's
compiled step and ``repro.launch.hlo_analysis`` reads back: the
all-gathers, all-reduces, reduce-scatters, all-to-alls and
collective-permutes of one device.  The port runs a mesh as one
controller, so its own step issues none of them; this pass asks
DTensor's sharding propagation, PyTorch's partitioner, which ones the
same step needs:

* :func:`fake_mesh` opens a fake process group (no device, data or
  network: it hallucinates every collective) of the mesh's size, up to
  512 ranks, and a ``DeviceMesh`` of the mesh's shape and axis names, as
  rank 0; it refuses to start beside a live process group (a fleet's
  gloo group) and tears both down after;
* :func:`placements` turns a spec (``models/sharding.P``) into DTensor
  placements: an axis on a dim is ``Shard(dim)`` on that mesh dim, several
  axes on one dim are ordered ``Shard(dim)``s, the rest ``Replicate()``;
* :func:`count` runs ``steps.lowering_for``'s step once on meta DTensors,
  each argument placed by its spec, with ``act_sharding.constrain_to`` a
  ``redistribute`` to the constraint's spec (it stays the identity outside
  this pass), each FSDP parameter gathered where the model reads it and
  again in the backward (:class:`_Gather`), and the optimizer's update on
  each device's shards (elementwise: no collective; the few bytes of its
  global norm's all-reduce, and of Adafactor's factored row and column
  means, are not counted), under :class:`CollectiveCounter`, which
  records every functional collective DTensor issues by the reference's
  kind names with its operand's bytes on rank 0, as ``hlo_analysis``
  counts an HLO collective's operand bytes on one device.  An op DTensor
  has no rule for, or whose rule fails on these layouts (a head split
  the "model" axis does not divide), runs with its DTensor arguments
  replicated over one mesh dim, else over all (the gathers counted;
  ``replicated`` counts such ops by name);
* :func:`step_collectives` walks a model's stacks at a few layers and
  scales them to its depth (``cost_analysis.scaled_by_depth``), as the
  flops are walked.

The counts are per device, the reference's: a step that cannot be
partitioned raises, and ``launch/dryrun.py`` records why.
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Dict, Iterator, List

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.launch import cost_analysis, steps
from repro_torch.models import act_sharding
from repro_torch.models.sharding import shard_shape

MAX_RANKS = 512

# the functional collectives DTensor issues, by the reference's kind names
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def _kind(func):
    """The reference's kind name of a functional collective, else None."""
    name = func._schema.name
    ns, _, op = name.partition("::")
    return _KINDS.get(op) if ns in _NAMESPACES else None


@contextlib.contextmanager
def _even_strided_shards():
    """DTensor's ``_StridedShard`` finds a rank's share of a dim by
    splitting an ``arange`` of the whole dim: seconds a call on a wide
    model's flattened activations, gigabytes on a stacked weight.  Inside
    the block a dim that splits evenly takes its share in closed form (the
    formula DTensor itself uses for symbolic sizes); any other, and a
    torch whose method takes other arguments, keep DTensor's own."""
    try:
        from torch.distributed.tensor.placement_types import (
            _StridedShard, _StridedShardOffsetMode)
        own = _StridedShard.local_shard_size_and_offset
        takes = inspect.signature(own).parameters
    except (ImportError, AttributeError, TypeError, ValueError):
        takes = {}
    if "offset_mode" not in takes:
        yield
        return
    first, none = _StridedShardOffsetMode.FIRST, _StridedShardOffsetMode.NONE

    def closed_form(self, curr_local_size, num_chunks, rank,
                    offset_mode=first):
        sf = self.split_factor
        if (all(isinstance(v, int) for v in (curr_local_size, rank, sf))
                and offset_mode in (first, none)
                and curr_local_size % (sf * num_chunks) == 0):
            piece = curr_local_size // (sf * num_chunks)
            return (curr_local_size // num_chunks,
                    None if offset_mode == none else rank * piece)
        return own(self, curr_local_size, num_chunks, rank, offset_mode)

    _StridedShard.local_shard_size_and_offset = closed_form
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = own


@contextlib.contextmanager
def _planned_steps_kept():
    """DTensor plans a redistribution of a strided layout by a shortest
    path search over layouts, asking each layout for its next steps and
    their costs anew in every search: on the 3-D multi-pod mesh minutes a
    step.  Inside the block a planner (one per mesh and tensor shape)
    keeps the steps it has worked out, keyed by the layout and by the
    target layouts and reductions it has seen (what the steps depend on),
    so every search finds the same path in a fraction of the time."""
    try:
        from torch.distributed.tensor._redistribute import (
            DTensorRedistributePlanner as planner)
        own = planner.get_next_state
    except (ImportError, AttributeError):
        yield
        return

    def kept(self, placements, order):
        key = (placements, order,
               frozenset(getattr(self, "strided_shard_placements_in_target",
                                 ())),
               frozenset(getattr(self, "partial_reduce_ops_in_target", ())))
        memo = self.__dict__.setdefault("_partition_steps", {})
        if key not in memo:
            memo[key] = own(self, placements, order)
        return memo[key]

    planner.get_next_state = kept
    try:
        yield
    finally:
        planner.get_next_state = own


@contextlib.contextmanager
def fake_mesh(mesh) -> Iterator["torch.distributed.device_mesh.DeviceMesh"]:
    """A fake process group of ``mesh.size`` ranks (this process rank 0)
    and a ``DeviceMesh`` of ``mesh``'s shape and axis names over it, torn
    down after the block.  Refuses to start where a process group is
    already initialised: the fleet's gloo group must not be replaced."""
    # importing the module registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    n = mesh.size
    if n > MAX_RANKS:
        raise ValueError(f"a fake process group of {n} ranks: at most "
                         f"{MAX_RANKS}")
    if dist.is_initialized():
        raise RuntimeError(
            "partition.fake_mesh: a process group is already initialised "
            "(a fleet's); the partition pass opens its own fake one and "
            "runs outside a fleet")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)
    try:
        yield init_device_mesh("cpu", tuple(mesh.shape.values()),
                               mesh_dim_names=tuple(mesh.shape))
    finally:
        dist.destroy_process_group()


def placements(spec, ndim: int, dmesh) -> List:
    """DTensor placements of a tensor of ``ndim`` dims laid out by
    ``spec`` on ``dmesh``: one per mesh dim, ``Shard(d)`` where the spec
    puts that axis on dim d (several axes on one dim are ordered
    ``Shard(d)``s, the mesh's major axis first), else ``Replicate()``."""
    names = list(dmesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(tuple(spec)[:ndim]):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None and ax in names:
                out[names.index(ax)] = Shard(d)
    return out


def distribute(t: torch.Tensor, spec, mesh, dmesh):
    """The meta DTensor of a meta tensor ``t`` laid out by ``spec``: rank
    0's shard, no data moved."""
    local = torch.empty(shard_shape(t.shape, spec, mesh), dtype=t.dtype,
                        device="meta")
    return DTensor.from_local(local, dmesh, placements(spec, t.dim(), dmesh),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _in_place(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and returns[0].alias_info is not None and \
        returns[0].alias_info.is_write


def _writes_into_a_plain_tensor(func, args) -> bool:
    """An in-place op on a plain tensor with a DTensor operand (a one-hot
    filled from sharded tokens): DTensor takes only DTensor targets."""
    return (_in_place(func) and bool(args)
            and isinstance(args[0], torch.Tensor)
            and not isinstance(args[0], DTensor))


class CollectiveCounter(TorchDispatchMode):
    """Records the functional collectives dispatched while it is entered:
    ``coll`` (operand bytes by kind) and ``replicated`` (the ops run
    replicated, by name).  A DTensor op is left to DTensor (the
    collectives it issues come back through this mode as plain ops); one
    that DTensor has no rule for is run replicated."""

    def __init__(self, dmesh):
        super().__init__()
        self.dmesh = dmesh
        self.coll: Dict[str, int] = {}
        self.replicated: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if _writes_into_a_plain_tensor(func, args):
                return self._run_replicated(func, args, kwargs)
            seen = dict(self.coll)
            try:
                with _Recorder(self):
                    return tree_map(self._reduce_masked,
                                    func(*args, **kwargs))
            except Exception:  # noqa: BLE001 -- no rule, or one that fails
                self.coll = seen
                return self._run_replicated(func, args, kwargs)
        return self._record(func, args, kwargs)

    def _reduce_masked(self, x):
        """A vocab-parallel lookup's masked partial sum (a ``gather`` or an
        embedding on a sharded dim) reduced at once, while its mask still
        fits its shape: DTensor's later reduction of it fails once a view
        has dropped the index dim."""
        if isinstance(x, DTensor) and any(
                type(p).__name__ == "_MaskPartial" for p in x.placements):
            return x.redistribute(self.dmesh, [
                Replicate() if type(p).__name__ == "_MaskPartial" else p
                for p in x.placements])
        return x

    def _record(self, func, args, kwargs):
        kind = _kind(func)
        if kind is not None:
            first = args[0]
            ops = first if isinstance(first, (list, tuple)) else [first]
            self.coll[kind] = self.coll.get(kind, 0) + sum(
                t.numel() * t.element_size() for t in ops)
        return func(*args, **kwargs)

    def _run_replicated(self, func, args, kwargs):
        """``func`` where DTensor has no rule for it, or its rule fails on
        these layouts: first with the DTensor arguments replicated over one
        mesh dim at a time (a head split that the "model" axis does not
        divide keeps its batch shards), else on whole tensors, every
        DTensor argument replicated and the outputs replicated DTensors;
        the collectives of either are counted, and an in-place op returns
        its first argument."""
        name = str(func.overloadpacket)
        self.replicated[name] = self.replicated.get(name, 0) + 1
        ins = [x for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, DTensor)]
        tries = [] if _writes_into_a_plain_tensor(func, args) else [
            d for d in range(self.dmesh.ndim)
            if any(not isinstance(x.placements[d], Replicate) for x in ins)]
        for dim in tries:
            def one_dim(x):
                if not isinstance(x, DTensor):
                    return x
                pl = list(x.placements)
                pl[dim] = Replicate()
                return x.redistribute(self.dmesh, pl)
            seen = dict(self.coll)
            try:
                with torch.no_grad(), _Recorder(self):
                    out = func(*tree_map(one_dim, args),
                               **tree_map(one_dim, kwargs))
                    out = tree_map(self._reduce_masked, out)
            except Exception:  # noqa: BLE001 -- the next dim, or whole
                self.coll = seen
                continue
            return args[0] if _in_place(func) else out
        rep = [Replicate()] * self.dmesh.ndim

        def whole(x):
            if isinstance(x, DTensor):
                return x.redistribute(self.dmesh, rep).to_local()
            return x

        with torch.no_grad(), _Recorder(self):
            out = func(*tree_map(whole, args), **tree_map(whole, kwargs))
        if _in_place(func):
            return args[0]

        def wrap(x):
            if isinstance(x, torch.Tensor) and not isinstance(x, DTensor):
                return DTensor.from_local(x, self.dmesh, rep,
                                          run_check=False)
            return x

        with torch.no_grad():
            return tree_map(wrap, out)


class _Recorder(TorchDispatchMode):
    """Inside a :class:`CollectiveCounter` op: leaves DTensor ops to
    DTensor and records the collectives they issue."""

    def __init__(self, counter: CollectiveCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        return self.counter._record(func, args, kwargs or {})


class _Gather(torch.autograd.Function):
    """An FSDP leaf gathered for its use: ``redistribute`` to the layout
    without the FSDP axes; the backward gathers it again (the leaf is
    resharded after the forward, as the reference's compiled step and
    PyTorch's FSDP do) and reduces the gradient back to the leaf's
    shards."""

    @staticmethod
    def forward(ctx, x, dmesh, target):
        ctx.x, ctx.dmesh, ctx.target = x, dmesh, target
        return x.redistribute(dmesh, target)

    @staticmethod
    def backward(ctx, grad):
        ctx.x.detach().redistribute(ctx.dmesh, ctx.target)
        return (grad.redistribute(ctx.dmesh, ctx.x.placements), None,
                None)


class _Layout:
    """The partition pass's answers to ``act_sharding.placing``: a
    constraint is a ``redistribute`` to its spec (a plain tensor first
    becomes a replicated DTensor), a parameter is gathered by
    :class:`_Gather`, and the optimizer's operands are their local
    shards."""

    def __init__(self, dmesh):
        self.dmesh = dmesh

    def _dtensor(self, x):
        if isinstance(x, DTensor):
            return x
        return DTensor.from_local(x, self.dmesh,
                                  [Replicate()] * self.dmesh.ndim,
                                  run_check=False)

    def constrain(self, x, spec):
        x = self._dtensor(x)
        return x.redistribute(self.dmesh,
                              placements(spec, x.dim(), self.dmesh))

    def gather(self, x, spec):
        x = self._dtensor(x)
        target = placements(spec, x.dim(), self.dmesh)
        if tuple(target) == tuple(x.placements):
            return x
        return _Gather.apply(x, self.dmesh, target)

    def local(self, x):
        return x.to_local() if isinstance(x, DTensor) else x


def _dtensors(tree, mesh, dmesh):
    """A tree of ``steps.Struct`` as meta DTensors placed by their specs."""
    if isinstance(tree, steps.Struct):
        return distribute(tree.meta, tree.spec, mesh, dmesh)
    if isinstance(tree, dict):
        return {k: _dtensors(v, mesh, dmesh) for k, v in tree.items()}
    return [_dtensors(v, mesh, dmesh) for v in tree]


def analyze(fn, args, mesh, dmesh=None) -> Dict:
    """One pass of ``fn(*args)`` on ``mesh``, ``args`` a tree of
    ``steps.Struct`` placed by their specs: ``coll_bytes`` and
    ``coll_<kind>`` (one device's operand bytes of each kind), and
    ``replicated`` (the ops run replicated, by name).  ``dmesh``: an open
    :func:`fake_mesh` of ``mesh`` (one is opened for the call if None)."""
    if dmesh is None:
        with fake_mesh(mesh) as dmesh:
            return analyze(fn, args, mesh, dmesh)
    dargs = _dtensors(list(args), mesh, dmesh)
    counter = CollectiveCounter(dmesh)
    with _even_strided_shards(), _planned_steps_kept(), \
            act_sharding.placing(_Layout(dmesh)), \
            act_sharding.activation_mesh(mesh), implicit_replication(), \
            counter:
        out = fn(*dargs)
    del out
    res = {f"coll_{k}": v for k, v in sorted(counter.coll.items())}
    return {"coll_bytes": sum(counter.coll.values()), **res,
            "replicated": dict(counter.replicated)}


def count(cfg, shape, mesh, dmesh=None) -> Dict:
    """:func:`analyze` of ``shape``'s step of ``cfg`` on ``mesh``
    (``steps.lowering_for``)."""
    return analyze(*steps.lowering_for(cfg, shape, mesh), mesh, dmesh)


def step_collectives(cfg, shape, mesh) -> Dict:
    """:func:`count` of the whole model: each stack walked at a few layers
    and scaled to its depth (``cost_analysis.scaled_by_depth``), on one
    fake mesh (DTensor's sharding decisions, cached by op and layout,
    carry from one walk to the next)."""
    with fake_mesh(mesh) as dmesh:
        return cost_analysis.scaled_by_depth(
            cfg, lambda c: {"cost": count(c, shape, mesh, dmesh)})["cost"]


__all__ = ["CollectiveCounter", "MAX_RANKS", "analyze", "count",
           "distribute", "fake_mesh", "placements", "step_collectives"]
