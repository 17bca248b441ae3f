"""The cost terms of a step, counted op by op as the step runs: FLOPs, HBM
bytes, collective bytes, and the temporary and peak bytes it holds.

Counterpart of ``repro.launch.hlo_analysis``, which parses a compiled XLA
program into its computations and costs them recursively.  Torch has no
compiled program to read, so :class:`CostCounter` (a
``TorchDispatchMode``) counts the aten operations the port's own step
issues, once, on its arguments: meta tensors (the dry run, no device
touched) or real ones on either device.  It keeps the reference's keys,
``flops``, ``bytes``, ``coll_bytes`` and ``coll_<kind>``, and its rules
op for op:

* **flops**: matrix products and convolutions only, at 2 M N K
  (``HloCostAnalyzer._dot_flops``): ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``addbmm``, ``mv``, ``addmv``, ``dot``, ``convolution``
  and its backward, which is what ``einsum``, ``matmul`` and ``linear``
  reach.  Elementwise work counts no flops, as in the reference.
* **bytes**: each op's operand and output bytes (an operand read through
  a broadcast counts the elements it holds), as the reference prices a
  fusion or a dot; a view counts 0, an allocation without a write
  (``empty``) 0, and a write into a slice (``copy_``, ``index_put_``,
  ``slice_scatter`` and their kin: the cache writes) twice the updated
  slice, as the reference's ``dynamic-update-slice`` rule.  Eager torch
  does not fuse, so this is an eager proxy of HBM traffic: every
  intermediate goes to memory and back, where the reference's figure is
  the post-fusion one.
* **collectives**: the port runs a mesh as one controller, so the only
  collective it performs is the one its mesh layer makes itself, the
  expert-parallel all-to-all (``models/moe_shard_map.exchange``), which
  records every shard's bytes sent through :func:`collective` under
  ``coll_all-to-all``.  The collectives XLA's partitioner inserts for the
  reference (FSDP gathers, reductions of the gradients) have no
  counterpart here and are not counted.
* **kernels**: a call of one of the five hand-written kernels' wrappers
  (``kernels.counted``) counts as one entry under the kernel's name, with
  the ``(flops, bytes)`` of its ``work(...)`` and the launches the card
  makes for it; the ops inside the wrapper (the plain twin's on CPU or
  meta tensors, the padding copies on the card) are not counted, so the
  count is the same on meta, on the CPU and on the card.  The kernel's
  flops add to ``flops``, where the reference's HLO counts a Pallas
  custom call's operand bytes and no flops: comparisons with the
  reference run ``backend="reference"``, where neither package has a
  kernel.  The result carries ``kernels``: per name its ``launches``,
  ``flops`` and ``bytes``.
* **memory** (:func:`memory_analysis`): the storages made inside the run
  are counted at allocation and dropped when their last reference goes
  (a weakref finalizer on each storage, which works on meta tensors);
  storages made inside a kernel's wrapper count only if they outlive it,
  and the temporary an op allocates inside one call (``INTERNAL``:
  logsumexp's ``x - max(x)``) for the call.
  ``temp_bytes`` is the largest live set less what is still held at the
  end (``output_bytes``), and the peak is the arguments plus the largest
  live set, the reference's argument + temp + output.

Every count is global: one controller runs every shard of a mesh, and the
dry run (``launch/dryrun.py``) splits the counts evenly over the devices.

The reference scales a scan body by its trip count; the port's loops are
Python loops and count themselves.  A full model's step is too slow to
walk layer by layer in the dry run, so :func:`scaled_by_depth` walks each
stack of blocks at depths 1, 2 and 3 and extrapolates the counts to the
stack's depth along the quadratic through them (an eager train step's
bytes grow with depth squared: each layer's gradient lands in a buffer of
the whole stacked leaf, which a line would miss), the live-set peaks
along the line through depths 2 and 3.  A stack of at most 3 layers is
walked whole.  A test holds the scaled count equal to a full walk.
"""
from __future__ import annotations

import dataclasses
import weakref
from contextlib import contextmanager
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels

aten = torch.ops.aten


def _mm_flops(a, b) -> int:
    return 2 * a.shape[0] * a.shape[1] * b.shape[-1]


def _bmm_flops(a, b) -> int:
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv_flops(out, weight) -> int:
    """2 x each output element x the input channels of a group x the
    kernel's taps."""
    return 2 * out.numel() * (weight.numel() // weight.shape[0])


def _conv_backward_flops(args, out) -> int:
    grad_out, weight, mask = args[0], args[2], args[-1]
    per = _conv_flops(grad_out, weight)
    return per * (int(mask[0]) + int(mask[1]))


# the products: (args, output) -> flops
FLOPS = {
    aten.mm.default: lambda a, o: _mm_flops(a[0], a[1]),
    aten.addmm.default: lambda a, o: _mm_flops(a[1], a[2]),
    aten.bmm.default: lambda a, o: _bmm_flops(a[0], a[1]),
    aten.baddbmm.default: lambda a, o: _bmm_flops(a[1], a[2]),
    aten.addbmm.default: lambda a, o: _bmm_flops(a[1], a[2]),
    aten.mv.default: lambda a, o: 2 * a[0].numel(),
    aten.addmv.default: lambda a, o: 2 * a[1].numel(),
    aten.dot.default: lambda a, o: 2 * a[0].numel(),
    aten.convolution.default: lambda a, o: _conv_flops(o, a[1]),
    aten.convolution_backward.default: _conv_backward_flops,
}

# writes into a slice of a buffer: (args) -> the updated slice
SLICE_WRITES = {
    aten.copy_.default: lambda a: a[0],
    aten.index_put_.default: lambda a: a[2],
    aten.index_put.default: lambda a: a[2],
    aten._index_put_impl_.default: lambda a: a[2],
    aten.slice_scatter.default: lambda a: a[1],
    aten.select_scatter.default: lambda a: a[1],
    aten.index_copy_.default: lambda a: a[3],
    aten.index_copy.default: lambda a: a[3],
}

# ops that allocate a temporary inside one call, unseen by the dispatcher:
# (args) -> its bytes, live for the call (logsumexp's x - max(x))
INTERNAL = {aten.logsumexp.default: lambda a: footprint(a[0])}

# allocations that write nothing
NO_WRITE = {aten.empty.memory_format, aten.empty_strided.default,
            aten.empty_like.default, aten.new_empty.default,
            aten.new_empty_strided.default}


def footprint(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` holds: a dimension broadcast with
    stride 0 counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


# per op: (a view, returns a new buffer, the slice-write rule, the flops
# rule, writes its output), worked out once
_RULES: Dict = {}


def _rules(func):
    r = _RULES.get(func)
    if r is None:
        r = _RULES[func] = (
            _is_view(func),
            not any(x.alias_info for x in func._schema.returns),
            SLICE_WRITES.get(func), FLOPS.get(func), func not in NO_WRITE)
    return r


def _flat_tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (tensors, and lists or
    tuples of them, one level deep as aten takes them)."""
    for a in x:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered (see the module
    docstring): ``flops``, ``bytes``, ``coll`` (bytes by kind),
    ``kernels`` (by name), and the live bytes of the storages made inside
    it (``live``, ``peak``).  ``arguments`` holds tensors made before it
    whose storages are not counted as allocations."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, float] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._pending = set()
        self._refs: Dict[int, weakref.ref] = {}
        self._inside = False
        self._known = {t.untyped_storage()._cdata
                       for t in _tensors(arguments)}

    def __enter__(self):
        kernels.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.COUNTERS.remove(self)
        return super().__exit__(*exc)

    # -- memory -------------------------------------------------------------

    def _alloc(self, n: int) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        n = self._sizes.pop(key)
        if key in self._pending:
            self._pending.discard(key)
        else:
            self.live -= n

    def _track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._sizes or key in self._known:
                continue
            self._sizes[key] = st.nbytes()
            if self._inside:
                self._pending.add(key)
            else:
                self._alloc(self._sizes[key])
            self._refs[key] = weakref.ref(st, self._dropper(key))

    def _dropper(self, key: int):
        def drop(_):
            self._refs.pop(key, None)
            self._free(key)
        return drop

    # -- the hooks ------------------------------------------------------------

    @contextmanager
    def kernel(self, name: str, work: Callable, launches: int):
        """One call of kernel ``name`` (``kernels.counted``)."""
        if self._inside:
            yield
            return
        flops, nbytes = work()
        e = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        e["launches"] += launches
        e["flops"] += flops
        e["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        self._inside = True
        try:
            yield
        finally:
            self._inside = False
            for key in self._pending:
                self._alloc(self._sizes[key])
            self._pending.clear()

    def collective(self, kind: str, nbytes: int) -> None:
        if not self._inside:
            self.coll[kind] = self.coll.get(kind, 0) + nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        internal = INTERNAL.get(func)
        held = (internal(args)
                if internal is not None and not self._inside else 0)
        self._alloc(held)
        out = func(*args, **kwargs)
        self.live -= held
        view, fresh, slice_of, flops_of, writes = _rules(func)
        if view:
            return out
        outs = _flat_tensors(out if isinstance(out, (list, tuple))
                             else (out,), [])
        if not self._inside:
            if slice_of is not None:
                self.bytes += 2 * footprint(slice_of(args))
            elif writes:
                ins = _flat_tensors(args, _flat_tensors(kwargs.values(), []))
                self.bytes += sum(footprint(t) for t in ins) + sum(
                    footprint(t) for t in outs)
            if flops_of is not None:
                self.flops += flops_of(args, out)
        if fresh:
            self._track(outs)
        return out

    def result(self) -> Dict:
        """The reference's dict (``flops``, ``bytes``, ``coll_bytes``,
        ``coll_<kind>``) and ``kernels``."""
        out = {"flops": self.flops, "bytes": self.bytes,
               "coll_bytes": sum(self.coll.values())}
        out.update({f"coll_{k}": v for k, v in self.coll.items()})
        out["kernels"] = {k: dict(v) for k, v in self.kernels.items()}
        return out


def collective(kind: str, t: torch.Tensor) -> None:
    """Record ``t`` as moved by one collective of ``kind`` (the reference's
    HLO names, e.g. ``"all-to-all"``) under the active counter: its bytes
    are every shard's bytes sent, each shard's operand of the collective
    side by side.  The copy that moves them is an op of its own and counts
    its bytes as any other."""
    if kernels.COUNTERS:
        kernels.COUNTERS[-1].collective(kind, t.numel() * t.element_size())


def count(fn: Callable, *args, **kwargs) -> Tuple[Dict, Dict]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`CostCounter`:
    (the :func:`analyze` dict, the :func:`memory_analysis` dict)."""
    with CostCounter((args, kwargs)) as c:
        out = fn(*args, **kwargs)
        held = c.live
    del out
    arg = tree_bytes((args, kwargs))
    return c.result(), {"argument_bytes": arg, "output_bytes": held,
                        "temp_bytes": c.peak - held,
                        "peak_per_device_bytes": arg + c.peak}


def analyze(fn: Callable, *args, **kwargs) -> Dict:
    """``flops``, ``bytes``, ``coll_bytes``, ``coll_<kind>`` and
    ``kernels`` of one run of ``fn(*args, **kwargs)``."""
    return count(fn, *args, **kwargs)[0]


def memory_analysis(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """``argument_bytes`` (the distinct storages of the arguments),
    ``output_bytes`` (made in the run and held at its end), ``temp_bytes``
    (the largest live set less the output) and ``peak_per_device_bytes``
    (arguments + temp + output) of one run of ``fn(*args, **kwargs)``."""
    return count(fn, *args, **kwargs)[1]


# ---------------------------------------------------------------------------
# a model's stacks of blocks, walked at depths 1-3 and extrapolated
# ---------------------------------------------------------------------------

def stack_depths(cfg) -> Dict[str, int]:
    """The depth of each stack of blocks of ``cfg``: ``dense`` (a MoE
    config's dense prefix), ``blocks`` (the decoder's others) and
    ``encoder``, those it has."""
    dense = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    out = {"dense": dense, "blocks": cfg.num_layers - dense,
           "encoder": cfg.encoder_layers}
    return {k: v for k, v in out.items() if v}


def with_depths(cfg, depths: Dict[str, int]):
    """``cfg`` with its stacks cut to ``depths``."""
    dense = depths.get("dense", 0)
    kw = {"num_layers": dense + depths["blocks"],
          "encoder_layers": depths.get("encoder", 0)}
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, first_dense_layers=dense)
    return dataclasses.replace(cfg, **kw)


def _flat(d, prefix=""):
    """``("a/b", number)`` of a nested dict; an empty dict is a leaf."""
    for k, v in d.items():
        if isinstance(v, dict) and v:
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _nest(flat: Dict) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[last] = v
    return out


def _quadratic(n: int, f1, f2, f3):
    """The quadratic through (1, f1), (2, f2), (3, f3) at ``n`` (exact in
    integers: both products of consecutive integers are even)."""
    return ((n - 2) * (n - 3) // 2 * f1 - (n - 1) * (n - 3) * f2
            + (n - 1) * (n - 2) // 2 * f3)


def scaled_by_depth(cfg, count_at: Callable[[object], Dict]) -> Dict:
    """``count_at(cfg)`` for the whole model, from walks of ``count_at`` on
    ``cfg`` cut to few layers (:func:`with_depths`).  ``count_at`` gives
    ``{"cost": ..., "memory": ...}``, nested dicts of numbers.  Every
    stack of at most 3 layers is walked whole, each deeper one at 1, 2 and
    3 with the others fixed, and its terms extrapolated to its depth and
    added to the walk at depth 1: the ``cost`` terms along the quadratic
    through the three walks, the ``memory`` terms (live sets at their
    largest, the largest of several phases) along the line through depths
    2 and 3.  The phase that holds a peak can change between depths 1 and
    2 (at 1 no layer comes before the last), not in a deeper stack of
    equal blocks, whose every phase grows by a fixed size a layer.  A key
    a walk lacks counts 0 there."""
    depths = stack_depths(cfg)
    base = {s: n if n <= 3 else 1 for s, n in depths.items()}
    f1 = dict(_flat(count_at(with_depths(cfg, base))))
    total = dict(f1)
    for s, n in depths.items():
        if n <= 3:
            continue
        f2 = dict(_flat(count_at(with_depths(cfg, {**base, s: 2}))))
        f3 = dict(_flat(count_at(with_depths(cfg, {**base, s: 3}))))
        for key in set(f1) | set(f2) | set(f3):
            a, b, c = (f.get(key, 0) for f in (f1, f2, f3))
            if {} in (a, b, c):
                continue
            at_n = (c + (n - 3) * (c - b) if key.startswith("memory/")
                    else _quadratic(n, a, b, c))
            total[key] = total.get(key, 0) + at_n - a
    return _nest(total)


def per_device(counts: Dict, n_devices: int) -> Dict:
    """Every number of a count split evenly over ``n_devices``."""
    return {k: per_device(v, n_devices) if isinstance(v, dict)
            else v / n_devices for k, v in counts.items()}


__all__ = ["CostCounter", "analyze", "collective", "count", "footprint",
           "memory_analysis", "per_device", "scaled_by_depth",
           "stack_depths", "tree_bytes", "with_depths"]
