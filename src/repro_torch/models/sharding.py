"""Sharding rules: the language model's parameters, activations and caches
mapped onto a mesh's axes.

Port of ``repro.models.sharding``.  Mesh axes (``launch/mesh.py``):

  "pod"   -- pure data parallelism across pods; parameters are replicated
             across pods (only the gradient all-reduce crosses them);
  "data"  -- batch sharding and FSDP parameter sharding (ZeRO-style);
  "model" -- tensor parallelism (heads / FFN / experts) and the sequence
             sharding of decode KV caches.

An axis is used only where the mesh's size divides the dim.  A spec is a
:class:`P`, a tuple with one entry per dim: ``None``, an axis name, or a
tuple of names; it compares equal, entry by entry, to ``tuple()`` of the
reference's ``PartitionSpec``.  Every function reads only ``mesh.shape``,
so it takes the plan-path ``Mesh`` or an ``AbstractMesh``.
:func:`shard_shape` is one device's local shape, the stand-in for
``NamedSharding.shard_shape``.  The reference's ``param_shardings`` (its
``NamedSharding`` tree) has no counterpart: the port places no tensor on a
mesh, it runs every shard on one device (a single controller).
"""
from __future__ import annotations

from typing import Any, Dict


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"))``,
    ``P()``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def axis_size(mesh, name) -> int:
    """The devices along ``name`` (an axis, a tuple of axes, or None: 1);
    an axis the mesh lacks counts 1."""
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= axis_size(mesh, n)
        return out
    return mesh.shape[name] if name in mesh.shape else 1


def _fits(dim: int, mesh, name) -> bool:
    n = axis_size(mesh, name)
    return n > 1 and dim % n == 0


def spec_for(mesh, shape, *axes) -> P:
    """A spec of ``axes`` for ``shape``, each axis dropped where it does not
    divide its dim (a tuple keeps the names the mesh has, if together they
    divide)."""
    out = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            out.append(None)
        elif isinstance(ax, (tuple, list)):
            keep = tuple(a for a in ax if a in mesh.shape)
            if keep and dim % axis_size(mesh, keep) == 0:
                out.append(keep if len(keep) > 1 else keep[0])
            else:
                out.append(None)
        else:
            out.append(ax if _fits(dim, mesh, ax) else None)
    return P(*out)


def dp_axes(mesh):
    """Batch-sharding axes: ("pod", "data") when the pod axis exists."""
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


# ---------------------------------------------------------------------------
# parameters: leaves named by their key path's suffix.  TP dim (heads x dh,
# d_ff, experts, vocab) on "model", the other large dim (FSDP) on "data",
# replicated over "pod".  First match wins, in this order: "pos_embed"
# ends with "embed" and so takes the "embed" rule before its own, as in the
# reference.
# ---------------------------------------------------------------------------

_RULES = [
    # (key suffix, axes per trailing dim); a stacked leaf's leading layer
    # dim is never sharded
    ("wq",       ("data", "model")),
    ("wq_a",     ("data", None)),       # MLA q down-proj (D, q_lora)
    ("wq_b",     (None, "model")),      # MLA q up-proj (q_lora, H*dh)
    ("wkv_a",    ("data", None)),       # MLA kv down-proj (D, c_kv + rope)
    ("wkv_b",    (None, "model")),      # MLA kv up-proj (c_kv, H*(nope+v))
    ("wk",       ("data", "model")),
    ("wv",       ("data", "model")),
    ("wo",       ("model", "data")),
    ("bq",       ("model",)),
    ("bk",       ("model",)),
    ("bv",       ("model",)),
    ("w1",       ("data", "model")),
    ("w3",       ("data", "model")),
    ("w2",       ("model", "data")),
    ("w_router", ("data", None)),
    # experts (E, D, F) / (E, F, D): experts on "model" (expert parallel)
    ("we1",      ("model", "data", None)),
    ("we3",      ("model", "data", None)),
    ("we2",      ("model", None, "data")),
    ("embed",    ("model", "data")),    # vocab-parallel embedding
    ("lm_head",  ("data", "model")),
    ("pos_embed", (None, None)),
    # rwkv6 / mamba: channel dims on "model" where divisible
    ("w_in",     ("data", "model")),
    ("w_out",    ("model", "data")),
    ("w_state",  (None, "model")),
]


def _spec_for_leaf(mesh, path: str, shape, fsdp_axes=("data",)) -> P:
    fsdp = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]

    def xlate(ax):
        return fsdp if ax == "data" else ax

    for suffix, axes in _RULES:
        if path.endswith(suffix):
            ndim = len(shape)
            axes = tuple(xlate(a) for a in axes)
            if len(axes) < ndim:          # stacked leading dims: unsharded
                axes = (None,) * (ndim - len(axes)) + axes
            elif len(axes) > ndim:
                axes = axes[-ndim:]
            return spec_for(mesh, shape, *axes)
    # default: FSDP the largest dim (the first of equals) if it is large
    # and fits
    if shape:
        big = shape.index(max(shape))
        if shape[big] >= 1024 and _fits(shape[big], mesh, fsdp):
            axes = [None] * len(shape)
            axes[big] = fsdp
            return P(*axes)
    return P()


def param_specs(mesh, params_shape: Dict, fsdp_axes=("data",)) -> Dict:
    """The spec tree of a parameter tree (tensors, meta tensors or anything
    with a ``.shape``), keyed as the tree.  ``fsdp_axes=("pod", "data")``
    extends the FSDP sharding across pods."""
    from repro_torch.launch.steps import leaves_with_paths
    out: Dict[str, Any] = {}
    for path, leaf in leaves_with_paths(params_shape):
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = _spec_for_leaf(mesh, path, tuple(leaf.shape),
                                    fsdp_axes)
    return out


# ---------------------------------------------------------------------------
# activations and caches
# ---------------------------------------------------------------------------

def batch_spec(mesh, batch: int, *rest_dims) -> P:
    """(B, ...) with the batch over the dp axes where they divide it, else
    over "data" where that divides it."""
    dp = dp_axes(mesh)
    if batch % axis_size(mesh, dp) == 0:
        return P(dp if len(dp) > 1 else dp[0], *rest_dims)
    if batch % axis_size(mesh, "data") == 0:
        return P("data", *rest_dims)
    return P(None, *rest_dims)


def kv_cache_spec(mesh, batch: int, seq: int) -> P:
    """(L, B, S, Hkv, dh), the sequence sharded (distributed flash-decode):
    a batch the dp axes divide goes over them with the sequence on
    "model"; a tiny batch gives the sequence every axis."""
    dp = dp_axes(mesh)
    if batch % axis_size(mesh, dp) == 0:
        bs = dp if len(dp) > 1 else dp[0]
        seq_ax = "model" if seq % axis_size(mesh, "model") == 0 else None
        return P(None, bs, seq_ax, None, None)
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    if seq % axis_size(mesh, axes) == 0:
        return P(None, None, axes, None, None)
    return P(None, None, None, None, None)


def state_spec(mesh, batch: int, heads: int) -> P:
    """(L, B, H, d, d), a recurrent state (RWKV / Mamba)."""
    b = batch_spec(mesh, batch)
    h_ax = "model" if heads % axis_size(mesh, "model") == 0 else None
    return P(None, b[0], h_ax, None, None)


def cache_leaf_spec(mesh, key: str, shape) -> P:
    """A decode-cache leaf's spec by its key: (L, B, S, ...) for the K/V
    likes, (L, B, ...) for the recurrent states."""
    if len(shape) < 3:
        return P()
    B = shape[1]
    if key in ("k", "v", "xk", "xv"):          # (L, B, S, Hkv, dh)
        return spec_for(mesh, shape, *kv_cache_spec(mesh, B, shape[2]))
    if key in ("c_kv", "k_rope"):              # (L, B, S, c)
        kv5 = kv_cache_spec(mesh, B, shape[2])
        return spec_for(mesh, shape, kv5[0], kv5[1], kv5[2], None)
    bs = batch_spec(mesh, B)
    if key == "state":                          # (L, B, H, N, N)
        return spec_for(mesh, shape, None, bs[0], "model", None, None)
    if key in ("xprev_t", "xprev_c"):           # (L, B, D)
        return spec_for(mesh, shape, None, bs[0], None)
    if key == "conv":                           # (L, B, W - 1, di)
        return spec_for(mesh, shape, None, bs[0], None, "model")
    if key == "ssm":                            # (L, B, di, n)
        return spec_for(mesh, shape, None, bs[0], "model", None)
    return P()


def shard_shape(shape, spec, mesh) -> tuple:
    """One device's shape of a ``shape`` array laid out by ``spec`` (dims
    past the spec's entries are whole)."""
    shape = tuple(shape)
    out = list(shape)
    for i, ax in enumerate(tuple(spec)[:len(shape)]):
        n = axis_size(mesh, ax)
        if shape[i] % n:
            raise ValueError(f"{spec} does not divide dim {i} of {shape} on "
                             f"{dict(mesh.shape)}")
        out[i] = shape[i] // n
    return tuple(out)
