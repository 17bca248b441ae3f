"""The port's expert-parallel MoE (``models/moe_shard_map.py``) against
the reference's ``shard_map`` dispatch.

The reference's two-hop all-to-all needs a device per shard, so it runs
once in a child process with 8 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``,
the pattern of ``tests/test_distributed.py``) that writes its outputs to
an ``.npz``: meshes (2, 4), (1, 8), (1, 2) over ("data", "model") and
(2, 2, 2) over ("pod", "data", "model"), at capacity factor 1.0 (pairs
dropped at both hops) and 8.0 (with a shared expert), float32; and the
fallback meshes.  The port runs in this process on the CPU under abstract
meshes of the same shapes, one controller, the shards a dimension of its
tensors.  Held: the output within 1e-5, the aux within 1e-6, and the same
kept pairs, which are read off the reference's output: each token's
output is the sum of its kept pairs' weighted expert outputs, and exactly
one subset of its K pairs fits it.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import base as tbase
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import act_sharding, moe
from repro_torch.models import moe_shard_map as msm

SRC = str(Path(__file__).resolve().parent.parent / "src")
OUT_ATOL, AUX_ATOL = 1e-5, 1e-6
B, S, D = 4, 32, 64

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CASES = [(cf, name) for cf in (1.0, 8.0) for name in MESHES]
# the reference's fallbacks, in its order: (mesh, axes, sequence length)
FALLBACKS = {"no_model_axis": ((2,), ("data",), S),
             "experts_not_divisible": ((1, 3), ("data", "model"), 30),
             "ep_1": ((8, 1), ("data", "model"), S),
             "batch_not_divisible": ((3, 2), ("data", "model"), S),
             "seq_not_divisible": ((2, 4), ("data", "model"), 30)}

_CHILD = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import base
from repro.models import act_sharding, moe
from repro.models.moe_shard_map import apply_moe_expert_parallel

def cfg_for(cf):
    c = base.get_config("phi3.5-moe-42b-a6.6b").reduced()
    return dataclasses.replace(c, d_model={D}, moe=dataclasses.replace(
        c.moe, num_experts=8, d_ff_expert=32, capacity_factor=cf,
        num_shared_experts=int(cf > 1)))

def run(cfg, p, x, shape, axes):
    n = int(np.prod(shape))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    def f(p, x):
        with act_sharding.activation_mesh(mesh):
            return apply_moe_expert_parallel(cfg, p, x)
    y, aux = jax.jit(f)(p, jnp.asarray(x))
    return np.asarray(y), np.asarray(aux)

inp = np.load(sys.argv[1])
out = {{}}
for cf in (1.0, 8.0):
    cfg = cfg_for(cf)
    p = moe.init_moe(cfg, jax.random.PRNGKey(1))
    for kp, v in jax.tree_util.tree_flatten_with_path(p)[0]:
        out[f"p{{cf}}/" + "/".join(str(k.key) for k in kp)] = np.asarray(v)
    for name, (shape, axes) in {meshes!r}.items():
        out[f"y{{cf}}_{{name}}"], out[f"aux{{cf}}_{{name}}"] = run(
            cfg, p, inp["x"], shape, axes)
    if cf == 1.0:
        for name, (shape, axes, s) in {fallbacks!r}.items():
            out[f"fb_{{name}}"], out[f"fbaux_{{name}}"] = run(
                cfg, p, inp["x"][:, :s], shape, axes)
np.savez(sys.argv[2], **out)
"""


def cfg_for(cf):
    c = tbase.get_config("phi3.5-moe-42b-a6.6b").reduced()
    return dataclasses.replace(c, d_model=D, moe=dataclasses.replace(
        c.moe, num_experts=8, d_ff_expert=32, capacity_factor=cf,
        num_shared_experts=int(cf > 1)))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's expert-parallel outputs, from one forced 8-device
    child."""
    d = tmp_path_factory.mktemp("moe_ep")
    x = np.random.default_rng(0).standard_normal((B, S, D)).astype(
        np.float32)
    np.savez(d / "in.npz", x=x)
    code = _CHILD.format(D=D, meshes=MESHES, fallbacks=FALLBACKS)
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC,
           "PATH": "/usr/bin:/bin", "HOME": str(d)}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    res = dict(np.load(d / "out.npz"))
    res["x"] = x
    return res


def params_of(ref, cf):
    p = {}
    prefix = f"p{cf}/"
    for k, v in ref.items():
        if k.startswith(prefix):
            *head, last = k[len(prefix):].split("/")
            node = p
            for h in head:
                node = node.setdefault(h, {})
            node[last] = torch.tensor(v)
    return p


def run_port(cfg, p, x, shape, axes, info=None):
    with act_sharding.activation_mesh(make_abstract_mesh(shape, axes)):
        return msm.apply_moe_expert_parallel(cfg, p, x, info)


def pair_outputs(cfg, p, xs, top_p, top_idx):
    """Each routed pair's weighted expert output (G, n, K, D), float32."""
    G, n, K = top_idx.shape
    out = torch.zeros(G, n, K, xs.shape[-1])
    for e in range(cfg.moe.num_experts):
        h = F.silu(xs @ p["we1"][e]) * (xs @ p["we3"][e])
        o = h @ p["we2"][e]
        for k in range(K):
            sel = (top_idx[..., k] == e)
            out[:, :, k][sel] = (o * top_p[..., k, None])[sel]
    return out


def kept_from_output(y_shards, pairs):
    """The subset of each token's K pairs whose sum fits its output (G, n,
    K) bool, and the best and second-best fits' errors."""
    G, n, K, _ = pairs.shape
    subsets = [torch.tensor([(m >> k) & 1 for k in range(K)], dtype=torch.bool)
               for m in range(2 ** K)]
    errs = torch.stack([(y_shards - (pairs * s[:, None].float()).sum(2))
                        .abs().amax(-1) for s in subsets], -1)   # (G, n, 2^K)
    best = errs.argmin(-1)
    ranked = errs.sort(-1).values
    return torch.stack(subsets)[best], ranked[..., 0], ranked[..., 1]


@pytest.mark.parametrize("cf,name", CASES)
def test_expert_parallel_matches_reference(reference, cf, name):
    cfg = cfg_for(cf)
    shape, axes = MESHES[name]
    p = params_of(reference, cf)
    x = torch.tensor(reference["x"])
    info = {}
    with torch.no_grad():
        y, aux = run_port(cfg, p, x, shape, axes, info)
    ref_y = reference[f"y{cf}_{name}"]
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, D)
    assert float(np.abs(y.numpy() - ref_y).max()) <= OUT_ATOL
    assert abs(float(aux) - float(reference[f"aux{cf}_{name}"])) <= AUX_ATOL
    lay = info["layout"]
    if cf == 1.0:
        # pairs are dropped, at both hops but at (1, 8), where each rank
        # owns one expert and the second hop has room for every row
        assert info["sent"].float().mean() < 1.0
        assert (info["kept"] < info["sent"]).any() == (name != "1x8")
    else:
        assert info["kept"].all()
    xs = msm.to_shards(x, lay)
    with torch.no_grad():
        top_p, top_idx, _ = msm.route(cfg, p, xs, lay)
        pairs = pair_outputs(cfg, p, xs, top_p, top_idx)
    ref_s = msm.to_shards(torch.tensor(ref_y), lay)
    if cf > 1:
        with torch.no_grad():
            sp = p["shared"]
            ref_s = ref_s - (F.silu(xs @ sp["w1"]) * (xs @ sp["w3"])) @ sp[
                "w2"]
    kept, fit, second = kept_from_output(ref_s, pairs)
    assert float(fit.max()) <= 1e-4 < float(second.min())
    assert torch.equal(kept, info["kept"])


def test_layout_capacities():
    """c_send and c_exp as the reference rounds them (up to a multiple of 8,
    at least 8), the dp axes (pod, data) on a pod mesh."""
    cfg = cfg_for(1.0)
    lay = msm.layout(cfg, make_abstract_mesh((2, 4), ("data", "model")), B, S)
    assert (lay["T_loc"], lay["c_send"], lay["c_exp"]) == (16, 8, 16)
    lay = msm.layout(cfg, make_abstract_mesh((2, 2, 2), ("pod", "data",
                                                         "model")), B, S)
    assert lay["dp_sizes"] == (2, 2) and lay["n_dp"] == 4
    big = dataclasses.replace(tbase.get_config("phi3.5-moe-42b-a6.6b"),
                              moe=dataclasses.replace(
                                  tbase.get_config("phi3.5-moe-42b-a6.6b").moe,
                                  capacity_factor=1.25))
    for ep, c_send in ((16, 40), (4, 640)):
        lay = msm.layout(big, make_abstract_mesh((1, ep), ("data", "model")),
                         1, 4096)
        assert (lay["c_send"], lay["c_exp"]) == (c_send, 800)


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallbacks_match_reference(reference, case):
    """Where the reference falls back (no "model" axis; E % EP; EP 1; B %
    n_dp; S % EP) the port runs the single dispatch, bit-equal to its own
    ``_moe_dispatch``, and within 1e-5 of the reference's fallback."""
    shape, axes, s = FALLBACKS[case]
    cfg = cfg_for(1.0)
    p = params_of(reference, 1.0)
    x = torch.tensor(reference["x"][:, :s])
    m = make_abstract_mesh(shape, axes)
    assert msm.layout(cfg, m, B, s) is None
    with torch.no_grad():
        y, aux = run_port(cfg, p, x, shape, axes)
        y0, aux0 = moe._moe_dispatch(cfg, p, x)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    assert float(np.abs(y.numpy() - reference[f"fb_{case}"]).max()) \
        <= OUT_ATOL
    assert abs(float(aux) - float(reference[f"fbaux_{case}"])) <= AUX_ATOL


def test_no_mesh_is_the_single_dispatch():
    """``apply_moe`` with impl "shard_map" and no mesh: the dispatch itself,
    no waves; under a mesh: the expert-parallel path (its own aux)."""
    cfg = cfg_for(1.0)
    assert cfg.moe.impl == "shard_map"
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(B, S, D, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, aux = moe.apply_moe(cfg, p, x)
        y0, aux0 = moe._moe_dispatch(cfg, p, x)
        assert torch.equal(y, y0) and torch.equal(aux, aux0)
        with act_sharding.activation_mesh(make_abstract_mesh(
                (1, 4), ("data", "model"))):
            y1, _ = moe.apply_moe(cfg, p, x)
    assert not torch.equal(y1, y0)


def test_pack_is_stable_and_drops_overflow():
    """``_pack`` keeps each group's rows in their order (a stable sort)
    and drops the rows past ``capacity``; ``_unpack`` returns each kept
    row to its place and zeros for the dropped ones."""
    groups = torch.tensor([[1, 0, 1, 1, 0, 1], [0, 0, 0, 1, 1, 1]])
    payload = torch.arange(12, dtype=torch.float32).view(2, 6) + 1
    plan = msm._plan(groups, 2, 2)
    buckets = msm._pack(plan, payload, 2, 2)
    assert buckets.tolist() == [[[2, 5], [1, 3]], [[7, 8], [10, 11]]]
    back = msm._unpack(plan, buckets, 6)
    assert back.tolist() == [[1, 2, 3, 0, 5, 0], [7, 8, 0, 10, 11, 0]]
