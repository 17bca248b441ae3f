"""The port's sharding rules (``models/sharding.py``,
``models/act_sharding.py``, the specs of ``launch/steps.py``) against the
reference's, exactly.

Specs are pure shape functions, so both packages run on device-less
meshes: the reference's ``make_abstract_mesh`` and the port's.  Every
spec must equal the reference's entry for entry (the port's ``P`` is a
tuple; the reference's ``PartitionSpec`` compares through ``tuple()``):
the parameters of all 10 configs on the single-pod (16, 16) and the
multi-pod (2, 16, 16) production meshes (with ``fsdp_axes_for``), the
optimizer states in the port's own layout, the decode caches at
``decode_32k`` and ``long_500k``, the step's data arguments at every
input shape, and the helpers over a grid of dims that do and do not
divide."""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import sharding as jsh
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import act_sharding as tact
from repro_torch.models import sharding as tsh

NAMES = tuple(jbase.list_configs())
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(name):
    shape, axes = MESHES[name]
    return (jmesh.make_abstract_mesh(shape, axes),
            tmesh.make_abstract_mesh(shape, axes))


def flat_ref(tree):
    """``{path: tuple(spec)}`` of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(s) for kp, s in flat}


def test_configs_and_production_meshes_match():
    """The port's production meshes are the reference's shapes
    (``repro/launch/mesh.py:make_production_mesh``, which needs 256 / 512
    devices to build), device-less."""
    assert sorted(NAMES) == sorted(tbase.list_configs()) and len(NAMES) == 10
    for multi in (False, True):
        t = tmesh.make_production_mesh(multi_pod=multi)
        j = jmesh.make_abstract_mesh(*MESHES["pod2x16x16" if multi
                                            else "pod16x16"])
        assert dict(j.shape) == dict(t.shape)
        assert tuple(j.axis_names) == t.axis_names and j.size == t.size
    assert t.size == 512 and list(t.shape) == ["pod", "data", "model"]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_reference(name, mesh_name):
    jm, tm = meshes(mesh_name)
    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    fsdp = jsteps.fsdp_axes_for(jcfg, jm)
    assert tsteps.fsdp_axes_for(tcfg, tm) == fsdp
    want = flat_ref(jsh.param_specs(jm, jsteps.abstract_params(jcfg), fsdp))
    got = dict(tsteps.leaves_with_paths(tsh.param_specs(
        tm, tsteps.abstract_params(tcfg), fsdp)))
    assert got == want
    assert all(type(s) is tsh.P for s in got.values())


def test_fsdp_extends_over_pods_for_dense_adafactor_only():
    jm, tm = meshes("pod2x16x16")
    got = {n: tsteps.fsdp_axes_for(tbase.get_config(n), tm) for n in NAMES}
    assert got["llama3-405b"] == ("pod", "data")
    assert got["deepseek-v3-671b"] == ("data",)        # MoE: replicated
    assert got["phi4-mini-3.8b"] == ("data",)
    assert tsteps.fsdp_axes_for(tbase.get_config("llama3-405b"),
                                meshes("pod16x16")[1]) == ("data",)


def ref_opt_specs(jcfg, jm):
    ps = jsteps.abstract_params(jcfg)
    return jsteps.opt_state_specs(jm, ps, jsteps.abstract_opt_state(jcfg, ps),
                                  jsteps.fsdp_axes_for(jcfg, jm))


def port_opt_specs(tcfg, tm):
    ps = tsteps.abstract_params(tcfg)
    state = tsteps.abstract_opt_state(tcfg, ps)
    return state, tsteps.opt_state_specs(tm, ps, state,
                                         tsteps.fsdp_axes_for(tcfg, tm))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "llama3-405b",
                                  "deepseek-v3-671b", "rwkv6-3b"])
def test_opt_state_specs_match_reference(name, mesh_name):
    """AdamW (phi4-mini, rwkv6) and Adafactor (llama3, deepseek): each
    leaf of the port's layout has the reference's spec for that leaf."""
    jm, tm = meshes(mesh_name)
    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    want = flat_ref(ref_opt_specs(jcfg, jm))
    state, got = port_opt_specs(tcfg, tm)
    paths = [p for p, _ in tsteps.leaves_with_paths(
        tsteps.abstract_params(tcfg))]
    flat = {}
    if jcfg.optimizer == "adamw":
        for k in ("m", "v"):
            for p, s, leaf in zip(paths, got[k], state[k]):
                flat[f"{k}/{p}"] = tuple(s)
                assert len(s) in (0, leaf.dim())
    else:
        assert jcfg.optimizer == "adafactor"
        for p, d, st in zip(paths, got, state):
            for stat, s in d.items():
                flat[f"{p}/{stat}"] = tuple(s)
                assert len(s) in (0, st[stat].dim())
    assert flat == want


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_match_reference(name, mesh_name, shape_name):
    jm, tm = meshes(mesh_name)
    shape = jbase.INPUT_SHAPES[shape_name]
    want, jshapes = jsteps.cache_specs(jbase.get_config(name), jm,
                                       shape.global_batch, shape.seq_len)
    got, tshapes = tsteps.cache_specs(tbase.get_config(name), tm,
                                      shape.global_batch, shape.seq_len)
    assert {k: tuple(v) for k, v in got.items()} == flat_ref(want)
    assert {k: tuple(v.shape) for k, v in tshapes.items()} == {
        k: tuple(v.shape) for k, v in jshapes.items()}
    assert all(v.device.type == "meta" for v in tshapes.values())


@pytest.mark.parametrize("shape_name", sorted(jbase.INPUT_SHAPES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2"])
def test_batch_structs_match_reference(name, mesh_name, shape_name):
    """Shapes, dtypes and specs of the data arguments (a frontend's float32
    embeddings among them)."""
    jm, tm = meshes(mesh_name)
    shape = jbase.INPUT_SHAPES[shape_name]
    want = jsteps.batch_structs(jbase.get_config(name), shape, jm)
    got = tsteps.batch_structs(tbase.get_config(name),
                               tbase.INPUT_SHAPES[shape_name], tm)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.meta.shape) == tuple(w.shape), k
        assert str(g.meta.dtype).split(".")[1] == np.dtype(w.dtype).name
        want_spec = () if w.sharding is None else tuple(w.sharding.spec)
        assert tuple(g.spec) == want_spec, k


# ---------------------------------------------------------------------------
# the helpers over dims that do and do not divide
# ---------------------------------------------------------------------------

GRID_MESHES = [((16, 16), ("data", "model")), ((2, 16, 16),
                                                ("pod", "data", "model")),
               ((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
               ((4,), ("model",)), ((3, 2), ("data", "model"))]
DIMS = (1, 2, 3, 6, 8, 12, 16, 24, 32, 48, 256, 512, 1000)
AXES = (None, "data", "model", "pod", ("data", "model"),
        ("pod", "data"), ("pod", "data", "model"), ("model", "data"))


@pytest.mark.parametrize("mesh_i", range(len(GRID_MESHES)))
def test_spec_helpers_match_reference_on_a_grid(mesh_i):
    shape, axes = GRID_MESHES[mesh_i]
    jm = jmesh.make_abstract_mesh(shape, axes)
    tm = tmesh.make_abstract_mesh(shape, axes)
    for d0, d1 in itertools.product(DIMS, DIMS):
        for a0, a1 in itertools.product(AXES, AXES):
            assert tuple(tsh.spec_for(tm, (d0, d1), a0, a1)) == tuple(
                jsh.spec_for(jm, (d0, d1), a0, a1))
        assert tuple(tsh.batch_spec(tm, d0, None, "model")) == tuple(
            jsh.batch_spec(jm, d0, None, "model"))
        assert tuple(tsh.kv_cache_spec(tm, d0, d1)) == tuple(
            jsh.kv_cache_spec(jm, d0, d1))
        assert tuple(tsh.state_spec(tm, d0, d1)) == tuple(
            jsh.state_spec(jm, d0, d1))
        for key in ("k", "c_kv", "state", "xprev_t", "conv", "ssm", "x"):
            full = (3, d0, d1, 8, 4)
            assert tuple(tsh.cache_leaf_spec(tm, key, full)) == tuple(
                jsh.cache_leaf_spec(jm, key, full))
    for name in (None, "data", ("pod", "model"), "nope"):
        assert tsh.axis_size(tm, name) == jsh.axis_size(jm, name)
    assert tsh.dp_axes(tm) == jsh.dp_axes(jm)


def test_default_rule_and_shapes_match_reference():
    """Leaves no rule names: the largest dim (the first of equals, as
    ``np.argmax``) on the FSDP axes when >= 1024 and divisible."""
    for shape, axes in GRID_MESHES:
        jm = jmesh.make_abstract_mesh(shape, axes)
        tm = tmesh.make_abstract_mesh(shape, axes)
        for leaf in [(4096,), (1024, 1024), (8, 2048, 2048), (1000, 3),
                     (512, 4096), (1023,), (), (3, 5)]:
            for fsdp in (("data",), ("pod", "data")):
                assert tuple(tsh._spec_for_leaf(tm, "a/norm", leaf, fsdp)) \
                    == tuple(jsh._spec_for_leaf(jm, "a/norm", leaf, fsdp))


def test_pos_embed_takes_the_embed_rule():
    """``_RULES`` match by suffix, first match wins: "pos_embed" ends with
    "embed", whose rule comes first, so it is vocab-parallel like the
    embedding, not replicated as its own rule says; as in the reference."""
    jm, tm = meshes("pod16x16")
    got = tsh._spec_for_leaf(tm, "frontend/pos_embed", (4096, 1024))
    assert tuple(got) == ("model", "data") == tuple(
        jsh._spec_for_leaf(jm, "frontend/pos_embed", (4096, 1024)))
    assert [s for s, _ in tsh._RULES] == [s for s, _ in jsh._RULES]
    assert [a for _, a in tsh._RULES] == [a for _, a in jsh._RULES]
    assert [s for s, _ in tsh._RULES].index("embed") < [
        s for s, _ in tsh._RULES].index("pos_embed")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_shard_shape_matches_named_sharding(mesh_name):
    """``shard_shape`` against the reference's ``NamedSharding.shard_shape``
    for every parameter of deepseek-v3 (the most rules)."""
    jm, tm = meshes(mesh_name)
    cfg = tbase.get_config("deepseek-v3-671b")
    params = tsteps.abstract_params(cfg)
    specs = dict(tsteps.leaves_with_paths(tsh.param_specs(tm, params)))
    for path, leaf in tsteps.leaves_with_paths(params):
        spec = specs[path]
        want = jax.sharding.NamedSharding(
            jm, jax.sharding.PartitionSpec(*spec)).shard_shape(
            tuple(leaf.shape))
        assert tsh.shard_shape(leaf.shape, spec, tm) == want, path
    with pytest.raises(ValueError):
        tsh.shard_shape((10, 3), tsh.P("model"), tm)


def test_constrain_is_the_identity_and_records():
    """No mesh: nothing recorded.  Under a mesh: ``x`` itself comes back,
    its spec is ``spec_for``'s (axes that do not divide dropped, trailing
    dims padded), and an axis named twice fails as the reference's
    ``NamedSharding`` does."""
    x = torch.zeros(4, 6, 8)
    with tact.record_constraints() as log:
        assert tact.constrain(x, "data") is x
    assert log == []
    m = tmesh.make_abstract_mesh((2, 4), ("data", "model"))
    with tact.activation_mesh(m), tact.record_constraints() as log:
        assert tact.constrain(x, "data", "model") is x
        assert tact.constrain(x, tact.dp(), None, "model") is x
        assert tact.current_mesh() is m
        with pytest.raises(ValueError):
            tact.constrain(torch.zeros(8, 8), "model", "model")
    assert tact.current_mesh() is None
    assert log == [((4, 6, 8), ("data", None, None)),
                   ((4, 6, 8), ("data", None, "model"))]
    pod = tmesh.make_abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    assert tact.dp(pod) == ("pod", "data") and tact.dp(m) == "data"
    with tact.activation_mesh(pod), tact.record_constraints() as log:
        tact.constrain(x, tact.dp())
    assert log == [((4, 6, 8), (("pod", "data"), None, None))]
