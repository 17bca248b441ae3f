"""The port's op-level cost counter (``launch/cost_analysis.py``) against
the reference's HLO analyzer (``repro.launch.hlo_analysis``).

The analyzer's rules are held op by op on the same ops (the reference's
compiled, or for the slice instructions its lowered, HLO read by
``hlo_analysis.analyze``); the reference's steps of reduced phi4-mini are
compiled in one child process (``XLA_FLAGS=
--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``) on one
device and on a (2, 4) mesh, and their flops held against the port's
count of its own steps on meta tensors, their collectives against the
port's partition pass (``launch/partition.py``).  The five kernels' ``work(...)``
give the figures their bounds have printed; under a counter a wrapper's
call is one kernel entry.  ``memory_analysis`` follows a hand-made
sequence of allocations exactly, and ``scaled_by_depth`` equals a full
walk of the model."""
import collections
import contextlib
import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis
from repro_torch import kernels
from repro_torch.cfd import solver
from repro_torch.cfd.grid import GridConfig, max_bodies
from repro_torch.configs.base import InputShape, get_config
from repro_torch.kernels.actuation import ops as aops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.poisson import ops as pops
from repro_torch.kernels.rwkv6 import ops as wops
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun, partition, steps
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import act_sharding
from repro_torch.models.sharding import P

SRC = str(Path(__file__).resolve().parent.parent / "src")
SHAPES = {"train": ("t", 64, 8, "train"), "prefill": ("p", 64, 8, "prefill"),
          "decode": ("d", 64, 8, "decode")}
MESHES = ((1, 1), (2, 4))
# the port's flops within 2% of the reference's on one device (the train
# step measured 0.011% apart, prefill and decode equal)
TOL_FLOPS = 0.02
# the port's per-device collective bytes within this factor of the
# reference's: DTensor and XLA plan the same layouts' collectives apart
# (measured 0.55x in train, 1.04x in prefill and decode)
TOL_COLL = 2.0


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the analyzer's rules (the twins of tests/test_substrates.py's)
# ---------------------------------------------------------------------------

def test_counter_counts_a_chain_of_products_exactly():
    """10 chained tanh(h @ w) layers: 10 x 2 M N K, the reference's scaled
    scan body, exactly; elementwise work adds no flops."""
    def f(x, w):
        h = x
        for i in range(w.shape[0]):
            h = torch.tanh(h @ w[i])
        return h

    res = ca.analyze(f, meta(8, 64), meta(10, 64, 64))
    assert res["flops"] == 10 * 2 * 8 * 64 * 64


def test_counter_counts_nested_loops_exactly():
    def f(x, w):
        h = x
        for _ in range(3):
            for i in range(w.shape[0]):
                h = h @ w[i]
        return h

    res = ca.analyze(f, meta(4, 32), meta(5, 32, 32))
    assert res["flops"] == 3 * 5 * 2 * 4 * 32 * 32


S = jax.ShapeDtypeStruct
F32 = jnp.float32


def _reference_bytes(fn, args, compiled):
    lowered = jax.jit(fn).lower(*args)
    if compiled:
        return hlo_analysis.analyze(lowered.compile().as_text())
    # the lowered module writes its names without the "%" and its entry
    # without the signature that the analyzer's parser keys on (as the
    # compiled text writes them)
    txt = re.sub(r"^(\s*(?:ROOT )?)(\S+ = )", r"\1%\2",
                 lowered.as_text(dialect="hlo"), flags=re.M)
    txt = re.sub(r"^ENTRY (\S+) \{", r"ENTRY %\1 () -> () {", txt,
                 flags=re.M)
    return hlo_analysis.analyze(txt)


# (the reference's op, its argument shapes, read compiled or as lowered,
# the port's op on meta tensors of the same shapes).  The slice
# instructions are read as lowered: compiled, XLA wraps them in a fusion
# that the analyzer prices as a fusion of the whole buffer.
OPS = {
    "matmul": (lambda a, b: a @ b, (S((8, 64), F32), S((64, 32), F32)),
               True, lambda a, b: a @ b),
    "elementwise": (jnp.tanh, (S((8, 64), F32),), True, torch.tanh),
    "slice_write": (lambda x, u, i: jax.lax.dynamic_update_slice(
        x, u, (i, 0)), (S((64, 32), F32), S((4, 32), F32),
                        S((), jnp.int32)), False,
        lambda x, u, i: x[3:7].copy_(u)),
    "slice_read": (lambda x, i: jax.lax.dynamic_slice(x, (i, 0), (4, 32)),
                   (S((64, 32), F32), S((), jnp.int32)), False,
                   lambda x, i: x[3:7].clone()),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_bytes_follow_the_reference_rule(op):
    """A matmul (operands + output, 2 M N K), an elementwise op (operand +
    output), a write into a slice (twice the update) and a slice read
    (twice the slice): the reference's bytes and flops for the same op."""
    jfn, shapes, compiled, tfn = OPS[op]
    want = _reference_bytes(jfn, shapes, compiled)
    args = [meta(*s.shape, dtype=torch.int32 if s.dtype == jnp.int32
                 else torch.float32) for s in shapes]
    got = ca.analyze(tfn, *args)
    assert got["bytes"] == want["bytes"] and got["flops"] == want["flops"]


def test_views_and_empty_allocations_count_no_bytes():
    def f(x):
        y = x.t()[2:5].unsqueeze(0)
        return torch.empty_like(y), y

    assert ca.analyze(f, meta(16, 8))["bytes"] == 0


# ---------------------------------------------------------------------------
# reduced phi4-mini against the reference's compiled steps
# ---------------------------------------------------------------------------

_CHILD = """
import json
import numpy as np
import jax
from repro.configs.base import InputShape, get_config
from repro.launch import hlo_analysis, steps
cfg = get_config("phi4-mini-3.8b").reduced()
out = {{}}
for shape in {meshes!r}:
    n = shape[0] * shape[1]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             ("data", "model"))
    for kind, args in {shapes!r}.items():
        with mesh:
            fn, a = steps.lowering_for(cfg, InputShape(*args), mesh)
            txt = fn.lower(*a).compile().as_text()
        r = hlo_analysis.analyze(txt)
        out[f"{{shape[0]}}x{{shape[1]}}/{{kind}}"] = [r["flops"], r["bytes"]]
        out[f"{{shape[0]}}x{{shape[1]}}/{{kind}}/coll"] = {{
            k: v for k, v in r.items() if k.startswith("coll_")}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_counts(tmp_path_factory):
    d = tmp_path_factory.mktemp("costs")
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC,
           "PATH": "/usr/bin:/bin", "HOME": str(d)}
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_CHILD.format(
            meshes=MESHES, shapes=SHAPES))],
        capture_output=True, text=True, env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def port_counts(mesh_shape, kind):
    cfg = get_config("phi4-mini-3.8b").reduced()
    mesh = make_abstract_mesh(mesh_shape, ("data", "model"))
    return dryrun.step_counts(cfg, InputShape(*SHAPES[kind]), mesh)["cost"]


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_reduced_phi4_flops_match_the_reference_on_one_device(
        reference_counts, kind):
    """``backend="reference"`` on one device: the port's count of its own
    step within 2% of the reference's ``hlo_analysis`` flops (the bytes
    are an eager proxy, not gated: PERF.md records their ratio)."""
    want, want_bytes = reference_counts[f"1x1/{kind}"]
    got = port_counts((1, 1), kind)
    print(f"[cost] reduced phi4-mini {kind}, one device: flops port "
          f"{got['flops']} reference {want} (gap {got['flops'] / want - 1:.4%})"
          f"; bytes port {got['bytes']} reference {want_bytes} (ratio "
          f"{got['bytes'] / want_bytes:.4f})")
    assert abs(got["flops"] - want) <= TOL_FLOPS * want, (got, want)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_reduced_phi4_flops_on_a_2x4_mesh(reference_counts, kind):
    """On a (2, 4) mesh the reference's per-device flops times 8 cover the
    port's global count (the partitioner may repeat work, never drop
    it)."""
    per_device, _ = reference_counts[f"2x4/{kind}"]
    got = port_counts((2, 4), kind)["flops"]
    print(f"[cost] reduced phi4-mini {kind}, (2, 4): reference per device x 8 "
          f"over the port's global flops {8 * per_device / got:.6f}")
    assert 8 * per_device >= (1 - TOL_FLOPS) * got, (per_device, got)


# ---------------------------------------------------------------------------
# the partition pass's collectives
# ---------------------------------------------------------------------------

def port_collectives(mesh_shape, kind):
    cfg = get_config("phi4-mini-3.8b").reduced()
    mesh = make_abstract_mesh(mesh_shape, ("data", "model"))
    return dryrun.partition_counts(cfg, InputShape(*SHAPES[kind]), mesh)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_reduced_phi4_collectives_within_2x_of_the_reference(
        reference_counts, kind):
    """On a (2, 4) mesh the partition pass's per-device collective bytes
    are within 2x of the reference's ``hlo_analysis`` of its compiled,
    partitioned step (the kinds printed side by side)."""
    want = reference_counts[f"2x4/{kind}/coll"]
    part = port_collectives((2, 4), kind)
    assert part["coll_status"] == "counted", part
    got = part["coll_partition"]
    kinds = sorted({k for k in (*want, *got)
                    if k.startswith("coll_") and k != "coll_bytes"})
    print(f"[coll] reduced phi4-mini {kind}, (2, 4): port "
          f"{got['coll_bytes']} reference {want['coll_bytes']} (ratio "
          f"{got['coll_bytes'] / want['coll_bytes']:.4f}); "
          + ", ".join(f"{k[5:]} {got.get(k, 0)} / {want.get(k, 0)}"
                      for k in kinds))
    assert want["coll_bytes"] / TOL_COLL <= got["coll_bytes"] \
        <= TOL_COLL * want["coll_bytes"]


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_no_collectives_on_one_device(reference_counts, kind):
    """On a (1, 1) mesh neither package communicates."""
    assert reference_counts[f"1x1/{kind}/coll"]["coll_bytes"] == 0
    part = port_collectives((1, 1), kind)
    assert part["coll_status"] == "counted"
    assert part["coll_partition"]["coll_bytes"] == 0


def test_an_fsdp_linear_layer_counts_its_gathers_and_its_reduction():
    """y = x @ w, x (8, 16) over "data", w (16, 32) FSDP-sharded over
    "data" on a (2, 4) mesh, and the gradient of sum(y) in w constrained
    back to w's spec: w's shard of 8 x 32 float32 gathered in the forward
    and again in the backward (2 x 1024 bytes), and the whole 16 x 32
    gradient reduce-scattered (2048 bytes); nothing on "model", where
    both are whole."""
    mesh = make_abstract_mesh((2, 4), ("data", "model"))

    def layer(x, w):
        w.requires_grad_(True)
        y = x @ act_sharding.gathered(w, P(None, None))
        g, = torch.autograd.grad(y.sum(), [w])
        return act_sharding.constrain_to(g, P("data", None))

    args = (steps.Struct(meta(8, 16), P("data", None)),
            steps.Struct(meta(16, 32), P("data", None)))
    got = partition.analyze(layer, args, mesh)
    assert got == {"coll_bytes": 4096, "coll_all-gather": 2 * 8 * 32 * 4,
                   "coll_reduce-scatter": 16 * 32 * 4, "replicated": {}}


def test_specs_become_ordered_shards():
    """Every axis of a spec entry shards that dim on its mesh dim, the
    others replicate; the hooks are the identity outside the pass."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    with partition.fake_mesh(mesh) as dm:
        assert dm.shape == (2, 2, 2)
        assert partition.placements(P(("pod", "data"), "model"), 2, dm) \
            == [Shard(0), Shard(0), Shard(1)]
        assert partition.placements(P(None, "data"), 3, dm) == [
            Replicate(), Shard(1), Replicate()]
        x = partition.distribute(meta(4, 6), P(("pod", "data"), None), mesh,
                                 dm)
        assert x.to_local().shape == (1, 6) and x.shape == (4, 6)
    x = meta(4, 6)
    assert act_sharding.gathered(x, P("data")) is x
    assert act_sharding.local_shards([x]) == [x]


def test_fake_mesh_refuses_a_live_group_and_too_many_ranks():
    """The pass opens its own fake group, never beside a live one (a
    fleet's), and tears it down after; at most 512 ranks."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match="512"):
        with partition.fake_mesh(make_abstract_mesh((2, 512),
                                                    ("data", "model"))):
            pass
    with partition.fake_mesh(make_abstract_mesh((2, 16, 16),
                                                ("pod", "data", "model"))):
        assert dist.get_world_size() == 512
        with pytest.raises(RuntimeError, match="already initialised"):
            with partition.fake_mesh(make_abstract_mesh((1, 1),
                                                        ("data", "model"))):
                pass
    assert not dist.is_initialized()


@pytest.mark.parametrize("size", [24, 96, 100])
def test_strided_shard_sizes_in_closed_form_equal_dtensors(size):
    """The pass's closed form of a strided shard's size and first offset
    equals DTensor's own (which splits an ``arange`` of the dim) for every
    rank, split factor and mode; an uneven or ``ALL`` case is DTensor's."""
    from torch.distributed.tensor.placement_types import (
        _StridedShard, _StridedShardOffsetMode)
    cases = [(sf, n, r, mode) for sf in (1, 2, 4) for n in (2, 3, 4)
             for r in range(n) for mode in _StridedShardOffsetMode]

    def shares():
        return [_StridedShard(0, split_factor=sf).local_shard_size_and_offset(
            size, n, r, mode) for sf, n, r, mode in cases]

    want = shares()
    with partition._even_strided_shards():
        got = shares()
    assert got == want


def test_kept_planner_steps_are_dtensors_own(monkeypatch):
    """Reduced phi4-mini's decode on a (2, 2, 2) multi-pod mesh, whose
    strided layouts DTensor's redistribution planner searches, with the
    planner's steps kept (``partition._planned_steps_kept``): at the
    second ask of each layout, and at every 50th ask after, the kept
    steps equal what DTensor's own planner answers at that moment, costs
    and order included (the order breaks the search's ties).  The pass
    without the kept steps asks ~100x as often (~4 min on one CPU
    thread), so this checks the kept steps where they are reused."""
    from torch.distributed.tensor import DTensor, _redistribute
    planner = _redistribute.DTensorRedistributePlanner
    own, keep = planner.get_next_state, partition._planned_steps_kept
    asks, checked = collections.Counter(), []

    @contextlib.contextmanager
    def kept_and_checked():
        with keep():
            kept = planner.get_next_state
            assert kept is not own

            def check(self, placements, order):
                got = kept(self, placements, order)
                key = (id(self), placements, order)
                asks[key] += 1
                if asks[key] == 2 or asks[key] % 50 == 0:
                    checked.append(1)
                    assert list(got.items()) == list(
                        own(self, placements, order).items()), key
                return got

            planner.get_next_state = check
            try:
                yield
            finally:
                planner.get_next_state = kept

    # DTensor keeps its plans and sharding decisions across passes
    torch._C._clear_DTensor_sharding_propagator_cache()
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding \
        .cache_clear()
    _redistribute.clear_redistribute_planner_cache()
    _redistribute._gen_transform_infos.cache_clear()
    monkeypatch.setattr(partition, "_planned_steps_kept", kept_and_checked)
    got = partition.count(get_config("phi4-mini-3.8b").reduced(),
                          InputShape(*SHAPES["decode"]),
                          make_abstract_mesh((2, 2, 2),
                                             ("pod", "data", "model")))
    print(f"[coll] reduced phi4-mini decode, (2, 2, 2): {got}; "
          f"{sum(asks.values())} asks of {len(asks)} layouts, "
          f"{len(checked)} checked against DTensor's own planner")
    assert planner.get_next_state is own
    assert len(checked) > 1000 and sum(asks.values()) > 10 * len(asks)
    assert got["coll_bytes"] > 0


def test_a_step_that_cannot_be_partitioned_says_why(monkeypatch):
    """A failing pass gives ``coll_status: "not counted: <reason>"`` and
    no collective of its own, never a silent 0 under "counted"."""
    def fail(*a):
        raise NotImplementedError("no rule")
    monkeypatch.setattr(partition, "step_collectives", fail)
    part = port_collectives((2, 4), "decode")
    assert part == {"coll_status": "not counted: NotImplementedError: "
                                   "no rule"}
    assert dryrun.with_collectives({"coll_bytes": 3}, part) == {
        "coll_bytes": 3}


# ---------------------------------------------------------------------------
# the kernels counted by their own work
# ---------------------------------------------------------------------------

def test_kernel_work_gives_the_bounds_figures():
    """Each kernel's ``work(...)`` at the shape its bound was printed at
    (phase 1 of ``chip_smoke.py``), to the printed digits."""
    res16 = GridConfig(res=16)
    fl, nb = aops.work(res16, 4, 50)
    assert (round(fl / 1e9, 4), round(nb / 1e6, 4)) == (3.3314, 3.3707)
    fl, nb = aops.work(res16, 4, 50, max_bodies(), 3)
    assert (round(fl / 1e9, 4), round(nb / 1e6, 4)) == (3.4439, 8.4378)
    fl, nb = pops.work(4, res16.ny, res16.nx, 50)
    assert (round(fl / 1e6, 3), round(nb / 1e6, 4)) == (48.323, 1.1151)
    fl, nb = fops.work(1, 4096, 24, 8, 128, 2)
    assert (round(fl / 1e9, 3), round(nb / 1e6, 1)) == (103.079, 67.1)
    fl, nb = fops.work(1, 4096, 25, 5, 64, 2, sliding_window=1024)
    assert (round(fl / 1e9, 3), round(nb / 1e6, 2)) == (23.491, 31.46)
    products, elementwise = wops.flops_by_unit(1, 4096, 40, 64, 32)
    assert (round(products / 1e9, 4), round(elementwise / 1e9, 4)) == (
        3.3345, 0.1573)
    fl, nb = wops.work(1, 4096, 40, 64, 32, 2)
    assert fl == products + elementwise and round(nb / 1e6, 2) == 106.17


def _flash_call():
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 256, h, 32)),
                            dtype=torch.float32) for h in (4, 2, 2))
    return (lambda: fops.flash_attention(q, k, v),
            fops.work(1, 256, 4, 2, 32, 4), 1)


def _wkv6_call():
    rng = np.random.default_rng(1)
    r, k, v = (torch.tensor(rng.standard_normal((1, 64, 2, 16)),
                            dtype=torch.float32) for _ in range(3))
    w = torch.full((1, 64, 2, 16), 0.9)
    u, s0 = torch.zeros(2, 16), torch.zeros(1, 2, 16, 16)
    return (lambda: wops.wkv6(r, k, v, w, u, s0),
            wops.work(1, 64, 2, 16, 32, 4), 2)


def _sor_planes_call():
    g = GridConfig(res=4)
    planes = [torch.randn(2, g.ny, g.nx // 2) for _ in range(4)]
    return (lambda: pops.rb_sor_planes(*planes, g.dx, g.dy, iters=8),
            pops.work(2, g.ny, g.nx, 8), 1)


def _sor_full_call():
    g = GridConfig(res=4)
    rhs, p0 = torch.randn(2, g.ny, g.nx), torch.randn(2, g.ny, g.nx)
    return (lambda: pops.rb_sor(rhs, g.dx, g.dy, iters=8, p0=p0,
                                packed=False),
            pops.work(2, g.ny, g.nx, 8), 1)


def _fused_call():
    g = GridConfig(res=4)
    from repro_torch.cfd.grid import build_geometry
    ga = solver.geom_to_arrays(build_geometry(g, "cylinder"), "cpu")
    st = solver.FlowState(torch.zeros(2, g.ny, g.nx + 1),
                          torch.zeros(2, g.ny + 1, g.nx),
                          torch.zeros(2, g.ny, g.nx))
    jet = torch.tensor([0.1, -0.2])
    return (lambda: aops.fused_interval(g, ga, st, jet, 3),
            aops.work(g, 2, 3), 1)


KERNEL_CALLS = {"flash_attention": _flash_call, "wkv6": _wkv6_call,
                "rb_sor_slabs_packed": _sor_planes_call,
                "rb_sor_slabs": _sor_full_call,
                "fused_interval": _fused_call}


@pytest.mark.parametrize("name", sorted(KERNEL_CALLS))
def test_a_wrapper_call_counts_as_one_kernel_entry(name):
    """On CPU tensors the wrapper runs the plain twin, whose ops count
    nothing: the call is one entry under the kernel's name with its work
    and the card's launches, and its flops and bytes are the step's."""
    call, (flops, nbytes), launches = KERNEL_CALLS[name]()
    res = ca.analyze(call)
    assert res["kernels"] == {name: {"launches": launches, "flops": flops,
                                     "bytes": nbytes}}
    assert (res["flops"], res["bytes"]) == (flops, nbytes)


def test_kernel_hook_is_inert_without_a_counter():
    with kernels.counted("x", lambda: pytest.fail("work evaluated")):
        pass


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

def test_memory_analysis_follows_allocations_and_frees():
    """Allocations and frees by hand: the live bytes peak at 22 000 (b, a
    view of c and e), 2 000 are held at the end (the view), the peak adds
    the argument."""
    def f(x):
        a = torch.empty(1000, device="meta")
        b = torch.empty(2000, device="meta")
        del a
        c = torch.empty(500, device="meta")
        d = c[100:]
        del c
        e = torch.empty(3000, device="meta")
        del b, e
        return d

    mem = ca.memory_analysis(f, meta(64))
    assert mem == {"argument_bytes": 256, "output_bytes": 2000,
                   "temp_bytes": 20000, "peak_per_device_bytes": 22256}


def test_memory_inside_a_kernel_counts_what_outlives_it():
    """A wrapper's scratch freed before it returns is not counted; its
    output is, from the moment the wrapper returns."""
    def f():
        with kernels.counted("k", lambda: (0, 0)):
            scratch = torch.empty(5000, device="meta")
            out = torch.empty(100, device="meta")
            del scratch
        return out

    mem = ca.memory_analysis(f)
    assert (mem["temp_bytes"], mem["output_bytes"]) == (0, 400)


# ---------------------------------------------------------------------------
# per-block scaling against the full walk
# ---------------------------------------------------------------------------

SCALING = {"phi4-mini-3.8b": ({"blocks": 2}, {"blocks": 4}),
           "deepseek-v3-671b": ({"dense": 1, "blocks": 2},
                                {"dense": 1, "blocks": 4}),
           "seamless-m4t-large-v2": ({"blocks": 2, "encoder": 2},
                                     {"blocks": 4, "encoder": 4})}


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(SCALING))
def test_scaled_count_equals_the_full_walk(arch, kind):
    """Reduced configs on a (2, 4) mesh (deepseek's MoE through the
    expert-parallel exchange): the count scaled from walks at 1-3 layers
    a stack equals the full walk at 2 and 4 layers, every term (flops,
    bytes, collective bytes, kernels, output and temporary bytes)."""
    mesh = make_abstract_mesh((2, 4), ("data", "model"))
    shape = InputShape(*SHAPES[kind])
    base = get_config(arch).reduced()
    for depths in SCALING[arch]:
        cfg = ca.with_depths(base, depths)
        scaled, full = dryrun.step_counts(cfg, shape, mesh), _walk(
            cfg, shape, mesh)
        assert scaled == full, (depths, scaled, full)


def _walk(cfg, shape, mesh):
    from repro_torch.launch import steps
    fn, args = steps.lowering_for(cfg, shape, mesh)
    cost, mem = ca.count(fn, *dryrun._metas(args))
    return {"cost": cost, "memory": {"output_bytes": mem["output_bytes"],
                                     "temp_bytes": mem["temp_bytes"]}}


def test_collective_counts_the_expert_parallel_exchange():
    """Reduced phi3.5-moe on a (2, 4) mesh takes the expert-parallel
    all-to-all: its two hops' buckets (rows and expert ids) are counted
    under ``coll_all-to-all``; on one device there is none (the single
    dispatch)."""
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    shape = InputShape(*SHAPES["prefill"])
    on_mesh = dryrun.step_counts(cfg, shape, make_abstract_mesh(
        (2, 4), ("data", "model")))["cost"]
    assert on_mesh["coll_all-to-all"] > 0
    assert on_mesh["coll_bytes"] == on_mesh["coll_all-to-all"]
    one = make_abstract_mesh((1, 1), ("data", "model"))
    assert dryrun.step_counts(cfg, shape, one)["cost"]["coll_bytes"] == 0
