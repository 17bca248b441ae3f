"""Parity of the port's optimizers (``repro_torch.optim.optimizers``) with
the reference's (``repro.optim.optimizers``): ``cosine_schedule``, AdamW
with and without weight decay and clipping, Adafactor factored and not,
its per-layer path for stacked leaves and its bfloat16 update direction,
``make_optimizer``; and the DRL path's AdamW held bit for bit against the
list form it had before the update went tensor by tensor.

The same numpy inputs go through both packages for 3 steps.  float32
results agree within 1e-6 of the array's largest magnitude: both compute
the same float32 expression, the global norm and the means summing in
another order (a clipped run adds twice the measured difference of the two
global norms, :func:`clip_rtol`).

A bfloat16 update direction is the product of four bfloat16-rounded
factors, ``g``, ``rsqrt(vr / denom + eps)``, ``rsqrt(vc + eps)`` and the
clip scale, rounded to bfloat16 after each of the first two products; the
last, exact in float32, is rounded only to the params' dtype (the
reference's jitted update: XLA drops the bfloat16 round trip there, its
op-by-op update keeps it).  It is held against the reference jitted, as its
train step runs it, two ways.  Bit for bit: at least 99% of each step's
factored update equals the reference's (the clip lifted; a port with a
float32 direction fails this, the control).  And in size: where the two
packages' float32 values behind a factor differ in the last bit (the
rsqrt, the means), its bfloat16 rounding can land one ulp (at most 2^-7
relative) apart, and each product may round the other way (2^-8): so each
step's update is held within 4 * 2^-7 + 3 * 2^-8 (5.5 * 2^-7, 4.3%) of
its magnitude, plus the float32 rounding of ``p - update``.  Each step
starts both packages from the reference's state, so a step's difference
does not carry into the next.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as J
from repro_torch.optim import optimizers as T
from tests._torch_parity import to_np

RTOL = 1e-6
STEPS = 3
BF16_DIRECTION = 4 * 2.0 ** -7 + 3 * 2.0 ** -8
F32_EPS = 2.0 ** -23


def assert_rel(ref, out, what, rtol=RTOL):
    a, b = to_np(ref).astype(np.float64), to_np(out).astype(np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(np.abs(a).max(initial=0.0), 1e-30)
    err = np.abs(a - b).max(initial=0.0)
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol:.0e} x {scale:.3e}"


def inputs(shapes, seed=0, heavy_layer=False):
    """Params and STEPS gradient sets as numpy float32; with
    ``heavy_layer`` 5% of the first layer's gradients in each stacked leaf
    are 20x the rest, so that layer's update RMS differs from the others'
    (the per-layer clipping then matters)."""
    rng = np.random.default_rng(seed)
    ps = [(0.05 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    gs = []
    for _ in range(STEPS):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        if heavy_layer:
            for x in g:
                if x.ndim >= 3:
                    x[0] *= np.where(rng.random(x.shape[1:]) < 0.05, 20.0,
                                     1.0).astype(np.float32)
        gs.append(g)
    return ps, gs


def run_both(jopt, topt, ps, gs):
    jp, tp = [jnp.asarray(p) for p in ps], [torch.tensor(p) for p in ps]
    js, ts = jopt.init(jp), topt.init(tp)
    for step, g in enumerate(gs):
        jp, js = jopt.update([jnp.asarray(x) for x in g], js, jp,
                             jnp.int32(step))
        tp, ts = topt.update([torch.tensor(x) for x in g], ts, tp, step)
    return jp, js, tp, ts


def clip_rtol(gs, max_grad_norm):
    """RTOL, widened for a clipped run by twice the largest relative
    difference of the two packages' global norms of these gradients: the
    norm sums ~10^5 squares in another order (5.7e-7 apart here), and a
    second moment holds the square of the clipped gradient."""
    if not max_grad_norm:
        return RTOL
    d = max(abs(float(J.global_norm([jnp.asarray(x) for x in g]))
                - float(T.global_norm([torch.tensor(x) for x in g])))
            / float(J.global_norm([jnp.asarray(x) for x in g])) for g in gs)
    return RTOL + 2 * d


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (5, 5)])
def test_cosine_schedule(warmup, total):
    jf, tf = J.cosine_schedule(3e-4, warmup, total), \
        T.cosine_schedule(3e-4, warmup, total)
    for step in (0, 1, warmup // 2, warmup, warmup + 1, (warmup + total) // 2,
                 total - 1, total, total + 7):
        a, b = float(jf(jnp.int32(step))), tf(step)
        assert b.dtype == torch.float32
        assert abs(a - float(b)) <= RTOL * 3e-4, (step, a, float(b))


def test_constant_schedule():
    """A Python float, which meets float32 tensors as the reference's
    float32 rate."""
    lr = T.constant_schedule(1e-3)(5)
    assert isinstance(lr, float)
    assert np.float32(lr) == np.asarray(J.constant_schedule(1e-3)(5))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

SHAPES = [(6, 40), (40,), (3, 20, 12), ()]


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw(weight_decay, max_grad_norm, schedule):
    lr = (lambda m: m.cosine_schedule(1e-2, 2, 10)) if schedule == "cosine" \
        else (lambda m: 1e-2)
    kw = dict(weight_decay=weight_decay, max_grad_norm=max_grad_norm)
    ps, gs = inputs(SHAPES)
    jp, js, tp, ts = run_both(J.adamw(lr(J), **kw), T.adamw(lr(T), **kw),
                              ps, gs)
    rtol = clip_rtol(gs, max_grad_norm)
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert b.dtype == torch.float32
        assert_rel(a, b, f"param {i}", rtol)
        assert_rel(js["m"][i], ts["m"][i], f"m {i}", rtol)
        assert_rel(js["v"][i], ts["v"][i], f"v {i}", rtol)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_donated_update_equals_returned(opt, monkeypatch):
    """``update(donate=True)`` writes into the given tensors the values
    that ``update()`` returns in new ones, here across several AdamW slices
    and Adafactor's per-layer path; ``update()`` leaves the given params
    and state as they were."""
    monkeypatch.setattr(T, "CHUNK", 4099)
    make = {"adamw": lambda: T.adamw(1e-2, weight_decay=0.1,
                                     max_grad_norm=1.0),
            "adafactor": lambda: T.adafactor(1e-2, max_grad_norm=1.0)}[opt]
    flat = (lambda s: s["m"] + s["v"]) if opt == "adamw" else \
        (lambda s: [x for d in s for x in d.values()])
    ps, gs = inputs([(6, 130, 140), (40,), (5, 9)])
    tp = [torch.tensor(p) for p in ps]
    dp = [p.clone() for p in tp]
    o = make()
    ts, ds = o.init(tp), o.init(dp)
    for step, g in enumerate(gs):
        g = [torch.tensor(x) for x in g]
        before = [x.clone() for x in tp + flat(ts)]
        new_p, new_s = o.update(g, ts, tp, step)
        assert all(torch.equal(a, b) for a, b in zip(before, tp + flat(ts)))
        assert not any(a is b for a, b in zip(new_p, tp))
        tp, ts = new_p, new_s
        out_p, out_s = o.update(g, ds, dp, step, donate=True)
        assert all(a is b for a, b in zip(out_p, dp)) and out_s is ds
        for a, b in zip(tp, dp):
            assert torch.equal(a, b)
    for a, b in zip(flat(ts), flat(ds)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the DRL path's AdamW: bit for bit the list form it replaced
# ---------------------------------------------------------------------------

def _adamw_list_form(lr, *, b1=0.9, b2=0.999, eps=1e-8, max_grad_norm=0.0):
    """The port's AdamW before it went tensor by tensor: every moment and
    bias-corrected moment built for the whole list at once."""
    def update(grads, state, params, step):
        if max_grad_norm:
            grads, _ = T.clip_by_global_norm(grads, max_grad_norm)
        else:
            grads = [g.to(torch.float32) for g in grads]
        t = torch.as_tensor(step, dtype=torch.float32,
                            device=grads[0].device) + 1.0
        m = [b1 * m_ + (1 - b1) * g for m_, g in zip(state["m"], grads)]
        v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(state["v"], grads)]
        mh = [m_ / (1 - b1 ** t) for m_ in m]
        vh = [v_ / (1 - b2 ** t) for v_ in v]
        new_params = []
        for p, m_, v_ in zip(params, mh, vh):
            du = m_ / (torch.sqrt(v_) + eps)
            new_params.append((p.to(torch.float32) - lr * du).to(p.dtype))
        return new_params, {"m": m, "v": v}
    return update


@pytest.mark.parametrize("max_grad_norm", [0.0, 0.5])
def test_ppo_adamw_bit_equal_to_list_form(max_grad_norm):
    """The PPO update's optimizer (``ppo.make_optimizer``: lr 3e-4, clip
    0.5) over the MLP policy's shapes, 3 steps, bit for bit."""
    from repro_torch.drl import ppo
    shapes = [(149, 512), (512,), (512, 512), (512,), (512, 2), (2,), (2,)]
    ps, gs = inputs(shapes, seed=3)
    cfg = ppo.PPOConfig(max_grad_norm=max_grad_norm)
    new = ppo.make_optimizer(cfg)
    old = _adamw_list_form(cfg.lr, max_grad_norm=max_grad_norm)
    tp = [torch.tensor(p) for p in ps]
    op = [p.clone() for p in tp]
    ts = new.init(tp)
    os_ = {k: [x.clone() for x in v] for k, v in ts.items()}
    for step, g in enumerate(gs):
        g = [torch.tensor(x) for x in g]
        tp, ts = new.update(g, ts, tp, step)
        op, os_ = old(g, os_, op, step)
        for a, b in zip(tp, op):
            assert torch.equal(a, b)
        for k in ("m", "v"):
            for a, b in zip(ts[k], os_[k]):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

# factored (both trailing dims >= 128) and not, the per-layer path of
# stacked leaves at (8, 130, 140) and (6, 256, 192), a stack of 4 layers
# (no per-layer path: the reference maps only over more than 4)
AF_SHAPES = [(130, 140), (300,), (3, 40), (8, 130, 140), (6, 256, 192),
             (4, 128, 128)]


@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0])
def test_adafactor_float32(max_grad_norm):
    ps, gs = inputs(AF_SHAPES, heavy_layer=True)
    kw = dict(max_grad_norm=max_grad_norm)
    jp, js, tp, ts = run_both(J.adafactor(1e-2, **kw),
                              T.adafactor(1e-2, **kw), ps, gs)
    rtol = clip_rtol(gs, max_grad_norm)
    for i, (a, b, s, shape) in enumerate(zip(jp, tp, ts, AF_SHAPES)):
        assert_rel(a, b, f"param {shape}", rtol)
        factored = len(shape) >= 2 and min(shape[-2:]) >= 128
        assert set(s) == ({"vr", "vc"} if factored else {"v"})
        for k in s:
            assert_rel(js[i][k], s[k], f"{k} {shape}", rtol)


def test_adafactor_per_layer_clipping_matters():
    """On these inputs the per-layer update RMS differs from the whole
    stack's, so the parity above holds the per-layer path, not a
    whole-tensor clip that would happen to agree."""
    ps, gs = inputs(AF_SHAPES, heavy_layer=True)
    p = torch.tensor(ps[3])
    whole = T.adafactor(1e-2)
    out_layer = whole.update([torch.tensor(gs[0][3])], whole.init([p]), [p],
                             0)[0][0]
    flat = p.reshape(1, 8 * 130, 140)      # one slice: one clip over all
    out_flat = whole.update([torch.tensor(gs[0][3]).reshape(1, 8 * 130, 140)],
                            whole.init([flat]), [flat], 0)[0][0]
    assert (out_layer - out_flat.reshape(p.shape)).abs().max() > 1e-6


def bf16_steps(update_dtype, param_dtype, seed, **kw):
    """Both packages' Adafactor with a bfloat16 direction (the port's in
    ``update_dtype``), each step from the reference's params and state,
    the reference jitted as its train step runs it: per step, a list of
    (params before, reference's after, port's after, shape) as float64,
    and the two new states."""
    ps, gs = inputs(AF_SHAPES, seed=seed, heavy_layer=True)
    jo = J.adafactor(1e-2, update_dtype=jnp.bfloat16, **kw)
    to = T.adafactor(1e-2, update_dtype=update_dtype, **kw)
    jd = jnp.dtype(param_dtype)
    td = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    jp = [jnp.asarray(p, jd) for p in ps]
    js = jo.init(jp)
    update = jax.jit(jo.update)
    out = []
    for step, g in enumerate(gs):
        tp = [torch.tensor(np.asarray(p, np.float32)).to(td) for p in jp]
        ts = [{k: torch.tensor(np.asarray(v)) for k, v in s.items()}
              for s in js]
        jn, js_new = update([jnp.asarray(x, jd) for x in g], js, jp,
                            jnp.int32(step))
        tn, ts_new = to.update([torch.tensor(x).to(td) for x in g], ts, tp,
                               step)
        assert all(b.dtype == td for b in tn)
        f64 = lambda x: np.asarray(to_np(x.float() if torch.is_tensor(x)
                                         else x), np.float64)
        out.append(([(f64(a0), f64(a), f64(b), shape) for a0, a, b, shape
                     in zip(jp, jn, tn, AF_SHAPES)], js_new, ts_new))
        jp, js = jn, js_new
    return out


def factored(shape):
    return len(shape) >= 2 and min(shape[-2:]) >= 128


@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0])
def test_adafactor_bfloat16_direction(max_grad_norm):
    """``update_dtype=bfloat16`` on float32 params: each step's update
    within BF16_DIRECTION of the reference's (plus p's float32 rounding),
    the factored statistics at float32's tolerance."""
    for leaves, js, ts in bf16_steps(torch.bfloat16, "float32", 1,
                                     max_grad_norm=max_grad_norm):
        for a0, a, b, shape in leaves:
            tol = (BF16_DIRECTION * np.abs(a0 - a)
                   + 2 * F32_EPS * np.abs(a0) + 1e-30)
            assert (np.abs(b - a) <= tol).all(), shape
        rtol = clip_rtol(inputs(AF_SHAPES, seed=1, heavy_layer=True)[1],
                         max_grad_norm)
        for s_ref, s in zip(js, ts):
            for k in s:
                assert_rel(s_ref[k], s[k], k, rtol)


def bit_equal_fractions(update_dtype, param_dtype, seed, max_grad_norm):
    """Per step and factored leaf, the share of new params bit-equal to
    the reference's, with the update clipping lifted (see below)."""
    return [float(np.mean(a == b))
            for leaves, _, _ in bf16_steps(update_dtype, param_dtype, seed,
                                           max_grad_norm=max_grad_norm,
                                           clip_threshold=1e30)
            for _, a, b, shape in leaves if factored(shape)]


@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 2])
def test_adafactor_bfloat16_direction_bit_equal(seed, param_dtype,
                                                max_grad_norm):
    """The two-broadcast bfloat16 direction itself: at least 99% of each
    step's factored update is bit-equal to the reference's (read: 99.8% to
    100% over six seeds).  The update clipping is lifted here: its scale is
    one float32 number per layer slice rounded to bfloat16, and where the
    two packages' RMS differ in the last bit it can round to neighbouring
    values and move a whole slice by one ulp of the scale (read once in
    six seeds: a layer of the (6, 256, 192) stack), which BF16_DIRECTION
    bounds above.  Left are the per-row and per-column factors, whose
    rounding flips touch a row or a column each."""
    fr = bit_equal_fractions(torch.bfloat16, param_dtype, seed,
                             max_grad_norm)
    assert min(fr) >= 0.99, fr


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adafactor_float32_direction_is_not_bit_equal(param_dtype):
    """The control of the test above: a port that took its direction in
    float32 instead fails it (read: 0.01% to 0.07% bit-equal on float32
    params, 84% to 87% on bfloat16 params, where p's rounding hides most
    of the difference)."""
    fr = bit_equal_fractions(torch.float32, param_dtype, 0, 0.0)
    assert min(fr) < 0.99, fr


def test_adafactor_bfloat16_params():
    """bfloat16 params (the full configs): the new params come back in
    bfloat16, their update within BF16_DIRECTION of the reference's after
    each step from the same state, and p - update rounded to bfloat16 once
    more (one ulp, 2^-7 of p)."""
    for leaves, _, _ in bf16_steps(torch.bfloat16, "bfloat16", 2,
                                   max_grad_norm=1.0):
        for p0, a, b, shape in leaves:
            tol = (BF16_DIRECTION * np.abs(p0 - a) + 2.0 ** -7 * np.abs(a)
                   + 1e-30)
            assert (np.abs(a - b) <= tol).all(), shape


# ---------------------------------------------------------------------------
# make_optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_make_optimizer(name):
    ps, gs = inputs(AF_SHAPES[:3])
    jp, js, tp, ts = run_both(J.make_optimizer(name, 1e-3, max_grad_norm=1.0),
                              T.make_optimizer(name, 1e-3, max_grad_norm=1.0),
                              ps, gs)
    for a, b in zip(jp, tp):
        assert_rel(a, b, name)


def test_unknown_optimizer_raises():
    for make in (J.make_optimizer, T.make_optimizer):
        with pytest.raises(ValueError, match="unknown optimizer 'sgd'"):
            make("sgd", 1e-3)
