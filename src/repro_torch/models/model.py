"""The language model, decoder-only or encoder-decoder: init,
``forward_train``, ``lm_loss``, and serving: ``init_cache``, ``prefill``,
``decode_step``.

Port of ``repro.models.model`` for ``attention_kind`` ``"gqa"`` (the dense
configs and the mixture of experts), ``"none"`` (RWKV-6), ``"hybrid"``
(Hymba: attention and Mamba side by side, ``models/hybrid.py``, in
``hyb``) and ``"mla"`` (DeepSeek-V3's latent attention, ``models/mla.py``,
in ``mla``; it takes no kernel backend, as in the reference).  Parameters
are a plain dict shaped like the reference's tree: ``{"embed", "blocks",
"final_norm", "lm_head"}`` with every leaf of ``blocks`` stacked on a
leading layer axis; the reference's ``lax.scan`` over layers is a Python
loop over that axis.  A MoE config's blocks hold ``moe``
(``models/moe.py``) in place of ``ffn``; with ``first_dense_layers`` its
first layers are a stack of their own, ``blocks_dense``, run before
``blocks`` (the reference's two scans).  Each block returns the router's
aux loss beside its output (0 for a dense FFN), and ``forward_train``
returns their sum over both stacks.  A config with ``mtp`` (DeepSeek's
multi-token prediction) holds ``params["mtp"] = {"block", "norm"}``, one
unstacked dense block whose loss on the token two ahead joins the aux
(0.3 of its mean) in ``forward_train``.

Under a mesh (``act_sharding.activation_mesh``, set by the step builders)
the model computes what the reference's mesh path computes, on one
controller: the embedding lookup is a one-hot matmul (its gradient a
matmul, not a scatter-add), a decode's cache write is the masked write and
its attention the mesh chain (``models/attention.py``), a MoE layer with
``impl="shard_map"`` runs the expert-parallel dispatch
(``models/moe_shard_map.py``), and the reference's activation constraints
are ``act_sharding.constrain`` calls, which return their input and record
its spec.  Without a mesh none of this runs.

The remat policy follows the reference's: with ``cfg.remat == "full"``
each block runs under ``torch.utils.checkpoint`` (non-reentrant) when grad
is enabled, as ``jax.checkpoint`` wraps the reference's scan body, so a
backward keeps one hidden state per layer and recomputes the block's
activations; ``""`` and ``"dots"`` leave the block as it is (the reference
tests only ``"full"``).  Under ``torch.no_grad`` it changes nothing.  The
MTP block runs under checkpointing whenever grad is enabled, whatever
``remat`` says, as the reference wraps it in ``jax.checkpoint``.

``backend="pallas"`` runs each layer's sequence mixer through a
hand-written kernel: flash attention (``kernels/flash_attention``) for
``"gqa"`` and for a hybrid block's attention branch (its Mamba branch is
plain PyTorch, as in the reference), WKV6 (``kernels/rwkv6``) for
``"none"``; one launch per layer on CUDA tensors.  ``"reference"`` runs
the plain PyTorch mixers.

Serving follows the reference: ``prefill`` runs the reference mixers and
returns the next-token logits with a cache in the compute dtype (also for
a config whose ``kv_cache_dtype`` is float8: that dtype is ``init_cache``'s
only, a quirk of the reference kept here); ``decode_step`` runs one token
through every layer against the cache, which it updates in place, layer
slice by layer slice, with no host synchronisation.  An RWKV cache is the
per-layer WKV state (float32) and the two token-shift states; a hybrid
cache is K and V beside the Mamba conv state (compute dtype) and SSM state
(float32); an MLA cache is the compressed latent ``c_kv`` and the rope
key ``k_rope``, which decode reads in the absorbed form.  Neither
``prefill`` nor ``decode_step`` runs the MTP head, as in the reference.
The cache keeps one leading axis of ``num_layers`` whatever the stacks:
each stack works on its slice of that axis, in place.

The encoder-decoder (``encoder_layers > 0``, seamless-m4t) and the
modality frontends are ported.  An audio config's frame embeddings
(``frontend_embeds``, (B, T, frontend_dim)) go through the learned
projector (``models/frontend.py``), gain sinusoidal positions and run
through ``params["encoder"]``: a stack of non-causal blocks (dense
attention over the reference mixer, whatever ``backend``, as the
reference's encoder scan takes its default backend) and a final norm.
Every decoder block holds ``ln_c`` and ``cross`` and attends the
encoder's output after its self-attention; its cache keeps the cross K
and V, ``xk`` / ``xv`` (L, B, T_enc, Hkv, dh), which ``prefill`` fills
from the prompt's frames (``init_cache`` sizes T_enc from its length
instead, a quirk of the reference kept here) and each decode step reads.
A config with ``rope_kind == "none"`` adds sinusoidal positions to the
token embeddings, a decode's at its device position.  A vision config's
projected patch embeddings replace the first P token embeddings of the
prompt; M-RoPE (``rope_kind == "mrope"``) runs on (t, h, w) positions
that repeat the text position three times, as the reference's do (so it
turns every vector as RoPE does).  ``check_supported`` refuses an
encoder-decoder without the audio frontend or over another mixer than
GQA attention, which the reference cannot run or serve.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import act_sharding
from repro_torch.models import attention as attn_mod
from repro_torch.models import frontend as fe_mod
from repro_torch.models import hybrid as hyb_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ShapesOnly, apply_mlp, apply_norm,
                                       dtype_of, embed_init, init_mlp,
                                       init_norm, sinusoidal_at,
                                       sinusoidal_positions, to_cache_dtype)
from repro_torch.models.sharding import cache_leaf_spec

Params = Dict[str, Any]

ATTENTION_KINDS = ("gqa", "none", "hybrid", "mla")
ROPE_KINDS = ("rope", "mrope", "none")
FRONTENDS = ("", "audio", "vision")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config that needs a part of the
    reference's model that is not ported."""
    missing = []
    if cfg.attention_kind not in ATTENTION_KINDS:
        missing.append(f"attention_kind {cfg.attention_kind!r}")
    if cfg.attention_kind != "none" and cfg.rope_kind not in ROPE_KINDS:
        missing.append(f"rope_kind {cfg.rope_kind!r}")
    if cfg.frontend not in FRONTENDS:
        missing.append(f"frontend {cfg.frontend!r}")
    if cfg.is_encdec and cfg.frontend != "audio":
        # the reference's encoder reads the frontend's frame embeddings
        missing.append("an encoder-decoder without the audio frontend")
    if cfg.is_encdec and cfg.attention_kind != "gqa":
        # the reference's prefill fills the cross cache in its GQA branch
        missing.append(f"an encoder-decoder over attention_kind "
                       f"{cfg.attention_kind!r}")
    if cfg.attention_kind == "none" and (cfg.ssm is None
                                         or cfg.ssm.kind != "rwkv6"):
        missing.append("an ssm other than rwkv6")
    if cfg.attention_kind == "hybrid" and (cfg.ssm is None
                                           or cfg.ssm.kind != "mamba"):
        missing.append("a hybrid ssm other than mamba")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported: "
                                  f"{', '.join(missing)}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_blocks(cfg: ModelConfig, gen: torch.Generator, lead, *,
                 is_moe: bool = False, cross: bool = False) -> Params:
    """The blocks of a stack of ``lead`` layers (``(n,)``), or one unstacked
    block (``()``: the MTP head's); with ``cross`` each also holds the
    encoder-decoder's cross attention (``ln_c``, ``cross``)."""
    lead = tuple(lead)
    p: Params = {"ln1": init_norm(cfg, lead + (cfg.d_model,), gen.device),
                 "ln2": init_norm(cfg, lead + (cfg.d_model,), gen.device)}
    if cfg.attention_kind == "none":
        p["tmix"] = ssm_mod.init_rwkv_tmix(cfg, gen, lead)
        p["cmix"] = ssm_mod.init_rwkv_cmix(cfg, gen, lead)
        return p
    if cfg.attention_kind == "hybrid":
        p["hyb"] = hyb_mod.init_hybrid(cfg, gen, lead)
    elif cfg.attention_kind == "mla":
        p["mla"] = mla_mod.init_mla(cfg, gen, lead)
    else:
        p["attn"] = attn_mod.init_attention(cfg, gen, lead)
    if is_moe:
        p["moe"] = moe_mod.init_moe(cfg, gen, lead)
    else:
        p["ffn"] = init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, lead)
    if cross:
        p["ln_c"] = init_norm(cfg, lead + (cfg.d_model,), gen.device)
        p["cross"] = attn_mod.init_attention(cfg, gen, lead)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters with the reference's distributions, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``.  On the
    ``"meta"`` device: the shapes and dtypes only, no memory and no draws
    (``launch.steps.abstract_params``)."""
    check_supported(cfg)
    if str(device) == "meta":
        device, gen = torch.device("meta"), ShapesOnly()
    else:
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
    dt = dtype_of(cfg.param_dtype)
    p: Params = {"embed": embed_init(gen, (cfg.vocab_padded, cfg.d_model),
                                     dt)}
    nd = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    if nd:
        p["blocks_dense"] = _init_blocks(cfg, gen, (nd,))
    p["blocks"] = _init_blocks(cfg, gen, (cfg.num_layers - nd,),
                               is_moe=cfg.moe is not None,
                               cross=cfg.is_encdec)
    if cfg.is_encdec:
        p["encoder"] = {
            "blocks": _init_blocks(cfg, gen, (cfg.encoder_layers,)),
            "final_norm": init_norm(cfg, (cfg.d_model,), device)}
    p["final_norm"] = init_norm(cfg, (cfg.d_model,), device)
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_padded), dt)
    if cfg.frontend:
        p["frontend"] = fe_mod.init_frontend(cfg, gen)
    if cfg.mtp:
        p["mtp"] = {"block": _init_blocks(cfg, gen, ()),
                    "norm": init_norm(cfg, (cfg.d_model,), device)}
    return p


def layer(blocks: Params, i: int) -> Params:
    """Layer ``i`` of a stacked block tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def block_stacks(params: Params):
    """The decoder's stacks of blocks in layer order: a MoE config's dense
    prefix ``blocks_dense`` where it has one, then ``blocks`` (an
    encoder-decoder's encoder is ``params["encoder"]``)."""
    return [params[k] for k in ("blocks_dense", "blocks") if k in params]


def stack_depth(blocks: Params) -> int:
    return blocks["ln1"]["scale"].shape[0]


def all_layers(params: Params):
    """Every layer's parameters in order, over both stacks."""
    for blocks in block_stacks(params):
        for i in range(stack_depth(blocks)):
            yield layer(blocks, i)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _mixer(cfg: ModelConfig, bp, h, positions, *, causal=True,
           backend="reference"):
    """The sequence mixer of one block on its normed input: the
    self-attention (causal, or unmasked in the encoder), a hybrid block's
    attention and Mamba, or MLA (which takes no backend)."""
    hn = apply_norm(cfg, bp["ln1"], h)
    if "mla" in bp:
        return mla_mod.apply_mla(cfg, bp["mla"], hn, positions)
    if "hyb" in bp:
        return hyb_mod.apply_hybrid(cfg, bp["hyb"], hn, positions,
                                    backend=backend)
    return attn_mod.apply_attention(cfg, bp["attn"], hn, positions,
                                    causal=causal, backend=backend)


def _ffn(cfg: ModelConfig, bp, h):
    """The feed-forward sublayer on its normed input -> (out, aux loss):
    the experts and the router's aux where the block has ``moe``, else the
    dense MLP and 0."""
    hn = apply_norm(cfg, bp["ln2"], h)
    if "moe" in bp:
        return moe_mod.apply_moe(cfg, bp["moe"], hn)
    return apply_mlp(cfg, bp["ffn"], hn), _no_aux(h)


def _no_aux(h):
    return torch.zeros((), dtype=torch.float32, device=h.device)


def _rwkv_block(cfg: ModelConfig, h, bp, xprev_t, state, xprev_c, *,
                backend="reference"):
    """One RWKV block, time mix then channel mix, from the given token-shift
    states and WKV state -> (h, new xprev_t, new state, new xprev_c)."""
    hn = apply_norm(cfg, bp["ln1"], h)
    mix, xprev_t, state = ssm_mod.apply_rwkv_tmix(
        cfg, bp["tmix"], hn, xprev_t, state, backend=backend)
    h = h + mix
    hn = apply_norm(cfg, bp["ln2"], h)
    cm, xprev_c = ssm_mod.apply_rwkv_cmix(cfg, bp["cmix"], hn, xprev_c)
    return h + cm, xprev_t, state, xprev_c


def _rwkv_zero_states(cfg: ModelConfig, h):
    """A sequence's starting (x_prev, WKV state): zeros."""
    B, _, D = h.shape
    N = cfg.ssm.head_dim
    return h.new_zeros((B, D)), torch.zeros(
        (B, cfg.num_heads, N, N), dtype=torch.float32, device=h.device)


def _block_body(cfg: ModelConfig, h, bp, *, positions, causal=True,
                enc_out=None, backend="reference"):
    """One residual block -> (h, the block's aux loss).  A decoder block of
    an encoder-decoder attends ``enc_out`` after its mixer."""
    if cfg.attention_kind == "none":
        # rwkv: time mix + channel mix, zero shift states per sequence
        x0, state0 = _rwkv_zero_states(cfg, h)
        h = _rwkv_block(cfg, h, bp, x0, state0, x0, backend=backend)[0]
        # channel sharding: the WKV recurrence is sequential over the
        # sequence
        return (act_sharding.constrain(h, act_sharding.dp(), None, "model"),
                _no_aux(h))
    h = h + _mixer(cfg, bp, h, positions, causal=causal, backend=backend)
    if enc_out is not None and "cross" in bp:
        hc = apply_norm(cfg, bp["ln_c"], h)
        h = h + attn_mod.apply_cross_attention(cfg, bp["cross"], hc, enc_out)
    f, aux = _ffn(cfg, bp, h)
    # the sequence-parallel residual stream: batch over dp, sequence over
    # "model"
    return act_sharding.constrain(h + f, act_sharding.dp(), "model",
                                  None), aux


def _scan_blocks(cfg: ModelConfig, blocks, h, *, positions, causal=True,
                 enc_out=None, backend="reference"):
    """The layers of one stack in order (the reference's scan over the
    stacked axis), each under activation checkpointing for ``remat ==
    "full"`` -> (h, the sum of the blocks' aux losses)."""
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    aux = _no_aux(h)
    for i in range(stack_depth(blocks)):
        bp = layer(blocks, i)
        if remat:
            h, a = checkpoint(_block_body, cfg, h, bp, positions=positions,
                              causal=causal, enc_out=enc_out,
                              backend=backend, use_reentrant=False)
        else:
            h, a = _block_body(cfg, h, bp, positions=positions,
                               causal=causal, enc_out=enc_out,
                               backend=backend)
        aux = aux + a
    return h, aux


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def _lookup(cfg: ModelConfig, params, tokens):
    """The embedding rows of ``tokens`` in the compute dtype.  Under a mesh,
    the reference's one-hot matmul (the vocab axis on "model"): the same
    rows, and a backward that is a matmul (one-hot^T @ dh) where the
    gather's is a scatter-add.  The one-hot is (B, S, V) in the compute
    dtype, built by a scatter (no int64 one-hot)."""
    cd = dtype_of(cfg.compute_dtype)
    if act_sharding.current_mesh() is None:
        return params["embed"][tokens].to(cd)
    oh = torch.zeros(tuple(tokens.shape) + (cfg.vocab_padded,), dtype=cd,
                     device=tokens.device)
    oh.scatter_(-1, tokens.long()[..., None], 1.0)
    oh = act_sharding.constrain(oh, act_sharding.dp(), None, "model")
    return oh @ params["embed"].to(cd)


def _embed(cfg: ModelConfig, params, tokens, frontend_embeds=None,
           pos_offset=0):
    """The decoder's input: the embedding rows of ``tokens``; a vision
    prompt's projected patches in place of its first P rows; for
    ``rope_kind == "none"`` plus the sinusoidal rows of positions
    ``pos_offset + arange(S)`` (``pos_offset`` an int, or a decode's 0-d
    device tensor)."""
    cd = dtype_of(cfg.compute_dtype)
    h = _lookup(cfg, params, tokens)
    if cfg.frontend == "vision" and frontend_embeds is not None:
        proj = fe_mod.project(cfg, params["frontend"], frontend_embeds)
        h = torch.cat([proj.to(cd), h[:, proj.shape[1]:]], dim=1)
    if cfg.rope_kind == "none" and cfg.attention_kind != "none":
        pos = pos_offset + torch.arange(h.shape[1], device=h.device)
        h = h + sinusoidal_at(pos, cfg.d_model).to(cd)[None]
    if cfg.attention_kind == "none":            # rwkv: channel sharding
        return act_sharding.constrain(h, act_sharding.dp(), None, "model")
    return act_sharding.constrain(h, act_sharding.dp(), "model", None)


def _positions(cfg: ModelConfig, tokens):
    """(B, S) int32 positions 0..S-1; M-RoPE's (B, S, 3) repeat them as
    the (t, h, w) components, as the reference's text positions do."""
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32,
                       device=tokens.device)[None].expand(B, S)
    if cfg.rope_kind == "mrope":
        pos = pos[..., None].expand(B, S, 3)
    return pos


def _unembed(cfg: ModelConfig, params, h):
    cd = dtype_of(cfg.compute_dtype)
    # leave sequence parallelism before the vocab-parallel contraction
    h = act_sharding.constrain(h, act_sharding.dp(), None, None)
    h = apply_norm(cfg, params["final_norm"], h)
    head = (params["embed"].to(cd).T if cfg.tie_embeddings
            else params["lm_head"].to(cd))
    return (h.to(cd) @ head).float()


def _run_encoder(cfg: ModelConfig, params, frontend_embeds):
    """The audio encoder over the frame embeddings (B, T, frontend_dim) ->
    (B, T, D): the projector, sinusoidal positions, the non-causal blocks
    on the reference mixer (the reference's encoder scan takes its default
    backend, so the flash kernel never runs here), the final norm."""
    cd = dtype_of(cfg.compute_dtype)
    h = fe_mod.project(cfg, params["frontend"], frontend_embeds).to(cd)
    B, T, _ = h.shape
    h = h + sinusoidal_positions(T, cfg.d_model, h.device).to(cd)[None]
    pos = torch.arange(T, dtype=torch.int32, device=h.device)[None].expand(
        B, T)
    h, _ = _scan_blocks(cfg, params["encoder"]["blocks"], h, positions=pos,
                        causal=False)
    return apply_norm(cfg, params["encoder"]["final_norm"], h)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward_train(cfg: ModelConfig, params: Params, tokens,
                  frontend_embeds=None, *, backend: Optional[str] = None):
    """tokens (B, S) int[, frontend_embeds (B, T, frontend_dim): an audio
    config's frames, a vision config's patches] -> (logits (B, S, V)
    float32, aux loss: the routers' over every MoE layer, 0.0 without one,
    plus the MTP head's loss where the config has one)."""
    check_supported(cfg)
    backend = attn_mod.resolve_backend(backend)
    enc_out = (_run_encoder(cfg, params, frontend_embeds) if cfg.is_encdec
               else None)
    h = _embed(cfg, params, tokens, frontend_embeds)
    pos = _positions(cfg, tokens)
    aux = _no_aux(h)
    for blocks in block_stacks(params):
        h, a = _scan_blocks(cfg, blocks, h, positions=pos, enc_out=enc_out,
                            backend=backend)
        aux = aux + a
    logits = _unembed(cfg, params, h)
    if cfg.mtp:
        aux = aux + _mtp_loss(cfg, params, h, tokens)
    return logits, aux


def _mtp_loss(cfg: ModelConfig, params, h, tokens):
    """DeepSeek's multi-token prediction: one extra dense block predicts
    token t + 2 from the blocks' output ``h`` at t (before the final norm)
    and the embedding of token t + 1 -> 0.3 times its mean cross entropy
    over the first S - 2 positions.  The shifts wrap around, as
    ``jnp.roll`` does; the block runs the reference mixer, checkpointed
    whenever grad is enabled (the reference's ``jax.checkpoint``)."""
    emb_next = _lookup(cfg, params, torch.roll(tokens, -1, dims=1))
    hm = apply_norm(cfg, params["mtp"]["norm"], h) + emb_next
    pos = _positions(cfg, tokens)
    bp = params["mtp"]["block"]
    if torch.is_grad_enabled():
        hm, _ = checkpoint(_block_body, cfg, hm, bp, positions=pos,
                           use_reentrant=False)
    else:
        hm, _ = _block_body(cfg, hm, bp, positions=pos)
    logits = _unembed(cfg, params, hm)                    # predicts t + 2
    nll = _token_nll(cfg, logits, torch.roll(tokens, -2, dims=1))
    return 0.3 * nll[:, :-2].mean()


def _token_nll(cfg: ModelConfig, logits, labels):
    """Cross entropy per token, logsumexp minus the label's logit (the
    reference's one-hot contraction picks the same value; its one-hot,
    shaped as the logits, carries the vocab-parallel constraint, recorded
    here on the logits)."""
    logits = act_sharding.constrain(logits, act_sharding.dp(), None, "model")
    lse = torch.logsumexp(logits.float(), dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0].float()
    return lse - gold


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            backend: Optional[str] = None):
    """batch: {"tokens": (B, S) int, "labels": (B, S) int[, "mask"][,
    "frontend_embeds"]} -> (loss + aux, {"loss", "aux"})."""
    logits, aux = forward_train(cfg, params, batch["tokens"],
                                batch.get("frontend_embeds"),
                                backend=backend)
    nll = _token_nll(cfg, logits, batch["labels"])
    mask = batch.get("mask")
    if mask is not None:
        nll = nll * mask
        loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss + aux, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: Optional[torch.dtype] = None, device="cuda") -> Params:
    """A zeroed decode cache for ``batch`` sequences of ``seq_len``
    positions, every leaf stacked on a leading layer axis.  ``dtype``
    defaults to ``kv_cache_dtype``, else the compute dtype; RWKV's WKV
    state and Mamba's SSM state are float32 whatever it is.  An
    encoder-decoder's cache also holds the cross K and V, ``xk`` / ``xv``
    (L, batch, T_enc, Hkv, dh), T_enc the frames a prompt of ``seq_len``
    tokens carries."""
    check_supported(cfg)
    device = (torch.device("meta") if str(device) == "meta"
              else resolve_device(device))
    dt = dtype or dtype_of(cfg.kv_cache_dtype or cfg.compute_dtype)
    c = _self_cache(cfg, batch, seq_len, dt, device)
    if cfg.is_encdec:
        c.update(_cross_cache(cfg, batch, fe_mod.num_frontend_tokens(
            cfg, seq_len), dt, device))
    return c


def _cross_cache(cfg: ModelConfig, batch: int, t_enc: int, dt, device):
    """Zeroed cross K and V, (L, batch, t_enc, Hkv, dh)."""
    shape = (cfg.num_layers, batch, t_enc, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"xk": torch.zeros(shape, dtype=dt, device=device),
            "xv": torch.zeros(shape, dtype=dt, device=device)}


def _self_cache(cfg: ModelConfig, batch: int, seq_len: int, dt,
                device) -> Params:
    """The zeroed cache of the decoder's own mixers, in ``dt`` (float32
    states aside)."""
    L = cfg.num_layers
    if cfg.attention_kind == "none":
        N = cfg.ssm.head_dim
        shift = (L, batch, cfg.d_model)
        return {"state": torch.zeros((L, batch, cfg.num_heads, N, N),
                                     dtype=torch.float32, device=device),
                "xprev_t": torch.zeros(shift, dtype=dt, device=device),
                "xprev_c": torch.zeros(shift, dtype=dt, device=device)}
    if cfg.attention_kind == "mla":
        return mla_mod.init_mla_cache(cfg, batch, seq_len, L, dt, device)
    c = attn_mod.init_kv_cache(cfg, batch, seq_len, L, dt, device)
    if cfg.attention_kind == "hybrid":
        # the Mamba leaves: conv (L, B, W - 1, di) in dt, ssm float32
        di = cfg.num_heads * cfg.resolved_head_dim
        c["conv"] = torch.zeros((L, batch, cfg.ssm.conv_width - 1, di),
                                dtype=dt, device=device)
        c["ssm"] = torch.zeros((L, batch, di, cfg.ssm.state_size),
                               dtype=torch.float32, device=device)
    return c


def _pos_tensor(pos, device) -> torch.Tensor:
    """A decode position, a Python int or a 0-d integer tensor, as a 0-d
    int64 tensor on ``device``."""
    if torch.is_tensor(pos):
        return pos.to(device=device, dtype=torch.int64).reshape(())
    return torch.tensor(pos, dtype=torch.int64, device=device)


def _decode_block(cfg: ModelConfig, h, bp, cache_slices, pos):
    """One block of single-token decode on this layer's cache slices;
    returns (h, new slices).  A KV slice comes back as the same tensor,
    written in place; RWKV's and Mamba's states come back new."""
    new = dict(cache_slices)
    if cfg.attention_kind == "none":
        h, new["xprev_t"], new["state"], new["xprev_c"] = _rwkv_block(
            cfg, h, bp, cache_slices["xprev_t"], cache_slices["state"],
            cache_slices["xprev_c"])
        return h, new
    hn = apply_norm(cfg, bp["ln1"], h)
    if "mla" in bp:
        mix, new["c_kv"], new["k_rope"] = mla_mod.decode_mla(
            cfg, bp["mla"], hn, cache_slices["c_kv"], cache_slices["k_rope"],
            pos)
    elif "hyb" in bp:
        mix, new["k"], new["v"], new["conv"], new["ssm"] = \
            hyb_mod.decode_hybrid(cfg, bp["hyb"], hn, cache_slices["k"],
                                  cache_slices["v"], cache_slices["conv"],
                                  cache_slices["ssm"], pos)
    else:
        mix, new["k"], new["v"] = attn_mod.decode_attention(
            cfg, bp["attn"], hn, cache_slices["k"], cache_slices["v"], pos)
    h = h + mix
    if "cross" in bp:
        hc = apply_norm(cfg, bp["ln_c"], h)
        h = h + attn_mod.cross_attend(cfg, bp["cross"], hc,
                                      cache_slices["xk"], cache_slices["xv"])
    return h + _ffn(cfg, bp, h)[0], new


def _pin_cache(cache) -> None:
    """Under a mesh, each stacked cache leaf constrained to its
    ``cache_leaf_spec``, as the reference pins its loop-carried cache."""
    mesh = act_sharding.current_mesh()
    if mesh is not None:
        for k, v in cache.items():
            act_sharding.constrain_to(v, cache_leaf_spec(mesh, k, v.shape))


def _scan_decode(cfg: ModelConfig, blocks, h, cache, pos):
    """The layers of one stack in order for one token; each layer's slice
    of the stacked cache (the stack's own layers) is updated in place (one
    buffer, as the reference's loop-carried cache), pinned to its spec
    before the loop and after each layer under a mesh."""
    _pin_cache(cache)
    for i in range(stack_depth(blocks)):
        slices = {k: v[i] for k, v in cache.items()}
        h, new = _decode_block(cfg, h, layer(blocks, i), slices, pos)
        for k, t in new.items():
            if t is not slices[k]:
                slices[k].copy_(to_cache_dtype(t, slices[k].dtype))
        _pin_cache(cache)
    return h


def decode_step(cfg: ModelConfig, params: Params, cache: Params, token,
                pos):
    """token (B, 1) int; pos a Python int or a 0-d integer tensor ->
    (logits (B, V) float32, cache).  The cache returned is the one given,
    updated in place (the reference donates its buffer): a caller that
    needs the old cache clones it first.  A ``pos`` past the cache's end
    overwrites its last slot, as the reference's clamped update does.  An
    encoder-decoder's token attends the cross K and V its cache holds."""
    check_supported(cfg)
    pos = _pos_tensor(pos, token.device)
    h = _embed(cfg, params, token, pos_offset=pos)
    first = 0
    for blocks in block_stacks(params):
        n = stack_depth(blocks)
        # the stack's layers of the cache: views, written in place
        h = _scan_decode(cfg, blocks, h, {k: v[first:first + n]
                                          for k, v in cache.items()}, pos)
        first += n
    return _unembed(cfg, params, h)[:, 0], cache


# ---------------------------------------------------------------------------
# prefill: the forward pass that also fills the decode cache
# ---------------------------------------------------------------------------

def _pad_cache(out, x) -> None:
    """Write one layer's K, V, latent or rope key ``x`` (B, S, ...) into
    its zeroed cache slice ``out`` (B, cache_len, ...): cut past
    ``cache_len``, zeros after S (the reference's pad or truncation, in
    place)."""
    n = min(x.shape[1], out.shape[1])
    out[:, :n] = x[:, :n]


def prefill(cfg: ModelConfig, params: Params, tokens, cache_len: int = 0,
            frontend_embeds=None):
    """tokens (B, S) int[, frontend_embeds as ``forward_train`` takes them]
    -> (next-token logits (B, V) float32, the cache filled for positions
    [0, S)).  The KV (or MLA) cache holds ``cache_len`` positions (default
    S) in the compute dtype; RWKV's cache, and a hybrid cache's Mamba
    leaves, are the states after the last token, whatever ``cache_len``;
    an encoder-decoder's cross K and V cover the prompt's frames, however
    many.  Runs the reference mixers, as the reference's prefill does."""
    check_supported(cfg)
    B, S = tokens.shape
    cache_len = cache_len or S
    if cfg.attention_kind == "none":
        h, cache = _rwkv_prefill_cache(cfg, params, tokens)
        return _unembed(cfg, params, h[:, -1:, :])[:, 0], cache
    enc_out = (_run_encoder(cfg, params, frontend_embeds) if cfg.is_encdec
               else None)
    h = _embed(cfg, params, tokens, frontend_embeds)
    pos = _positions(cfg, tokens)
    cd = dtype_of(cfg.compute_dtype)
    cache = _self_cache(cfg, B, cache_len, cd, h.device)
    if enc_out is not None:
        cache.update(_cross_cache(cfg, B, enc_out.shape[1], cd, h.device))
    # the leaves each layer's mixer returns, padded to cache_len
    padded = ("c_kv", "k_rope") if cfg.attention_kind == "mla" else ("k",
                                                                      "v")
    for i, bp in enumerate(all_layers(params)):
        hn = apply_norm(cfg, bp["ln1"], h)
        hyb = bp.get("hyb")
        if "mla" in bp:
            # c_kv after its norm, the rope key after RoPE: the same
            # projection as the mixer's output
            a, *kv = mla_mod.apply_mla(cfg, bp["mla"], hn, pos,
                                       return_cache=True)
        else:
            a, *kv = attn_mod.apply_attention(
                cfg, bp["attn"] if hyb is None else hyb["attn"], hn, pos,
                return_kv=True)
        if hyb is not None:
            m, cache["conv"][i], cache["ssm"][i] = ssm_mod.apply_mamba(
                cfg, hyb["mamba"], hn)
            a = hyb_mod.merge(hyb, a, m)
        h = h + a
        if enc_out is not None:
            xk, xv = attn_mod.cross_kv(cfg, bp["cross"], enc_out)
            hc = apply_norm(cfg, bp["ln_c"], h)
            h = h + attn_mod.cross_attend(cfg, bp["cross"], hc, xk, xv)
            cache["xk"][i], cache["xv"][i] = xk, xv
        h = h + _ffn(cfg, bp, h)[0]
        for name, x in zip(padded, kv):
            _pad_cache(cache[name][i], x)
    # only the next-token logits: the whole (B, S, V) is dead weight
    return _unembed(cfg, params, h[:, -1:, :])[:, 0], cache


def _rwkv_prefill_cache(cfg: ModelConfig, params, tokens):
    """One recurrent pass from zero states -> (h, each layer's states
    after the last token)."""
    blocks = params["blocks"]
    h = _embed(cfg, params, tokens)
    B = tokens.shape[0]
    L = stack_depth(blocks)
    N = cfg.ssm.head_dim
    cd = dtype_of(cfg.compute_dtype)
    cache = {"state": torch.empty((L, B, cfg.num_heads, N, N),
                                  dtype=torch.float32, device=h.device),
             "xprev_t": torch.empty((L, B, cfg.d_model), dtype=cd,
                                    device=h.device),
             "xprev_c": torch.empty((L, B, cfg.d_model), dtype=cd,
                                    device=h.device)}
    for i in range(L):
        x0, state0 = _rwkv_zero_states(cfg, h)
        h, cache["xprev_t"][i], cache["state"][i], cache["xprev_c"][i] = \
            _rwkv_block(cfg, h, layer(blocks, i), x0, state0, x0)
        h = act_sharding.constrain(h, act_sharding.dp(), None, "model")
    return h, cache
