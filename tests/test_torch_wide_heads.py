"""The language models at the kernels' wide heads, on the CPU: a reduced
phi4-mini at attention head dim 256 and a reduced rwkv6 at WKV6 head size
256, through ``forward_train`` and ``lm_loss`` with both backends, against
the reference's (its Pallas kernels in interpret mode), the parameters
carried over by ``convert.model_params_from_jax``.  On the card the same
entry points launch the flash kernel's dh-256 instantiation and WKV6's
cluster passes (``chip_smoke.py`` phase 4, tests/test_torch_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.rwkv6 import ops as twkv
from repro_torch.models import model as tmodel
from tests._torch_parity import assert_close


def _wide(cfg, name):
    """The reduced config (d_model 256, 2 layers) at a head of 256:
    phi4-mini with 2 query heads over 1 KV head of 256, rwkv6 with one
    WKV6 head of 256 (H x N = d_model)."""
    if name == "phi4-mini-3.8b":
        return dataclasses.replace(cfg, head_dim=256, num_heads=2,
                                   num_kv_heads=1)
    return dataclasses.replace(cfg, head_dim=256, num_heads=1,
                               num_kv_heads=1,
                               ssm=dataclasses.replace(cfg.ssm,
                                                       head_dim=256))


@pytest.fixture(scope="module", params=["phi4-mini-3.8b", "rwkv6-3b"])
def wide_case(request):
    name = request.param
    cfg_j = _wide(jbase.get_config(name).reduced(), name)
    cfg_t = _wide(tbase.get_config(name).reduced(), name)
    params = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.integers(0, cfg_j.vocab_size, (2, 64)).astype(np.int32)
    tree = jax.tree.map(np.asarray, params)
    return (cfg_j, cfg_t, params,
            convert.model_params_from_jax(cfg_t, tree, device="cpu"),
            toks, labels)


# as tests/test_torch_lm.py: the reduced models' logits are O(1); 2 layers
# of float32 matmuls, norms and softmax / recurrence, another summation
# order -> 2e-5 on the logits, 1e-5 on the loss (a mean of ~6)
LOGIT_ATOL, LOSS_ATOL = 2e-5, 1e-5


def test_wide_configs_reach_the_wide_kernel_shapes(wide_case):
    """The kernels on the card would run these heads at 256: flash's dh-256
    instantiation, WKV6's cluster passes (4 blocks of 64 rows)."""
    _, cfg_t, *_ = wide_case
    if cfg_t.attention_kind == "gqa":
        assert tflash.kernel_head_dim(cfg_t.resolved_head_dim) == 256
    else:
        assert twkv.kernel_head_size(cfg_t.ssm.head_dim) == 256
        assert twkv.cluster_blocks(256) == 4


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_wide_forward_train_matches_reference(wide_case, backend):
    cfg_j, cfg_t, jp, tp, toks, _ = wide_case
    ref, _ = jmodel.forward_train(cfg_j, jp, jnp.asarray(toks),
                                  backend=backend)
    out, _ = tmodel.forward_train(cfg_t, tp, torch.tensor(toks),
                                  backend=backend)
    assert out.shape == (2, 64, cfg_t.vocab_padded)
    assert_close(ref, out, LOGIT_ATOL, f"{cfg_t.name} {backend} logits")


def test_wide_lm_loss_matches_reference(wide_case):
    cfg_j, cfg_t, jp, tp, toks, labels = wide_case
    ref, _ = jmodel.lm_loss(cfg_j, jp, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)},
                            backend="pallas")
    out, _ = tmodel.lm_loss(cfg_t, tp, {"tokens": torch.tensor(toks),
                                        "labels": torch.tensor(labels)},
                            backend="pallas")
    assert abs(float(ref) - float(out)) <= LOSS_ATOL
