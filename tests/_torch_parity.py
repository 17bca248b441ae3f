"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*).

The reference (``repro``, JAX on the CPU) and the port (``repro_torch``)
get the same numpy inputs; results come back as numpy and are compared
within a tolerance each test states.  Torch runs single-threaded with TF32
off, so its float32 arithmetic is plain IEEE float32 like the reference's.
"""
import numpy as np
import torch

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def to_np(x):
    """A torch tensor or JAX array as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_diff(ref, out):
    """(max abs difference, max relative difference) of two arrays."""
    a, b = to_np(ref).astype(np.float64), to_np(out).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    return float(d.max(initial=0.0)), float(
        (d / np.maximum(np.abs(a), 1e-30)).max(initial=0.0))


def assert_close(ref, out, atol, what=""):
    err, _ = max_diff(ref, out)
    assert err <= atol, f"{what}: max abs diff {err:.3e} > {atol:.1e}"

