"""Hand-written CUDA kernels of the port (``csrc/``), their builds
(``build.py``) and their Python wrappers with plain PyTorch twins."""

import collections
import contextlib

import torch

# dynamic shared memory one block may claim on an H100 (227 KB)
SMEM_PER_BLOCK = 232_448


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when a gradient would have to pass through ``kernel``: grad
    mode is on and one of ``tensors`` requires grad.  The kernels are
    forward only, as the reference's Pallas kernels are (jax cannot
    differentiate them: ``pallas_call``'s JVP rule asserts), and a CUDA
    launch has no autograd link, so a backward through it would drop the
    gradient silently.  The plain twin on CPU tensors refuses the same way,
    so both devices train only through ``backend="reference"``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} is forward only and cannot be differentiated: the "
            f"reference cannot differentiate its Pallas kernels either, "
            f"so training runs the reference mixers (backend='reference'); "
            f"call the kernel under torch.no_grad() or on tensors that do "
            f"not require grad")


# the cost counters (``launch/cost_analysis.CostCounter``) entered on this
# process, innermost last
COUNTERS: list = []

# the CPU calls served by the reference path in a kernel's twin's place,
# keyed by (kernel, grid shape): an odd grid width has no checkerboard
# parity, so ``backend="fused"`` and ``backend="pallas"`` fall back on it
# as the reference's do (warning once per shape).  On the card such a call
# runs a kernel (its planes ``(nx + 1) // 2`` wide), and a kernel that
# fails to build or launch raises
FALLBACKS: collections.Counter = collections.Counter()


def fell_back(kernel: str, shape) -> None:
    """Count one call of ``kernel``'s path on a grid of ``shape`` that ran
    the reference path instead (:data:`FALLBACKS`)."""
    FALLBACKS[(kernel, tuple(int(n) for n in shape))] += 1


@contextlib.contextmanager
def counted(kernel: str, work, launches=1):
    """Run a wrapper's body as one call of ``kernel``: under an active cost
    counter the call is recorded once, with ``work()`` (the kernel's
    ``(flops, bytes)`` from the call's shapes) and the ``launches`` the
    card makes for it (a count, or a function that returns it, called
    only under a counter), and the ops the body issues (the twin's on CPU
    or meta tensors, the padding and copies on the card) are not counted
    themselves; only the storages that outlive the body count as
    allocated.  Without a counter, or inside another counted body, it does
    nothing."""
    if not COUNTERS:
        yield
        return
    with COUNTERS[-1].kernel(kernel, work, launches() if callable(launches)
                             else launches):
        yield


@contextlib.contextmanager
def allocating(kernel: str, nbytes: int, device):
    """Allocate a call's outputs, scratch and padded copies inside this
    block: where the card cannot hold them, the allocator's out-of-memory
    error becomes a ``ValueError`` that names the call's ``nbytes`` (which
    the wrapper reckons from the shapes) beside the card's free bytes.
    The wrappers allocate before any launch, so such a call launches
    nothing."""
    try:
        yield
    except torch.OutOfMemoryError as err:
        free, total = torch.cuda.mem_get_info(device)
        raise ValueError(
            f"{kernel} needs {nbytes} bytes of device memory for this call "
            f"(outputs, scratch and padded copies), more than {device} can "
            f"give: {free} bytes free of {total}") from err
