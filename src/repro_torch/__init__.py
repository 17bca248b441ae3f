"""PyTorch/CUDA port of the DRL x CFD active-flow-control trainer.

The package mirrors ``repro``'s layout (``cfd/``, ``drl/``, ``kernels/``,
``optim/``) module by module, so each port has a counterpart a reader can
find by name.  It imports ``torch`` and numpy only: never ``jax`` and never
anything of the ``repro`` package.

Entry points take ``device=`` and default to ``"cuda"``; asking for CUDA on a
host without it raises (:func:`repro_torch.device.resolve_device`).  The
hand-written Hopper kernels under ``kernels/`` run on CUDA tensors; on CPU
tensors their plain PyTorch versions run instead.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
