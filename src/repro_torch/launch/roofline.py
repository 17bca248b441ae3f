"""Hardware presets and the model-FLOP count a roofline prices against.

Port of the device half of ``repro.launch.roofline``: :class:`HardwareSpec`,
:data:`HARDWARE_PRESETS`, :func:`hardware_spec`, :func:`param_count`,
:func:`active_param_count` and :func:`model_flops`.  MODEL_FLOPS is 6 N D
for a train step over D tokens (6 N_active D for MoE) and 2 N per token
for prefill and decode; an encoder-decoder's encoder parameters count
over the frontend's frames instead of the tokens, and not in a decode.
The presets keep the reference's ``tpu_v5e`` and ``cpu_generic`` and add
``h100_sxm``, the dense bfloat16 tensor-core peak and HBM3 rate of an
H100 SXM.  A spec is chosen explicitly, through
``$REPRO_HW_SPEC``, or detected from the torch device (a CUDA H100 ->
``h100_sxm``, the CPU -> ``cpu_generic``); any other device raises with
the preset list, as the reference does for an unknown platform.

:class:`Roofline` and :func:`build` are the reference's terms over a dict
of per-device HLO counts (``flops``, ``bytes``, ``coll_bytes`` and
``coll_<kind>``), priced against a :class:`HardwareSpec`: compute =
flops / peak, memory = bytes / HBM rate, collective = collective bytes /
link rate.  Torch has no compiled-HLO cost analysis, so the port's dry run
(``launch/dryrun.py``) records no such dict; these take one from the
caller, as the reference's do from its HLO analysis.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.steps import leaves_with_paths, param_leaves
from repro_torch.models import frontend as fe_mod


@dataclass(frozen=True)
class HardwareSpec:
    """Peak rates a roofline prices against, for one device.  ``ici_bw`` is
    the per-link interconnect rate the collective term divides by."""
    name: str
    peak_flops: float            # FLOP/s per device
    hbm_bw: float                # main-memory bytes/s per device
    ici_bw: float                # interconnect bytes/s per link
    description: str = ""

    def to_dict(self) -> Dict:
        return {"name": self.name, "peak_flops": self.peak_flops,
                "hbm_bw": self.hbm_bw, "ici_bw": self.ici_bw}


HARDWARE_PRESETS: Dict[str, HardwareSpec] = {
    "tpu_v5e": HardwareSpec(
        name="tpu_v5e", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
        description="TPU v5e chip: bf16 peak, HBM2e, ICI per link "
                    "(~per direction)"),
    "cpu_generic": HardwareSpec(
        name="cpu_generic", peak_flops=5e10, hbm_bw=2e10, ici_bw=1e10,
        description="one generic x86 core: ~50 GFLOP/s sustained f32 FMA, "
                    "~20 GB/s sustained DRAM, loopback interconnect"),
    "h100_sxm": HardwareSpec(
        name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=25e9,
        description="NVIDIA H100 SXM: dense bf16 tensor-core peak, HBM3, "
                    "one NVLink 4 link per direction"),
}

# environment override consulted when no spec is passed explicitly
HW_SPEC_ENV = "REPRO_HW_SPEC"


def _detect(device) -> str:
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu_generic"
    if dev.type == "cuda" and torch.cuda.is_available():
        name = torch.cuda.get_device_name(dev)
        if "H100" in name:
            return "h100_sxm"
        what = f"CUDA device {name!r}"
    else:
        what = f"device {str(dev)!r}"
    raise ValueError(
        f"no hardware preset for {what}; pass one of "
        f"{sorted(HARDWARE_PRESETS)} explicitly (name= / ${HW_SPEC_ENV}) or "
        f"a HardwareSpec with your device's peak numbers")


def hardware_spec(name: Union[None, str, HardwareSpec] = None,
                  device=None) -> HardwareSpec:
    """Resolve the hardware a roofline prices against.

    Precedence: explicit ``name`` (a preset name or a HardwareSpec, passed
    through) > the ``$REPRO_HW_SPEC`` preset name > detection from
    ``device`` (default: CUDA device 0 when there is one, else the CPU).
    Anything unrecognized raises a ValueError listing the presets."""
    if isinstance(name, HardwareSpec):
        return name
    if name is None:
        name = os.environ.get(HW_SPEC_ENV) or None
    if name is not None:
        try:
            return HARDWARE_PRESETS[name]
        except KeyError:
            raise ValueError(
                f"unknown hardware spec {name!r}; choose a preset from "
                f"{sorted(HARDWARE_PRESETS)} (or pass a HardwareSpec with "
                f"your device's peak_flops/hbm_bw/ici_bw)") from None
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return HARDWARE_PRESETS[_detect(device)]


def param_count(cfg: ModelConfig, params_shape) -> int:
    return sum(math.prod(v.shape) for v in param_leaves(params_shape))


def active_param_count(cfg: ModelConfig, params_shape) -> int:
    """MoE: only top_k (+shared) experts per token are active."""
    total = 0
    for path, leaf in leaves_with_paths(params_shape):
        n = math.prod(leaf.shape)
        if cfg.moe is not None and any(
                path.endswith(s) for s in ("we1", "we2", "we3")):
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total


def _encoder_param_count(params_shape) -> int:
    return sum(math.prod(leaf.shape)
               for path, leaf in leaves_with_paths(params_shape)
               if path.startswith("encoder/"))


def model_flops(cfg: ModelConfig, shape: InputShape, params_shape) -> float:
    """6 N_active D for a train step, 2 N_active D for prefill / decode
    (D = batch x seq, or batch for one decode token).  An encoder-decoder's
    encoder parameters run over the frontend's frames (batch x T_enc), and
    not at all in a decode."""
    n_enc = _encoder_param_count(params_shape) if cfg.is_encdec else 0
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    fl = mult * (active_param_count(cfg, params_shape) - n_enc) * tokens
    if n_enc and shape.kind != "decode":
        t_enc = shape.global_batch * fe_mod.num_frontend_tokens(
            cfg, shape.seq_len)
        fl += mult * n_enc * t_enc
    return fl


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops: float
    coll_by_kind: Dict[str, float]
    # the device the terms price against; None resolves through
    # hardware_spec() (explicit > $REPRO_HW_SPEC > device detection)
    hw: Optional[HardwareSpec] = None

    def __post_init__(self):
        if self.hw is None:
            self.hw = hardware_spec()

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_dev / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_dev / self.hw.ici_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS over the global HLO flops."""
        total = self.flops_per_dev * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu_bound(self) -> float:
        """The model-FLOPs utilization the terms allow at most."""
        ideal = self.model_flops / (self.n_devices * self.hw.peak_flops)
        return ideal / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "coll_by_kind": self.coll_by_kind,
            "model_flops": self.model_flops,
            "hw": self.hw.to_dict(),
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio, "mfu_bound": self.mfu_bound,
        }


def build(arch: str, shape_name: str, mesh_name: str, n_devices: int,
          analyzed: Dict[str, float], model_fl: float,
          hw: Union[None, str, HardwareSpec] = None) -> Roofline:
    """A :class:`Roofline` from per-device counts ``analyzed``: ``flops``,
    ``bytes``, ``coll_bytes`` and each ``coll_<kind>``."""
    coll_by_kind = {k[len("coll_"):]: v for k, v in analyzed.items()
                    if k.startswith("coll_") and k != "coll_bytes"}
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, n_devices=n_devices,
        flops_per_dev=analyzed.get("flops", 0.0),
        bytes_per_dev=analyzed.get("bytes", 0.0),
        coll_bytes_per_dev=analyzed.get("coll_bytes", 0.0),
        model_flops=model_fl, coll_by_kind=coll_by_kind,
        hw=hardware_spec(hw))
