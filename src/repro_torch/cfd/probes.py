"""Pressure-probe layouts + sampler (bilinear interpolation at fixed points).

Port of ``repro.cfd.probes``.  Layouts are registered by name so scenarios
can pick an observation vector per case:

  ring149   72 probes on three rings + 77 wake grid (the default)
  sparse24  16-probe ring at r=0.8 + 8 near-wake probes
  sparse8   8-probe ring at r=0.8
  pinball   8-probe ring around each pinball cylinder + a 5x7 wake grid
  tandem    16-probe ring around each tandem cylinder + 8 wake probes

``sample_pressure`` takes the probe coordinates as data, so per-env probe
layouts batch into one call; a probe mask zeroes padded slots.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.cfd.grid import CYL_X, CYL_Y, GEOMETRIES, probe_positions


def _ring(n: int, r: float, cx: float = CYL_X, cy: float = CYL_Y) -> np.ndarray:
    a = 2 * np.pi * np.arange(n) / n
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=-1)


def _sparse24() -> np.ndarray:
    wake = np.stack([np.linspace(1.5, 8.0, 8), np.zeros(8)], axis=-1)
    return np.concatenate([_ring(16, 0.8), wake])


def _body_rings(geometry: str, n: int, r: float) -> np.ndarray:
    return np.concatenate([_ring(n, r, b.x, b.y)
                           for b in GEOMETRIES[geometry]])


def _pinball() -> np.ndarray:
    rings = _body_rings("pinball", 8, 0.8)
    wx, wy = np.meshgrid(np.linspace(2.0, 8.0, 7), np.linspace(-1.4, 1.4, 5))
    wake = np.stack([wx.ravel(), wy.ravel()], axis=-1)
    return np.concatenate([rings, wake])


def _tandem() -> np.ndarray:
    wake = np.stack([np.linspace(2.5, 9.0, 8),
                     np.full(8, CYL_Y)], axis=-1)
    return np.concatenate([_body_rings("tandem", 16, 0.8), wake])


LAYOUTS: Dict[str, Callable[[], np.ndarray]] = {
    "ring149": probe_positions,
    "sparse24": _sparse24,
    "sparse8": lambda: _ring(8, 0.8),
    "pinball": _pinball,
    "tandem": _tandem,
}


def layout_positions(name: str) -> np.ndarray:
    """(P, 2) physical probe coordinates for a registered layout."""
    try:
        return LAYOUTS[name]()
    except KeyError:
        raise KeyError(f"unknown probe layout {name!r}; "
                       f"known: {sorted(LAYOUTS)}") from None


def layout_size(name: str) -> int:
    return len(layout_positions(name))


def sample_pressure(probe_ij, p, mask=None) -> torch.Tensor:
    """p: (..., ny, nx) cell-centered pressure -> (..., P) probe values.

    probe_ij: (..., P, 2) fractional [row, col] coords (see
    ``grid.points_to_ij``); mask: optional (..., P) multiplier zeroing
    padded slots.

    A clamped bilinear gather with the arithmetic of
    ``map_coordinates(order=1, mode="nearest")``: per axis the nodes are
    ``floor(c)`` and ``floor(c) + 1`` with weights ``1 - (c - floor(c))``
    and ``c - floor(c)``, each index clamped into the grid; the four
    corner terms ``w_row * w_col * value`` are summed in the order
    (lo,lo), (lo,hi), (hi,lo), (hi,hi)."""
    ny, nx = p.shape[-2:]
    ij = torch.as_tensor(probe_ij, dtype=torch.float32, device=p.device)
    lead = p.shape[:-2]
    ij = ij.expand(*lead, *ij.shape[-2:])
    flat = p.reshape(*lead, ny * nx)

    def nodes(c, size):
        lower = torch.floor(c)
        w_hi = c - lower
        w_lo = 1 - w_hi
        idx = lower.to(torch.int64)
        return [(idx.clamp(0, size - 1), w_lo),
                ((idx + 1).clamp(0, size - 1), w_hi)]

    vals = None
    for r_idx, r_w in nodes(ij[..., 0], ny):
        for c_idx, c_w in nodes(ij[..., 1], nx):
            term = r_w * c_w * torch.gather(flat, -1, r_idx * nx + c_idx)
            vals = term if vals is None else vals + term
    if mask is not None:
        vals = vals * torch.as_tensor(mask, dtype=vals.dtype,
                                      device=vals.device)
    return vals
