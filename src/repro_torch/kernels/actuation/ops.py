"""Fused actuation-interval path: ``backend="fused"`` for the env hot loop.

Port of ``repro.kernels.actuation.ops``.  One actuation interval
(``steps_per_action`` dt's) runs with the velocity fields and both packed
pressure parity planes carried across every dt:

- on a CUDA tensor, one launch of the hand-written kernel
  ``csrc/fused_interval.cu`` for the whole env batch, the dt loop inside
  the kernel (:func:`fused_interval_cuda`);
- on a CPU tensor, its plain PyTorch twin (:func:`fused_interval_plain`),
  which chains the solver's own ``_momentum`` -> packed SOR projection
  -> velocity correction, so the twin cannot drift from the solver.

Tier selection (:func:`select_tier`): a CPU state on a grid of odd width
(no checkerboard parity) falls back to the reference loop, warning once
per grid shape.  A CUDA state the kernel cannot serve (odd width, or
packed planes over the shared memory of one block, the analogue of the
reference's VMEM budget) raises: the card never runs the plain loop in
the kernel's place.
"""
from __future__ import annotations

import ctypes
import warnings

import torch

from repro_torch._warn import warn_once_cache
from repro_torch.cfd import poisson, solver
from repro_torch.cfd.grid import GridConfig
from repro_torch.kernels import SMEM_PER_BLOCK

# reduction slots after the four planes (csrc/fused_interval.cu)
_SCRATCH_FLOATS = 128

_FALLBACK_WARNED = warn_once_cache()


def smem_bytes(cfg: GridConfig) -> int:
    """Shared-memory bytes the kernel keeps resident per env: the four
    packed planes (red, black, rhs_r, rhs_b) and the reduction slots."""
    return 4 * (4 * cfg.ny * (cfg.nx // 2) + _SCRATCH_FLOATS)


def check_kernel_grid(cfg: GridConfig) -> None:
    """Raise ``ValueError`` unless the CUDA kernel can serve the grid: an
    even width, and one env's packed planes within one block's shared
    memory (res <= 17 at the default aspect)."""
    ny, nx = cfg.ny, cfg.nx
    if nx % 2:
        raise ValueError(
            f"backend='fused' needs an even grid width for packed "
            f"checkerboard parity, got grid (ny={ny}, nx={nx}); use "
            f"backend='reference' for this grid")
    need = smem_bytes(cfg)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"backend='fused' keeps one env's four packed pressure planes in "
            f"one block's shared memory: grid (ny={ny}, nx={nx}) needs {need} "
            f"bytes, over the {SMEM_PER_BLOCK} a block may have.  Spreading "
            f"an env over a thread-block cluster is not written yet; run "
            f"this grid with backend='reference'")


def select_tier(cfg: GridConfig, device) -> str:
    """Which realization serves ``backend="fused"`` for tensors on ``device``.

    "cuda"       CUDA tensors: the hand-written kernel; a grid it cannot
                 serve raises (:func:`check_kernel_grid`)
    "plain"      CPU tensors: its plain PyTorch twin
    "reference"  CPU tensors on a grid of odd width (warns once per shape)
    """
    if torch.device(device).type == "cuda":
        check_kernel_grid(cfg)
        return "cuda"
    ny, nx = cfg.ny, cfg.nx
    if nx % 2:
        if ("odd_nx", ny, nx) not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(("odd_nx", ny, nx))
            warnings.warn(
                f"backend='fused' needs an even grid width for packed "
                f"checkerboard parity; grid (ny={ny}, nx={nx}) falls back "
                f"to the reference loop (this warning fires once per shape)",
                RuntimeWarning, stacklevel=3)
        return "reference"
    return "plain"


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def packed_projection_planes(cfg: GridConfig, red, black, rhs_r, rhs_b):
    """The pressure solve of one dt on packed planes: ``poisson_iters``
    pairs, the last ``n_polish`` unrelaxed."""
    iters = cfg.poisson_iters
    n_sor = iters - poisson.n_polish(iters)
    omega = float(cfg.poisson_omega)
    row_odd = (torch.arange(cfg.ny, device=red.device) % 2 == 1)[:, None]
    for i in range(iters):
        red, black = poisson.packed_sweep_pair(
            red, black, rhs_r, rhs_b, omega if i < n_sor else 1.0,
            dx=cfg.dx, dy=cfg.dy, row_odd=row_odd)
    return red, black


def fused_dt(cfg: GridConfig, ga: solver.GeomArrays, u, v, red, black,
             jet_vel, re, act_mode):
    """One dt with the pressure held packed.  Returns
    ``(u, v, red, black, cd, cl)``."""
    u_bc, v_bc, fx, fy = solver._momentum(cfg, ga, u, v, jet_vel, re,
                                          act_mode)
    rhs = solver.divergence(u_bc, v_bc, cfg) / cfg.dt
    rhs_r, rhs_b = poisson.pack_checkerboard(rhs)
    red, black = packed_projection_planes(cfg, red, black, rhs_r, rhs_b)
    p = poisson.unpack_checkerboard(red, black)
    u_new, v_new = solver._correct(cfg, ga, u_bc, v_bc, p)
    cd, cl = solver.force_coefficients(cfg, fx, fy)
    return u_new, v_new, red, black, cd, cl


def fused_interval_plain(cfg: GridConfig, geom_arrays, state, jet_vel,
                         n_steps: int, *, re=None, act_mode=None):
    """The kernel's plain PyTorch twin: ``fused_dt`` looped ``n_steps``
    times, the planes packed once before and unpacked once after."""
    ga = solver.GeomArrays(*geom_arrays)
    re = cfg.re if re is None else re
    act_mode = 0.0 if act_mode is None else act_mode
    u, v = state.u, state.v
    red, black = poisson.pack_checkerboard(state.p)
    cds, cls = [], []
    for _ in range(n_steps):
        u, v, red, black, cd, cl = fused_dt(cfg, ga, u, v, red, black,
                                            jet_vel, re, act_mode)
        cds.append(cd)
        cls.append(cl)
    flow = solver.FlowState(u, v, poisson.unpack_checkerboard(red, black))
    return flow, solver.StepOutputs(cd=torch.stack(cds, dim=-1),
                                    cl=torch.stack(cls, dim=-1))


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _consts(cfg: GridConfig):
    """The kernel's float constants (csrc/fused_interval.cu ``Consts``),
    each computed in float64 as the reference does, rounded to float32."""
    dx, dy = cfg.dx, cfg.dy
    _, _, inv_diag = poisson.sor_coefficients(dx, dy)
    b, om = cfg.upwind_blend, float(cfg.poisson_omega)
    vals = (cfg.dt, dx, dy, dx ** 2, dy ** 2, 2 * dx, 2 * dy, b, 1 - b,
            cfg.dt / cfg.penal_eta, inv_diag, om, 1 - om, cfg.ny * dy,
            0.5 * cfg.u_mean ** 2)
    return (ctypes.c_float * len(vals))(*vals)


def _per_env_vector(x, n: int, device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    return t.expand(n).contiguous() if t.dim() == 0 else t.reshape(n).contiguous()


def _load():
    from repro_torch.kernels import build
    lib = build.load("fused_interval")
    if lib.fused_interval_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_interval_launch.argtypes = (
            [p] * 14 + [i] * 7 + [p, p])
        lib.fused_interval_launch.restype = ctypes.c_int
    return lib


def fused_interval_cuda(cfg: GridConfig, geom_arrays, state, jet_vel,
                        n_steps: int, *, re=None, act_mode=None):
    """One launch of ``csrc/fused_interval.cu`` for the whole env batch:
    ``n_steps`` dt's, returns ``(FlowState, StepOutputs)`` with
    ``(N, n_steps)`` C_D / C_L (``(n_steps,)`` for an unbatched state)."""
    u, v, p = state
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"fused_interval_cuda needs CUDA tensors, got "
                         f"{dev}; CPU tensors take fused_interval_plain")
    check_kernel_grid(cfg)
    ny, nx = cfg.ny, cfg.nx
    batched = u.dim() == 3
    if not batched:
        u, v, p = u[None], v[None], p[None]
    n = u.shape[0]
    shapes = {"u": (u, (n, ny, nx + 1)), "v": (v, (n, ny + 1, nx)),
              "p": (p, (n, ny, nx))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != dev:
            raise ValueError(f"{name}: expected float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    ga = solver.GeomArrays(*geom_arrays)
    geom = [g.to(dev, torch.float32).contiguous() for g in ga]
    u, v, p = u.contiguous(), v.contiguous(), p.contiguous()
    jet = _per_env_vector(jet_vel, n, dev)
    re_t = _per_env_vector(cfg.re if re is None else re, n, dev)
    mode = _per_env_vector(0.0 if act_mode is None else act_mode, n, dev)
    u_out, v_out, p_out = (torch.empty_like(u), torch.empty_like(v),
                           torch.empty_like(p))
    u_scr, v_scr = torch.empty_like(u), torch.empty_like(v)
    cd = torch.empty((n, n_steps), dtype=torch.float32, device=dev)
    cl = torch.empty_like(cd)
    geom_ptrs = (ctypes.c_void_p * len(geom))(*[g.data_ptr() for g in geom])
    consts = _consts(cfg)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_interval_launch(
            u.data_ptr(), v.data_ptr(), p.data_ptr(),
            ctypes.cast(geom_ptrs, ctypes.c_void_p), jet.data_ptr(),
            re_t.data_ptr(), mode.data_ptr(), u_out.data_ptr(),
            v_out.data_ptr(), p_out.data_ptr(), u_scr.data_ptr(),
            v_scr.data_ptr(), cd.data_ptr(), cl.data_ptr(), n, ny, nx,
            n_steps, cfg.poisson_iters, poisson.n_polish(cfg.poisson_iters),
            smem_bytes(cfg), ctypes.cast(consts, ctypes.c_void_p), stream)
    from repro_torch.kernels.build import check_launch
    check_launch(lib, err, "fused_interval")
    fused_interval_cuda.launches += 1
    flow = solver.FlowState(u_out, v_out, p_out)
    if not batched:
        flow = solver.FlowState(*(a[0] for a in flow))
        cd, cl = cd[0], cl[0]
    return flow, solver.StepOutputs(cd=cd, cl=cl)


fused_interval_cuda.launches = 0


# ---------------------------------------------------------------------------
# the interval
# ---------------------------------------------------------------------------

def fused_interval(cfg: GridConfig, geom_arrays, state: solver.FlowState,
                   jet_vel, n_steps: int, *, re=None, act_mode=None):
    """One actuation interval with fields resident across every dt; the
    ``backend="fused"`` arm of ``solver.step_interval``.  The realization
    follows :func:`select_tier` for the state's device: a CUDA state
    launches the kernel or raises, it never falls back to the twin or the
    reference loop."""
    tier = select_tier(cfg, state.u.device)
    if re is None:
        re = cfg.re
    # act_mode=0.0 is exact against the jets-only branch ((1-0)*jet + 0*rot
    # multiplies through exactly in float32) and keeps one kernel signature
    if act_mode is None:
        act_mode = 0.0
    if tier == "reference":
        return solver.step_interval(cfg, geom_arrays, state, jet_vel,
                                    n_steps, re=re, act_mode=act_mode,
                                    backend="reference")
    if tier == "cuda":
        return fused_interval_cuda(cfg, geom_arrays, state, jet_vel, n_steps,
                                   re=re, act_mode=act_mode)
    return fused_interval_plain(cfg, geom_arrays, state, jet_vel, n_steps,
                                re=re, act_mode=act_mode)
