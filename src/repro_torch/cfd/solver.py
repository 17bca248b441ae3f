"""Fractional-step (Chorin projection) incompressible Navier-Stokes on a
staggered MAC grid, with a volume-penalization immersed-boundary cylinder
and synthetic-jet / rotary actuation.  Port of ``repro.cfd.solver``.

u: (..., ny, nx+1) x-velocity at x-faces   v: (..., ny+1, nx) y-velocity
p: (..., ny, nx)   pressure at cell centers

Leading dims are the env batch (where ``repro`` used ``vmap``).  The
per-env scalars ``re`` and ``act_mode`` are Python floats or tensors shaped
like the batch, ``(...,)``.  ``jet_vel`` is either such a scalar or a
per-body vector of rotary surface speeds, ``(..., A)``: one trailing dim
more than the batch.  The geometry fields are shared by the batch, or
carry the batch's dims in front (one geometry per env, gathered from a
bank: :func:`gather_geometry`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.cfd import poisson
from repro_torch.cfd.grid import Geometry, GridConfig
from repro_torch.device import resolve_device


class FlowState(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor


class GeomArrays(NamedTuple):
    """Static geometry fields as float32 tensors, shared by every env.

    The field order is the reference's (``repro.cfd.solver.GeomArrays``);
    the fused-interval kernel takes them in this order.  The trailing
    per-body fields (``rotb_*`` per-body rotary targets, ``own_*`` the
    nearest-body force ownership; see ``grid.Geometry``) default to
    ``None`` and are read only by the per-body branch of ``_momentum``."""
    chi_u: torch.Tensor
    chi_v: torch.Tensor
    jet_u: torch.Tensor
    jet_v: torch.Tensor
    jmask_u: torch.Tensor
    jmask_v: torch.Tensor
    rot_u: torch.Tensor
    rot_v: torch.Tensor
    rmask_u: torch.Tensor
    rmask_v: torch.Tensor
    inlet_u: torch.Tensor
    rotb_u: torch.Tensor = None   # (B, ny, nx+1)
    rotb_v: torch.Tensor = None   # (B, ny+1, nx)
    own_u: torch.Tensor = None    # (B, ny, nx+1)
    own_v: torch.Tensor = None    # (B, ny+1, nx)


class StepOutputs(NamedTuple):
    cd: torch.Tensor         # drag coefficient, (...,) or (..., n_steps);
    cl: torch.Tensor         # (..., B) / (..., n_steps, B) per body


def is_per_body(jet_vel, u) -> bool:
    """Whether ``jet_vel`` is a per-body vector for the flow field ``u``
    ((..., ny, nx+1)): a tensor with one trailing dim beyond the batch."""
    return torch.is_tensor(jet_vel) and jet_vel.dim() == u.dim() - 1


def geometry_bank(arrays: Sequence[GeomArrays], n_bodies: int) -> GeomArrays:
    """Geometries stacked into one ``(G, ...)`` bank, in the given order,
    their per-body fields zero-padded to ``n_bodies`` (zero rotary targets
    and zero ownership: the padded bodies are inert)."""
    def pad(a):
        return torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, n_bodies - a.shape[0]))

    per = [ga._replace(rotb_u=pad(ga.rotb_u), rotb_v=pad(ga.rotb_v),
                       own_u=pad(ga.own_u), own_v=pad(ga.own_v))
           for ga in arrays]
    return GeomArrays(*(torch.stack(xs).contiguous() for xs in zip(*per)))


def gather_geometry(bank: GeomArrays, geom_id) -> GeomArrays:
    """Each env's geometry from a stacked ``(G, ...)`` bank: every field
    gains the batch dims of ``geom_id`` in front."""
    return GeomArrays(*(None if f is None else f[geom_id] for f in bank))


def _per_env(x):
    """A per-env scalar broadcast against (..., rows, cols) fields."""
    return x[..., None, None] if torch.is_tensor(x) else x


def init_state(cfg: GridConfig, geom: Geometry, device="cuda") -> FlowState:
    """Start from the inlet profile everywhere (impulsive start)."""
    device = resolve_device(device)
    f32 = torch.float32
    inlet = torch.as_tensor(geom.inlet_u, dtype=f32, device=device)
    u = inlet[:, None].expand(cfg.ny, cfg.nx + 1)
    u = u * (1.0 - torch.as_tensor(geom.chi_u, dtype=f32, device=device))
    v = torch.zeros((cfg.ny + 1, cfg.nx), dtype=f32, device=device)
    p = torch.zeros((cfg.ny, cfg.nx), dtype=f32, device=device)
    return FlowState(u, v, p)


# ---------------------------------------------------------------------------
# boundary conditions (ghost-cell padding)
# ---------------------------------------------------------------------------

def _apply_bc_u(u, inlet_u):
    """In-array BCs for u: inlet Dirichlet, outlet zero-gradient (the
    outlet copies column -2 after it is final)."""
    u = u.clone()
    u[..., :, 0] = inlet_u
    u[..., :, -1] = u[..., :, -2]
    return u


def _apply_bc_v(v):
    v = v.clone()
    v[..., :, 0] = 0.0                 # inlet: v = 0
    v[..., :, -1] = v[..., :, -2]      # outlet: zero-gradient
    v[..., 0, :] = 0.0                 # bottom wall
    v[..., -1, :] = 0.0                # top wall
    return v


def _pad_u(u):
    """Ghosts for stencils: walls no-slip (reflect), x handled in-array."""
    u = torch.cat([-u[..., :1, :], u, -u[..., -1:, :]], dim=-2)
    left = 2 * u[..., :, :1] - u[..., :, 1:2]           # extrapolate inlet
    right = u[..., :, -1:]                              # zero-gradient outlet
    return torch.cat([left, u, right], dim=-1)          # (ny+2, nx+3)


def _pad_v(v):
    top = v[..., -1:, :] * 0.0
    bot = v[..., :1, :] * 0.0
    v = torch.cat([bot, v, top], dim=-2)                # (ny+3, nx) walls
    left = -v[..., :, :1]                               # inlet v=0 (reflect)
    right = v[..., :, -1:]                              # outlet zero-gradient
    return torch.cat([left, v, right], dim=-1)          # (ny+3, nx+2)


# ---------------------------------------------------------------------------
# spatial operators
# ---------------------------------------------------------------------------

def _advect_diffuse_u(up, vp, cfg: GridConfig, re):
    """du/dt = -u du/dx - v du/dy + (1/Re) lap(u) at u-faces, from the
    padded fields of ``_pad_u``/``_pad_v``."""
    dx, dy = cfg.dx, cfg.dy
    uc = up[..., 1:-1, 1:-1]
    ul, ur = up[..., 1:-1, :-2], up[..., 1:-1, 2:]
    ub, ut = up[..., :-2, 1:-1], up[..., 2:, 1:-1]
    v_at_u = 0.25 * (vp[..., 1:-2, :-1] + vp[..., 1:-2, 1:]
                     + vp[..., 2:-1, :-1] + vp[..., 2:-1, 1:])
    b = cfg.upwind_blend
    dudx_up = torch.where(uc > 0, (uc - ul) / dx, (ur - uc) / dx)
    dudy_up = torch.where(v_at_u > 0, (uc - ub) / dy, (ut - uc) / dy)
    dudx = b * dudx_up + (1 - b) * (ur - ul) / (2 * dx)
    dudy = b * dudy_up + (1 - b) * (ut - ub) / (2 * dy)
    adv = uc * dudx + v_at_u * dudy
    lap = (ul + ur - 2 * uc) / dx ** 2 + (ub + ut - 2 * uc) / dy ** 2
    return -adv + lap / _per_env(re)


def _advect_diffuse_v(up, vp, cfg: GridConfig, re):
    dx, dy = cfg.dx, cfg.dy
    vc = vp[..., 1:-1, 1:-1]
    vl, vr = vp[..., 1:-1, :-2], vp[..., 1:-1, 2:]
    vb, vt = vp[..., :-2, 1:-1], vp[..., 2:, 1:-1]
    u_at_v = 0.25 * (up[..., :-1, 1:-2] + up[..., :-1, 2:-1]
                     + up[..., 1:, 1:-2] + up[..., 1:, 2:-1])
    b = cfg.upwind_blend
    dvdx_up = torch.where(u_at_v > 0, (vc - vl) / dx, (vr - vc) / dx)
    dvdy_up = torch.where(vc > 0, (vc - vb) / dy, (vt - vc) / dy)
    dvdx = b * dvdx_up + (1 - b) * (vr - vl) / (2 * dx)
    dvdy = b * dvdy_up + (1 - b) * (vt - vb) / (2 * dy)
    adv = u_at_v * dvdx + vc * dvdy
    lap = (vl + vr - 2 * vc) / dx ** 2 + (vb + vt - 2 * vc) / dy ** 2
    return -adv + lap / _per_env(re)


def divergence(u, v, cfg: GridConfig):
    return ((u[..., :, 1:] - u[..., :, :-1]) / cfg.dx
            + (v[..., 1:, :] - v[..., :-1, :]) / cfg.dy)


# ---------------------------------------------------------------------------
# one time step
# ---------------------------------------------------------------------------

def _momentum(cfg: GridConfig, ga: GeomArrays, u, v, jet_vel, re, act_mode):
    """The momentum half of one dt: explicit advect-diffuse predictor,
    implicit volume penalization, and the fused BC/outlet-mass-correction
    pass.  Returns ``(u_bc, v_bc, fx, fy)``.

    Contract (the reference's): the body force is the momentum the
    penalization removed, measured against the predictor ``u_star`` BEFORE
    boundary conditions are applied.

    ``jet_vel`` is the scalar amplitude (``act_mode=None``: jets; else
    the per-env jets/rotary blend) or a per-body vector ``(..., A)`` of
    rotary surface speeds (:func:`is_per_body`), padded or cut to the
    geometry's body count; slot 0 doubles as the jet amplitude.  On the
    per-body branch ``fx``/``fy`` come back per body, ``(..., B)``, split
    by the nearest-body ownership."""
    chi_u, chi_v, inlet_u = ga.chi_u, ga.chi_v, ga.inlet_u
    dt = cfg.dt
    up, vp = _pad_u(u), _pad_v(v)
    u_star = u + dt * _advect_diffuse_u(up, vp, cfg, re)
    v_star = v + dt * _advect_diffuse_v(up, vp, cfg, re)

    lam = dt / cfg.penal_eta
    jet_tgt_u = ga.jet_u[..., 0, :, :] - ga.jet_u[..., 1, :, :]
    jet_tgt_v = ga.jet_v[..., 0, :, :] - ga.jet_v[..., 1, :, :]
    per_body = is_per_body(jet_vel, u)
    if per_body:
        if ga.rotb_u is None:
            raise ValueError(
                "a per-body (vector) jet_vel needs the per-body geometry "
                "fields (rotb_*/own_*); build GeomArrays with "
                "geom_to_arrays(build_geometry(cfg, geometry))")
        nb = ga.rotb_u.shape[-3]
        av = jet_vel
        if av.shape[-1] < nb:                 # pad to the body count
            av = torch.nn.functional.pad(av, (0, nb - av.shape[-1]))
        av = av[..., :nb]
        a0 = _per_env(av[..., 0])
        m = _per_env(0.0 if act_mode is None else act_mode)
        rot_t_u = torch.sum(av[..., :, None, None] * ga.rotb_u, dim=-3)
        rot_t_v = torch.sum(av[..., :, None, None] * ga.rotb_v, dim=-3)
        tgt_u = (1 - m) * a0 * jet_tgt_u + m * rot_t_u
        tgt_v = (1 - m) * a0 * jet_tgt_v + m * rot_t_v
        pen_u = torch.maximum(chi_u, (1 - m) * ga.jmask_u + m * ga.rmask_u)
        pen_v = torch.maximum(chi_v, (1 - m) * ga.jmask_v + m * ga.rmask_v)
    elif act_mode is None:                    # jets-only path
        jv = _per_env(jet_vel)
        tgt_u = jv * jet_tgt_u
        tgt_v = jv * jet_tgt_v
        pen_u = torch.maximum(chi_u, ga.jmask_u)
        pen_v = torch.maximum(chi_v, ga.jmask_v)
    else:                                     # per-env jets/rotary blend
        jv = _per_env(jet_vel)
        m = _per_env(act_mode)
        tgt_u = jv * ((1 - m) * jet_tgt_u + m * ga.rot_u)
        tgt_v = jv * ((1 - m) * jet_tgt_v + m * ga.rot_v)
        pen_u = torch.maximum(chi_u, (1 - m) * ga.jmask_u + m * ga.rmask_u)
        pen_v = torch.maximum(chi_v, (1 - m) * ga.jmask_v + m * ga.rmask_v)
    u_pen = (u_star + lam * pen_u * tgt_u) / (1 + lam * pen_u)
    v_pen = (v_star + lam * pen_v * tgt_v) / (1 + lam * pen_v)
    # reaction force from the PREDICTOR, before BCs touch the fields
    if per_body:
        fx = -torch.sum(ga.own_u * ((u_pen - u_star) / dt)[..., None, :, :],
                        dim=(-2, -1)) * cfg.dx * cfg.dy
        fy = -torch.sum(ga.own_v * ((v_pen - v_star) / dt)[..., None, :, :],
                        dim=(-2, -1)) * cfg.dx * cfg.dy
    else:
        fx = -torch.sum((u_pen - u_star) / dt, dim=(-2, -1)) * cfg.dx * cfg.dy
        fy = -torch.sum((v_pen - v_star) / dt, dim=(-2, -1)) * cfg.dx * cfg.dy

    # inlet BC, outlet BC and the global outlet mass correction in one pass
    influx = torch.sum(inlet_u, dim=-1) * cfg.dy
    outflux = torch.sum(u_pen[..., :, -2], dim=-1) * cfg.dy
    out_col = (u_pen[..., :, -2]
               + ((influx - outflux) / (cfg.ny * cfg.dy))[..., None])
    u_bc = u_pen.clone()
    u_bc[..., :, 0] = inlet_u
    u_bc[..., :, -1] = out_col
    v_bc = _apply_bc_v(v_pen)
    return u_bc, v_bc, fx, fy


def _correct(cfg: GridConfig, ga: GeomArrays, u_bc, v_bc, p):
    """Projection velocity correction, then the in-array BCs."""
    dt = cfg.dt
    u_new = u_bc.clone()
    v_new = v_bc.clone()
    u_new[..., :, 1:-1] += -dt * (p[..., :, 1:] - p[..., :, :-1]) / cfg.dx
    v_new[..., 1:-1, :] += -dt * (p[..., 1:, :] - p[..., :-1, :]) / cfg.dy
    return _apply_bc_u(u_new, ga.inlet_u), _apply_bc_v(v_new)


def force_coefficients(cfg: GridConfig, fx, fy):
    # 0.5 * rho * Ubar^2 * D = 0.5
    return fx / (0.5 * cfg.u_mean ** 2), fy / (0.5 * cfg.u_mean ** 2)


def step(cfg: GridConfig, geom_arrays: GeomArrays, state: FlowState, jet_vel,
         *, re=None, act_mode=None, backend: Optional[str] = None
         ) -> Tuple[FlowState, StepOutputs]:
    """Advance one dt.  ``backend`` picks the Poisson backend (see
    ``poisson.solve``); "fused" only changes behaviour at the interval level
    and solves a single step with the reference sweep."""
    backend = poisson.resolve_backend(backend)
    ga = GeomArrays(*geom_arrays)
    if re is None:
        re = cfg.re
    u, v, p = state
    u_bc, v_bc, fx, fy = _momentum(cfg, ga, u, v, jet_vel, re, act_mode)
    rhs = divergence(u_bc, v_bc, cfg) / cfg.dt
    p = poisson.solve(rhs, cfg.dx, cfg.dy, iters=cfg.poisson_iters,
                      omega=cfg.poisson_omega, p0=p,
                      backend="reference" if backend == "fused" else backend)
    u_new, v_new = _correct(cfg, ga, u_bc, v_bc, p)
    cd, cl = force_coefficients(cfg, fx, fy)
    return FlowState(u_new, v_new, p), StepOutputs(cd=cd, cl=cl)


def step_interval(cfg: GridConfig, geom_arrays: GeomArrays, state: FlowState,
                  jet_vel, n_steps: int, *, re=None, act_mode=None,
                  backend: Optional[str] = None, geom_id=None
                  ) -> Tuple[FlowState, StepOutputs]:
    """Advance ``n_steps`` dt under one held actuation amplitude (one
    actuation interval).  Returns per-dt ``(..., n_steps)`` force
    coefficients, ``(..., n_steps, B)`` for a per-body ``jet_vel``.

    ``geom_id`` (int64, the batch's shape) makes ``geom_arrays`` a stacked
    ``(G, ...)`` bank from which each env takes its own geometry.

    ``backend="fused"`` runs the interval through
    ``repro_torch.kernels.actuation``: on a CUDA tensor the hand-written
    fused-interval kernel, on a CPU tensor its plain twin.  A call the
    kernel cannot serve raises on a CUDA tensor; on a CPU tensor an odd
    width falls back to the reference loop with a once-per-shape warning.
    Every other backend loops :func:`step`."""
    backend = poisson.resolve_backend(backend)
    if backend == "fused":
        from repro_torch.kernels.actuation import ops as actuation_ops
        return actuation_ops.fused_interval(cfg, geom_arrays, state, jet_vel,
                                            n_steps, re=re, act_mode=act_mode,
                                            geom_id=geom_id)
    if geom_id is not None:
        geom_arrays = gather_geometry(geom_arrays, geom_id)
    dim = -2 if is_per_body(jet_vel, state.u) else -1
    cds, cls = [], []
    for _ in range(n_steps):
        state, out = step(cfg, geom_arrays, state, jet_vel, re=re,
                          act_mode=act_mode, backend=backend)
        cds.append(out.cd)
        cls.append(out.cl)
    return state, StepOutputs(cd=torch.stack(cds, dim=dim),
                              cl=torch.stack(cls, dim=dim))


def geom_to_arrays(geom: Geometry, device="cuda") -> GeomArrays:
    """Static geometry as float32 tensors on ``device`` (the per-body
    fields ``None`` where the geometry has none)."""
    device = resolve_device(device)
    def as32(a):
        return None if a is None else torch.as_tensor(
            a, dtype=torch.float32, device=device).contiguous()
    return GeomArrays(*(as32(getattr(geom, f, None))
                        for f in GeomArrays._fields))
