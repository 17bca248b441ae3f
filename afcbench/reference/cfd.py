"""The plain reference of the CFD environment: geometry, probes, one
actuation interval and the env step, in float32 PyTorch.

Written from the paper's equations and the solver's stated arithmetic: a
staggered MAC grid over the 22D x 4.1D channel, an explicit blended-upwind
advect-diffuse predictor, implicit volume penalization of the bodies, the
jets and the rotating shells, the force as the momentum the penalization
removes, red-black SOR on packed checkerboard planes (the last pairs
unrelaxed), the projection, bilinear pressure probes, the smoothed
actuation (eq. 11) and the reward (eq. 12).  It imports nothing of the
program: the geometry, the probe positions and every constant are worked
out here from the configuration.

Every function takes the env batch as the leading dim and computes in the
dtype of the state it is given, so the same code is the lower-precision
control when handed bfloat16 fields.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

H = 4.1                 # channel height / D
LX = 22.0               # channel length / D
X0 = -2.0               # inlet x
CYL_X, CYL_Y = 0.0, 0.05
RADIUS = 0.5
JET_CENTERS_DEG = (90.0, 270.0)
JET_WIDTH_DEG = 10.0
POLISH = 10             # unrelaxed SOR pairs at the end of a solve

_PINBALL_BACK_X = -0.5 + 1.5 * np.sqrt(3.0) / 2.0
BODIES = {
    "cylinder": ((CYL_X, CYL_Y),),
    "pinball": ((-0.5, 0.0), (_PINBALL_BACK_X, 0.75),
                (_PINBALL_BACK_X, -0.75)),
    "tandem": ((0.0, CYL_Y), (1.5, CYL_Y)),
}
MAX_BODIES = max(len(b) for b in BODIES.values())

# name -> (Re, actuation, probe layout, geometry)
SCENARIOS = {
    "cyl_re100": (100.0, "jets", "ring149", "cylinder"),
    "cyl_re200": (200.0, "jets", "ring149", "cylinder"),
    "cyl_re500": (500.0, "jets", "ring149", "cylinder"),
    "cyl_re100_rotary": (100.0, "rotary", "ring149", "cylinder"),
    "cyl_re200_rotary": (200.0, "rotary", "ring149", "cylinder"),
    "cyl_re100_sparse8": (100.0, "jets", "sparse8", "cylinder"),
    "cyl_re200_sparse24": (200.0, "jets", "sparse24", "cylinder"),
    "pinball_re100": (100.0, "rotary", "pinball", "pinball"),
    "pinball_re130": (130.0, "rotary", "pinball", "pinball"),
    "tandem_re100": (100.0, "rotary", "tandem", "tandem"),
}


@dataclass(frozen=True)
class Grid:
    res: int = 16
    dt: float = 0.005
    u_mean: float = 1.0
    poisson_iters: int = 60
    poisson_omega: float = 1.7
    penal_eta: float = 2e-4
    upwind_blend: float = 0.2

    @property
    def nx(self) -> int:
        return int(round(LX * self.res))

    @property
    def ny(self) -> int:
        n = int(round(H * self.res))
        return n + (n % 2)

    @property
    def dx(self) -> float:
        return LX / self.nx

    @property
    def dy(self) -> float:
        return H / self.ny

    @property
    def u_max(self) -> float:
        return 1.5 * self.u_mean


# ---------------------------------------------------------------------------
# geometry (numpy, float64, cast once)
# ---------------------------------------------------------------------------

def _solid(xx, yy, dx, cx, cy):
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    return np.clip(0.5 * (1 - (r - RADIUS) / (0.5 * dx)), 0.0, 1.0)


def _rotary(xx, yy, dx, cx, cy):
    rx, ry = xx - cx, yy - cy
    r = np.sqrt(rx ** 2 + ry ** 2) + 1e-12
    mask = np.clip((RADIUS + 0.75 * dx - r) / (0.5 * dx), 0.0, 1.0)
    mag = np.clip(r / RADIUS, 0.0, 1.0) * mask
    return mag * (-ry / r), mag * (rx / r), mask


def _jets(xx, yy, dx):
    rx, ry = xx - CYL_X, yy - CYL_Y
    r = np.sqrt(rx ** 2 + ry ** 2) + 1e-12
    theta = np.degrees(np.arctan2(ry, rx)) % 360.0
    shell = ((r - RADIUS) > -1.5 * dx) & ((r - RADIUS) < 0.75 * dx)
    width = max(JET_WIDTH_DEG, np.degrees(3.0 * dx / RADIUS))
    profiles, mask = [], np.zeros_like(r)
    for c in JET_CENTERS_DEG:
        d = np.abs((theta - c + 180.0) % 360.0 - 180.0)
        prof = np.clip(1.0 - (d / (width / 2)) ** 2, 0.0, 1.0)
        prof = prof * (d < width / 2) * shell * (JET_WIDTH_DEG / width)
        profiles.append(prof)
        mask = np.maximum(mask, (prof > 0).astype(np.float64))
    return np.stack(profiles), rx / r, ry / r, mask


def geometry(grid: Grid, name: str) -> Dict[str, np.ndarray]:
    """The static fields of one body set at u- and v-faces, the per-body
    ones padded to ``MAX_BODIES``."""
    bodies = BODIES[name]
    dx, dy = grid.dx, grid.dy
    xc = X0 + (np.arange(grid.nx) + 0.5) * dx
    yc = -H / 2 + (np.arange(grid.ny) + 0.5) * dy
    xxu, yyu = np.meshgrid(X0 + np.arange(grid.nx + 1) * dx, yc)
    xxv, yyv = np.meshgrid(xc, -H / 2 + np.arange(grid.ny + 1) * dy)
    g = {}
    for f, xx, yy in (("u", xxu, yyu), ("v", xxv, yyv)):
        g["chi_" + f] = np.maximum.reduce([_solid(xx, yy, dx, *b)
                                           for b in bodies])
        if name == "cylinder":
            prof, nxv, nyv, jmask = _jets(xx, yy, dx)
            g["jet_" + f] = prof * (nxv if f == "u" else nyv)[None]
        else:
            g["jet_" + f] = np.zeros((2,) + xx.shape)
            jmask = np.zeros(xx.shape)
        g["jmask_" + f] = jmask
        rot = [_rotary(xx, yy, dx, *b) for b in bodies]
        comp = 0 if f == "u" else 1
        rotb = np.stack([r[comp] for r in rot])
        g["rmask_" + f] = np.maximum.reduce([r[2] for r in rot])
        g["rot_" + f] = rotb.sum(axis=0)
        d = np.stack([np.sqrt((xx - bx) ** 2 + (yy - by) ** 2) - RADIUS
                      for bx, by in bodies])
        near = np.argmin(d, axis=0)
        own = np.stack([(near == i).astype(np.float64)
                        for i in range(len(bodies))])
        pad = ((0, MAX_BODIES - len(bodies)), (0, 0), (0, 0))
        g["rotb_" + f] = np.pad(rotb, pad)
        g["own_" + f] = np.pad(own, pad)
    g["inlet_u"] = grid.u_max * (H - 2 * yc) * (H + 2 * yc) / H ** 2
    return g


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def _ring(n, r, cx=CYL_X, cy=CYL_Y):
    a = 2 * np.pi * np.arange(n) / n
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=-1)


def _ring149():
    pts = [(CYL_X + r * np.cos(2 * np.pi * k / 24),
            CYL_Y + r * np.sin(2 * np.pi * k / 24))
           for r in (0.6, 0.8, 1.0) for k in range(24)]
    pts += [(x, y) for x in np.linspace(1.2, 9.0, 11)
            for y in np.linspace(-1.2, 1.2, 7)]
    return np.asarray(pts, dtype=np.float64)


def _pinball():
    rings = np.concatenate([_ring(8, 0.8, *b) for b in BODIES["pinball"]])
    wx, wy = np.meshgrid(np.linspace(2.0, 8.0, 7), np.linspace(-1.4, 1.4, 5))
    return np.concatenate([rings, np.stack([wx.ravel(), wy.ravel()], -1)])


def _tandem():
    rings = np.concatenate([_ring(16, 0.8, *b) for b in BODIES["tandem"]])
    wake = np.stack([np.linspace(2.5, 9.0, 8), np.full(8, CYL_Y)], -1)
    return np.concatenate([rings, wake])


LAYOUTS = {
    "ring149": _ring149,
    "sparse24": lambda: np.concatenate(
        [_ring(16, 0.8), np.stack([np.linspace(1.5, 8.0, 8), np.zeros(8)],
                                  -1)]),
    "sparse8": lambda: _ring(8, 0.8),
    "pinball": _pinball,
    "tandem": _tandem,
}


def probe_ij(grid: Grid, layout: str) -> np.ndarray:
    """(P, 2) fractional [row, col] cell-centre coordinates of a layout."""
    pts = LAYOUTS[layout]()
    col = (pts[:, 0] - (X0 + 0.5 * grid.dx)) / grid.dx
    row = (pts[:, 1] - (-H / 2 + 0.5 * grid.dy)) / grid.dy
    return np.stack([row, col], axis=-1).astype(np.float32)


def sample(ij: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Bilinear pressure at fractional (row, col) points, indices clamped
    into the grid: ij (N, P, 2), p (N, ny, nx) -> (N, P)."""
    ny, nx = p.shape[-2:]
    flat = p.reshape(p.shape[0], -1)
    out = None
    r0, c0 = torch.floor(ij[..., 0]), torch.floor(ij[..., 1])
    for r_i, r_w in ((r0, 1 - (ij[..., 0] - r0)), (r0 + 1, ij[..., 0] - r0)):
        for c_i, c_w in ((c0, 1 - (ij[..., 1] - c0)),
                         (c0 + 1, ij[..., 1] - c0)):
            idx = (r_i.long().clamp(0, ny - 1) * nx
                   + c_i.long().clamp(0, nx - 1))
            term = r_w.to(p.dtype) * c_w.to(p.dtype) * torch.gather(flat, 1,
                                                                   idx)
            out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# the env batch the reference steps
# ---------------------------------------------------------------------------

class Batch(NamedTuple):
    """Per-env physics of a batch of scenarios, fields (N, ...)."""
    geom: Dict[str, torch.Tensor]
    re: torch.Tensor          # (N,)
    mode: torch.Tensor        # (N,) 0 jets, 1 rotary
    ij: torch.Tensor          # (N, P, 2) probe coordinates (padded)
    mask: torch.Tensor        # (N, P) 1 = live probe
    act_mask: torch.Tensor    # (N, A) 1 = live action slot
    per_body: bool            # a vector of rotary speeds per env


def make_batch(grid: Grid, scenarios: Sequence[str], device,
               dtype=torch.float32) -> Batch:
    """The physics of each env of ``scenarios`` (one name per env)."""
    specs = [SCENARIOS[s] for s in scenarios]
    geoms = {}
    for _, _, _, gname in specs:
        if gname not in geoms:
            geoms[gname] = geometry(grid, gname)
    geom = {k: torch.as_tensor(np.stack([geoms[s[3]][k] for s in specs]),
                               dtype=dtype, device=device)
            for k in geoms[specs[0][3]]}
    ijs = [probe_ij(grid, s[2]) for s in specs]
    n_p = max(len(a) for a in ijs)
    ij = np.zeros((len(specs), n_p, 2), np.float32)
    mask = np.zeros((len(specs), n_p), np.float32)
    for i, a in enumerate(ijs):
        ij[i, :len(a)] = a
        mask[i, :len(a)] = 1.0
    widths = [len(BODIES[s[3]]) if s[1] == "rotary" else 1 for s in specs]
    a_dim = max(widths)
    act_mask = np.zeros((len(specs), a_dim), np.float32)
    for i, w in enumerate(widths):
        act_mask[i, :w] = 1.0

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Batch(geom=geom, re=f32([s[0] for s in specs]),
                 mode=f32([float(s[1] == "rotary") for s in specs]),
                 ij=f32(ij), mask=f32(mask), act_mask=f32(act_mask),
                 per_body=a_dim > 1)


# ---------------------------------------------------------------------------
# one dt
# ---------------------------------------------------------------------------

def _col(x):
    return x[:, None, None]


def _pad_u(u):
    u = torch.cat([-u[..., :1, :], u, -u[..., -1:, :]], dim=-2)
    return torch.cat([2 * u[..., :, :1] - u[..., :, 1:2], u, u[..., :, -1:]],
                     dim=-1)


def _pad_v(v):
    v = torch.cat([v[..., :1, :] * 0.0, v, v[..., -1:, :] * 0.0], dim=-2)
    return torch.cat([-v[..., :, :1], v, v[..., :, -1:]], dim=-1)


def _advect_u(up, vp, grid: Grid, re):
    dx, dy, w = grid.dx, grid.dy, grid.upwind_blend
    c = up[..., 1:-1, 1:-1]
    left, right = up[..., 1:-1, :-2], up[..., 1:-1, 2:]
    bot, top = up[..., :-2, 1:-1], up[..., 2:, 1:-1]
    v_at = 0.25 * (vp[..., 1:-2, :-1] + vp[..., 1:-2, 1:]
                   + vp[..., 2:-1, :-1] + vp[..., 2:-1, 1:])
    ddx = w * torch.where(c > 0, (c - left) / dx, (right - c) / dx) \
        + (1 - w) * (right - left) / (2 * dx)
    ddy = w * torch.where(v_at > 0, (c - bot) / dy, (top - c) / dy) \
        + (1 - w) * (top - bot) / (2 * dy)
    lap = (left + right - 2 * c) / dx ** 2 + (bot + top - 2 * c) / dy ** 2
    return -(c * ddx + v_at * ddy) + lap / _col(re)


def _advect_v(up, vp, grid: Grid, re):
    dx, dy, w = grid.dx, grid.dy, grid.upwind_blend
    c = vp[..., 1:-1, 1:-1]
    left, right = vp[..., 1:-1, :-2], vp[..., 1:-1, 2:]
    bot, top = vp[..., :-2, 1:-1], vp[..., 2:, 1:-1]
    u_at = 0.25 * (up[..., :-1, 1:-2] + up[..., :-1, 2:-1]
                   + up[..., 1:, 1:-2] + up[..., 1:, 2:-1])
    ddx = w * torch.where(u_at > 0, (c - left) / dx, (right - c) / dx) \
        + (1 - w) * (right - left) / (2 * dx)
    ddy = w * torch.where(c > 0, (c - bot) / dy, (top - c) / dy) \
        + (1 - w) * (top - bot) / (2 * dy)
    lap = (left + right - 2 * c) / dx ** 2 + (bot + top - 2 * c) / dy ** 2
    return -(u_at * ddx + c * ddy) + lap / _col(re)


def _v_walls(v):
    v = v.clone()
    v[..., :, 0] = 0.0
    v[..., :, -1] = v[..., :, -2]
    v[..., 0, :] = 0.0
    v[..., -1, :] = 0.0
    return v


def momentum(grid: Grid, b: Batch, u, v, amp):
    """Predictor, penalization and boundary conditions of one dt, and the
    body force measured against the predictor: (u, v, fx, fy), the forces
    (N,) or per body (N, B)."""
    g, dt = b.geom, grid.dt
    up, vp = _pad_u(u), _pad_v(v)
    u_s = u + dt * _advect_u(up, vp, grid, b.re)
    v_s = v + dt * _advect_v(up, vp, grid, b.re)
    m = _col(b.mode)
    jet_u = g["jet_u"][:, 0] - g["jet_u"][:, 1]
    jet_v = g["jet_v"][:, 0] - g["jet_v"][:, 1]
    if b.per_body:
        a = torch.nn.functional.pad(amp, (0, MAX_BODIES - amp.shape[-1]))
        a0 = _col(a[:, 0])
        tgt_u = (1 - m) * a0 * jet_u + m * torch.sum(
            a[:, :, None, None] * g["rotb_u"], dim=1)
        tgt_v = (1 - m) * a0 * jet_v + m * torch.sum(
            a[:, :, None, None] * g["rotb_v"], dim=1)
    else:
        a0 = _col(amp)
        tgt_u = a0 * ((1 - m) * jet_u + m * g["rot_u"])
        tgt_v = a0 * ((1 - m) * jet_v + m * g["rot_v"])
    pen_u = torch.maximum(g["chi_u"], (1 - m) * g["jmask_u"]
                          + m * g["rmask_u"])
    pen_v = torch.maximum(g["chi_v"], (1 - m) * g["jmask_v"]
                          + m * g["rmask_v"])
    lam = dt / grid.penal_eta
    u_p = (u_s + lam * pen_u * tgt_u) / (1 + lam * pen_u)
    v_p = (v_s + lam * pen_v * tgt_v) / (1 + lam * pen_v)
    area = grid.dx * grid.dy
    du, dv = (u_p - u_s) / dt, (v_p - v_s) / dt
    if b.per_body:
        fx = -torch.sum(g["own_u"] * du[:, None], dim=(-2, -1)) * area
        fy = -torch.sum(g["own_v"] * dv[:, None], dim=(-2, -1)) * area
    else:
        fx = -torch.sum(du, dim=(-2, -1)) * area
        fy = -torch.sum(dv, dim=(-2, -1)) * area
    inflow = torch.sum(g["inlet_u"], dim=-1) * grid.dy
    outflow = torch.sum(u_p[..., :, -2], dim=-1) * grid.dy
    u_bc = u_p.clone()
    u_bc[..., :, 0] = g["inlet_u"]
    u_bc[..., :, -1] = (u_p[..., :, -2]
                        + ((inflow - outflow) / (grid.ny * grid.dy))[:, None])
    return u_bc, _v_walls(v_p), fx, fy


def pack(a):
    """(N, ny, nx) -> red and black planes (N, ny, nx // 2):
    red[j, k] = a[j, 2k + j % 2], black[j, k] = a[j, 2k + 1 - j % 2]."""
    odd = (torch.arange(a.shape[-2], device=a.device) % 2 == 1)[:, None]
    pairs = a.reshape(*a.shape[:-1], a.shape[-1] // 2, 2)
    return (torch.where(odd, pairs[..., 1], pairs[..., 0]),
            torch.where(odd, pairs[..., 0], pairs[..., 1]))


def unpack(red, black):
    odd = (torch.arange(red.shape[-2], device=red.device) % 2 == 1)[:, None,
                                                                      None]
    pairs = torch.where(odd, torch.stack([black, red], -1),
                        torch.stack([red, black], -1))
    return pairs.reshape(*red.shape[:-1], 2 * red.shape[-1])


def _half_sweep(act, oth, rhs, shift, om, dx2, dy2, inv_diag):
    """Gauss-Seidel on one colour's plane from the other's: Neumann ghosts
    at the inlet and the walls, Dirichlet zero at the outlet; rows where
    ``shift`` holds take their horizontal neighbours one packed column to
    the right."""
    west = torch.cat([act[..., :, :1], oth[..., :, :-1]], dim=-1)
    east = torch.cat([oth[..., :, 1:], -act[..., :, -1:]], dim=-1)
    horiz = torch.where(shift, oth + east, west + oth)
    north = torch.cat([act[..., :1, :], oth[..., :-1, :]], dim=-2)
    south = torch.cat([oth[..., 1:, :], act[..., -1:, :]], dim=-2)
    gs = (horiz / dx2 + (north + south) / dy2 - rhs) * inv_diag
    return (1 - om) * act + om * gs


def sor(grid: Grid, red, black, rhs_r, rhs_b):
    """``poisson_iters`` red-black pairs on packed planes, the last
    ``min(POLISH, iters // 2)`` with omega 1."""
    dx2, dy2 = grid.dx ** 2, grid.dy ** 2
    inv_diag = 1.0 / (2.0 / dx2 + 2.0 / dy2)
    odd = (torch.arange(grid.ny, device=red.device) % 2 == 1)[:, None]
    iters = grid.poisson_iters
    n_sor = iters - min(POLISH, iters // 2)
    for i in range(iters):
        om = float(grid.poisson_omega) if i < n_sor else 1.0
        red = _half_sweep(red, black, rhs_r, odd, om, dx2, dy2, inv_diag)
        black = _half_sweep(black, red, rhs_b, ~odd, om, dx2, dy2, inv_diag)
    return red, black


def correct(grid: Grid, b: Batch, u_bc, v_bc, p):
    dt = grid.dt
    u, v = u_bc.clone(), v_bc.clone()
    u[..., :, 1:-1] += -dt * (p[..., :, 1:] - p[..., :, :-1]) / grid.dx
    v[..., 1:-1, :] += -dt * (p[..., 1:, :] - p[..., :-1, :]) / grid.dy
    u = u.clone()
    u[..., :, 0] = b.geom["inlet_u"]
    u[..., :, -1] = u[..., :, -2]
    return u, _v_walls(v)


class Flow(NamedTuple):
    u: torch.Tensor     # (N, ny, nx + 1)
    v: torch.Tensor     # (N, ny + 1, nx)
    p: torch.Tensor     # (N, ny, nx)


def interval(grid: Grid, b: Batch, flow: Flow, amp, n_steps: int
             ) -> Tuple[Flow, torch.Tensor, torch.Tensor]:
    """``n_steps`` dt under one held amplitude: the flow after, and the
    drag and lift coefficients of every dt, (N, n_steps) or per body (N,
    n_steps, B)."""
    u, v = flow.u, flow.v
    red, black = pack(flow.p)
    scale = 0.5 * grid.u_mean ** 2
    cds, cls = [], []
    for _ in range(n_steps):
        u_bc, v_bc, fx, fy = momentum(grid, b, u, v, amp)
        div = ((u_bc[..., :, 1:] - u_bc[..., :, :-1]) / grid.dx
               + (v_bc[..., 1:, :] - v_bc[..., :-1, :]) / grid.dy)
        rhs_r, rhs_b = pack(div / grid.dt)
        red, black = sor(grid, red, black, rhs_r, rhs_b)
        u, v = correct(grid, b, u_bc, v_bc, unpack(red, black))
        cds.append(fx / scale)
        cls.append(fy / scale)
    return Flow(u, v, unpack(red, black)), torch.stack(cds, 1), \
        torch.stack(cls, 1)


class Step(NamedTuple):
    flow: Flow
    amp: torch.Tensor       # the smoothed amplitude after the step
    obs: torch.Tensor       # (N, P)
    reward: torch.Tensor    # (N,)
    cd: torch.Tensor        # (N,) mean drag over the interval (all bodies)
    cl: torch.Tensor        # (N,) mean lift over the interval (all bodies)


def env_step(grid: Grid, b: Batch, flow: Flow, amp, action, cd0, *,
             steps_per_action: int, beta: float, omega_l: float) -> Step:
    """One actuation period: the action in [-1, 1] scaled to the jet or
    surface speed limit, smoothed (eq. 11), held for ``steps_per_action``
    dt; the probes after it, and the reward r = C_D0 - <C_D> - omega_L
    |<C_L>| (eq. 12), the lift penalized per body."""
    a = torch.clamp(action.to(flow.u.dtype), -1.0, 1.0) * grid.u_max
    if b.per_body:
        a = a * b.act_mask.to(a.dtype)
    amp = torch.clamp(amp + beta * (a - amp), -grid.u_max, grid.u_max)
    flow, cd_t, cl_t = interval(grid, b, flow, amp, steps_per_action)
    cd_b, cl_b = cd_t.mean(dim=1), cl_t.mean(dim=1)
    if b.per_body:
        cd, cl, pen = cd_b.sum(-1), cl_b.sum(-1), cl_b.abs().sum(-1)
    else:
        cd, cl, pen = cd_b, cl_b, cl_b.abs()
    reward = cd0 - cd - omega_l * pen
    obs = sample(b.ij, flow.p) * b.mask.to(flow.p.dtype)
    return Step(flow, amp, obs, reward, cd, cl)
