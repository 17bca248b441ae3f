"""Grid + geometry for the Schäfer cylinder benchmark (22D x 4.1D channel).

The port's own copy of ``repro.cfd.grid``'s numpy geometry: a uniform
staggered MAC grid with an immersed-boundary cylinder, every mask and
target precomputed with numpy at construction time.  The arithmetic is the
reference's line for line, so the masks are identical by construction.

Every registered geometry builds: the classic single cylinder (jets and
rotary), the fluidic pinball (three bodies) and tandem cylinders (two),
each with per-body rotary targets and a nearest-body ownership partition
for per-body forces.

Coordinates: x in [-2, 20] (cylinder center at origin, inlet 2D upstream),
y in [-H/2, H/2] with H = 4.1.  The cylinder is offset +0.05D in y to
trigger vortex shedding.  D = 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

H = 4.1                 # channel height / D
LX = 22.0               # channel length / D
X0 = -2.0               # inlet x
CYL_X, CYL_Y = 0.0, 0.05
RADIUS = 0.5
JET_CENTERS_DEG = (90.0, 270.0)
JET_WIDTH_DEG = 10.0


@dataclass(frozen=True)
class Body:
    """One immersed cylinder: center + radius (D = 2r = 1 by default)."""
    x: float
    y: float
    r: float = RADIUS


# "cylinder" is the single-body Schäfer case (the golden fixtures pin it);
# "pinball" is the fluidic pinball, three unit cylinders on an equilateral
# triangle of side 1.5D, apex upstream; "tandem" two inline cylinders 1.5D
# apart
_PINBALL_BACK_X = -0.5 + 1.5 * np.sqrt(3.0) / 2.0      # ~0.799
GEOMETRIES: dict = {
    "cylinder": (Body(CYL_X, CYL_Y),),
    "pinball": (Body(-0.5, 0.0),
                Body(_PINBALL_BACK_X, 0.75),
                Body(_PINBALL_BACK_X, -0.75)),
    "tandem": (Body(0.0, CYL_Y), Body(1.5, CYL_Y)),
}


def geometry_names() -> Tuple[str, ...]:
    """Registered geometry names in canonical (sorted) order."""
    return tuple(sorted(GEOMETRIES))


def geometry_index(name: str) -> int:
    """Canonical index of a geometry (see :func:`geometry_names`)."""
    try:
        return geometry_names().index(name)
    except ValueError:
        raise KeyError(f"unknown geometry {name!r}; "
                       f"known: {geometry_names()}") from None


def max_bodies() -> int:
    """The most bodies of any registered geometry: the per-body width of
    the geometry bank and of the per-body kernel."""
    return max(len(b) for b in GEOMETRIES.values())


@dataclass(frozen=True)
class GridConfig:
    res: int = 16                 # cells per diameter
    re: float = 100.0
    dt: float = 0.005
    u_mean: float = 1.0           # mean inlet velocity (Um = 1.5 * u_mean)
    poisson_iters: int = 60
    poisson_omega: float = 1.7    # SOR relaxation
    penal_eta: float = 2e-4       # volume-penalization time scale
    upwind_blend: float = 0.2     # 0 = central advection, 1 = full upwind

    @property
    def nx(self) -> int:
        return int(round(LX * self.res))

    @property
    def ny(self) -> int:
        # keep even for red-black tiling
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
        return 1.5 * self.u_mean  # parabolic profile peak


def cell_centers(cfg: GridConfig) -> Tuple[np.ndarray, np.ndarray]:
    x = X0 + (np.arange(cfg.nx) + 0.5) * cfg.dx
    y = -H / 2 + (np.arange(cfg.ny) + 0.5) * cfg.dy
    return x, y


def inlet_profile(cfg: GridConfig, y: np.ndarray) -> np.ndarray:
    """Parabolic U_inlet(y) = Um (H-2y)(H+2y)/H^2, eq. (3)."""
    um = cfg.u_max
    return um * (H - 2 * y) * (H + 2 * y) / H ** 2


def _smoothed_solid(xx, yy, dx, cx=CYL_X, cy=CYL_Y, radius=RADIUS
                    ) -> np.ndarray:
    """chi in [0,1]: 1 inside the cylinder, smoothed over ~1 cell."""
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    eps = 0.5 * dx
    return np.clip(0.5 * (1 - (r - radius) / eps), 0.0, 1.0)


def _rotary_shell(xx, yy, dx, cx=CYL_X, cy=CYL_Y, radius=RADIUS):
    """Rigid-rotation target per unit surface speed ``(rot_x, rot_y)`` and
    its penalization mask: 1 out to r = R + 0.25 dx, tapering linearly to 0
    at R + 0.75 dx."""
    rx, ry = xx - cx, yy - cy
    r = np.sqrt(rx ** 2 + ry ** 2) + 1e-12
    tx, ty = -ry / r, rx / r
    rmask = np.clip((radius + 0.75 * dx - r) / (0.5 * dx), 0.0, 1.0)
    mag = np.clip(r / radius, 0.0, 1.0) * rmask
    return mag * tx, mag * ty, rmask


def _jet_shell(xx, yy, dx):
    """Jet actuation targets on the surface band within each jet arc.

    The 10-degree arc is widened to cover >= 3 cells at coarse resolution
    and the velocity rescaled to conserve the physical jet's mass flux.
    Returns (profile (2,ny,nx), normal_x, normal_y, jmask (ny,nx))."""
    rx, ry = xx - CYL_X, yy - CYL_Y
    r = np.sqrt(rx ** 2 + ry ** 2) + 1e-12
    theta = np.degrees(np.arctan2(ry, rx)) % 360.0
    shell = ((r - RADIUS) > -1.5 * dx) & ((r - RADIUS) < 0.75 * dx)
    nxv, nyv = rx / r, ry / r
    width_eff = max(JET_WIDTH_DEG, np.degrees(3.0 * dx / RADIUS))
    flux_scale = JET_WIDTH_DEG / width_eff
    profiles, jmask = [], np.zeros_like(r)
    for c in JET_CENTERS_DEG:
        d = np.abs((theta - c + 180.0) % 360.0 - 180.0)
        inside = d < width_eff / 2
        prof = np.clip(1.0 - (d / (width_eff / 2)) ** 2, 0.0, 1.0)
        prof = prof * inside * shell * flux_scale
        profiles.append(prof)
        jmask = np.maximum(jmask, (prof > 0).astype(np.float64))
    return np.stack(profiles), nxv, nyv, jmask


@dataclass(frozen=True)
class Geometry:
    """Static precomputed fields (numpy), in ``solver.GeomArrays`` order.

    ``rotb_u[b]`` is body *b*'s rotary target per unit surface speed (zero
    outside its penalization band); ``own_u[b]`` is a nearest-body one-hot
    partition of unity that splits the penalization force into per-body
    C_D / C_L.  For the single cylinder they are ``rot_*`` and all ones."""
    chi_u: np.ndarray        # (ny, nx+1) solid fraction at u faces
    chi_v: np.ndarray        # (ny+1, nx) solid fraction at v faces
    jet_u: np.ndarray        # (2, ny, nx+1) jet direction*profile at u faces
    jet_v: np.ndarray        # (2, ny+1, nx) jet direction*profile at v faces
    jmask_u: np.ndarray      # (ny, nx+1) jet penalization mask at u faces
    jmask_v: np.ndarray      # (ny+1, nx) jet penalization mask at v faces
    rot_u: np.ndarray        # (ny, nx+1) rotary target (x comp) per unit speed
    rot_v: np.ndarray        # (ny+1, nx) rotary target (y comp) per unit speed
    rmask_u: np.ndarray      # (ny, nx+1) rotary penalization mask at u faces
    rmask_v: np.ndarray      # (ny+1, nx) rotary penalization mask at v faces
    inlet_u: np.ndarray      # (ny,) parabolic inlet profile at u rows
    probe_ij: np.ndarray     # (149, 2) float cell-index coords of probes
    cell_volume: float
    name: str = "cylinder"   # GEOMETRIES key this was built from
    rotb_u: np.ndarray = None  # (B, ny, nx+1) per-body rotary target (x comp)
    rotb_v: np.ndarray = None  # (B, ny+1, nx) per-body rotary target (y comp)
    own_u: np.ndarray = None   # (B, ny, nx+1) nearest-body partition of unity
    own_v: np.ndarray = None   # (B, ny+1, nx) nearest-body partition of unity

    @property
    def n_bodies(self) -> int:
        return len(GEOMETRIES[self.name])


def _ownership(xx, yy, bodies) -> np.ndarray:
    """(B, ny, nx) nearest-body one-hot partition of unity (ties -> the
    first body, so the stack sums to exactly 1 at every cell)."""
    d = np.stack([np.sqrt((xx - b.x) ** 2 + (yy - b.y) ** 2) - b.r
                  for b in bodies])
    nearest = np.argmin(d, axis=0)
    return np.stack([(nearest == i).astype(np.float64)
                     for i in range(len(bodies))])


def build_geometry(cfg: GridConfig, geometry: str = "cylinder") -> Geometry:
    if geometry not in GEOMETRIES:
        raise KeyError(f"unknown geometry {geometry!r}; "
                       f"known: {geometry_names()}")
    bodies = GEOMETRIES[geometry]
    dx, dy = cfg.dx, cfg.dy
    xc, yc = cell_centers(cfg)
    # u faces: x at i*dx + X0, y at centers
    xu = X0 + np.arange(cfg.nx + 1) * dx
    yu = yc
    xxu, yyu = np.meshgrid(xu, yu)
    # v faces: x at centers, y at -H/2 + j*dy
    xv = xc
    yv = -H / 2 + np.arange(cfg.ny + 1) * dy
    xxv, yyv = np.meshgrid(xv, yv)

    # solid fraction: the union (max) over bodies, the identity for one
    chi_u = np.maximum.reduce([_smoothed_solid(xxu, yyu, dx, b.x, b.y, b.r)
                               for b in bodies])
    chi_v = np.maximum.reduce([_smoothed_solid(xxv, yyv, dx, b.x, b.y, b.r)
                               for b in bodies])

    if geometry == "cylinder":
        # synthetic jets are carved into the classic cylinder only
        ju_prof, nx_u, _, jmask_u = _jet_shell(xxu, yyu, dx)
        jv_prof, _, ny_v, jmask_v = _jet_shell(xxv, yyv, dx)
        # jet target velocity: outward normal component * parabolic profile
        jet_u = ju_prof * nx_u[None]
        jet_v = jv_prof * ny_v[None]
    else:
        jet_u = np.zeros((2,) + xxu.shape)
        jet_v = np.zeros((2,) + xxv.shape)
        jmask_u = np.zeros(xxu.shape)
        jmask_v = np.zeros(xxv.shape)

    # per-body rotary targets; distinct bodies' penalization bands never
    # overlap (gap >= 0.5D against a ~0.75 dx band), so the union mask and
    # the summed target give each body its rotating-wall BC
    rotb_u, rotb_v, rmasks_u, rmasks_v = [], [], [], []
    for b in bodies:
        ru, _, rmu = _rotary_shell(xxu, yyu, dx, b.x, b.y, b.r)
        _, rv, rmv = _rotary_shell(xxv, yyv, dx, b.x, b.y, b.r)
        rotb_u.append(ru)
        rotb_v.append(rv)
        rmasks_u.append(rmu)
        rmasks_v.append(rmv)
    rotb_u = np.stack(rotb_u)
    rotb_v = np.stack(rotb_v)
    rmask_u = np.maximum.reduce(rmasks_u)
    rmask_v = np.maximum.reduce(rmasks_v)
    # the single-field target: every body co-rotating at one speed
    rot_u = np.sum(rotb_u, axis=0)
    rot_v = np.sum(rotb_v, axis=0)

    own_u = _ownership(xxu, yyu, bodies)
    own_v = _ownership(xxv, yyv, bodies)

    inlet_u = inlet_profile(cfg, yu)
    probe_ij = points_to_ij(cfg, probe_positions())
    return Geometry(chi_u=chi_u, chi_v=chi_v, jet_u=jet_u, jet_v=jet_v,
                    jmask_u=jmask_u, jmask_v=jmask_v,
                    rot_u=rot_u, rot_v=rot_v,
                    rmask_u=rmask_u, rmask_v=rmask_v,
                    inlet_u=inlet_u, probe_ij=probe_ij, cell_volume=dx * dy,
                    name=geometry, rotb_u=rotb_u, rotb_v=rotb_v,
                    own_u=own_u, own_v=own_v)


def points_to_ij(cfg: GridConfig, pts: np.ndarray) -> np.ndarray:
    """(P, 2) physical (x, y) -> (P, 2) fractional cell-center [row=j, col=i]
    coordinates for :func:`repro_torch.cfd.probes.sample_pressure`."""
    pi = (pts[:, 0] - (X0 + 0.5 * cfg.dx)) / cfg.dx
    pj = (pts[:, 1] - (-H / 2 + 0.5 * cfg.dy)) / cfg.dy
    return np.stack([pj, pi], axis=-1)


def probe_positions() -> np.ndarray:
    """149 probes: 72 on three rings around the cylinder + 77 wake grid
    (7 x 11), following the layout style of Wang et al. 2022 (Fig. 3)."""
    pts = []
    for r in (0.6, 0.8, 1.0):
        for k in range(24):
            a = 2 * np.pi * k / 24
            pts.append((CYL_X + r * np.cos(a), CYL_Y + r * np.sin(a)))
    xs = np.linspace(1.2, 9.0, 11)
    ys = np.linspace(-1.2, 1.2, 7)
    for x in xs:
        for y in ys:
            pts.append((x, y))
    out = np.asarray(pts, dtype=np.float64)
    if out.shape != (149, 2):
        raise AssertionError(f"probe layout has shape {out.shape}")
    return out
