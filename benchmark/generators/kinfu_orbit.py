"""Scene and sensor generator `kinfu_orbit`: a hand-held RGB-D scan of a
tabletop, as KinectFusion's users make one.

The scene, in the volume's frame (the cube centred on the origin, z up):
a table whose top (1.2 × 0.8 × 0.04 m) lies at z = 0 on four legs over a
floor disc at z = −0.75 in a round room (a cylindrical wall on the
floor's rim, beyond the volume), the bumpy object of the TSDF smoke
(`frozen/scenes.bumpy_mesh`) at the table's centre, and three boxy
clutter objects (`superellipsoid_mesh`) around it, each resting on the
table. Every surface is a triangle mesh, sampled by area.

The sensor: a pinhole camera on an orbit around the table (radius, height
and target from the configuration), `deg_per_frame` degrees a frame. A
frame is the z-buffer of the surface samples on the render device
(`scatter_reduce("amin")`), each surface sampled densely enough for its
nearest view that a pixel expects `points_per_pixel` samples, then axial
noise σ(z) = a + b·(z − z0)² m (Nguyen, Izadi & Lovell, 3DIMPVT 2012)
drawn once per frame. A frame whose clean depth leaves more than 1% of
its seen pixels empty (pinholes: an empty pixel whose four neighbours
all hold a depth), or holds a depth outside [0.5, 4] m, raises.

Everything is drawn from the pool seed the caller gives, so the frames are
the same in every run on one device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.frozen import scenes

MAX_SAMPLES = 80_000_000        # a scene needing more is misconfigured
PINHOLE_SHARE = 0.01
DEPTH_RANGE = (0.5, 4.0)


class Frame(NamedTuple):
    depth: np.ndarray       # (h, w) float32 metres, 0 = no measurement
    T_cw: np.ndarray        # (4, 4) float32 world→camera, the true pose
    pinholes: float         # share of the seen pixels left empty (clean)


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World→camera (+z forward, +x right, +y down), float32."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])            # rows: camera axes
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ eye
    return T.astype(np.float32)


def orbit_pose(orbit: dict, deg: float) -> np.ndarray:
    a = math.radians(deg)
    r = float(orbit["radius"])
    eye = (r * math.cos(a), r * math.sin(a), float(orbit["height"]))
    return look_at(eye, (0.0, 0.0, float(orbit["target_height"])))


def _box(centre, size, bottom=True):
    """Triangles (n, 3, 3) of an axis-aligned box's faces."""
    c = np.asarray(centre, np.float64)
    hx, hy, hz = np.asarray(size, np.float64) / 2
    v = np.array([[x, y, z] for x in (-hx, hx) for y in (-hy, hy)
                  for z in (-hz, hz)]) + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (1, 5, 7, 3)] + ([(0, 2, 6, 4)] if bottom else [])
    tris = [(q[0], q[1], q[2]) for q in quads] + \
        [(q[0], q[2], q[3]) for q in quads]
    return v[np.asarray(tris)]


def _disc(z, radius, segments=96):
    a = np.linspace(0.0, 2.0 * math.pi, segments + 1)
    rim = np.stack([radius * np.cos(a), radius * np.sin(a),
                    np.full_like(a, z)], -1)
    centre = np.array([0.0, 0.0, z])
    return np.stack([np.broadcast_to(centre, rim[:-1].shape), rim[:-1],
                     rim[1:]], 1)


def _wall(z0, z1, radius, segments=96):
    """Triangles of a vertical cylinder's side."""
    a = np.linspace(0.0, 2.0 * math.pi, segments + 1)
    ring = np.stack([radius * np.cos(a), radius * np.sin(a)], -1)

    def at(z, k):
        return np.concatenate([ring[k], np.full((segments, 1), z)], -1)

    lo0, lo1 = at(z0, slice(0, -1)), at(z0, slice(1, None))
    hi0, hi1 = at(z1, slice(0, -1)), at(z1, slice(1, None))
    return np.concatenate([np.stack([lo0, lo1, hi1], 1),
                           np.stack([lo0, hi1, hi0], 1)])


def _mesh(verts, faces, scale, yaw, offset):
    """A mesh scaled per axis, turned about z and moved to rest its lowest
    point on z = offset[2]."""
    v = np.asarray(verts, np.float64) * np.asarray(scale, np.float64)
    c, s = math.cos(yaw), math.sin(yaw)
    v = v @ np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]).T
    v[:, 2] -= v[:, 2].min()
    v += np.asarray(offset, np.float64)
    return v[np.asarray(faces, np.int64)]


def scene(params: dict, rng) -> list:
    """The surfaces: a list of triangle arrays (n, 3, 3), one a piece."""
    t = params["table"]
    L, Wd, th = t["top"]
    hgt, leg = float(t["height"]), float(t["leg"])
    pieces = [_box((0.0, 0.0, -th / 2), (L, Wd, th), bottom=False)]
    for sx in (-1, 1):
        for sy in (-1, 1):
            pieces.append(_box(
                (sx * (L / 2 - leg), sy * (Wd / 2 - leg),
                 -th - (hgt - th) / 2), (leg, leg, hgt - th)))
    room = float(params["floor_radius"])
    pieces.append(_disc(-hgt, room))
    pieces.append(_wall(-hgt, -hgt + float(params["wall_height"]), room))
    o = params["object"]
    v, f = scenes.bumpy_mesh(subdiv=int(o["subdiv"]),
                             bumps=float(o["bumps"]))
    r = float(np.linalg.norm(v, axis=1).max())
    pieces.append(_mesh(v, f, [float(o["radius"]) / r] * 3, 0.0,
                        (0.0, 0.0, 0.0)))
    c = params["clutter"]
    for i in range(int(c["count"])):
        v, f = scenes.superellipsoid_mesh(subdiv=3, p=4.0,
                                          bumps=0.05 * (i + 1))
        a = 2.0 * math.pi * i / int(c["count"]) + 0.5
        sx, sy, sz = c["half_extent"]
        pieces.append(_mesh(
            v, f, (sx, sy + float(c["grow"]) * i, sz),
            float(rng.uniform(0.0, 2.0 * math.pi)),
            (c["ring"][0] * math.cos(a), c["ring"][1] * math.sin(a), 0.0)))
    return pieces


def _nearest_depth(tris, poses, K, shape) -> float:
    """The least camera depth at which any pose sees a vertex or centroid
    of the piece inside its image."""
    fx, fy, cx, cy = K
    h, w = shape
    pts = np.concatenate([tris.reshape(-1, 3), tris.mean(1)])
    best = math.inf
    for T in poses:
        p = pts @ T[:3, :3].T.astype(np.float64) + T[:3, 3]
        z = p[:, 2]
        ok = z > 1e-6
        u = fx * p[ok, 0] / z[ok] + cx
        v = fy * p[ok, 1] / z[ok] + cy
        inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        if inside.any():
            best = min(best, float(z[ok][inside].min()))
    return best


def sample(pieces, poses, K, shape, per_pixel: float, seed: int, device):
    """Area-uniform samples (n, 3) of every piece seen by some pose, at a
    density that gives `per_pixel` samples a pixel at the piece's nearest
    depth."""
    fx = max(K[0], K[1])
    g = torch.Generator(device=device)
    out, total = [], 0
    for i, tris in enumerate(pieces):
        z = _nearest_depth(tris, poses, K, shape)
        if not math.isfinite(z):
            continue
        area = 0.5 * np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0],
                                             tris[:, 2] - tris[:, 0]), axis=1)
        n = int(math.ceil(per_pixel * (fx / z) ** 2 * area.sum()))
        total += n
        if total > MAX_SAMPLES:
            raise ValueError(f"kinfu_orbit: {total} samples needed")
        g.manual_seed(seed * 1000 + i)
        t = torch.as_tensor(tris, dtype=torch.float32, device=device)
        pick = torch.multinomial(torch.as_tensor(area, device=device), n,
                                 replacement=True, generator=g)
        r1 = torch.sqrt(torch.rand(n, generator=g, device=device))
        r2 = torch.rand(n, generator=g, device=device)
        tri = t[pick]
        out.append((1 - r1)[:, None] * tri[:, 0]
                   + (r1 * (1 - r2))[:, None] * tri[:, 1]
                   + (r1 * r2)[:, None] * tri[:, 2])
    return torch.cat(out)


def render(points, T_cw, K, shape):
    """Z-buffer: the least camera depth of the samples in each pixel, 0
    where none lands; and the share of seen pixels left as pinholes."""
    h, w = shape
    fx, fy, cx, cy = K
    T = torch.as_tensor(T_cw, dtype=torch.float32, device=points.device)
    p = points @ T[:3, :3].T + T[:3, 3]
    z = p[:, 2]
    zc = torch.clamp(z, min=1e-6)
    u = torch.round(fx * p[:, 0] / zc + cx)
    v = torch.round(fy * p[:, 1] / zc + cy)
    ok = (z > 1e-6) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    flat = (v[ok] * w + u[ok]).to(torch.int64)
    zbuf = torch.full((h * w,), math.inf, device=points.device)
    zbuf.scatter_reduce_(0, flat, z[ok], "amin")
    depth = torch.where(torch.isfinite(zbuf), zbuf, 0.0).reshape(h, w)
    full = depth > 0
    inner = torch.zeros_like(full)
    inner[1:-1, 1:-1] = (full[:-2, 1:-1] & full[2:, 1:-1]
                         & full[1:-1, :-2] & full[1:-1, 2:])
    holes = int((inner & ~full).sum())
    seen = int(full.sum()) + holes
    return depth, holes / max(seen, 1)


def noisy(depth, noise: dict, seed: int):
    """Axial noise σ(z) = a + b·(z − z0)² on every measured pixel."""
    g = torch.Generator(device=depth.device)
    g.manual_seed(seed)
    n = torch.randn(depth.shape, generator=g, device=depth.device)
    sigma = float(noise["a"]) + float(noise["b"]) * (
        depth - float(noise["z0"])) ** 2
    return torch.where(depth > 0, depth + sigma * n, 0.0)


def make(params: dict, K, shape, posed: int, segment: int, seed: int,
         device) -> tuple:
    """(posed frames, segment frames): `posed` frames spread evenly around
    the orbit, then `segment` consecutive frames from angle 0."""
    orbit = params["orbit"]
    step = float(orbit["deg_per_frame"])
    poses = [orbit_pose(orbit, 360.0 * k / posed) for k in range(posed)] \
        + [orbit_pose(orbit, step * f) for f in range(segment)]
    pieces = scene(params, np.random.default_rng([seed, 0]))
    pts = sample(pieces, poses, K, shape, float(params["points_per_pixel"]),
                 seed, device)
    frames = []
    for i, T in enumerate(poses):
        depth, holes = render(pts, T, K, shape)
        if holes > PINHOLE_SHARE:
            raise ValueError(f"kinfu_orbit: frame {i} leaves {holes:.4f} "
                             "of its seen pixels empty")
        seen = depth[depth > 0]
        lo, hi = float(seen.min()), float(seen.max())
        if lo < DEPTH_RANGE[0] or hi > DEPTH_RANGE[1]:
            raise ValueError(f"kinfu_orbit: frame {i} sees depths "
                             f"{lo:.3f}-{hi:.3f} m")
        d = noisy(depth, params["noise"], seed * 1000 + 500 + i)
        frames.append(Frame(d.cpu().numpy().astype(np.float32), T, holes))
    return frames[:posed], frames[posed:]
