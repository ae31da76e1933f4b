"""Synthetic scenes with known ground truth (numpy only).

Copies of ``objective_slam_tpu.utils.synthetic`` (synthetic.py:17-96, 266)
— the same random draws in the same order, so the same seed gives the same
arrays — plus ``bin_picking_scene``, a copy of ``bench.build_scene``
(bench.py:89-138). The port cannot import either: both import jax.
"""

from __future__ import annotations

import math

import numpy as np


def random_rotation_quat(rng) -> np.ndarray:
    """Shoemake uniform random quaternion (w, x, y, z)
    (scene_generation.hpp:33-51)."""
    x0, x1, x2 = rng.uniform(size=3)
    th1, th2 = 2 * math.pi * x1, 2 * math.pi * x2
    r1, r2 = math.sqrt(1 - x0), math.sqrt(x0)
    return np.array([math.sin(th1) * r1, math.cos(th1) * r1,
                     math.sin(th2) * r2, math.cos(th2) * r2], np.float32)


def quat_to_matrix(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _bump_field(v, bumps: float):
    """Radial bump field; the z term breaks the 180° symmetry about x."""
    return 1.0 + bumps * (np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
                          + 0.7 * np.sin(2 * v[:, 2] + 1.0)
                          * np.cos(2 * v[:, 0]))


def blob_cloud(rng, n: int, bumps: float = 0.3):
    """A bumpy star-convex blob with outward (radial) normals."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    radii = _bump_field(v, bumps)
    return (v * radii[:, None]).astype(np.float32), v.astype(np.float32)


def plant_model(rng, model_points, model_normals, scene_points=None,
                scene_normals=None, translation=None, quat=None):
    """Place the model into a scene at a (random) rigid pose:
    T = Trans(scene_centroid) · Trans(t) · Rot(q) · Trans(−model_centroid)
    (scene_generation.hpp:54-86). Returns (points, normals, T_true)."""
    mp = np.asarray(model_points, np.float32)
    mn = np.asarray(model_normals, np.float32)
    if translation is None:
        translation = rng.uniform(size=3).astype(np.float32)
    if quat is None:
        quat = random_rotation_quat(rng)
    mc = mp.mean(axis=0)
    if scene_points is None:
        sc = np.zeros(3, np.float32)
        sp = np.zeros((0, 3), np.float32)
        sn = np.zeros((0, 3), np.float32)
    else:
        sp = np.asarray(scene_points, np.float32)
        sn = np.asarray(scene_normals, np.float32)
        sc = sp.mean(axis=0)

    R = quat_to_matrix(quat)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = sc + np.asarray(translation, np.float32) - R @ mc

    placed = mp @ R.T + T[:3, 3]
    placed_n = mn @ R.T
    out_p = np.concatenate([sp, placed]).astype(np.float32)
    out_n = np.concatenate([sn, placed_n]).astype(np.float32)
    return out_p, out_n, T


def clutter_cloud(rng, n: int, lo=-2.0, hi=4.0):
    """Uniform clutter points with random unit normals."""
    p = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    nr = rng.normal(size=(n, 3))
    nr /= np.linalg.norm(nr, axis=1, keepdims=True)
    return p, nr.astype(np.float32)


def bin_picking_scene(rng, mp_raw, mn_raw, n_total=100_000, n_instances=4,
                      n_inst_pts=15_000):
    """The bench scan (bench.py:89-138): `n_instances` instances of the
    model, at least a diameter apart, among eight planar clutter patches.
    Returns (points, normals, [T_true per instance])."""
    n_clutter = n_total - n_instances * n_inst_pts
    per = n_clutter // 8
    cps, cns = [], []
    for b in range(8):
        cnt = per if b < 7 else n_clutter - 7 * per
        u = rng.uniform(-1.5, 1.5, size=(cnt, 2))
        z = rng.normal(scale=0.01, size=(cnt, 1))
        pts = np.concatenate([u, z], axis=1)
        R = quat_to_matrix(random_rotation_quat(rng))
        offset = rng.uniform(-3.0, 5.0, size=3)
        cps.append(pts @ R.T + offset)
        nrm = np.tile(R[:, 2], (cnt, 1)) + rng.normal(scale=0.02,
                                                      size=(cnt, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        cns.append(nrm)
    sp = np.concatenate(cps).astype(np.float32)
    sn = np.concatenate(cns).astype(np.float32)

    diam = float(np.linalg.norm(mp_raw.max(0) - mp_raw.min(0)))
    truths = []
    centers = []
    for _ in range(n_instances):
        sel = rng.choice(len(mp_raw), size=n_inst_pts, replace=False)
        while True:
            t = rng.uniform(-2.5, 2.5, size=3).astype(np.float32)
            if all(np.linalg.norm(t - c) > diam for c in centers):
                break
        centers.append(t)
        sp, sn, T = plant_model(rng, mp_raw[sel], mn_raw[sel], sp, sn,
                                translation=t)
        truths.append(T)
    return sp, sn, truths
