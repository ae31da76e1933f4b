"""Synthetic scenes with known ground truth (numpy only).

Copies of ``objective_slam_tpu.utils.synthetic`` (synthetic.py:17-266)
— the same random draws in the same order, so the same seed gives the
same arrays — plus ``bin_picking_scene``, a copy of ``bench.build_scene``
(bench.py:89-138), and the UWA-analog models and scenes of
``tools/run_uwa_analog.py`` (``build_models``, ``build_scene``, :44-69,
135-201, with ``MODEL_DIAMS`` of ``tools/analyze_uwa.py:28-33``) and its
real-mesh models (``build_models_real``, :79-119). The port cannot import
any of them: they import jax.
"""

from __future__ import annotations

import math
from pathlib import Path

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


_ICO_T = (1.0 + math.sqrt(5.0)) / 2.0
_ICO_VERTS = np.array([
    [-1, _ICO_T, 0], [1, _ICO_T, 0], [-1, -_ICO_T, 0], [1, -_ICO_T, 0],
    [0, -1, _ICO_T], [0, 1, _ICO_T], [0, -1, -_ICO_T], [0, 1, -_ICO_T],
    [_ICO_T, 0, -1], [_ICO_T, 0, 1], [-_ICO_T, 0, -1], [-_ICO_T, 0, 1],
], np.float64)
_ICO_FACES = np.array([
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
], np.int64)


def bumpy_mesh(subdiv: int = 3, bumps: float = 0.3):
    """A closed triangle mesh (subdivided icosahedron with the same radial
    bump field as blob_cloud) — a real mesh-derived test shape with faces,
    standing in for the reference's PLY mesh models
    (matlab/compute_normals.m consumes exactly this kind of input).

    Returns (vertices (n,3) f32, faces (m,3) int32)."""
    verts = _ICO_VERTS / np.linalg.norm(_ICO_VERTS, axis=1, keepdims=True)
    faces = _ICO_FACES
    for _ in range(subdiv):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    radii = _bump_field(verts, bumps)
    return ((verts * radii[:, None]).astype(np.float32),
            faces.astype(np.int32))


def torus_mesh(nu: int = 64, nv: int = 32, major: float = 1.0,
               minor: float = 0.4, wobble: float = 0.35):
    """Closed genus-1 triangle mesh (torus) — a structurally distinct test
    shape for the UWA-analog occlusion study (its surface has no spherical
    topology, unlike the bumpy blobs; PPF feature statistics differ
    qualitatively). `wobble` varies the tube radius and lifts the tube
    center along the ring ASYMMETRICALLY — a perfect torus is rotationally
    symmetric about its axis, which makes 'the' 6-DoF pose ill-posed for
    validation. Returns (vertices (nu·nv, 3) f32, faces int32)."""
    iu = np.arange(nu)
    iv = np.arange(nv)
    u = 2.0 * np.pi * iu / nu
    v = 2.0 * np.pi * iv / nv
    uu, vv = np.meshgrid(u, v, indexing="ij")           # (nu, nv)
    r_u = minor * (1.0 + wobble * (0.6 * np.sin(3 * uu)
                                   + 0.4 * np.cos(2 * uu + 1.0)))
    x = (major + r_u * np.cos(vv)) * np.cos(uu)
    y = (major + r_u * np.cos(vv)) * np.sin(uu)
    z = r_u * np.sin(vv) + wobble * 0.4 * minor * np.sin(2 * uu + 0.5)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces += [[a, b, c], [a, c, d]]
    return (verts.astype(np.float32), np.asarray(faces, np.int32))


def superellipsoid_mesh(subdiv: int = 4, p: float = 4.0,
                        bumps: float = 0.0):
    """Closed rounded-box triangle mesh: the unit icosphere remapped onto
    the p-norm unit ball (p = 4 gives a box with rounded edges — flat
    faces + sharp creases, the opposite feature regime from the blobs).
    Optional radial bumps on top. Returns (vertices f32, faces int32)."""
    verts, faces = bumpy_mesh(subdiv=subdiv, bumps=0.0)
    verts = verts.astype(np.float64)
    unit = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    s = (np.abs(unit) ** p).sum(axis=1) ** (-1.0 / p)
    out = unit * s[:, None]
    if bumps > 0:
        out = out * _bump_field(unit, bumps)[:, None]
    return out.astype(np.float32), faces


def partial_view(points, normals, viewpoint, res: int = 96,
                 depth_tol: float = 0.05):
    """Self-occlusion culling: keep the points a sensor at `viewpoint`
    actually sees — back-face cull, then a z-buffer over an image grid
    keeps only points within depth_tol·range of the nearest hit per pixel.
    The partial-view generator for occlusion studies (the reference's UWA
    scenes are real partial scans; SURVEY.md §4.5)."""
    p = np.asarray(points, np.float64)
    nr = np.asarray(normals, np.float64)
    vp = np.asarray(viewpoint, np.float64)
    to_vp = vp - p
    depth = np.linalg.norm(to_vp, axis=1)
    front = np.sum(nr * to_vp, axis=1) > 0

    z = p.mean(axis=0) - vp
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    rel = p - vp
    d = rel @ z
    u = (rel @ x) / np.maximum(d, 1e-9)
    v = (rel @ y) / np.maximum(d, 1e-9)
    ui = np.clip(((u - u.min()) / max(np.ptp(u), 1e-9)
                  * (res - 1)).astype(int), 0, res - 1)
    vi = np.clip(((v - v.min()) / max(np.ptp(v), 1e-9)
                  * (res - 1)).astype(int), 0, res - 1)
    pix = ui * res + vi
    zbuf = np.full(res * res, np.inf)
    np.minimum.at(zbuf, pix[front], depth[front])
    visible = front & (depth <= zbuf[pix] * (1.0 + depth_tol))
    return visible


def look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """World→camera 4×4 (T_cw) for a camera at `eye` looking at `target`
    (camera convention: +z forward, +x right, +y down)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    if np.linalg.norm(right) < 1e-9:
        right = np.cross(fwd, [1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=1)     # camera axes in world
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ eye
    return T


def render_depth(points, T_cw, intrinsics, shape):
    """Z-buffer a point cloud into a depth image — the synthetic RGB-D
    sensor of the TSDF path (min camera depth per pixel; 0 = no hit).
    Returns (h, w) float32."""
    h, w = shape
    fx, fy, cx, cy = intrinsics
    T = np.asarray(T_cw, np.float64)
    pc_ = np.asarray(points, np.float64) @ T[:3, :3].T + T[:3, 3]
    z = pc_[:, 2]
    front = z > 1e-6
    u = np.round(fx * pc_[:, 0] / np.maximum(z, 1e-9) + cx).astype(int)
    v = np.round(fy * pc_[:, 1] / np.maximum(z, 1e-9) + cy).astype(int)
    ok = front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    depth = np.full(h * w, np.inf)
    np.minimum.at(depth, v[ok] * w + u[ok], z[ok])
    depth[~np.isfinite(depth)] = 0.0
    return depth.reshape(h, w).astype(np.float32)


# The UWA dataset's model diameters (analyze_mian.py:42-47), as
# tools/analyze_uwa.py holds them; the UWA-analog models are scaled to them.
MODEL_DIAMS = {
    "chef": 136.59418,
    "trex": 98.828925,
    "para": 131.250275,
    "chicken": 86.28052,
}
N_TOTAL = 26_000           # raw points of every UWA-analog scene
SCENE_LEAF_FACTOR = 0.075  # scene voxel leaf / largest model diameter


def uwa_analog_models():
    """The four UWA-analog meshes at the UWA diameters
    (run_uwa_analog.py:50-69). Returns {name: (verts, faces)}."""
    out = {}
    v, f = bumpy_mesh(subdiv=4, bumps=0.35)
    out["chef"] = (v, f)
    v, f = bumpy_mesh(subdiv=4, bumps=0.5)
    out["trex"] = (v * np.float32([1.0, 0.45, 0.4]), f)     # elongated
    out["para"] = torus_mesh()                               # genus 1
    out["chicken"] = superellipsoid_mesh(subdiv=4, p=4.0, bumps=0.2)
    for name, (v, f) in out.items():
        d = float((v.max(axis=0) - v.min(axis=0)).max())
        out[name] = ((v * (MODEL_DIAMS[name] / d)).astype(np.float32), f)
    return out


# Laser-scanned skeleton meshes (binary STL) that stand for the UWA models
# in the real-mesh run: name -> (file, the UWA diameter it is scaled to).
REAL_MESHES = {
    "skull": ("BONEMergedSkull.stl", 136.59418),
    "pelvis": ("BONEPelvis.stl", 131.250275),
    "humerus": ("BONEhumerus_L.stl", 98.828925),
    "scapula": ("BONEScapula_L.stl", 86.28052),
}
REAL_MODEL_DIAMS = {name: diam for name, (_, diam) in REAL_MESHES.items()}
# The package's copy of those meshes (dm_control 1.0.43, Apache-2.0; see
# the NOTICE there).
REAL_MESH_DIR = Path(__file__).resolve().parent.parent / "assets" / \
    "dog_bones"


def uwa_real_models(mesh_dir=REAL_MESH_DIR, n_samples: int = 6000,
                    seed: int = 123):
    """The four scanned bone meshes of REAL_MESHES, read from `mesh_dir`,
    scaled to their UWA diameters and sampled uniformly by area with
    interpolated normals (run_uwa_analog.py:89-119; the raw vertices of
    these decimated meshes crowd at high curvature). Raises
    FileNotFoundError when a mesh is missing. Pass REAL_MODEL_DIAMS to
    uwa_analog_scene as `diams`.

    Returns ({name: (points, None)}, {name: normals})."""
    from objective_slam_tpu_torch.utils import ply, pointcloud as pc

    rng = np.random.default_rng(seed)
    out, normals = {}, {}
    for name, (fname, diam) in REAL_MESHES.items():
        path = Path(mesh_dir) / fname
        if not path.exists():
            raise FileNotFoundError(f"real mesh not found: {path}")
        v, f = ply.read_stl(path)
        v = (v * (diam / pc.bbox_diameter(v))).astype(np.float32)
        sp, normals[name] = pc.sample_mesh_surface(v, f, n_samples, rng)
        out[name] = (sp, None)
    return out, normals


def uwa_analog_scene(rng, models, normals, diams=None):
    """One cluttered UWA-analog scene holding a partial view of every model
    at a random pose, N_TOTAL points in all (run_uwa_analog.py:135-201).
    `diams` adds model diameters to MODEL_DIAMS (the real-mesh models').
    Returns (scene_pts, scene_nrm, {name: (T_true, occlusion %)})."""
    diams = {**MODEL_DIAMS, **(diams or {})}
    scale = max(diams.values())
    views = {}
    for name, (verts, _faces) in models.items():
        nrm = normals[name]
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        vis = partial_view(verts, nrm, d * 4.0 * diams[name])
        # An extra half-space cut spreads occlusion over ~55-85 %.
        extra = rng.uniform(0.0, 0.55)
        if extra > 0.02:
            cut_d = rng.normal(size=3)
            cut_d /= np.linalg.norm(cut_d)
            proj = (verts - verts.mean(axis=0)) @ cut_d
            lim = np.quantile(proj[vis], 1.0 - extra)
            vis = vis & (proj <= lim)
        views[name] = (verts[vis], nrm[vis],
                       100.0 * (1.0 - float(vis.mean())))

    # Planar clutter fills the budget before planting (plant_model centres
    # poses on the current scene centroid).
    n_clutter = N_TOTAL - sum(len(v[0]) for v in views.values())
    per = n_clutter // 6
    parts_p, parts_n = [], []
    for b in range(6):
        cnt = per if b < 5 else n_clutter - 5 * per
        u = rng.uniform(-0.8, 0.8, size=(cnt, 2)) * scale
        z = rng.normal(scale=0.004 * scale, size=(cnt, 1))
        pts = np.concatenate([u, z], axis=1)
        R = quat_to_matrix(random_rotation_quat(rng))
        off = rng.uniform(-1.0, 1.0, size=3) * scale
        parts_p.append((pts @ R.T + off).astype(np.float32))
        parts_n.append(np.tile(R[:, 2].astype(np.float32), (cnt, 1)))
    sp = np.concatenate(parts_p).astype(np.float32)
    sn = np.concatenate(parts_n).astype(np.float32)

    truths = {}
    centers = []
    placed = []
    for name, (vp_, vn_, occl) in views.items():
        # Non-overlapping placement: pairwise gap > 1.05 mean diameters.
        while True:
            t = rng.uniform(-1.1, 1.1, size=3).astype(np.float32) * scale
            if all(np.linalg.norm(t - c) >
                   0.55 * (diams[name] + diams[o]) * 1.05
                   for c, o in zip(centers, placed)):
                break
        centers.append(t)
        placed.append(name)
        sp, sn, T = plant_model(rng, vp_, vn_, sp, sn, translation=t)
        truths[name] = (T, occl)
    return sp.astype(np.float32), sn.astype(np.float32), truths
