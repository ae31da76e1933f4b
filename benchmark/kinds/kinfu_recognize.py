"""Deployment kind `kinfu_recognize`: an object-level SLAM session on one
card (SLAM++-style), each request one depth frame tracked and fused, and
every `recognize_every`-th frame of the segment followed by the recognition
of the scene's known objects on the fused surface.

It is `kinfu_track` (imported, unchanged) with recognition added. The
objects are the scene generator's own meshes (the last pieces of
``scene``: the bumpy object and the clutter), each described from
area-uniform samples of its mesh in the world frame, so that its true pose
is the identity. The program under test registers one model description
per object on the port's ``StreamingRecognizer`` at set-up; a recognition
request calls ``recognize()`` after ``track_depth_frame`` and ends with
every object's refined pose on the host. The frames on which it runs are
the same in every pass over the segment (frames 2, 5, ..., 23 at a cadence
of 3).

What decides `correct` is `judge`: (a) the camera's pose at each judged
request and the volume after the window's last completed recognition
request against the plain KinFu reference, as `kinfu_track` judges them;
(b) that request's extracted rows and normals against
frozen/surface_reference on the same volume; (c) each judged
recognition's matches, made on the program's own surface of that request
(kept on the host), against frozen/reference's plain PPF, with
`ppf_scan`'s numbers.
"""

from __future__ import annotations

import hashlib
import importlib
import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.frozen import reference as ref
from benchmark.frozen import scenes
from benchmark.frozen import surface_reference as sr
from benchmark.kinds import kinfu_track as kt
from benchmark.kinds import ppf_scan

POOL_SEED = kt.POOL_SEED


class Request(NamedTuple):
    scan: int           # the frame's place in the segment
    model: int          # always 0 (the metric readers key work on both)
    recognize: bool     # recognition follows the frame


class Outcome(NamedTuple):
    pose: np.ndarray            # (4, 4) float32 camera world→camera
    lost: bool
    matches: tuple | None       # ppf_scan.Outcome per object (host), or
    #                             None on a frame without recognition
    surface: tuple | None       # (points, normals) the program matched on
    capacity: int | None        # rows extracted (the program's counter)
    occupancy: int | None       # near-surface voxels (the counter)
    scene_points: dict | None   # object -> scene points after downsampling
    voxels: int                 # voxels of the volume


class Final(kt.Final):
    """The program's volume and surface after the window's last completed
    recognition request."""

    def __init__(self):
        super().__init__()
        self.surface = None
        self.capacity = None


def object_meshes(config) -> list:
    """Triangles (n, 3, 3) of the scene's objects, in the world frame: the
    last 1 + clutter count pieces of the generator's scene."""
    gen = importlib.import_module(
        f"benchmark.generators.{config['scene']['generator']}")
    pieces = gen.scene(config["scene"], np.random.default_rng([POOL_SEED, 0]))
    return pieces[-(1 + int(config["scene"]["clutter"]["count"])):]


def sample_mesh(tris, n: int, rng):
    """n area-uniform samples of a closed star-shaped mesh and their face
    normals, turned away from the mesh's centroid (float32)."""
    e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    cross = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    face = rng.choice(len(tris), size=n, p=area / area.sum())
    r1, r2 = np.sqrt(rng.random(n)), rng.random(n)
    t = tris[face]
    pts = ((1 - r1)[:, None] * t[:, 0] + (r1 * (1 - r2))[:, None] * t[:, 1]
           + (r1 * r2)[:, None] * t[:, 2])
    nrm = cross[face] / np.linalg.norm(cross[face], axis=1, keepdims=True)
    out = np.sum(nrm * (t.mean(axis=1) - tris.reshape(-1, 3).mean(0)), 1)
    nrm = np.where((out < 0)[:, None], -nrm, nrm)
    return pts.astype(np.float32), nrm.astype(np.float32)


class Inputs(kt.Inputs):
    """`kinfu_track`'s frames and settings, the objects' raw models and the
    cadence."""

    def __init__(self, config, traffic, seed: int):
        super().__init__(config, traffic, seed)
        self.final = Final()
        self.every = int(traffic["recognize_every"])
        objs = config["objects"]
        self.names = list(objs["names"])
        self.models = []
        for i, tris in enumerate(object_meshes(config)):
            p, n = sample_mesh(tris, int(objs["n_raw"]),
                               np.random.default_rng([POOL_SEED, 10 + i]))
            self.models.append({"points": p, "normals": n})
        if len(self.models) != len(self.names):
            raise ValueError(f"{len(self.names)} names for "
                             f"{len(self.models)} objects")
        self.tau_d = float(objs["tau_d"])
        self.d_dists = [self.tau_d * scenes.bbox_diameter(m["points"])
                        for m in self.models]

    def requests(self):
        """The segment's frames in order, replayed; recognition on frames
        every-1, 2·every-1, ..."""
        while True:
            for f in range(self.segment):
                yield Request(f, 0, f % self.every == self.every - 1)


def _host_match(res) -> ppf_scan.Outcome:
    """What ppf_scan.judge reads of a MatchResult, on the host."""
    return ppf_scan.Outcome(
        num_votes=res.num_votes.cpu(), votes=res.pose_votes.cpu(),
        poses=res.poses.cpu(), keep=res.pose_keep.cpu(),
        clustered=res.clustered_counts.cpu(),
        translations=res.clustered_translations.cpu(), pose=res.pose.cpu(),
        state_changed=None, ladder_steps=0.0, k1_launches=0, k2_launches=0)


class Deployment(kt.Deployment):
    """`kinfu_track`'s session with the objects registered."""

    def __init__(self, inputs: Inputs, device):
        super().__init__(inputs, device)
        from objective_slam_tpu_torch.config import PPFConfig
        from objective_slam_tpu_torch.models import drost
        from objective_slam_tpu_torch.utils import pointcloud

        self.rec.config = PPFConfig(**inputs.config["match"])
        for name, m, d in zip(inputs.names, inputs.models, inputs.d_dists):
            mp, mn = pointcloud.voxel_downsample_np(m["points"], m["normals"],
                                                    d)
            self.rec.register_model(name, drost.build_model_description(
                mp, mn, self.rec.config, d_dist=d, device=self.device))
        self._voxels = int(np.prod(inputs.dims))
        self._sync()

    def serve(self, req: Request) -> Outcome:
        """The frame as `kinfu_track` serves it; on a recognition frame then
        `recognize()`, ended by every object's pose on the host."""
        final = self.inputs.final
        held = (final.volume, final.frame)
        out = super().serve(req)
        if not req.recognize:
            final.volume, final.frame = held
            return Outcome(out.pose, out.lost, None, None, None, None, None,
                           self._voxels)
        res = self.rec.recognize()
        for r in res.values():
            r.pose.cpu()
        matches = tuple(res[n] for n in self.inputs.names)
        last = getattr(self.rec, "last_recognition", None)
        if last is None:        # a recognizer that keeps no counters
            return Outcome(out.pose, out.lost, matches, None, None, None,
                           None, self._voxels)
        final.surface = (last.points, last.normals)
        final.capacity = last.capacity
        return Outcome(out.pose, out.lost, matches, final.surface,
                       last.capacity, last.occupancy,
                       dict(last.scene_points), self._voxels)

    def retain(self, out: Outcome) -> Outcome:
        """Host copies of what the judge reads, taken once the request's
        latency is read. Where the program keeps no host surface of its
        recognition, its surface is extracted here again, outside the
        latency, from the same volume."""
        if out.matches is None:
            return out
        out = out._replace(matches=tuple(_host_match(r) for r in out.matches))
        if out.surface is None:
            from objective_slam_tpu_torch._common import to_numpy
            surf = self.rec.surface()
            ok = to_numpy(surf.valid)
            out = out._replace(surface=(to_numpy(surf.points)[ok],
                                        to_numpy(surf.normals)[ok]),
                               capacity=int(ok.shape[0]))
        final = self.inputs.final
        final.surface, final.capacity = out.surface, out.capacity
        return out


class _Matches:
    """frozen/reference's plain PPF on the program's surfaces, in the place
    of ppf_scan's Reference: `scan` numbers a surface, `model` an object.
    Each surface's scene is the program's recognition scene (its rows
    voxelized at the object's d_dist where d_dist exceeds 1.5 voxels, as
    `recognize` samples it), ICP's target all of its rows."""

    def __init__(self, inputs: Inputs, device, prec):
        self.inputs = inputs
        self.device = torch.device(device)
        self.prec = prec
        m = inputs.config["match"]
        self.df = int(m["ref_point_df"])
        self.max_poses = int(m["max_poses"])
        self.iters = int(m["icp_iterations"])
        self.max_dist_factor = float(m["icp_max_dist_factor"])
        self._models, self._cands, self._keys = {}, {}, {}
        self._surfaces = []

    def add(self, surface) -> int:
        """The number of the surface (points, normals), the same for equal
        surfaces."""
        h = hashlib.sha256()
        for a in surface:
            h.update(np.ascontiguousarray(a).tobytes())
        key = h.hexdigest()
        if key not in self._keys:
            self._keys[key] = len(self._surfaces)
            self._surfaces.append(surface)
        return self._keys[key]

    def model(self, i) -> ref.Model:
        if i not in self._models:
            m = self.inputs.models[i]
            self._models[i] = ref.build_model(
                m["points"], m["normals"], self.inputs.tau_d,
                scenes.voxel_downsample_np, self.device, self.prec)
        return self._models[i]

    def candidates(self, s, i) -> ref.Candidates:
        if (s, i) not in self._cands:
            p, n = self._surfaces[s]
            d = self.model(i).d_dist
            if d > 1.5 * self.inputs.voxel_size:
                p, n = scenes.voxel_downsample_np(p, n, d)
            self._cands[(s, i)] = ref.candidates(
                self.model(i), torch.as_tensor(p, device=self.device),
                torch.as_tensor(n, device=self.device), self.df,
                self.max_poses, self.prec)
        return self._cands[(s, i)]

    def outcome(self, s, i, nudge: float = 0.0) -> ppf_scan.Outcome:
        """The reference's own answer in the program's place (the control),
        as `ppf_scan.Reference.outcome` gives it."""
        c = self.candidates(s, i)
        win = int(torch.argmax(c.clustered))
        start = c.poses[win].clone()
        start[0, 3] += nudge * self.model(i).diameter
        pose = self.refine(s, i, start[None])[0]
        keep = torch.ones_like(c.votes, dtype=torch.bool)
        return ppf_scan.Outcome(torch.tensor(c.num_votes), c.votes, c.poses,
                                keep, c.clustered, c.poses[:, :3, 3], pose,
                                None, 0.0, 0, 0)

    def refine(self, s, i, starts):
        """ICP from each start in turn (the distance matrix of one start
        against every row is the largest the reference holds)."""
        model = self.model(i)
        p, n = (torch.as_tensor(a, device=self.device)
                for a in self._surfaces[s])
        return torch.cat([ref.icp(model, p, n, st[None], self.iters,
                                  self.max_dist_factor * model.d_dist,
                                  self.prec) for st in starts])


class _Pick(NamedTuple):
    scan: int
    model: int


class Reference(kt.Reference):
    """`kinfu_track`'s reference (the replay, kept at the last completed
    recognition request), the surface reference on the program's volume
    there, and the plain PPF on the program's surfaces."""

    def __init__(self, inputs: Inputs, device, prec=ref.FP32):
        super().__init__(inputs, device, prec)
        self.matches = _Matches(inputs, self.device, prec)
        self._surface = None

    def surface_gaps(self, params) -> dict:
        """`surface_gaps` of the program's surface at the last completed
        recognition request, against the surface reference on the
        program's volume there."""
        if self._surface is None:
            final = self.inputs.final
            if final.surface is None or final.volume is None:
                self._surface = {"rows_gap": math.inf,
                                 "normal_gap": math.inf}
            else:
                vol = final.volume
                r = sr.extract(vol.tsdf, vol.weight, vol.origin,
                               vol.voxel_size, final.capacity, prec=self.prec)
                self._surface = surface_gaps(
                    final.surface, r, vol.origin.cpu().numpy(),
                    vol.voxel_size, self.inputs.dims,
                    float(params["normal_deg"]))
        return self._surface


def surface_gaps(surface, r: sr.Surface, origin, voxel_size: float, dims,
                 normal_deg: float) -> dict:
    """rows_gap: the share of the reference's rows `r` that the rows of
    `surface` (points, normals on the host), place by place, do not hold
    (a row missing, added or out of order), the difference of the counts
    included, over the reference's count; normal_gap: the share of the
    rows both hold in the same place whose normals part by more than
    `normal_deg` degrees."""
    pts, nrm = surface
    _, H, W = dims
    ijk = np.round((pts - origin) / np.float32(voxel_size) - 0.5) \
        .astype(np.int64)
    mine = (ijk[:, 0] * H + ijk[:, 1]) * W + ijk[:, 2]
    theirs = r.index.cpu().numpy()
    k = min(mine.shape[0], theirs.shape[0])
    same = mine[:k] == theirs[:k]
    miss = int(np.count_nonzero(~same)) + abs(mine.shape[0]
                                              - theirs.shape[0])
    a = torch.as_tensor(np.asarray(nrm)[:k][same])
    b = r.normals.cpu()[:k][torch.as_tensor(same)]
    cos = torch.clamp(torch.sum(a * b, dim=1), -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(cos))
    return {"rows_gap": miss / max(theirs.shape[0], 1),
            "normal_gap": float(torch.mean((ang > normal_deg).to(
                torch.float64))) if ang.numel() else math.inf}


def judge(reference: Reference, req: Request, out: Outcome, params):
    """What one request gives to each number compared.

    camera_gap, tsdf_gap, weight_gap: `kinfu_track.judge`'s pose_gap (the
    camera) and volume gaps, the volume at the last completed recognition
    request. rows_gap, normal_gap: `Reference.surface_gaps` there.
    matches: on a recognition request, `ppf_scan.judge` of each object's
    match on the program's surface of the request."""
    row = kt.judge(reference, req, out, params)
    row["camera_gap"] = row.pop("pose_gap")
    row.update(reference.surface_gaps(params))
    if out.matches is not None:
        s = reference.matches.add(out.surface)
        row["matches"] = [ppf_scan.judge(reference.matches, _Pick(s, i), m,
                                         params)
                          for i, m in enumerate(out.matches)]
    return row


def aggregate(rows):
    """The numbers compared, over a run's judged requests: the KinFu and
    surface numbers of the worst request, and ppf_scan's aggregates of
    every judged match (pooled topk_gap and survivors_gap, the worst
    winner_gap, the median pose_gap)."""
    out = {k: max(r[k] for r in rows) for k in (
        "camera_gap", "tsdf_gap", "weight_gap", "rows_gap", "normal_gap")}
    matches = [m for r in rows for m in r.get("matches", ())]
    if matches:
        agg = ppf_scan.aggregate(matches)
        out.update({k: agg[k] for k in ("topk_gap", "survivors_gap",
                                        "winner_gap", "pose_gap")})
    return out
