"""Deployment kind `kinfu_track`: a KinectFusion session on one card, each
request one depth frame tracked and fused.

Inputs (through the configuration's scene generator): the posed frames
and the segment's frames of a hand-held orbit, drawn from the fixed
POOL_SEED, so that every run does the same work; `--seed` draws only the
requests that are judged. The program under test is the port's
``StreamingRecognizer`` over a ``TSDFVolume`` of the configuration's size.
Set-up fuses the posed frames through ``integrate_depth_frame``, as in a
session mid-scan, and keeps that volume as the snapshot. A request is one
depth frame handed from the host, as a sensor hands it, to
``track_depth_frame`` with the configuration's march; its pose is the
camera's pose the recognizer holds afterwards. The first request of each
segment restores the volume from the snapshot (a device copy) and starts
tracking from the true pose of frame 0; later ones start from the pose
before them (`state` carry).

What decides `correct` is `judge`: the plain reference
(frozen/kinfu_reference) builds its own snapshot from the raw frames and
replays the segment once, and its poses and its volume at the window's
last completed frame are held against the program's.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.frozen import kinfu_reference as kr
from benchmark.metrics import kinfu_work

# The seed of the scene, the orbit and the noise: the same in every run, so
# that --seed, which draws the judged requests, does not change the work.
POOL_SEED = 1


class Request(NamedTuple):
    scan: int       # the frame's place in the segment
    model: int      # always 0 (the metric readers key work on both)


class Outcome(NamedTuple):
    pose: np.ndarray        # (4, 4) float32 world→camera after the request
    lost: bool              # the lost-tracking gate held the frame back


class Final:
    """The program's volume after its last completed request and that
    request's frame: what the judge's volume gaps read. It lives on the
    inputs, so the window keeps this one volume on the card and no other."""

    def __init__(self):
        self.volume = None
        self.frame = -1


def _render_device():
    return torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")


class Inputs:
    """The frames and the deployment's settings: what both the program and
    the reference are given."""

    def __init__(self, config, traffic, seed: int):
        self.config = config
        self.traffic = traffic
        vol, cam = config["volume"], config["camera"]
        n = int(vol["dims"])
        self.dims = (n, n, n)
        self.extent = float(vol["size_m"])
        self.voxel_size = self.extent / n
        self.origin = np.full(3, -self.extent / 2, np.float32)
        self.truncation = float(vol["truncation_m"])
        self.w_max = float(vol["w_max"])
        self.K = tuple(float(k) for k in cam["intrinsics"])
        self.shape = (int(cam["height"]), int(cam["width"]))
        m = config["march"]
        self.march = (float(m["t_near"]), float(m["t_far"]),
                      int(m["n_steps"]))
        dt = (self.march[1] - self.march[0]) / (self.march[2] - 1)
        if not dt < self.truncation:
            raise ValueError(f"the raycast step {dt:.5f} m is not below the "
                             f"truncation {self.truncation} m")
        self.iters = int(config["track"]["iters"])
        self.min_inlier_frac = float(config["track"]["min_inlier_frac"])
        if traffic["state"] != "carry" or traffic["restart"] != "snapshot":
            raise ValueError("kinfu_track carries the volume from frame to "
                             "frame and restarts from the snapshot")
        self.segment = int(traffic["segment"])
        gen = importlib.import_module(
            f"benchmark.generators.{config['scene']['generator']}")
        self.posed, self.frames = gen.make(
            config["scene"], self.K, self.shape,
            int(traffic["posed_frames"]), self.segment, POOL_SEED,
            _render_device())
        self.final = Final()

    def requests(self):
        """The segment's frames in order, replayed."""
        while True:
            for f in range(self.segment):
                yield Request(f, 0)


class Deployment:
    """The program under test on `device`, set up for the inputs."""

    def __init__(self, inputs: Inputs, device):
        from objective_slam_tpu_torch.models import tsdf

        self.inputs = inputs
        self.device = torch.device(device)
        # The recognizer fuses at w_max 64 and tracks in 10 steps, its own
        # values, which the configuration states for the reference.
        self.rec = tsdf.StreamingRecognizer(tsdf.make_volume(
            inputs.origin, inputs.dims, inputs.voxel_size,
            inputs.truncation, device=self.device))
        for fr in inputs.posed:
            self.rec.integrate_depth_frame(fr.depth, inputs.K, fr.T_cw)
        self.snapshot = self.rec.volume
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, req: Request) -> Outcome:
        """One frame, ended by its pose on the host (the pose's host copy
        waits for the frame's update; a frame held back ends at the host
        read of its tracking's inliers)."""
        inputs = self.inputs
        fr = inputs.frames[req.scan]
        hint = None
        if req.scan == 0:
            snap = self.snapshot
            self.rec.volume = dataclasses.replace(
                snap, tsdf=snap.tsdf.clone(), weight=snap.weight.clone())
            hint = fr.T_cw
        t_near, t_far, n_steps = inputs.march
        self.rec.track_depth_frame(
            fr.depth, inputs.K, T_cw_hint=hint,
            min_inlier_frac=inputs.min_inlier_frac, t_near=t_near,
            t_far=t_far, n_steps=n_steps)
        inputs.final.volume = self.rec.volume
        inputs.final.frame = req.scan
        return Outcome(np.array(self.rec.T_cw, np.float32),
                       bool(self.rec.tracking_lost))

    @staticmethod
    def retain(out: Outcome) -> Outcome:
        """What the judge reads is on the host already."""
        return out

    def warm_up(self):
        """One whole segment: every shape the window uses and the
        allocator's pools; the window's first request restores the
        snapshot."""
        it = self.inputs.requests()
        for _ in range(self.inputs.segment):
            self.serve(next(it))
        self._sync()


class Replay(NamedTuple):
    poses: list             # (4, 4) float32 world→camera per frame
    lost: list
    updated: list           # voxels each frame's update touched
    volume: kr.Volume | None    # at the frame asked for, else None


def session(inputs: Inputs, device, prec=kr.FP32) -> kr.Stream:
    """The plain reference's session after set-up: its own snapshot, the
    posed frames fused."""
    dev = torch.device(device)
    stream = kr.Stream(
        kr.make_volume(inputs.origin, inputs.dims, inputs.voxel_size,
                       inputs.truncation, dev),
        inputs.K, inputs.w_max, inputs.march, inputs.iters,
        inputs.min_inlier_frac, prec)
    for fr in inputs.posed:
        stream.fuse(torch.as_tensor(fr.depth, device=dev), fr.T_cw)
    return stream


def advance(stream: kr.Stream, inputs: Inputs, f: int, nudge: float = 0.0):
    """Frame f of the segment through the reference's session, frame 0
    from its true pose moved along x by `nudge` voxels: (lost, voxels
    updated)."""
    fr = inputs.frames[f]
    hint = None
    if f == 0:
        hint = fr.T_cw.copy()
        hint[0, 3] += nudge * inputs.voxel_size
    depth = torch.as_tensor(fr.depth, device=stream.vol.tsdf.device)
    _, lost, n = stream.step(depth, hint)
    return lost, n


def replay(inputs: Inputs, device, prec=kr.FP32, keep: int = -1,
           each=None) -> Replay:
    """The reference's replay of the segment from its snapshot, keeping a
    copy of the volume after frame `keep`; `each(f, stream)`, if given,
    is called after every frame."""
    stream = session(inputs, device, prec)
    poses, lost, updated, kept = [], [], [], None
    for f in range(len(inputs.frames)):
        gone, n = advance(stream, inputs, f)
        poses.append(stream.T_cw.cpu().numpy())
        lost.append(gone)
        updated.append(n)
        if f == keep:
            kept = stream.vol.clone()
        if each is not None:
            each(f, stream)
    return Replay(poses, lost, updated, kept)


def volume_gaps(program, reference: kr.Volume, truncation: float,
                frames: int) -> dict:
    """The program's volume against the reference's after `frames` frames
    of the segment.

    tsdf_gap: the mean |Δ tsdf| over τ on the voxels both observed;
    tsdf_max: the largest of the same (a voxel whose projection rounds to
    another pixel reads another depth there, so one voxel can differ by up
    to 2τ in sound runs: it does not tell them from faults); weight_gap:
    the share of the voxels either observed whose weights differ, per
    frame of the segment (each fused frame can flip the count of voxels
    at the edges of its frustum and band, so the share grows with the
    frames, in sound runs as under faults)."""
    pt, pw = program.tsdf, program.weight
    rt, rw = reference.tsdf.to(pt.device), reference.weight.to(pt.device)
    both = (pw > 0) & (rw > 0)
    either = int(((pw > 0) | (rw > 0)).sum())
    diff = (pt - rt).abs()[both] / truncation
    some = diff.numel() > 0
    return {"tsdf_gap": float(diff.mean()) if some else 0.0,
            "tsdf_max": float(diff.max()) if some else 0.0,
            "weight_gap": int((pw != rw).sum()) / max(either, 1) / frames}


class Reference:
    """The plain reference on the inputs: one replay of the segment, made
    when first asked for, keeping the volume at the program's last
    completed frame."""

    def __init__(self, inputs: Inputs, device, prec=kr.FP32):
        self.inputs = inputs
        self.device = torch.device(device)
        self.prec = prec
        self._replay = None
        self._gaps = None

    def replayed(self) -> Replay:
        if self._replay is None:
            self._replay = replay(self.inputs, self.device, self.prec,
                                  keep=self.inputs.final.frame)
        return self._replay

    def gaps(self) -> dict:
        """The volume gaps at the program's last completed frame."""
        if self._gaps is None:
            final = self.inputs.final
            kept = self.replayed().volume
            self._gaps = volume_gaps(final.volume, kept,
                                     self.inputs.truncation,
                                     final.frame + 1) \
                if final.volume is not None and kept is not None \
                else {"tsdf_gap": math.inf, "weight_gap": math.inf}
        return self._gaps

    def work(self, scan, model):
        """The voxels frame `scan`'s update touches (kinfu_work.Work)."""
        h, w = self.inputs.shape
        return kinfu_work.Work(self.replayed().updated[scan], h * w)


def judge(reference: Reference, req: Request, out: Outcome, params):
    """What one request gives to each number compared.

    pose_gap: the largest displacement of the volume's 8 corners under the
    program's pose against the reference's at the same frame, over the
    volume's edge; it covers the raycast, the association, the
    Gauss-Newton steps and the gate. tsdf_gap and weight_gap (the same
    for every request: `volume_gaps` at the window's last completed
    frame) cover the update."""
    rp = reference.replayed()
    inputs = reference.inputs
    row = {"pose_gap": kr.corner_gap(out.pose, rp.poses[req.scan],
                                     inputs.origin, inputs.extent)}
    row.update(reference.gaps())
    return row


def aggregate(rows):
    """The numbers compared, over a run's judged requests: each the worst
    request."""
    return {k: max(r[k] for r in rows)
            for k in ("pose_gap", "tsdf_gap", "weight_gap")}
