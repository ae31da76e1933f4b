"""Deployment kind `ppf_scan`: a scan → pose service over one card.

Inputs (through the configuration's generators): the raw models and a
pool of raw scans, drawn from the fixed POOL_SEED, so that every run does
the same work; `--seed` draws the order in which the loop sends the pool's
scans and the requests that are judged. The program under test builds one
model description per model at set-up, as ``pipeline.ppf_registration``
builds them once across scenes. A request is one model matched in one scan:
``drost.match_with_state`` on the program's device voxel grid of the scan,
with the raw scan (every `icp_stride`-th point) for ICP, as the CLI passes
it. The voxel grid runs once per scan and is charged to the scan's first
request. The traffic's `state` says whether a request hands the caps state
its model's previous request returned (`carry`, a serving loop) or none
(`none`, the public ``match()`` path: count pass, host sync, top-K ladder).

What decides `correct` is `judge`: the plain reference (frozen/reference)
worked out again from the raw inputs, against the program's outputs.
"""

from __future__ import annotations

import importlib
import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.frozen import reference as ref
from benchmark.frozen import scenes
from benchmark.metrics import kernel_work

# The seed of the models and the scan pool: the same in every run, so that
# --seed, which orders the pool, does not change the work.
POOL_SEED = 1


class Request(NamedTuple):
    scan: int
    model: int
    first: bool


class Outcome(NamedTuple):
    """What one request returned, kept for the judge and the counters."""
    num_votes: torch.Tensor
    votes: torch.Tensor            # top-K counts, descending
    poses: torch.Tensor
    keep: torch.Tensor
    clustered: torch.Tensor
    translations: torch.Tensor
    pose: torch.Tensor
    state_changed: bool | None     # carry traffic: the returned state is new
    ladder_steps: float            # log2(returned max_poses / configured)
    k1_launches: int
    k2_launches: int


def _generator(name):
    return importlib.import_module(f"benchmark.generators.{name}")


def voxel_count(points, leaf) -> int:
    """Occupied cells of the scan's voxel grid (float64 cells)."""
    p = np.asarray(points, np.float64)
    cell = np.floor((p - p.min(axis=0)) / leaf).astype(np.int64)
    dims = cell.max(axis=0) + 1
    return int(np.unique((cell[:, 0] * dims[1] + cell[:, 1]) * dims[2]
                         + cell[:, 2]).shape[0])


class Inputs:
    """The raw models, the scan pool and the deployment's derived sizes:
    what both the program and the reference are given."""

    def __init__(self, config, traffic, seed: int):
        self.config = config
        self.traffic = traffic
        mcfg, scfg = config["models"], config["scenes"]
        self.models = _generator(mcfg["generator"]).make(
            np.random.default_rng([POOL_SEED, 0]), mcfg)
        gen = _generator(scfg["generator"])
        self.scans = [gen.make(np.random.default_rng([POOL_SEED, 1 + i]),
                               self.models, scfg)
                      for i in range(int(traffic["pool"]))]
        self.order = np.random.default_rng([seed, 2]).permutation(
            len(self.scans)).tolist()
        self.tau_d = float(mcfg["tau_d"])
        self.d_dists = [self.tau_d * scenes.bbox_diameter(m["points"])
                        for m in self.models]
        leaf = config["scene_leaf"]
        self.leaf = self.d_dists[0] if leaf == "model_d_dist" else float(leaf)
        cap = config["capacity"]
        self.occupancy = [voxel_count(p, self.leaf) for p, _ in self.scans]
        step = int(cap["round"])
        self.capacity = ((int(max(self.occupancy) * (1.0 + cap["margin"]))
                          + step - 1) // step) * step
        self.stride = int(config["icp_stride"])
        self.carry = traffic["state"] == "carry"

    def requests(self):
        """The loop's order: every model in every scan, the scans in the
        seed's order, cycled."""
        while True:
            for s in self.order:
                for m in range(len(self.models)):
                    yield Request(s, m, m == 0)


class Deployment:
    """The program under test on `device`, set up for the inputs."""

    def __init__(self, inputs: Inputs, device):
        from objective_slam_tpu_torch.config import PPFConfig
        from objective_slam_tpu_torch.models import drost
        from objective_slam_tpu_torch.ops import block_tally, fast_tally
        from objective_slam_tpu_torch.utils import pointcloud

        self.inputs = inputs
        self.device = torch.device(device)
        self._drost, self._pc = drost, pointcloud
        self._k1, self._k2 = block_tally, fast_tally
        self.cfg = PPFConfig(**inputs.config["match"])
        self.descs = []
        for m, d_dist in zip(inputs.models, inputs.d_dists):
            mp, mn = pointcloud.voxel_downsample_np(m["points"], m["normals"],
                                                    d_dist)
            self.descs.append(drost.build_model_description(
                mp, mn, self.cfg, d_dist=d_dist, device=self.device))
        st = inputs.stride
        self.scans = []
        for p, n in inputs.scans:
            p = torch.as_tensor(p, device=self.device)
            n = torch.as_tensor(n, device=self.device)
            self.scans.append((p, n, p[::st], n[::st]))
        self.states = [None] * len(self.descs)
        self._vox = None
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, req: Request) -> Outcome:
        """One request, ended by its pose on the host."""
        raw_p, raw_n, icp_p, icp_n = self.scans[req.scan]
        k1, k2 = self._k1.launches, self._k2.launches
        if req.first:
            self._vox = self._pc.voxel_downsample(
                raw_p, raw_n, self.inputs.leaf,
                capacity=self.inputs.capacity)
        state = self.states[req.model] if self.inputs.carry else None
        res, new_state = self._drost.match_with_state(
            self.descs[req.model], self._vox.points, self._vox.normals,
            self.cfg, state=state, icp_points=icp_p, icp_normals=icp_n)
        res.pose.cpu()
        self._sync()
        if self.inputs.carry:
            self.states[req.model] = new_state
        return Outcome(
            num_votes=res.num_votes, votes=res.pose_votes, poses=res.poses,
            keep=res.pose_keep,
            clustered=res.clustered_counts,
            translations=res.clustered_translations, pose=res.pose,
            state_changed=(new_state is not state) if self.inputs.carry
            else None,
            ladder_steps=math.log2(new_state.max_poses / self.cfg.max_poses),
            k1_launches=self._k1.launches - k1,
            k2_launches=self._k2.launches - k2)

    @staticmethod
    def retain(out: Outcome) -> Outcome:
        """A host copy of what the judge reads, taken once the request's
        latency is read, so that nothing the window keeps holds device
        memory (a slice of a large buffer would keep all of it)."""
        return out._replace(**{f: getattr(out, f).cpu() for f in (
            "num_votes", "votes", "poses", "keep", "clustered",
            "translations", "pose")})

    def warm_up(self):
        """Every scan and model of the pool once: every shape the window
        uses, and for carry traffic the state a serving loop holds."""
        it = self.inputs.requests()
        for _ in range(len(self.inputs.scans) * len(self.descs)):
            self.serve(next(it))


class Reference:
    """The plain reference on the inputs, cached per model and scan."""

    def __init__(self, inputs: Inputs, device, prec=ref.FP32):
        self.inputs = inputs
        self.device = torch.device(device)
        self.prec = prec
        m = inputs.config["match"]
        self.df = int(m["ref_point_df"])
        self.max_poses = int(m["max_poses"])
        self.iters = int(m["icp_iterations"])
        self.max_dist_factor = float(m["icp_max_dist_factor"])
        self._models, self._vox, self._cands = {}, {}, {}

    def model(self, i) -> ref.Model:
        if i not in self._models:
            m = self.inputs.models[i]
            self._models[i] = ref.build_model(
                m["points"], m["normals"], self.inputs.tau_d,
                scenes.voxel_downsample_np, self.device, self.prec)
        return self._models[i]

    def scan(self, s):
        """(voxel points, voxel normals, ICP points, ICP normals)."""
        if s not in self._vox:
            p, n = (torch.as_tensor(x, device=self.device)
                    for x in self.inputs.scans[s])
            vp, vn = ref.voxel_grid(p, n, self.inputs.leaf)
            st = self.inputs.stride
            self._vox[s] = (vp, vn, p[::st], n[::st])
        return self._vox[s]

    def candidates(self, s, i) -> ref.Candidates:
        if (s, i) not in self._cands:
            vp, vn, _, _ = self.scan(s)
            self._cands[(s, i)] = ref.candidates(
                self.model(i), vp, vn, self.df, self.max_poses, self.prec)
        return self._cands[(s, i)]

    def refine(self, s, i, starts):
        model = self.model(i)
        _, _, ip, inn = self.scan(s)
        return ref.icp(model, ip, inn, starts, self.iters,
                       self.max_dist_factor * model.d_dist, self.prec)

    def outcome(self, s, i, nudge: float = 0.0) -> Outcome:
        """The reference's own answer, in the program's place (the
        control): the winner is the first top clustered candidate. `nudge`
        moves ICP's start by that share of the diameter along x (the
        witness that ICP's path turns on last bits)."""
        c = self.candidates(s, i)
        win = int(torch.argmax(c.clustered))
        start = c.poses[win].clone()
        start[0, 3] += nudge * self.model(i).diameter
        pose = self.refine(s, i, start[None])[0]
        keep = torch.ones_like(c.votes, dtype=torch.bool)
        return Outcome(torch.tensor(c.num_votes), c.votes, c.poses, keep,
                       c.clustered, c.poses[:, :3, 3], pose, None, 0.0, 0, 0)

    def work(self, s, i):
        """Kernel-work quantities of one vote pass (kernel_work.Work)."""
        vp, vn, _, _ = self.scan(s)
        model = self.model(i)
        votes, pairs = ref.vote_total(model, vp, vn, self.df, self.prec)
        return kernel_work.Work(
            ref_rows=-(-vp.shape[0] // self.df), scene_points=vp.shape[0],
            model_points=model.points.shape[0],
            occupied_keys=model.keys.shape[0],
            model_pairs=int(model.counts.sum()), voting_pairs=pairs,
            votes=votes)


def judge(reference: Reference, req: Request, out: Outcome, params):
    """What one request gives to each number compared (see `aggregate`).

    votes: |program − reference| total votes and the reference's total;
    they cover the voxel grid, the keys and the model table.
    topk: Σ |program − reference| count, rank by rank over the survivors
    of the relative threshold, the shorter list padded with zeros (a
    survivor that one side lacks costs its whole count), and the
    reference's Σ; they cover the vote tally (α bins), top-K and the
    max_poses ladder that sizes it.
    survivors: |program − reference| number of survivors, and the
    reference's number; the ladder's guarantee that top-K holds every
    cell over the threshold up to the ceiling.
    winner_gap: the program's unrefined winner against the nearest of the
    reference's candidates within `near_tie` of its top clustered count (a
    near tie may go either way), as the largest model-point displacement
    over the model's diameter; it covers the candidate poses, clustering
    and the choice of the winner.
    pose_gap: the program's refined pose against the reference's ICP from
    the `starts` nearest of those candidates, the least gap in the same
    measure; it covers ICP."""
    c = reference.candidates(req.scan, req.model)
    model = reference.model(req.model)
    mine = out.votes[out.keep].to(torch.float64).cpu()
    theirs = c.votes.to(torch.float64).cpu()
    k = max(mine.shape[0], theirs.shape[0])
    top = (float(torch.sum(torch.abs(
        torch.nn.functional.pad(mine, (0, k - mine.shape[0]))
        - torch.nn.functional.pad(theirs, (0, k - theirs.shape[0]))))),
        float(torch.sum(theirs)))
    score = torch.where(out.keep, out.clustered, torch.full_like(
        out.clustered, -1.0))
    win = int(torch.argmax(score))
    unrefined = out.poses[win].clone()
    unrefined[:3, 3] = out.translations[win]
    dev = reference.device
    unrefined = unrefined.to(dev)
    ok = torch.nonzero(c.clustered >= (1.0 - params["near_tie"])
                       * torch.max(c.clustered)).reshape(-1)
    near = ref.pose_gap(model, c.poses[ok], unrefined[None])
    starts = ok[torch.argsort(near)[:int(params["starts"])]]
    finals = reference.refine(req.scan, req.model, c.poses[starts])
    gap = float(torch.min(ref.pose_gap(model, finals,
                                       out.pose.to(dev)[None])))
    return {"votes": (abs(int(out.num_votes) - c.num_votes), c.num_votes),
            "topk": top,
            "survivors": (abs(mine.shape[0] - theirs.shape[0]),
                          theirs.shape[0]),
            "winner_gap": float(torch.min(near)),
            "pose_gap": gap}


def aggregate(rows):
    """The numbers compared, over a run's judged requests.

    votes_gap, topk_gap, survivors_gap: pooled, Σ |gap| over Σ reference
    (last-bit key and α-bin flips make single requests sporadic; the pool
    is steady).
    winner_gap: the worst request.
    pose_gap: the median request: ICP's later iterations turn a last-bit
    difference into another path in a minority of requests, the reference
    against itself included (control.py's `nudge` side), while a fault
    or a lower precision moves every request."""
    def pooled(key):
        den = sum(r[key][1] for r in rows)
        return sum(r[key][0] for r in rows) / den if den else math.inf
    gaps = sorted(r["pose_gap"] for r in rows)
    mid = len(gaps) // 2
    median = gaps[mid] if len(gaps) % 2 else (gaps[mid - 1] + gaps[mid]) / 2
    return {"votes_gap": pooled("votes"), "topk_gap": pooled("topk"),
            "survivors_gap": pooled("survivors"),
            "winner_gap": max(r["winner_gap"] for r in rows),
            "pose_gap": median}
