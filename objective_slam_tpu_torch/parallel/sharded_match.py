"""Sharded PPF matching: the scene's reference rows split across shards.

Port of ``objective_slam_tpu.parallel.sharded_match`` (sharded_match.py:
1-356). The Hough dimension, the scene reference points, is split into D
equal slices; R is padded up to a multiple of D with rows that give only
``INVALID_KEY`` pairs.

  per shard:  its reference rows -> scene keys/α -> the engine's local
              accumulator -> local top-K candidates and their poses
  collective: all_gather of the K candidates of every shard, the
              saturation count against the GLOBAL threshold, and one sum
              of [votes, overflowed, saturated] over the shards
  global:     relative threshold, dense clustering of the D·K candidates,
              optional rescoring, winner, optional ICP (drost._pick_winner)

The JAX package runs the shards under ``shard_map`` over a mesh axis
"ref". Here a shard group carries them; the per-shard phase
(``_local_candidates``) and the global phase (``_global_phase``) are plain
functions of tensors, and the two groups differ only in their collectives:

  * ``LocalShards(n_shards, devices=None)`` — every shard in this process,
    one after another, each on its device (default: the model's, so D
    shards share one card or the CPU). The gather is a ``torch.cat``, the
    sum a sum. Tests hold this against the JAX mesh of 8 CPU devices.
  * ``DistShards(process_group=None, device=None)`` — one shard per rank of
    a ``torch.distributed`` group (NCCL on cards, gloo on the CPU), on the
    caller's device (default: the model's). ``dist.all_gather`` (list form)
    of each rank's packed candidates, one ``all_reduce`` of a small int64
    tensor; the global phase then runs on every rank.

The result is exact against the single-chip path whenever each shard's
survivors fit in K (``topk_saturated`` reports otherwise), and
``drost.extract_instances`` takes a ShardedMatchResult unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from objective_slam_tpu_torch._common import as_tensor, f32
from objective_slam_tpu_torch.config import PPFConfig
from objective_slam_tpu_torch.models import drost
from objective_slam_tpu_torch.models.drost import ModelDescription
from objective_slam_tpu_torch.ops import ppf as ppf_ops, transforms as tr, \
    voting, voting_fast
from objective_slam_tpu_torch.utils import profiling

_INT32_MAX = 2 ** 31 - 1


class ShardedMatchResult(NamedTuple):
    """Result of a sharded match (sharded_match.py:48-58)."""
    pose: torch.Tensor             # (4, 4) winner
    cluster_votes: torch.Tensor    # () winner's clustered count
    num_votes: torch.Tensor        # () int32 total votes, saturating
    overflowed: torch.Tensor       # () bool: a shard overflowed its buffer
    poses: torch.Tensor            # (D*K, 4, 4) gathered candidate poses
    pose_votes: torch.Tensor       # (D*K,) gathered raw vote counts
    pose_keep: torch.Tensor        # (D*K,) global-threshold survivors
    clustered_counts: torch.Tensor  # (D*K,) clustered weighted counts
    clustered_translations: torch.Tensor  # (D*K, 3)
    topk_saturated: torch.Tensor   # () bool: a shard's survivors exceeded K


class LocalShards:
    """n_shards shards run one after another in this process; shard s on
    devices[s] (one device or None: every shard on the model's device)."""

    def __init__(self, n_shards: int, devices=None):
        if devices is None or isinstance(devices, (str, torch.device)):
            devices = [devices] * n_shards
        if len(devices) != n_shards:
            raise ValueError(f"{len(devices)} devices for {n_shards} shards")
        self.size = n_shards
        self.local_shards = list(range(n_shards))
        self._devices = [None if d is None else torch.device(d)
                         for d in devices]

    def device(self, shard: int, model: ModelDescription) -> torch.device:
        return self._devices[shard] or model.device

    def all_gather(self, parts):
        """The local shards' parts in shard order, on the first's device."""
        return torch.cat([p.to(parts[0].device) for p in parts])

    def all_sum(self, parts):
        return torch.stack([p.to(parts[0].device) for p in parts]).sum(0)


class DistShards:
    """One shard per rank of a torch.distributed process group (default:
    the world), on `device` (None: the model's device)."""

    def __init__(self, process_group=None, device=None):
        import torch.distributed as dist

        self._dist, self._pg = dist, process_group
        self.size = dist.get_world_size(process_group)
        self.local_shards = [dist.get_rank(process_group)]
        self._device = None if device is None else torch.device(device)

    def device(self, shard: int, model: ModelDescription) -> torch.device:
        return self._device or model.device

    def all_gather(self, parts):
        (part,) = parts
        out = [torch.empty_like(part) for _ in range(self.size)]
        self._dist.all_gather(out, part.contiguous(), group=self._pg)
        return torch.cat(out)

    def all_sum(self, parts):
        (part,) = parts
        out = part.clone()
        self._dist.all_reduce(out, group=self._pg)
        return out


def _saturate(total_u):
    """The int32 sentinel contract on an exact int64 sum of shard totals
    read as uint32 (sharded_match.py:61-81)."""
    return torch.clamp(total_u, max=_INT32_MAX).to(torch.int32)


def psum_saturating(nv, group):
    """Saturating sum over the group's shards of per-shard saturating int32
    totals: 2³¹−1 if a shard is at that sentinel or the exact sum reaches
    it, else the exact sum. `nv` holds the totals of the group's local
    shards (one per entry of ``group.local_shards``).

    The JAX package sums two 16-bit limbs because its psum is int32; an
    int64 sum of the totals read as uint32, clamped, gives the same value
    for any input (a shard at the sentinel already puts the sum there)."""
    nv = torch.as_tensor(nv).reshape(-1)
    unsigned = nv.to(torch.int64) & 0xFFFFFFFF
    parts = [unsigned[i:i + 1] for i in range(unsigned.shape[0])]
    return _saturate(group.all_sum(parts)[0])


def _shard_rows(n_scene: int, ref_point_df: int, n_shards: int):
    """(R, R_pad, ref_idx (R_pad,) int64, pad_row (R_pad,) bool): pad rows
    index point n_scene − 1 and are masked (sharded_match.py:140-153)."""
    R = (n_scene + ref_point_df - 1) // ref_point_df
    R_pad = ((R + n_shards - 1) // n_shards) * n_shards
    ref_idx = np.full((R_pad,), n_scene - 1, np.int64)
    ref_idx[:R] = np.arange(0, R * ref_point_df, ref_point_df)
    pad_row = np.zeros((R_pad,), bool)
    pad_row[R:] = True
    return R, R_pad, ref_idx, pad_row


def size_sharded_caps(model: ModelDescription, scene_points, scene_normals,
                      config: PPFConfig, n_shards: int
                      ) -> tuple[int, int | None]:
    """Exact per-shard capacities from the count pass
    (sharded_match.py:84-113): (vote_cap_per_shard, seg_cap_per_shard) for
    `make_sharded_matcher`. vote_cap leaves out the per-row budget of the
    fast engines, which the matcher adds."""
    if config.engine == "correlation":
        return 0, None
    rows = drost._count_votes_rows(model, scene_points, scene_normals,
                                   config.ref_point_df, config.d_angle)
    votes_r, rows_r, segs_r = (r.cpu().numpy().astype(np.int64)
                               for r in rows)
    R = votes_r.shape[0]
    R_pad = ((R + n_shards - 1) // n_shards) * n_shards

    def shard_max(x):
        xp = np.zeros((R_pad,), np.int64)
        xp[:R] = x
        return int(xp.reshape(n_shards, -1).sum(axis=1).max())

    if config.engine == "fast" and model.fast_tables is not None \
            and model.fast_tables.block is not None:
        vote_cap = drost._next_cap(shard_max(rows_r) * 128)
        seg_cap = drost._next_cap(max(shard_max(segs_r), 1024))
        return vote_cap, seg_cap
    return drost._next_cap(shard_max(votes_r)), None


def _local_candidates(model: ModelDescription, config: PPFConfig,
                      scene_points, scene_normals, ref_idx, pad_row,
                      vote_cap: int, seg_cap: int | None,
                      runs_cap: int | None):
    """One shard (sharded_match.py:157-204): vote on its reference rows,
    take the top K cells of its accumulator (lax.top_k's order: descending,
    lower flat index first among equals) and build their poses. Returns
    (counts (K,), poses (K, 4, 4), weighted (K,), VoteResult)."""
    keys, alpha_s = drost._scene_keys(model, scene_points, scene_normals,
                                      ref_idx, config.d_angle)
    keys = torch.where(pad_row[:, None], ppf_ops.INVALID_KEY, keys)
    votes = drost._cast_votes(model, config, keys, alpha_s, vote_cap,
                              seg_cap, runs_cap)
    acc = votes.accumulator
    _, n_m, A = acc.shape
    K = config.max_poses
    counts, idx = voting._top_k(acc.reshape(-1), K)
    if counts.shape[0] < K:        # fewer cells than K: zero-count padding
        counts = torch.nn.functional.pad(counts, (0, K - counts.shape[0]))
        idx = torch.nn.functional.pad(idx, (0, K - idx.shape[0]))
    a_idx = (idx % A).to(torch.int32)
    m_idx = (idx // A) % n_m
    r_loc = idx // (A * n_m)

    s_pts = scene_points[ref_idx]
    s_beta, s_gamma = tr.canonical_angles(s_pts, scene_normals[ref_idx])
    poses = tr.pose_from_vote(
        a_idx, model.points[m_idx], model.beta[m_idx], model.gamma[m_idx],
        s_pts[r_loc], s_beta[r_loc], s_gamma[r_loc], config.d_angle)
    weighted = counts.to(torch.float32) * model.vote_weights[m_idx]
    return counts, poses, weighted, votes


def _threshold(config: PPFConfig, counts):
    """The relative vote threshold on the gathered counts' maximum."""
    return f32(config.vote_count_threshold) * \
        torch.max(counts).to(torch.float32)


def _global_phase(model: ModelDescription, config: PPFConfig, g_counts,
                  g_poses, g_weighted, scene_points, scene_normals,
                  icp_points=None, icp_normals=None):
    """Threshold, cluster, rescore, pick and refine the winner over the
    gathered D·K candidates (sharded_match.py:251-291). Returns (pose,
    cluster_votes, keep, clusters)."""
    keep = (g_counts.to(torch.float32) > _threshold(config, g_counts)) \
        & (g_counts > 0)
    pose, win, cl = drost._pick_winner(model, config, g_poses, g_weighted,
                                       keep, scene_points, scene_normals,
                                       icp_points, icp_normals)
    return pose, cl.vote_counts[win], keep, cl


def _pack(counts, poses, weighted):
    """One float32 row per candidate for a single gather: the count's bits,
    the weighted count, the 16 pose entries."""
    return torch.cat([counts.to(torch.int32).view(torch.float32)[:, None],
                      weighted[:, None], poses.reshape(-1, 16)], dim=1)


def _unpack(rows):
    return (rows[:, 0].contiguous().view(torch.int32),
            rows[:, 2:].reshape(-1, 4, 4), rows[:, 1].contiguous())


def _model_on(model: ModelDescription, device: torch.device):
    """The description with every tensor on `device`."""
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(move(v) for v in x))
        return x
    return model if model.device == device else move(model)


def make_sharded_matcher(group, model: ModelDescription, config: PPFConfig,
                         n_scene: int, vote_cap_per_shard: int,
                         seg_cap_per_shard: int | None = None,
                         runs_cap_per_shard: int | None = None):
    """A matcher over the shards of `group` (LocalShards or DistShards)
    (sharded_match.py:116-301).

    n_scene and the caps are fixed; `size_sharded_caps` derives the caps
    exactly. With engine "fast" each shard's vote_cap gains one
    TALLY_CHUNK per local row, as in the JAX package, with block tables
    too. runs_cap_per_shard is the correlation engine's compaction cap
    (None: its default); `overflowed` reports truncation, and
    `sharded_match` retries.

    Returns fn(scene_points, scene_normals, icp_points=None,
    icp_normals=None, timings=None) -> ShardedMatchResult. With
    config.refine_icp the winner is refined against icp_points (default
    the scene). `timings` (a profiling.Timings) collects "shard local" per
    local shard, "gather" and "global", each ended by a synchronize."""
    D = group.size
    _, R_pad, ref_idx_host, pad_host = _shard_rows(
        n_scene, config.ref_point_df, D)
    Rl = R_pad // D
    if config.engine == "fast":
        vote_cap_per_shard += Rl * voting_fast.TALLY_CHUNK
    K = config.max_poses
    shards = []
    for s in group.local_shards:
        dev = group.device(s, model)
        shards.append((dev, _model_on(model, dev),
                       torch.from_numpy(ref_idx_host[s * Rl:(s + 1) * Rl])
                       .to(dev),
                       torch.from_numpy(pad_host[s * Rl:(s + 1) * Rl])
                       .to(dev)))
    out_dev, out_model = shards[0][0], shards[0][1]

    def timed(name, timings):
        if timings is None:
            return contextlib.nullcontext([])
        return profiling.phase(name, timings)

    def matcher(scene_points, scene_normals, icp_points=None,
                icp_normals=None, timings=None):
        local = []
        for dev, mdl, ref_idx, pad_row in shards:
            with timed("shard local", timings) as hold:
                sp = as_tensor(scene_points, dev)
                sn = as_tensor(scene_normals, dev)
                local.append((sp, sn, *_local_candidates(
                    mdl, config, sp, sn, ref_idx, pad_row,
                    vote_cap_per_shard, seg_cap_per_shard,
                    runs_cap_per_shard)))
                hold.append(local[-1][2])
        with timed("gather", timings) as hold:
            g_counts, g_poses, g_weighted = _unpack(group.all_gather(
                [_pack(c, p, w) for _, _, c, p, w, _ in local]))
            # Each shard counts its cells above the GLOBAL threshold: a
            # shard with more survivors than K may have dropped some
            # before the gather (voting.top_votes' contract).
            thresh = _threshold(config, g_counts)
            flags = []
            for _, _, _, _, _, votes in local:
                acc = votes.accumulator
                above = torch.sum((acc.to(torch.float32) > thresh.to(
                    acc.device)) & (acc > 0), dtype=torch.int64)
                flags.append(torch.stack([
                    votes.num_votes.to(torch.int64) & 0xFFFFFFFF,
                    votes.overflowed.to(torch.int64),
                    (above > K).to(torch.int64)]))
            red = group.all_sum(flags)
            hold.append(red)
        with timed("global", timings) as hold:
            sp, sn = local[0][0], local[0][1]
            pose, cluster_votes, keep, cl = _global_phase(
                out_model, config, g_counts.to(out_dev), g_poses.to(out_dev),
                g_weighted.to(out_dev), sp, sn, icp_points, icp_normals)
            hold.append(pose)
        return ShardedMatchResult(
            pose=pose, cluster_votes=cluster_votes,
            num_votes=_saturate(red[0]), overflowed=red[1] > 0,
            poses=g_poses, pose_votes=g_counts, pose_keep=keep,
            clustered_counts=cl.vote_counts,
            clustered_translations=cl.translations,
            topk_saturated=red[2] > 0)

    return matcher


def sharded_match(group, model: ModelDescription, scene_points,
                  scene_normals, config: PPFConfig = PPFConfig(),
                  icp_points=None, icp_normals=None,
                  vote_cap_per_shard: int | None = None,
                  seg_cap_per_shard: int | None = None,
                  runs_cap_per_shard: int | None = None
                  ) -> ShardedMatchResult:
    """Sized sharded match that never truncates silently, the sharded
    analog of `drost.match` (sharded_match.py:304-356). Exact engines: caps
    default to `size_sharded_caps`. Correlation engine: starts at
    runs_cap_per_shard (None: the engine's default) and, while any shard
    overflows, retries at drost._next_cap(2·cap), stopping once the cap
    covers a shard's pairs."""
    n_scene = int(scene_points.shape[0])
    D = group.size
    _, R_pad, _, _ = _shard_rows(n_scene, config.ref_point_df, D)
    s_shard = (R_pad // D) * n_scene        # scene pairs of one shard

    if config.engine != "correlation":
        if vote_cap_per_shard is None:
            vote_cap_per_shard, seg_auto = size_sharded_caps(
                model, scene_points, scene_normals, config, D)
            if seg_cap_per_shard is None:
                seg_cap_per_shard = seg_auto
        matcher = make_sharded_matcher(
            group, model, config, n_scene, vote_cap_per_shard,
            seg_cap_per_shard=seg_cap_per_shard)
        return matcher(scene_points, scene_normals, icp_points=icp_points,
                       icp_normals=icp_normals)

    rc = runs_cap_per_shard
    while True:
        matcher = make_sharded_matcher(group, model, config, n_scene, 0,
                                       runs_cap_per_shard=rc)
        res = matcher(scene_points, scene_normals, icp_points=icp_points,
                      icp_normals=icp_normals)
        if rc is not None and rc >= s_shard:
            break
        if not bool(res.overflowed):
            break
        rc = drost._next_cap(2 * (rc if rc is not None
                                  else max(s_shard // 6, 65536)))
    return res
