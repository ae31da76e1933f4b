"""Drost-2010 PPF 6-DoF matcher — the port of
``objective_slam_tpu.models.drost`` (drost.py:42-685).

  scene points ──pairwise PPF keys + α_s──┐
                                          ├─ block-expansion voting ─ dense
  ModelDescription (key table + α_m) ─────┘   accumulator (R, n_m, 32)
                top-K + relative threshold    (model.cu:148-170)
                batched pose reconstruction   (kernel.cu:605-645)
                dense pose clustering         (kernel.cu:647-763)
                argmax winner, optional ICP   (model.cu:293-295)

Engines: "fast", "reference" (the readable engine) and "correlation"
(``voting_corr``, matmul-only, α within one bin). "fast" takes the block
engine (tally: kernel K1) when the model fits its budgets, else the
fallback engine ``voting_fast.cast_votes_fast`` (tally: kernel K2).
``use_fnv_keys`` keys the table, and every engine built from it, by
FNV-bucket rank (``hashing``); ``rescore_poses`` re-ranks near-tied Hough
peaks by their inlier score (``verify_pose``). Everything runs eagerly on
the device of the model description; numpy inputs are moved there.

Stages are ``profiling.span``s, recorded while a torch profiler runs:
``drost.match`` (the public entry), ``drost.count`` (the count pass),
``drost.core`` (one match at fixed capacities) with ``drost.keys``,
``drost.vote``, ``drost.topk`` and ``drost.cluster`` inside, and
``drost.sync`` around each host read of a device value.

A scene of more than ``PAIR_BUDGET`` reference-row × point pairs (the
fused surface of a 512³ volume at a fine d_dist) is keyed, counted and
voted in blocks of reference rows inside ``drost.vote``, each block sized
by its own exact count; the accumulator, and so every result, equals one
pass's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from objective_slam_tpu_torch._common import as_tensor, default_device, \
    f32, to_numpy
from objective_slam_tpu_torch.config import PPFConfig
from objective_slam_tpu_torch.ops import (clustering, hashing, icp,
                                          ppf as ppf_ops, transforms as tr,
                                          verify_pose, voting, voting_block,
                                          voting_corr, voting_fast)
from objective_slam_tpu_torch.utils.profiling import span

_ENGINES = ("fast", "reference", "correlation")


def _check_config(config: PPFConfig) -> None:
    if config.engine not in _ENGINES:
        raise ValueError(f"unknown engine {config.engine!r}; the port "
                         f"serves {_ENGINES}")


@dataclasses.dataclass(frozen=True)
class ModelDescription:
    """Scene-independent model description (drost.py:42-72), on one
    device. d_dist is the float32 value as a Python float."""
    points: torch.Tensor        # (n_m, 3) float32
    normals: torch.Tensor       # (n_m, 3) float32
    beta: torch.Tensor          # (n_m,) canonical Roty angle per point
    gamma: torch.Tensor         # (n_m,) canonical Rotz angle per point
    vote_weights: torch.Tensor  # (n_m,) per-point vote weights
    table: voting.KeyTable
    d_dist: float
    fast_tables: voting_fast.FastModelTables | None
    n_points: int
    num_keys: int
    max_dist_bin: int
    diameter: float
    corr_tables: voting_corr.CorrTables | None = None
    # FNV keying mode: table and engines are keyed by FNV-bucket rank.
    fnv_remap: hashing.FnvRemap | None = None

    @property
    def device(self) -> torch.device:
        return self.points.device


def build_model_description(points, normals, config: PPFConfig = PPFConfig(),
                            d_dist: float | None = None, vote_weights=None,
                            device=None) -> ModelDescription:
    """Build the model description (Model ctor, model.cu:43-82).

    d_dist defaults to tau_d · (max bbox edge) (alignment.cpp:246-253).
    The description lives on `device`: by default the device of `points`
    when it is a tensor, else the current CUDA device (no card: raises;
    pass device="cpu")."""
    _check_config(config)
    if device is None:
        device = points.device if isinstance(points, torch.Tensor) \
            else default_device()
    pts_np = to_numpy(points).astype(np.float32)
    bbox = pts_np.max(axis=0) - pts_np.min(axis=0)
    diameter = float(bbox.max())
    if d_dist is None:
        d_dist = config.tau_d * diameter
    d_dist = float(d_dist)
    max_dist_bin = int(np.linalg.norm(bbox) / d_dist) + 1
    num_keys = ppf_ops.num_keys(max_dist_bin)

    pts = as_tensor(pts_np, device)
    nrm = as_tensor(normals, device)
    n = pts.shape[0]
    keys, alpha = ppf_ops.pairwise_ppf_keys(pts, nrm, d_dist, config.d_angle,
                                            max_dist_bin)
    fnv_remap = None
    if config.use_fnv_keys:
        # Remap packed keys to FNV-bucket ranks (hash collisions conflate
        # buckets; hash 0 is left out) and key the table by rank.
        fnv_remap = hashing.build_fnv_remap(keys, d_dist, config.d_angle)
        num_keys = int(fnv_remap.occ_hashes.shape[0])
        keys = hashing.fnv_remap_keys(keys, fnv_remap, d_dist, config.d_angle)
    table = voting.build_key_table(keys, alpha, num_keys)
    beta, gamma = tr.canonical_angles(pts, nrm)
    if vote_weights is None:
        vote_weights = torch.ones(n, device=device)
    return ModelDescription(
        points=pts, normals=nrm, beta=beta, gamma=gamma,
        vote_weights=as_tensor(vote_weights, device),
        table=table, d_dist=float(np.float32(d_dist)),
        fast_tables=(voting_fast.build_fast_tables(table)
                     if config.engine in ("fast", "correlation") else None),
        corr_tables=(voting_corr.build_corr_tables(table, n, config.n_angle)
                     if config.engine == "correlation" else None),
        fnv_remap=fnv_remap,
        n_points=n, num_keys=num_keys, max_dist_bin=max_dist_bin,
        diameter=diameter)


class MatchResult(NamedTuple):
    """Result of matching one model against one scene (drost.py:147-164)."""
    pose: torch.Tensor              # (4, 4) winning transform
    cluster_votes: torch.Tensor     # () float32 winner's clustered count
    num_votes: torch.Tensor         # () int32 total Hough votes cast
    overflowed: torch.Tensor        # () bool vote capacity exceeded
    poses: torch.Tensor             # (max_poses, 4, 4) candidate poses
    pose_votes: torch.Tensor        # (max_poses,) raw vote counts (desc)
    pose_keep: torch.Tensor         # (max_poses,) threshold survivors
    clustered_counts: torch.Tensor  # (max_poses,) clustered counts
    clustered_translations: torch.Tensor  # (max_poses, 3)
    accumulator: torch.Tensor       # (R, n_m, 32) dense tallies
    topk_saturated: torch.Tensor    # () bool: raise max_poses


def _scene_inputs(model, scene_points, scene_normals, ref_point_df):
    pts = as_tensor(scene_points, model.device)
    nrm = as_tensor(scene_normals, model.device)
    ref_idx = torch.arange(0, pts.shape[0], ref_point_df, device=pts.device)
    return pts, nrm, ref_idx


# Scene pairs (reference rows × scene points) keyed at once. The keys, α
# and their temporaries take about 100 B a pair: 2²⁶ pairs about 7 GB,
# while a scene of 10⁵ points (2·10⁹ pairs at ref_point_df 5) cannot be
# keyed in one pass on one card. Above the budget the count and vote
# passes take blocks of reference rows; a row's counts and accumulator
# row are its own, so the results equal one pass's. At or below it, one
# pass, as the JAX package makes.
PAIR_BUDGET = 1 << 26


def _row_blocks(n_ref: int, n_s: int) -> list[tuple[int, int]]:
    """[start, end) blocks of reference rows, each within PAIR_BUDGET
    pairs (at least one row)."""
    step = max(1, PAIR_BUDGET // max(int(n_s), 1))
    return [(a, min(a + step, n_ref)) for a in range(0, n_ref, step)]


def _scene_keys(model: ModelDescription, scene_points, scene_normals,
                ref_idx, d_angle):
    """Scene pair keys and α_s in the model's key space: packed keys, or
    FNV-bucket ranks for a description built with use_fnv_keys
    (drost.py:167-177)."""
    keys, alpha_s = ppf_ops.pairwise_ppf_keys(
        scene_points, scene_normals, model.d_dist, d_angle,
        model.max_dist_bin, ref_indices=ref_idx)
    if model.fnv_remap is not None:
        # Every valid key lies in the packed key space: hash that once and
        # gather, rather than hashing each scene pair.
        ranks = hashing.fnv_rank_table(
            model.fnv_remap, ppf_ops.num_keys(model.max_dist_bin),
            model.d_dist, d_angle)
        valid = keys != ppf_ops.INVALID_KEY
        keys = torch.where(valid,
                           ranks[torch.where(valid, keys, 0).to(torch.int64)],
                           ppf_ops.INVALID_KEY)
    return keys, alpha_s


def _match_core(model: ModelDescription, scene_points, scene_normals, *,
                ref_point_df: int, vote_cap: int, config: PPFConfig,
                icp_points=None, icp_normals=None,
                seg_cap: int | None = None,
                runs_cap: int | None = None) -> MatchResult:
    """The matching pipeline at fixed capacities (drost.py:180-310)."""
    with span("drost.core"):
        _check_config(config)
        with span("drost.keys"):
            scene_points, scene_normals, ref_idx = _scene_inputs(
                model, scene_points, scene_normals, ref_point_df)
            blocks = _vote_blocks(config, ref_idx.shape[0],
                                  scene_points.shape[0])
            if len(blocks) == 1:
                keys, alpha_s = _scene_keys(model, scene_points,
                                            scene_normals, ref_idx,
                                            config.d_angle)
            s_ref_pts = scene_points[ref_idx]
            s_beta, s_gamma = tr.canonical_angles(s_ref_pts,
                                                  scene_normals[ref_idx])

        with span("drost.vote"):
            if len(blocks) == 1:
                votes = _cast_votes(model, config, keys, alpha_s, vote_cap,
                                    seg_cap, runs_cap)
            else:
                votes = _cast_votes_blocks(model, config, scene_points,
                                           scene_normals, ref_idx, blocks)
        with span("drost.topk"):
            top = voting.top_votes(votes.accumulator,
                                   config.vote_count_threshold,
                                   config.max_poses)
            m_idx = top.model_idx.to(torch.int64)
            r_idx = top.ref_idx.to(torch.int64)
            poses = tr.pose_from_vote(
                top.alpha_idx, model.points[m_idx], model.beta[m_idx],
                model.gamma[m_idx], s_ref_pts[r_idx], s_beta[r_idx],
                s_gamma[r_idx], config.d_angle)
            weighted = top.counts.to(torch.float32) * model.vote_weights[m_idx]
        pose, win, cl = _pick_winner(model, config, poses, weighted, top.keep,
                                     scene_points, scene_normals, icp_points,
                                     icp_normals)
        return MatchResult(
            pose=pose, cluster_votes=cl.vote_counts[win],
            num_votes=votes.num_votes, overflowed=votes.overflowed,
            poses=poses, pose_votes=top.counts, pose_keep=top.keep,
            clustered_counts=cl.vote_counts,
            clustered_translations=cl.translations,
            accumulator=votes.accumulator, topk_saturated=top.saturated)


def _cast_votes(model: ModelDescription, config: PPFConfig, keys, alpha_s,
                vote_cap: int, seg_cap: int | None = None,
                runs_cap: int | None = None) -> voting.VoteResult:
    """The configured engine's vote pass over scene keys (drost.py:208-234);
    a missing engine table raises instead of giving an empty
    accumulator."""
    if config.engine == "correlation":
        if model.corr_tables is None:
            raise ValueError("engine='correlation' but model.corr_tables is "
                             "None — rebuild tables for this engine")
        return voting_corr.cast_votes_corr(keys, alpha_s, model.corr_tables,
                                           model.n_points, runs_cap=runs_cap)
    if config.engine == "fast":
        if model.fast_tables is None:
            raise ValueError("engine='fast' but model.fast_tables is None — "
                             "rebuild tables for this engine")
        if model.fast_tables.block is not None:
            return voting_block.cast_votes_block(
                keys, alpha_s, model.fast_tables.block, model.n_points,
                config.d_angle, vote_cap, seg_cap=seg_cap)
        # Over the block budgets: the fallback engine (drost.py:228-231).
        return voting_fast.cast_votes_fast(
            keys, alpha_s, model.fast_tables, model.n_points,
            config.d_angle, vote_cap)
    return voting.cast_votes(keys, alpha_s, model.table, model.n_points,
                             config.d_angle, vote_cap)


def _vote_blocks(config: PPFConfig, n_ref: int, n_s: int):
    """The reference-row blocks of the vote pass: `_row_blocks`, or one
    block for the correlation engine, which sizes its own runs."""
    if config.engine == "correlation":
        return [(0, n_ref)]
    return _row_blocks(n_ref, n_s)


def _cast_votes_blocks(model: ModelDescription, config: PPFConfig,
                       scene_points, scene_normals, ref_idx,
                       blocks) -> voting.VoteResult:
    """The vote pass of a scene over PAIR_BUDGET, one block of reference
    rows at a time: the block's keys, its exact count and capacities (a
    host read), its votes; the blocks' accumulator rows stacked in order.
    Each block's capacities hold its count, so no vote is dropped;
    num_votes is int64, since the blocks' sum can pass int32."""
    accs, total, overflowed = [], None, None
    for a, b in blocks:
        keys, alpha_s = _scene_keys(model, scene_points, scene_normals,
                                    ref_idx[a:b], config.d_angle)
        rows = _row_counts(model, keys)
        with span("drost.sync"):
            sums = torch.stack([torch.sum(r, dtype=torch.int64)
                                for r in rows]).tolist()
        vote_cap, seg_cap = _caps(model, config, *sums, b - a)
        v = _cast_votes(model, config, keys, alpha_s, vote_cap, seg_cap)
        del keys, alpha_s
        accs.append(v.accumulator)
        n = v.num_votes.to(torch.int64)
        total = n if total is None else total + n
        overflowed = v.overflowed if overflowed is None \
            else overflowed | v.overflowed
    return voting.VoteResult(accumulator=torch.cat(accs), num_votes=total,
                             overflowed=overflowed)


def _caps(model: ModelDescription, config: PPFConfig, total: int,
          total_rows: int, n_segs: int, n_ref: int):
    """(vote_cap, seg_cap) from the exact count of `n_ref` reference rows:
    the block engine needs the row-padded votes plus one chunk per
    reference row, and seg_cap the nonzero segments; the fallback engine
    needs the votes plus TALLY_CHUNK slots per reference row."""
    seg_cap = None
    if config.engine == "fast":
        if model.fast_tables.block is not None:
            total = (total_rows + voting_block.CHUNK_ROWS * n_ref) * 128
            seg_cap = _next_cap(max(n_segs, 1024))
        else:
            total += voting_fast.TALLY_CHUNK * n_ref
    return _next_cap(total), seg_cap


def _pick_winner(model: ModelDescription, config: PPFConfig, poses, weighted,
                 keep, scene_points, scene_normals, icp_points=None,
                 icp_normals=None):
    """Dense clustering of the candidate poses, optional rescoring, the
    winner and its optional ICP refinement (drost.py:254-301); the sharded
    matcher's global phase runs the same. Returns (pose, winner index,
    clusters). The stages before ICP are the span ``drost.cluster``."""
    with span("drost.cluster"):
        cl = clustering.cluster_poses_dense(
            poses[:, :3, 3], tr.hrotmat2quat(poses), weighted, keep,
            model.d_dist, config.rot_thresh,
            include_center_cell=config.cluster_center_cell,
            use_l1_norm=config.use_l1_norm,
            use_averaged_clusters=config.use_averaged_clusters)
        if config.rescore_poses:
            # Geometric verification of the near-tied Hough peaks only
            # (drost.py:260-281): the vote count carries the
            # occlusion-robust support, the inlier score breaks ties
            # between aliased peaks.
            near = cl.vote_counts >= (f32(config.rescore_min_vote_frac)
                                      * torch.max(cl.vote_counts))
            cand = poses.clone()
            cand[:, :3, 3] = cl.translations
            scores = verify_pose.inlier_scores(
                cand, keep & near, model.points, scene_points, model.d_dist,
                model_normals=model.normals, scene_normals=scene_normals)
            combined = torch.where(keep & near,
                                   cl.vote_counts * (1.0 + scores), -1.0)
            win = torch.argmax(combined)
            pose = cand[win]
        else:
            win = torch.argmax(cl.vote_counts)
            pose = poses[win].clone()
            pose[:3, 3] = cl.translations[win]

    if config.refine_icp:
        # Voxel-pad sentinel points sit ~1e7 away and never fall inside the
        # rejection radius, so no validity mask is needed.
        if icp_points is None:
            icp_target, icp_nrm = scene_points, scene_normals
        else:
            icp_target = as_tensor(icp_points, model.device)
            icp_nrm = (None if icp_normals is None
                       else as_tensor(icp_normals, model.device))
        pose = icp.refine_pose(
            model.points, icp_target, pose,
            iterations=config.icp_iterations,
            max_dist=config.icp_max_dist_factor * model.d_dist,
            scene_normals=icp_nrm, model_normals=model.normals,
            point_to_plane=config.icp_point_to_plane).pose
    return pose, win, cl


def _count_votes_rows(model, scene_points, scene_normals, ref_point_df,
                      d_angle):
    """Exact per-reference-row counts (drost.py:326-348): three (R,) int32
    tensors, the votes, the block engine's vote rows and the nonzero
    scene-pair segments of each row. A row sum is bounded by n_s times the
    largest bucket, so int32 holds it; grand totals are summed by the
    caller."""
    pts, nrm, ref_idx = _scene_inputs(model, scene_points, scene_normals,
                                      ref_point_df)
    parts = [_row_counts(model, _scene_keys(model, pts, nrm, ref_idx[a:b],
                                            d_angle)[0])
             for a, b in _row_blocks(ref_idx.shape[0], pts.shape[0])]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(p) for p in zip(*parts))


def _row_counts(model, keys):
    """(votes, block-engine vote rows, nonzero segments) of each row of
    scene keys, int32."""
    valid = keys != ppf_ops.INVALID_KEY
    safe = torch.where(valid, keys, 0).to(torch.int64)
    cnt = torch.where(valid, model.table.counts[safe], 0)
    return (torch.sum(cnt, dim=1, dtype=torch.int32),
            torch.sum(voting_block.rows_for_counts(cnt), dim=1,
                      dtype=torch.int32),
            torch.sum(cnt > 0, dim=1, dtype=torch.int32))


def _count_votes(model, scene_points, scene_normals, ref_point_df,
                 d_angle) -> tuple[int, int, int]:
    """Exact (total votes, block-engine vote rows, nonzero scene-pair
    segments) — the count pass that sizes the buffers (drost.py:351-370);
    int32 sums of the per-row counts, as in the JAX package."""
    with span("drost.count"):
        rows = _count_votes_rows(model, scene_points, scene_normals,
                                 ref_point_df, d_angle)
        totals = torch.stack([torch.sum(r, dtype=torch.int32)
                              for r in rows])
        with span("drost.sync"):
            totals = totals.tolist()
    return int(totals[0]), int(totals[1]), int(totals[2])


def _next_cap(x: int) -> int:
    """Round a capacity up to the next {1, 1.25, 1.5, 1.75}·2^k bucket
    (drost.py:373-385)."""
    x = max(int(x), 1024)
    k = (x - 1).bit_length() - 1
    base = 1 << k
    for mult in (1.25, 1.5, 1.75, 2.0):
        cap = int(base * mult)
        if cap >= x:
            return cap
    return base * 2


class MatchCaps(NamedTuple):
    """Capacity state of one sized match (drost.py:388-397). vote_cap is 0
    for the correlation engine, which needs no vote buffer; runs_cap None
    means that engine's own default."""
    vote_cap: int
    seg_cap: int | None
    runs_cap: int | None
    max_poses: int


def match(model: ModelDescription, scene_points, scene_normals,
          config: PPFConfig = PPFConfig(), vote_cap: int | None = None,
          icp_points=None, icp_normals=None, runs_cap: int | None = None,
          max_poses_ceiling: int = 8192) -> MatchResult:
    """Sized match with the topk_saturated retry loop: max_poses doubles
    up to max_poses_ceiling (and the accumulator size); still saturated
    there, the flag comes back set (drost.py:400-419). runs_cap is the
    correlation engine's starting capacity (see _match_sized_caps); the
    other engines ignore it."""
    with span("drost.match"):
        return _match_loop(model, scene_points, scene_normals, config,
                           vote_cap, icp_points, icp_normals, runs_cap,
                           max_poses_ceiling)[0]


def _n_cells(model, scene_points, ref_point_df) -> int:
    n_s = int(scene_points.shape[0])
    R = (n_s + ref_point_df - 1) // ref_point_df
    return R * int(model.n_points) * voting.ALPHA_PAD


def match_with_state(model: ModelDescription, scene_points, scene_normals,
                     config: PPFConfig = PPFConfig(),
                     state: MatchCaps | None = None, icp_points=None,
                     icp_normals=None, max_poses_ceiling: int = 8192,
                     ) -> tuple[MatchResult, MatchCaps]:
    """Serving-loop match (drost.py:422-478): with `state` the match runs
    at the cached capacities without the count pass; on overflow, or on
    saturation below the ceiling, it falls back to the sized path.
    Saturation that persists at the ceiling is terminal: the flagged
    result comes back with the same state."""
    with span("drost.match"):
        if state is not None:
            cfg = dataclasses.replace(config, max_poses=state.max_poses)
            res = _match_core(model, scene_points, scene_normals,
                              ref_point_df=cfg.ref_point_df,
                              vote_cap=state.vote_cap, config=cfg,
                              icp_points=icp_points, icp_normals=icp_normals,
                              seg_cap=state.seg_cap, runs_cap=state.runs_cap)
            with span("drost.sync"):
                ovf, sat = torch.stack([res.overflowed,
                                        res.topk_saturated]).tolist()
            if not ovf:
                if not sat:
                    return res, state
                cells = _n_cells(model, scene_points, cfg.ref_point_df)
                if state.max_poses >= min(max_poses_ceiling, cells):
                    return res, state
        return _match_loop(model, scene_points, scene_normals, config, None,
                           icp_points, icp_normals, None, max_poses_ceiling)


def _match_loop(model, scene_points, scene_normals, config, vote_cap,
                icp_points, icp_normals, runs_cap, max_poses_ceiling):
    """The topk_saturated -> double-max_poses loop (drost.py:481-498);
    returns (result, caps that produced it)."""
    cfg = config
    while True:
        res, caps = _match_sized_caps(model, scene_points, scene_normals,
                                      cfg, vote_cap, icp_points, icp_normals,
                                      runs_cap)
        with span("drost.sync"):
            saturated = bool(res.topk_saturated)
        if not saturated:
            return res, caps
        cells = _n_cells(model, scene_points, cfg.ref_point_df)
        new_mp = min(2 * cfg.max_poses, max_poses_ceiling, cells)
        if new_mp <= cfg.max_poses:
            return res, caps
        cfg = dataclasses.replace(cfg, max_poses=new_mp)


def _match_sized_caps(model: ModelDescription, scene_points, scene_normals,
                      config: PPFConfig = PPFConfig(),
                      vote_cap: int | None = None, icp_points=None,
                      icp_normals=None, runs_cap: int | None = None
                      ) -> tuple[MatchResult, MatchCaps]:
    """Match at capacities sized by the exact count pass when vote_cap is
    None (drost.py:511-590): the block engine needs the row-padded votes
    plus one chunk per reference row, and seg_cap the nonzero segments; the
    fallback engine needs the votes plus TALLY_CHUNK slots per reference
    row.

    The correlation engine needs no vote buffer. It starts at runs_cap
    (None: its own default) and retries at the next capacity bucket while
    its histogram holds more occupied cells than the cap; the cap clamps
    to the scene-pair count, so the loop ends and no tally is truncated."""
    if config.engine == "correlation":
        if model.corr_tables is None:
            raise ValueError(
                "engine='correlation' requires corr_tables; build the model "
                "description with a correlation config")
        n_s = int(scene_points.shape[0])
        S = ((n_s + config.ref_point_df - 1) // config.ref_point_df) * n_s
        rc = runs_cap
        while True:
            res = _match_core(model, scene_points, scene_normals,
                              ref_point_df=config.ref_point_df, vote_cap=0,
                              config=config, icp_points=icp_points,
                              icp_normals=icp_normals, runs_cap=rc)
            if rc is not None and rc >= S:
                break
            with span("drost.sync"):
                overflowed = bool(res.overflowed)
            if not overflowed:
                break
            rc = _next_cap(2 * (rc if rc is not None
                                else max(S // 6, 65536)))
        return res, MatchCaps(0, None, rc, config.max_poses)
    if config.engine == "fast" and model.fast_tables is None:
        raise ValueError(
            "engine='fast' requires fast_tables; build the model "
            "description with a fast config")
    seg_cap = None
    n_s = int(scene_points.shape[0])
    n_ref = (n_s + config.ref_point_df - 1) // config.ref_point_df
    if vote_cap is None and len(_vote_blocks(config, n_ref, n_s)) > 1:
        vote_cap = 0        # each block of the vote pass sizes its own
    if vote_cap is None:
        vote_cap, seg_cap = _caps(model, config, *_count_votes(
            model, scene_points, scene_normals, config.ref_point_df,
            config.d_angle), n_ref)
    res = _match_core(model, scene_points, scene_normals,
                      ref_point_df=config.ref_point_df,
                      vote_cap=int(vote_cap), config=config,
                      icp_points=icp_points, icp_normals=icp_normals,
                      seg_cap=seg_cap)
    return res, MatchCaps(int(vote_cap), seg_cap, None, config.max_poses)


def _match_sized(model, scene_points, scene_normals,
                 config: PPFConfig = PPFConfig(), vote_cap=None,
                 icp_points=None, icp_normals=None,
                 runs_cap: int | None = None) -> MatchResult:
    return _match_sized_caps(model, scene_points, scene_normals, config,
                             vote_cap, icp_points, icp_normals, runs_cap)[0]


def match_accumulator_only(model: ModelDescription, scene_points,
                           scene_normals, config: PPFConfig = PPFConfig(),
                           vote_cap: int | None = None) -> voting.VoteResult:
    """Voting only, with the readable engine (drost.py:593-609): the dense
    accumulator of MATLAB's voting_scheme.m, for golden tests."""
    _check_config(config)
    if vote_cap is None:
        vote_cap = _next_cap(_count_votes(
            model, scene_points, scene_normals, config.ref_point_df,
            config.d_angle)[0])
    pts, nrm, ref_idx = _scene_inputs(model, scene_points, scene_normals,
                                      config.ref_point_df)
    keys, alpha_s = _scene_keys(model, pts, nrm, ref_idx, config.d_angle)
    return voting.cast_votes(keys, alpha_s, model.table, model.n_points,
                             config.d_angle, int(vote_cap))


def match_greedy_cpu(model: ModelDescription, scene_points, scene_normals,
                     config: PPFConfig = PPFConfig(),
                     vote_cap: int | None = None):
    """Match with the reference's CPU clustering mode (drost.py:612-624;
    ClusterTransformationsCPU, model.cu:246-266): device voting and pose
    reconstruction, host greedy clustering. Returns (pose, GreedyCluster)."""
    res = match(model, scene_points, scene_normals, config, vote_cap)
    keep = to_numpy(res.pose_keep)
    poses = to_numpy(res.poses)[keep]
    votes = to_numpy(res.pose_votes)[keep].astype(np.float32)
    gc = clustering.cluster_poses_greedy(poses, votes, float(model.d_dist),
                                         config.d_angle)
    return gc.poses[0], gc


def extract_instances(result: MatchResult, diameter: float,
                      max_instances: int = 8, min_votes_frac: float = 0.25,
                      min_separation_factor: float = 0.7
                      ) -> tuple[list[np.ndarray], list[float]]:
    """Greedy non-max suppression over the clustered candidates by
    translation distance (drost.py:627-685), on the host. Returns
    ([pose (4, 4)...], [clustered vote count...]), strongest first."""
    keep = to_numpy(result.pose_keep)
    poses = to_numpy(result.poses)[keep].copy()
    counts = to_numpy(result.clustered_counts)[keep]
    poses[:, :3, 3] = to_numpy(result.clustered_translations)[keep]
    if len(counts) == 0:
        return [], []
    order = np.argsort(-counts)
    vmax = float(counts[order[0]])
    thresh = min_separation_factor * diameter
    out_p: list[np.ndarray] = []
    out_c: list[float] = []
    for i in order:
        if float(counts[i]) < min_votes_frac * vmax \
                or len(out_p) >= max_instances:
            break
        t = poses[i][:3, 3]
        if all(np.linalg.norm(t - p[:3, 3]) > thresh for p in out_p):
            out_p.append(poses[i])
            out_c.append(float(counts[i]))
    return out_p, out_c
