"""The port's inlier rescoring against the JAX package's on the same poses
and clouds. A score is a count of model points over n_model; a point whose
nearest scene point sits at the inlier radius, or whose two nearest scene
points tie, may fall on the other side in the other library, so scores are
held to 2/n_model per pose, and the share of poses that differ at all is
printed. Invalid candidates score exactly -1 and every chunk size gives
the same scores."""

import numpy as np
import pytest
import torch

from objective_slam_tpu.ops import verify_pose as jvp
from objective_slam_tpu.utils import synthetic
from objective_slam_tpu_torch.ops import verify_pose as tvp


def _case(seed, n_model=60, n_poses=37):
    """A planted model among clutter and candidate poses scattered around
    the true one, some of them far off."""
    rng = np.random.default_rng(seed)
    mp, mn = synthetic.blob_cloud(rng, n_model)
    cp, cn = synthetic.clutter_cloud(rng, 80)
    sp, sn, T = synthetic.plant_model(rng, mp, mn, cp, cn)
    poses = np.tile(T[None], (n_poses, 1, 1)).astype(np.float32)
    for i in range(1, n_poses):
        R = synthetic.quat_to_matrix(synthetic.random_rotation_quat(rng))
        w = 0.02 * i / n_poses if i % 3 else 1.0
        poses[i, :3, :3] = (T[:3, :3] @ (w * R + (1 - w) * np.eye(3)))
        u, _, vt = np.linalg.svd(poses[i, :3, :3])
        poses[i, :3, :3] = u @ vt
        poses[i, :3, 3] += rng.normal(scale=0.05 * (i % 4), size=3)
    valid = rng.random(n_poses) < 0.8
    valid[0] = True
    return mp, mn, sp, sn, poses, valid


def _both(mp, mn, sp, sn, poses, valid, max_dist, normals, **kw):
    nj = dict(model_normals=mn, scene_normals=sn) if normals else {}
    nt = dict(model_normals=torch.from_numpy(mn),
              scene_normals=torch.from_numpy(sn)) if normals else {}
    want = np.asarray(jvp.inlier_scores(poses, valid, mp, sp, max_dist, **nj))
    got = tvp.inlier_scores(torch.from_numpy(poses), torch.from_numpy(valid),
                            torch.from_numpy(mp), torch.from_numpy(sp),
                            max_dist, **nt, **kw).numpy()
    return got, want


@pytest.mark.parametrize("seed,normals", [(0, True), (1, False), (2, True)])
def test_inlier_scores_match_jax(seed, normals):
    mp, mn, sp, sn, poses, valid = _case(seed)
    got, want = _both(mp, mn, sp, sn, poses, valid, 0.1, normals)
    assert got.shape == want.shape == (len(poses),)
    np.testing.assert_array_equal(got[~valid], -1.0)
    np.testing.assert_array_equal(want[~valid], -1.0)
    diff = np.abs(got - want)
    print(f"poses whose score differs: {(diff > 0).mean():.3f}, max "
          f"{diff.max() * len(mp):.1f} points")
    assert diff.max() <= 2.0 / len(mp) + 1e-7
    assert got[0] > 0.9 and got[0] == got[valid].max()


@pytest.mark.parametrize("chunk", [1, 5, 16, 64, None])
def test_chunk_size_does_not_change_scores(chunk):
    mp, mn, sp, sn, poses, valid = _case(3)
    args = (torch.from_numpy(poses), torch.from_numpy(valid),
            torch.from_numpy(mp), torch.from_numpy(sp), 0.1)
    kw = dict(model_normals=torch.from_numpy(mn),
              scene_normals=torch.from_numpy(sn))
    base = tvp.inlier_scores(*args, **kw, chunk=len(poses))
    assert torch.equal(tvp.inlier_scores(*args, **kw, chunk=chunk), base)


def test_unnormalised_normals_and_pad_rows():
    """Normals are normalised with the 1e-9 floor (a zero normal never
    agrees) and far-sentinel scene rows are nobody's neighbour."""
    mp, mn, sp, sn, poses, valid = _case(4)
    sp2 = np.concatenate([sp, np.full((8, 3), -1e7, np.float32)])
    sn2 = np.concatenate([sn * 3.0, np.zeros((8, 3), np.float32)])
    got, want = _both(mp, mn * 0.5, sp2, sn2, poses, valid, 0.1, True)
    assert np.abs(got - want).max() <= 2.0 / len(mp) + 1e-7
    ref, _ = _both(mp, mn, sp, sn, poses, valid, 0.1, True)
    np.testing.assert_array_equal(got, ref)


def test_no_candidates():
    mp, mn, sp, sn, poses, valid = _case(5)
    out = tvp.inlier_scores(torch.from_numpy(poses[:0]),
                            torch.from_numpy(valid[:0]),
                            torch.from_numpy(mp), torch.from_numpy(sp), 0.1)
    assert out.shape == (0,)
