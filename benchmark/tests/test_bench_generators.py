"""The frozen generators: the same arrays as the port's copies where
those end, and an end on the seeds where they never do."""

import numpy as np
import pytest

from benchmark.frozen import scenes
from objective_slam_tpu_torch.utils import synthetic


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_picking_scene_as_bench_draws_it(seed):
    mp, mn = scenes.blob_cloud(np.random.default_rng(0), 20000)
    mine = scenes.bin_picking_scene(np.random.default_rng(seed), mp, mn)
    theirs = synthetic.bin_picking_scene(np.random.default_rng(seed), mp,
                                         mn)
    np.testing.assert_array_equal(mine[0], theirs[0])
    np.testing.assert_array_equal(mine[1], theirs[1])


def test_uwa_analog_scene_as_the_harness_draws_it():
    models = scenes.uwa_analog_models()
    normals = {k: scenes.mesh_vertex_normals(*v) for k, v in models.items()}
    mine = scenes.uwa_analog_scene(np.random.default_rng(7), models, normals)
    theirs = synthetic.uwa_analog_scene(np.random.default_rng(7), models,
                                        normals)
    np.testing.assert_array_equal(mine[0], theirs[0])


@pytest.mark.parametrize("seed", [3100000007, 3000000003])
def test_placement_ends(seed):
    """Seeds whose placement never ends in bench.py's loop (the first
    offsets leave no room for the last instance)."""
    mp, mn = scenes.blob_cloud(np.random.default_rng([seed, 0]), 20000)
    for i in range(16):
        p, n, truths = scenes.bin_picking_scene(
            np.random.default_rng([seed, 1 + i]), mp, mn)
        assert p.shape == (100_000, 3) and len(truths) == 4
