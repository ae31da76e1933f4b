"""Registration loop: match every model against every scene.

Port of ``objective_slam_tpu.pipeline`` (pipeline.py:31-104), the
equivalent of ppf_registration (src/cuda/ppf.cu:29-106): model
descriptions are built once per model and reused across scenes, on one
device; scene keys are still computed per (scene, model) pair with that
model's d_dist. The log lines are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

import numpy as np

from objective_slam_tpu_torch._common import to_numpy
from objective_slam_tpu_torch.config import PPFConfig
from objective_slam_tpu_torch.models import drost

log = logging.getLogger("objective_slam_tpu_torch")


@dataclasses.dataclass
class RegistrationOutput:
    poses: list[list[np.ndarray]]          # [scene][model] -> (4, 4)
    results: list[list]                    # MatchResult or GreedyCluster
    descriptions: list[drost.ModelDescription]


def ppf_registration(scene_clouds: Sequence[tuple], model_clouds:
                     Sequence[tuple], model_d_dists: Sequence[float],
                     config: PPFConfig = PPFConfig(),
                     cpu_clustering: bool = False,
                     icp_clouds: Sequence[tuple] | None = None,
                     runs_cap: int | None = None,
                     device=None) -> RegistrationOutput:
    """Match all models in all scenes.

    scene_clouds / model_clouds: (points, normals) pairs, numpy or
    tensors, already downsampled (the CLI does it). model_d_dists: per-model
    quantization steps (tau_d · diameter). cpu_clustering: the greedy host
    clustering mode (model.cu:246-266). icp_clouds: per-scene
    full-resolution clouds for ICP, used when config.refine_icp. runs_cap:
    see drost.match. device: where the descriptions live (default: the
    current CUDA device; pass "cpu" to run on the CPU)."""
    descriptions = []
    for (mp, mn), d_dist in zip(model_clouds, model_d_dists):
        desc = drost.build_model_description(mp, mn, config, d_dist=d_dist,
                                             device=device)
        log.info("model description: %d points, d_dist=%.4f, %d keys",
                 desc.n_points, float(desc.d_dist), desc.num_keys)
        descriptions.append(desc)

    poses: list[list[np.ndarray]] = []
    results: list[list] = []
    for si, (sp, sn) in enumerate(scene_clouds):
        poses.append([])
        results.append([])
        for mi, desc in enumerate(descriptions):
            if cpu_clustering:
                pose, res = drost.match_greedy_cpu(desc, sp, sn, config)
                T = np.asarray(pose)
            else:
                res = drost.match(
                    desc, sp, sn, config,
                    icp_points=None if icp_clouds is None
                    else icp_clouds[si][0],
                    icp_normals=None if icp_clouds is None
                    else icp_clouds[si][1],
                    runs_cap=runs_cap)
                T = to_numpy(res.pose)
                if bool(res.overflowed):
                    log.warning("scene %d model %d: vote buffer overflow",
                                si, mi)
                if bool(res.topk_saturated):
                    log.warning("scene %d model %d: top-k saturated — "
                                "threshold survivors may exceed max_poses; "
                                "raise --max_poses", si, mi)
                log.info("scene %d model %d: votes=%d winner_votes=%.1f",
                         si, mi, int(res.num_votes),
                         float(res.cluster_votes))
            log.info("Found transformation:\n%s", T)
            poses[-1].append(T)
            results[-1].append(res)
    return RegistrationOutput(poses=poses, results=results,
                              descriptions=descriptions)
