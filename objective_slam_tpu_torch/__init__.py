"""objective_slam_tpu_torch — the PyTorch/CUDA port of objective_slam_tpu.

Point-pair-feature (PPF) 6-DoF object recognition (Drost et al. 2010)
for an NVIDIA Hopper GPU: build a model description from a point cloud
with normals, match it against a scene, get a 4x4 pose. The JAX package
``objective_slam_tpu`` is the reference each module is held against; this
package imports torch and numpy, never jax.

Layout (same module and function names as the JAX package):
  ops/transforms, ops/ppf    rigid-transform math, PPF keys and α
  ops/voting, voting_block   key table, readable engine, top-K; the
                             block-expansion engine of the main path
  ops/voting_fast            the fallback engine for models over the
                             block budgets
  ops/voting_corr            the correlation engine (matrix products only,
                             α within one bin)
  ops/hashing                FNV-1a hashes and the FNV keying mode
  ops/verify_pose            inlier rescoring of candidate poses
  ops/block_tally            kernel K1 (csrc/block_tally.cu) + plain twin
  ops/fast_tally             kernel K2 (csrc/fast_tally.cu) + plain twin
  ops/clustering, ops/icp    pose clustering, ICP refinement
  models/drost               ModelDescription, match, match_with_state
  pipeline, cli              ppf_registration and the `alignment` CLI
                             (python -m objective_slam_tpu_torch.cli)
  utils/                     voxel grid, normal estimation, PLY and STL
                             files, synthetic scenes, validation, the HTML
                             viewer, description files shared with the JAX
                             package
"""

import torch as _torch

# Full float32 matrix products, mirroring the JAX package's
# Precision.HIGHEST pin: under reduced precision the ICP pose chain
# random-walks (CLAUDE.md, "Hard-won TPU facts").
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from objective_slam_tpu_torch.config import PPFConfig  # noqa: E402,F401
from objective_slam_tpu_torch.models.drost import (  # noqa: E402,F401
    MatchCaps,
    ModelDescription,
    build_model_description,
    match,
    match_with_state,
)
