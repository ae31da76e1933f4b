"""Configuration for the PPF pipeline (PyTorch port).

A field-for-field copy of ``objective_slam_tpu.config.PPFConfig``: same
fields, defaults and derived properties. It is copied rather than imported
because importing anything from the JAX package imports ``jax``.

See the JAX package's docstring for the meaning of each field; the port
serves every ``engine`` ("fast", "reference", "correlation"),
``use_fnv_keys`` and ``rescore_poses``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PPFConfig:
    """Algorithm parameters (reference CLI flags, alignment.cpp:119-172)."""

    engine: str = "fast"
    use_fnv_keys: bool = False
    rescore_poses: bool = False
    rescore_min_vote_frac: float = 0.7
    refine_icp: bool = False
    icp_iterations: int = 24
    icp_max_dist_factor: float = 2.0
    icp_point_to_plane: bool = False
    n_angle: int = 30
    tau_d: float = 0.1
    ref_point_df: int = 1
    vote_count_threshold: float = 0.4
    max_poses: int = 1024
    cluster_center_cell: bool = False
    use_l1_norm: bool = False
    use_averaged_clusters: bool = False
    scene_leaf_size: float = 10.0
    validation_translation_threshold: float = 0.1
    validation_rotation_threshold_deg: float = 12.0

    @property
    def d_angle(self) -> float:
        """Angle quantization step, D_ANGLE0 = 2π/n_angle (kernel.h:16)."""
        return 2.0 * math.pi / self.n_angle

    @property
    def rot_thresh(self) -> float:
        """Quaternion clustering threshold, ROT_THRESH = 2*d_angle (kernel.h:17)."""
        return 2.0 * self.d_angle

    @property
    def n_feat_angle_bins(self) -> int:
        """Feature angles in [0, π] give n_angle/2 + 1 truncated bins."""
        return self.n_angle // 2 + 1

    @property
    def n_alpha_bins(self) -> int:
        """α+π in [0, 2π] gives bins 0..n_angle (kernel.cu:341-342)."""
        return self.n_angle + 1
