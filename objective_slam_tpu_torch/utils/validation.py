"""Ground-truth validation (port of ``objective_slam_tpu.utils.validation``,
validation.py:20-49): the reference match criteria of alignment.cpp:317-332
on the ported ``ht_dist``."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from objective_slam_tpu_torch._common import as_tensor
from objective_slam_tpu_torch.config import PPFConfig
from objective_slam_tpu_torch.ops import transforms as tr


class ValidationResult(NamedTuple):
    trans_err: float
    rot_err: float          # radians
    trans_thresh: float
    rot_thresh: float       # radians
    trans_match: bool
    rot_match: bool
    match: bool


def validate_pose(pose, truth, model_diameter: float,
                  config: PPFConfig = PPFConfig()) -> ValidationResult:
    """Match iff translation error < threshold · diameter and rotation
    error < threshold degrees (computed on the CPU in float32)."""
    cpu = torch.device("cpu")
    td, rd = tr.ht_dist(as_tensor(pose, cpu), as_tensor(truth, cpu))
    td, rd = float(td), float(rd)
    tt = config.validation_translation_threshold * model_diameter
    rt = math.radians(config.validation_rotation_threshold_deg)
    return ValidationResult(trans_err=td, rot_err=rd, trans_thresh=tt,
                            rot_thresh=rt, trans_match=td < tt,
                            rot_match=rd < rt, match=td < tt and rd < rt)
