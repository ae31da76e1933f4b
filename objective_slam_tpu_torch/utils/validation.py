"""Ground-truth validation (port of ``objective_slam_tpu.utils.validation``,
validation.py:20-67): the reference match criteria of alignment.cpp:317-332
on the ported ``ht_dist``, and the 4x4 truth files the CLI reads."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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


def read_truth_file(path) -> np.ndarray:
    """A whitespace-separated 4x4 row-major matrix — the validation file
    format Eigen's operator>> reads (util.hpp:95-104)."""
    vals = []
    with open(path) as f:
        for line in f:
            vals.extend(float(x) for x in line.split())
    if len(vals) < 16:
        raise ValueError(f"{path}: expected 16 floats, got {len(vals)}")
    return np.asarray(vals[:16], np.float32).reshape(4, 4)


def write_truth_file(path, T) -> None:
    T = np.asarray(T, np.float32)
    with open(path, "w") as f:
        for row in T:
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
