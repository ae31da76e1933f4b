"""The port's PPFConfig against the JAX package's, field for field."""

import dataclasses

import pytest

from objective_slam_tpu.config import PPFConfig as JaxConfig
from objective_slam_tpu_torch.config import PPFConfig as TorchConfig

_PROPS = ("d_angle", "rot_thresh", "n_feat_angle_bins", "n_alpha_bins")


def test_fields_and_defaults_match():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(JaxConfig)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(TorchConfig)]
    assert tf == jf
    assert dataclasses.is_dataclass(TorchConfig)
    assert TorchConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("kwargs", [
    {}, {"n_angle": 24}, {"n_angle": 36, "tau_d": 0.05},
    {"engine": "reference", "max_poses": 64, "ref_point_df": 5}])
def test_properties_match(kwargs):
    j, t = JaxConfig(**kwargs), TorchConfig(**kwargs)
    for name in _PROPS:
        assert getattr(t, name) == getattr(j, name), name
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
