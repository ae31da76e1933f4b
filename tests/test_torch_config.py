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


def test_default_device_never_picks_the_cpu(monkeypatch):
    """Without a card, an entry point given numpy inputs and no device
    raises and says how to ask for the CPU; device="cpu" still works."""
    import numpy as np
    import torch

    import objective_slam_tpu_torch as pt
    from objective_slam_tpu_torch import _common
    from objective_slam_tpu_torch.utils import synthetic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _common.default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _common.as_tensor(np.zeros((2, 3), np.float32))
    mp, mn = synthetic.blob_cloud(np.random.default_rng(0), 40)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.build_model_description(mp, mn)
    desc = pt.build_model_description(mp, mn, device="cpu")
    assert desc.device.type == "cpu"
    assert _common.as_tensor(mp, "cpu").device.type == "cpu"
