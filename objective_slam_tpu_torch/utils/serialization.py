"""Carrying a model description across from the JAX package.

The system has no learned weights: its parameters are the
``ModelDescription``. ``description_from_arrays`` takes exactly the arrays
and meta keys that ``objective_slam_tpu.utils.serialization.
save_model_description`` writes (serialization.py:26-57) and rebuilds the
block tables on the host, as the JAX loader does (:74-75);
``load_model_description`` reads such an ``.npz`` (format 1-3).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from objective_slam_tpu_torch._common import default_device
from objective_slam_tpu_torch.models import drost
from objective_slam_tpu_torch.ops import voting, voting_fast

_FORMAT_VERSIONS = (1, 2, 3)


def description_from_arrays(arrays, meta, device=None
                            ) -> drost.ModelDescription:
    """ModelDescription from the saved arrays (`points`, `normals`, `beta`,
    `gamma`, `vote_weights`, `d_dist`, `counts`, `offsets`, `pair_mr`,
    `pair_alpha`, `max_count`) and meta (`n_points`, `num_keys`,
    `max_dist_bin`, `diameter`, plus the table flags)."""
    if meta.get("fnv_k_occ") is not None:
        raise NotImplementedError(
            "FNV-keyed model descriptions are not ported yet (ROADMAP queue "
            "1 item 12)")
    if meta.get("has_corr_tables", False):
        raise NotImplementedError(
            "model descriptions built for engine='correlation' are not "
            "ported yet (ROADMAP queue 1 item 13)")
    device = default_device() if device is None else torch.device(device)

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(arrays[name])).to(device)

    table = voting.KeyTable(counts=t("counts"), offsets=t("offsets"),
                            pair_mr=t("pair_mr"), pair_alpha=t("pair_alpha"),
                            max_count=t("max_count"))
    fast_tables = (voting_fast.build_fast_tables(table)
                   if meta.get("has_fast_tables", False) else None)
    return drost.ModelDescription(
        points=t("points"), normals=t("normals"), beta=t("beta"),
        gamma=t("gamma"), vote_weights=t("vote_weights"), table=table,
        d_dist=float(np.float32(arrays["d_dist"])),
        fast_tables=fast_tables, n_points=int(meta["n_points"]),
        num_keys=int(meta["num_keys"]),
        max_dist_bin=int(meta["max_dist_bin"]),
        diameter=float(meta["diameter"]))


def load_model_description(path, device=None) -> drost.ModelDescription:
    """Read a description saved by the JAX package's
    ``save_model_description``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["format_version"] not in _FORMAT_VERSIONS:
            raise ValueError(f"unsupported model description version "
                             f"{meta['format_version']}")
        arrays = {k: z[k] for k in z.files if k != "meta"}
    return description_from_arrays(arrays, meta, device)
