"""Model-description files, shared with the JAX package.

The system has no learned weights: its parameters are the
``ModelDescription``. ``save_model_description`` writes the ``.npz`` format
3 of ``objective_slam_tpu.utils.serialization`` (serialization.py:23-57)
and ``load_model_description`` reads formats 1-3, so a description saved
by either package loads into the other. As there, the engine tables are
not stored: the block, fallback and correlation tables are rebuilt from
the key table on load. ``description_from_arrays`` takes the same arrays
and meta keys without a file.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from objective_slam_tpu_torch._common import default_device, to_numpy
from objective_slam_tpu_torch.models import drost
from objective_slam_tpu_torch.ops import hashing, voting, voting_corr, \
    voting_fast

_FORMAT_VERSION = 3
_FORMAT_VERSIONS = (1, 2, _FORMAT_VERSION)


def save_model_description(path, desc: drost.ModelDescription) -> None:
    """Write a ModelDescription to an .npz file in the JAX package's
    format 3 (the FNV dictionary as uint32)."""
    meta = {
        "format_version": _FORMAT_VERSION,
        "n_points": desc.n_points,
        "num_keys": desc.num_keys,
        "max_dist_bin": desc.max_dist_bin,
        "diameter": desc.diameter,
        "has_fast_tables": desc.fast_tables is not None,
        "has_corr_tables": desc.corr_tables is not None,
        "corr_n_angle": (desc.corr_tables.n_angle
                         if desc.corr_tables is not None else None),
        "fnv_k_occ": (desc.fnv_remap.k_occ
                      if desc.fnv_remap is not None else None),
    }
    extra = {}
    if desc.fnv_remap is not None:
        extra["fnv_occ_hashes"] = to_numpy(desc.fnv_remap.occ_hashes) \
            .astype(np.uint32)
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **extra,
        points=to_numpy(desc.points),
        normals=to_numpy(desc.normals),
        beta=to_numpy(desc.beta),
        gamma=to_numpy(desc.gamma),
        vote_weights=to_numpy(desc.vote_weights),
        d_dist=np.asarray(desc.d_dist, np.float32),
        counts=to_numpy(desc.table.counts),
        offsets=to_numpy(desc.table.offsets),
        pair_mr=to_numpy(desc.table.pair_mr),
        pair_alpha=to_numpy(desc.table.pair_alpha),
        max_count=to_numpy(desc.table.max_count),
    )


def description_from_arrays(arrays, meta, device=None
                            ) -> drost.ModelDescription:
    """ModelDescription from the saved arrays (`points`, `normals`, `beta`,
    `gamma`, `vote_weights`, `d_dist`, `counts`, `offsets`, `pair_mr`,
    `pair_alpha`, `max_count`, and `fnv_occ_hashes` in FNV mode) and meta
    (`n_points`, `num_keys`, `max_dist_bin`, `diameter`, plus the table
    flags)."""
    device = default_device() if device is None else torch.device(device)

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(arrays[name])).to(device)

    table = voting.KeyTable(counts=t("counts"), offsets=t("offsets"),
                            pair_mr=t("pair_mr"), pair_alpha=t("pair_alpha"),
                            max_count=t("max_count"))
    fast_tables = (voting_fast.build_fast_tables(table)
                   if meta.get("has_fast_tables", False) else None)
    corr_tables = None
    if meta.get("has_corr_tables", False):
        corr_tables = voting_corr.build_corr_tables(
            table, int(meta["n_points"]), n_angle=int(meta["corr_n_angle"]))
    fnv_remap = None
    if meta.get("fnv_k_occ") is not None:
        occ = np.asarray(arrays["fnv_occ_hashes"]).astype(np.int64)
        fnv_remap = hashing.FnvRemap(
            occ_hashes=torch.from_numpy(occ).to(device),
            k_occ=int(meta["fnv_k_occ"]))
    return drost.ModelDescription(
        points=t("points"), normals=t("normals"), beta=t("beta"),
        gamma=t("gamma"), vote_weights=t("vote_weights"), table=table,
        d_dist=float(np.float32(arrays["d_dist"])),
        fast_tables=fast_tables, corr_tables=corr_tables,
        fnv_remap=fnv_remap, n_points=int(meta["n_points"]),
        num_keys=int(meta["num_keys"]),
        max_dist_bin=int(meta["max_dist_bin"]),
        diameter=float(meta["diameter"]))


def load_model_description(path, device=None) -> drost.ModelDescription:
    """Read a description saved by either package's
    ``save_model_description``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["format_version"] not in _FORMAT_VERSIONS:
            raise ValueError(f"unsupported model description version "
                             f"{meta['format_version']}")
        arrays = {k: z[k] for k in z.files if k != "meta"}
    return description_from_arrays(arrays, meta, device)
