"""Raw binary array dumps for comparison with other implementations.

A copy of ``objective_slam_tpu.utils.debug_dump`` (numpy only): the
reference dumps device arrays as raw little-endian binaries for a
MATLAB-side comparison (write_device_vector, include/impl/util.hpp:55-91;
matlab/utils/compare_data_with_pcl.m). Tensors are copied to the host
first.
"""

from __future__ import annotations

import numpy as np

from objective_slam_tpu_torch._common import to_numpy


def dump_array(path, arr) -> None:
    """Write the raw little-endian bytes of `arr` (C order, no header)."""
    a = np.ascontiguousarray(to_numpy(arr))
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    with open(path, "wb") as f:
        f.write(a.tobytes())


def load_array(path, dtype, shape=None):
    """Read a raw dump back. shape=None returns a flat array."""
    data = np.fromfile(path, dtype=np.dtype(dtype).newbyteorder("<"))
    if shape is not None:
        data = data.reshape(shape)
    return data
