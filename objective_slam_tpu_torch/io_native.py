"""ctypes bindings to the native runtime (native/*.cpp), the port's own
copy of ``objective_slam_tpu.io_native`` (importing that module would
import the JAX package).

The reference's runtime around the device code is native C++ (PLY loading
via PCL, greedy clustering in transformation_clustering.cpp); these bindings
expose the rebuild's native equivalents from the repository's
``native/libobjective_slam_native.so``. Every entry point has a Python
counterpart (utils.ply, ops.clustering), and nothing on the match path
calls this module; `make -C native` builds the library.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parent.parent / "native" / \
    "libobjective_slam_native.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        raise OSError(f"native library not built: {_LIB_PATH} "
                      "(run `make -C native`)")
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.osn_ply_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long)]
    lib.osn_ply_read.restype = ctypes.c_int
    lib.osn_ply_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.osn_ply_write.restype = ctypes.c_int
    lib.osn_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.osn_cluster_poses_greedy.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.osn_cluster_poses_greedy.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def read_ply(path):
    """Native binary/ascii PLY read -> (points, normals|None)."""
    lib = _load()
    pts_p = ctypes.POINTER(ctypes.c_float)()
    nrm_p = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long()
    rc = lib.osn_ply_read(str(path).encode(), ctypes.byref(pts_p),
                          ctypes.byref(nrm_p), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"osn_ply_read({path}) failed with code {rc}")
    count = n.value
    pts = np.ctypeslib.as_array(pts_p, shape=(count, 3)).copy()
    normals = None
    if nrm_p:
        normals = np.ctypeslib.as_array(nrm_p, shape=(count, 3)).copy()
    lib.osn_free(pts_p)
    if nrm_p:
        lib.osn_free(nrm_p)
    return pts, normals


def write_ply(path, points, normals=None):
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    n = pts.shape[0]
    nrm_arg = None
    if normals is not None:
        nrm = np.ascontiguousarray(normals, np.float32)
        nrm_arg = nrm.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.osn_ply_write(str(path).encode(),
                           pts.ctypes.data_as(
                               ctypes.POINTER(ctypes.c_float)),
                           nrm_arg, n)
    if rc != 0:
        raise IOError(f"osn_ply_write({path}) failed with code {rc}")


def cluster_poses_greedy(poses, votes, trans_thresh, rot_thresh,
                         max_clusters: int = 3):
    """Native greedy clustering -> (poses (k,4,4), votes (k,))."""
    lib = _load()
    poses = np.ascontiguousarray(poses, np.float32)
    votes = np.ascontiguousarray(votes, np.float32)
    P = poses.shape[0]
    out_p = np.zeros((max_clusters, 16), np.float32)
    out_v = np.zeros((max_clusters,), np.float32)
    k = lib.osn_cluster_poses_greedy(
        poses.reshape(P, 16).ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        votes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        P, trans_thresh, rot_thresh, max_clusters,
        out_p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out_p[:k].reshape(k, 4, 4), out_v[:k]
