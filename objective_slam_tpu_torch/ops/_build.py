"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by nvcc for sm_90a into a shared
library with a plain C interface and loaded with ctypes. Libraries go to
``objective_slam_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. Nothing is built at import: ``load`` builds at first use, and
``build`` compiles several sources at once (one nvcc each, all started
together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("block_tally", "fast_tally")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and pathlib.Path(root, "bin", "nvcc").exists():
            return str(pathlib.Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile the libraries of `names` that are not built yet, one nvcc
    process per source, all running at once. Returns {name: compiler
    output} (ptxas register and shared-memory report) for those built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, so)
        logs = {}
        for name, (proc, tmp, so) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, so)
            logs[name] = out
        return logs
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = library_path(name)
            if not so.exists():
                build((name,))
            lib = ctypes.CDLL(str(so))
            _libs[name] = lib
        return lib
