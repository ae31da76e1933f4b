"""Build, load and launch the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by nvcc for sm_90a into a shared
library with a plain C interface and loaded with ctypes. Libraries go to
``objective_slam_tpu_torch/_build/`` (git-ignored), named by a hash of the
source, the ``csrc/*.cuh`` headers it includes and the flags, so an edited
source or header rebuilds and an unchanged one is reused. Nothing is
built at import: ``load`` builds at first use, and ``build`` compiles
several sources at once (one nvcc each, all started together).

Launching is here too: ``uses_kernel`` is the one rule that picks a kernel
or its plain twin, and ``launch`` calls a kernel's launcher on the current
stream and turns its error codes into exceptions. Each wrapper module
(``KERNELS``) keeps its own argument checks, outputs and launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# Each kernel's source name and the ops module that wraps it.
KERNELS = {"block_tally": "block_tally", "fast_tally": "fast_tally",
           "icp_refine": "icp", "gn_track": "gn_track", "raycast": "raycast"}
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list[pathlib.Path]:
    """csrc/<name>.cu and every csrc header it includes with quotes,
    directly or through another header, in the order first met."""
    found = [CSRC / f"{name}.cu"]
    for src in found:
        for inc in _INCLUDE.findall(src.read_text()):
            path = CSRC / inc
            if path.exists() and path not in found:
                found.append(path)
    return found


def library_path(name: str) -> pathlib.Path:
    """The library of csrc/<name>.cu, named by a hash of the flags, the
    source and the headers it includes, so that editing any of them
    rebuilds it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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


def wrapper(name: str):
    """The module that launches csrc/<name>.cu: its wrapper, which holds
    the module integer ``launches``."""
    return importlib.import_module(f"{__package__}.{KERNELS[name]}")


def uses_kernel(device: torch.device) -> bool:
    """The port's one path rule: a kernel for tensors on a CUDA device,
    its plain torch twin for tensors anywhere else."""
    return device.type == "cuda"


# Returned by a launcher when its kernel's block or cluster fits no SM
# (csrc/row_hist.cuh kErrNoClusterFits, csrc/icp_refine.cu, csrc/gn_track.cu).
_ERR_NO_FIT = -1


def launch(name: str, argtypes, *args, device: torch.device,
           no_fit: str) -> None:
    """Call the launcher ``osn_<name>`` of csrc/<name>.cu with `args` and
    `device`'s current stream, the stream after `args`. `argtypes` are
    the ctypes of `args`; they type the launcher once per loaded library.
    A return of −1 raises RuntimeError(no_fit), any other non-zero code
    RuntimeError with the CUDA error's text."""
    lib = load(name)
    fn = getattr(lib, f"osn_{name}")
    if not getattr(lib, "_osn_typed", False):
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.osn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.osn_cuda_error_string.restype = ctypes.c_char_p
        lib._osn_typed = True
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err == _ERR_NO_FIT:
        raise RuntimeError(no_fit)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed: "
                           + lib.osn_cuda_error_string(err).decode())
