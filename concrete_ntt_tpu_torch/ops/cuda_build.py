"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` (`SOURCES`) has a plain C interface and is compiled on
first use into `_build/kernels/<name>_<hash>.so` (ignored by git), keyed on
a hash of all the sources (headers included) and the flags:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <name>_<hash>.so csrc/<name>.cu

The compiler's output (ptxas register and shared-memory report included) is
kept beside the library as `<name>_<hash>.log`. A missing nvcc or a failed
build raises with the compiler's output; nothing falls back. `call` runs a
loaded entry point on a device's current stream: every kernel wrapper
(`ops/*_cuda.py`) launches through it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build", "kernels")
# the CUDA toolkit's default install prefix, tried after CUDA_HOME and PATH
_NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SOURCES = ("mxu32_multi", "mxu32_pass", "butterfly32", "mxu64_pass", "mxu64_multi", "crt_lift",
           "crt_lift128", "mont32_pointwise")

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit default."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        _NVCC_DEFAULT,
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{_NVCC_DEFAULT}): the CUDA toolkit is needed to build the port's kernels"
    )


def library_path(name: str) -> str:
    """Where the library for csrc/<name>.cu lives, keyed on sources + flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; returns its path.
    Safe to call for several sources at once from threads."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    nvcc = find_nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD, suffix=".so")
    os.close(fd)
    cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}"
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu:\n{log}")
    with open(so[:-3] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, so)  # atomic: concurrent builders race benignly
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _LIBS[name] = lib
    return lib


def call(dev: torch.device, fn, *args) -> int:
    """fn(*args, stream) with `dev` current, on its current stream: a
    loaded entry point's launch; returns its CUDA error code."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)
