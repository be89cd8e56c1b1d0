"""Build `csrc/hostmath64.cpp` with the host C++ compiler and bind it.

The 64-bit four-step tables need 64 x 64-bit products mod p, which numpy's
uint64 cannot hold; `csrc/hostmath64.cpp` computes them on unsigned
__int128. It is compiled on first use into `_build/host/hostmath64_<hash>.so`
(ignored by git), keyed on a hash of the source and the flags:

    c++ -O2 -std=c++17 -shared -fPIC -o hostmath64_<hash>.so csrc/hostmath64.cpp

($CXX, then c++, g++, clang++ on PATH.) A missing compiler or a failed build
raises with the compiler's output: there is no slower route to switch to.
The operators it builds are cached on disk by `ops/table_cache.py`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "hostmath64.cpp")
_BUILD = os.path.join(_PKG, "_build", "host")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_LIB: ctypes.CDLL | None = None


def find_cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError(
        "no C++ compiler found ($CXX, c++, g++, clang++): one is needed to build "
        "csrc/hostmath64.cpp, which makes the tables of the 64-bit four-step engine"
    )


def _build() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(FLAGS).encode() + f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD, f"hostmath64_{digest}.so")
    if os.path.exists(so):
        return so
    cxx = find_cxx()
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD, suffix=".so")
    os.close(fd)
    cmd = [cxx, *FLAGS, "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"failed to build csrc/hostmath64.cpp:\n$ {' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, so)  # atomic: concurrent compiles race benignly
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.fourstep_build.restype = ctypes.c_int
        lib.fourstep_build.argtypes = [ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64, *[u64p] * 8]
        lib.prep_matrix.restype = ctypes.c_int
        lib.prep_matrix.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
    return _LIB


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def fourstep_build(n: int, p: int, n1: int, twid, inv_twid) -> dict:
    """The six four-step operators (uint64 mod p) of (n, p) with n = n1·n2,
    from the bit-reversed negacyclic twiddle tables (sequences of ints)."""
    n2 = n // n1
    tw = np.array(twid, dtype=np.uint64)
    itw = np.array(inv_twid, dtype=np.uint64)
    shapes = {"A": (n1, n1), "F": (n2, n2), "d": (n1, n2), "G": (n2, n2), "e": (n1, n2),
              "Ainv": (n1, n1)}
    ops = {k: np.zeros(s, dtype=np.uint64) for k, s in shapes.items()}
    st = _lib().fourstep_build(p, n, n1, _u64p(tw), _u64p(itw), *(_u64p(a) for a in ops.values()))
    if st != 0:
        raise AssertionError(f"four-step factorization check {st} failed for n={n}, p={p}")
    return ops


def prep_matrix(M: np.ndarray, p: int, n_eplanes: int, n_dplanes: int):
    """(planes int8 [E*K, D*O], cvec int32 [D, O]) of M [K, O] mod p."""
    M = np.ascontiguousarray(M, dtype=np.uint64)
    k, o = M.shape
    planes = np.zeros((n_eplanes * k, n_dplanes * o), dtype=np.int8)
    cvec = np.zeros((n_dplanes, o), dtype=np.int32)
    st = _lib().prep_matrix(
        _u64p(M), k, o, p, n_eplanes, n_dplanes,
        planes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        cvec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if st != 0:
        raise AssertionError(f"digit-plane packing overflow (status {st}) for p={p}")
    return planes, cvec
