"""On-disk cache for the four-step operator matrices.

Counterpart of `concrete_ntt_tpu/ops/table_cache.py`. Building the six
four-step operators (A, F, d, G, e, Ainv) per (n, p) in numpy takes seconds
per prime, and they are pure functions of (n, p), so they are cached as
.npz files across processes (tests, `chip_smoke.py`).

The cache lives inside the package, in `_build/tables/` (ignored by git), so
it never mixes with the JAX package's files and nothing is written outside
the checkout. Delete the directory to force a rebuild.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

_FORMAT = 1  # bump to invalidate all cached operator files
_KEYS = ("A", "F", "d", "G", "e", "Ainv")
_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build", "tables")


def _cache_dir() -> str | None:
    try:
        os.makedirs(_DIR, exist_ok=True)
        return _DIR
    except OSError:
        return None


def cached_operators(n: int, p: int, build_fn):
    """Return build_fn()'s {A,F,d,G,e,Ainv} dict, memoized on disk."""
    d = _cache_dir()
    if d is None:
        return build_fn()
    path = os.path.join(d, f"fourstep_v{_FORMAT}_{n}_{p}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                ops = {k: z[k] for k in _KEYS}
            if all(ops[k].dtype == np.uint64 for k in _KEYS):
                return ops
        except (OSError, KeyError, ValueError):
            pass  # corrupt/partial file: rebuild below
    ops = build_fn()
    try:
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{k: np.ascontiguousarray(ops[k]) for k in _KEYS})
        os.replace(tmp, path)  # atomic: concurrent builders race benignly
    except OSError:
        pass
    return ops
