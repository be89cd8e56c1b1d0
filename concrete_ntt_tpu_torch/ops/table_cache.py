"""On-disk cache for the four-step operator matrices.

Counterpart of `concrete_ntt_tpu/ops/table_cache.py`. Building the six
four-step operators (A, F, d, G, e, Ainv) per (n, p) in numpy takes seconds
per prime, and they are pure functions of (n, p), so they are cached as
.npz files across processes (tests, `chip_smoke.py`): `cached_operators`
for a transform's six, `cached_arrays` for any named set of uint64 arrays
(the stage-split hybrid's per-block operators, `ops/stagesplit.py`).

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


def _memoized(path: str | None, keys, build_fn):
    """build_fn()'s {name: uint64 array} dict, read from `path` where it
    holds one (all of `keys`, or any non-empty set where keys is None)."""
    if path is None:
        return build_fn()
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                out = {k: z[k] for k in (z.files if keys is None else keys)}
            if out and all(v.dtype == np.uint64 for v in out.values()):
                return out
        except (OSError, KeyError, ValueError):
            pass  # corrupt/partial file: rebuild below
    out = build_fn()
    try:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{k: np.ascontiguousarray(out[k]) for k in (keys or out)})
        os.replace(tmp, path)  # atomic: concurrent builders race benignly
    except OSError:
        pass
    return out


def _path(name: str) -> str | None:
    d = _cache_dir()
    return None if d is None else os.path.join(d, name)


def cached_operators(n: int, p: int, build_fn):
    """Return build_fn()'s {A,F,d,G,e,Ainv} dict, memoized on disk."""
    return _memoized(_path(f"fourstep_v{_FORMAT}_{n}_{p}.npz"), _KEYS, build_fn)


def cached_arrays(key: str, build_fn):
    """Return build_fn()'s {name: uint64 array} dict, memoized on disk under
    an arbitrary key (the stage-split hybrid's per-block operator sets)."""
    return _memoized(_path(f"arrays_v{_FORMAT}_{key}.npz"), None, build_fn)
