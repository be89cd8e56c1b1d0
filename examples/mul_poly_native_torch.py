"""Wrapping-u32 negacyclic product on the PyTorch + CUDA port (twin of
examples/mul_poly_native.py, port of examples/mul_poly_native.rs).

native32::Plan32, n = 1024: the product equals the schoolbook negacyclic
convolution computed in wrapping u32 machine arithmetic. Runs on the card;
`--device cpu` runs the plain torch path.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from concrete_ntt_tpu_torch import native32
from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_wrapping

N = 1024

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
device = ap.parse_args().device

rng = np.random.default_rng(0)
lhs = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
rhs = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)

plan = native32.Plan32.try_new(N, device=device)
assert plan is not None
prod = plan.negacyclic_polymul(lhs, rhs).cpu().numpy()

expected = negacyclic_convolution_wrapping(lhs.tolist(), rhs.tolist(), 32)
assert prod.tolist() == expected
print(f"ok: wrapping-u32 negacyclic product, n={N}, 3 CRT channels, on {device}")
