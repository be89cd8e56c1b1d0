"""Negacyclic polynomial product over Z/pZ on the PyTorch + CUDA port (twin
of examples/mul_poly_prime.py, port of examples/mul_poly_prime.rs).

p = 1073479681, n = 1024: fwd both operands, fused pointwise multiply +
normalize, inverse transform; asserts equality with the schoolbook oracle.
Runs on the card; `--device cpu` runs the plain torch path.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from concrete_ntt_tpu_torch import prime32
from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_mod

N = 1024
P = 1073479681

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
device = ap.parse_args().device

rng = np.random.default_rng(0)
lhs = rng.integers(0, P, N).astype(np.uint32)
rhs = rng.integers(0, P, N).astype(np.uint32)

plan = prime32.Plan.new(N, P, device=device)
prod = plan.negacyclic_polymul(lhs, rhs).cpu().numpy()

expected = negacyclic_convolution_mod(lhs.tolist(), rhs.tolist(), P)
assert prod.tolist() == expected
print(f"ok: negacyclic product of two degree-{N - 1} polynomials mod {P}, on {device}")
