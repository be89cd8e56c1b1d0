"""The plain reference: exact against a schoolbook product in Python integers,
in agreement with the port's plain CPU path, independent of the port, and
the float64 control wrong where the reference is right."""

from __future__ import annotations

import ast
import os
import random
import subprocess
import sys

import pytest
import torch

from ntt_bench import spec
from ntt_bench.reference import exact, float64, products

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
P = 2 ** 64 - 2 ** 32 + 1  # the PBS configuration's ciphertext modulus


def schoolbook(a, b):
    n = len(a)
    c = [0] * n
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            if i + j < n:
                c[i + j] += x * y
            else:
                c[i + j - n] -= x * y
    return c


def limbs(rows, shift):
    return torch.tensor([[(v >> shift) & 0xFFFFFFFF for v in r] for r in rows], dtype=torch.int64)


@pytest.mark.parametrize("n", [2, 16, 64])
def test_polymul_u64_is_the_wrapping_product(n):
    rng = random.Random(n)
    a = [[rng.getrandbits(64) for _ in range(n)] for _ in range(3)]
    b = [[rng.getrandbits(64) for _ in range(n)] for _ in range(3)]
    a[0] = [2 ** 64 - 1] * n  # the largest coefficients: the widest sums
    b[0] = [2 ** 64 - 1] * n
    lo, hi = products.polymul_u64(limbs(a, 0), limbs(a, 32), limbs(b, 0), limbs(b, 32))
    for r in range(3):
        want = [v % 2 ** 64 for v in schoolbook(a[r], b[r])]
        assert [int(x) + (int(y) << 32) for x, y in zip(lo[r], hi[r])] == want


def _map(v, f):
    return [_map(x, f) for x in v] if isinstance(v, list) else f(v)


def halves(v):
    """Nested lists of Python ints in [0, 2^64) → int64 halves (lo, hi)."""
    return torch.tensor(_map(v, lambda x: x & 0xFFFFFFFF)), torch.tensor(_map(v, lambda x: x >> 32))


def test_canon_gl_is_the_residue_mod_p():
    rng = random.Random(9)
    a = [rng.randrange(-2 ** 61, 2 ** 61) for _ in range(500)] + [0, 1, -1, 2 ** 32 - 1, 0, 1]
    b = [rng.randrange(-2 ** 61, 2 ** 61) for _ in range(500)] + [2 ** 32 - 1] * 3 + [0, 0, -1]
    lo, hi = products.canon_gl(torch.tensor(a), torch.tensor(b))
    assert [x + (y << 32) for x, y in zip(lo.tolist(), hi.tolist())] == [
        (x + (y << 32)) % P for x, y in zip(a, b)]


@pytest.mark.parametrize("n,terms", [(4, 1), (32, 1), (32, 3)])
def test_external_product_is_exact_mod_p(n, terms):
    """acc + Σ over the terms of Σ_i d_i ⊛ K_ij mod P, against schoolbook
    sums in Python integers; the extreme digits and key values included."""
    rng = random.Random(100 + n + terms)
    acc = [[[rng.choice((P - 1, rng.randrange(P))) for _ in range(n)] for _ in range(2)] for _ in range(2)]
    want = [[list(acc[c][j]) for j in range(2)] for c in range(2)]
    args = []
    for _ in range(terms):
        dig = [[[rng.choice((-(2 ** 22), 2 ** 22 - 1, rng.randrange(-2 ** 22, 2 ** 22)))
                 for _ in range(n)] for _ in range(2)] for _ in range(2)]
        key = [[rng.choice((P - 1, rng.randrange(P))) for _ in range(n)] for _ in range(4)]
        args.append((torch.tensor(dig), tuple(h[None] for h in halves(key))))
        for c in range(2):
            for j in range(2):
                for i in range(2):
                    want[c][j] = [u + v for u, v in zip(want[c][j], schoolbook(dig[c][i], key[2 * i + j]))]
    lo, hi = products.external_product(halves(acc), args)
    for c in range(2):
        for j in range(2):
            got = [x + (y << 32) for x, y in zip(lo[c, j].tolist(), hi[c, j].tolist())]
            assert got == [v % P for v in want[c][j]]


def test_key_sum_is_the_weighted_sum_mod_p():
    rng = random.Random(4)
    rows = [[rng.choice((P - 1, rng.randrange(P))) for _ in range(8)] for _ in range(5)]
    counts = [3, 0, 1, 7, 2]
    lo, hi = products.key_sum(torch.tensor(counts), *halves(rows))
    got = [x + (y << 32) for x, y in zip(lo.tolist(), hi.tolist())]
    assert got == [sum(c * r[k] for c, r in zip(counts, rows)) % P for k in range(8)]


def test_ntt_round_trip_and_crt():
    for p in exact.PRIMES:
        t = exact.tables(64, p, "cpu")
        x = torch.randint(0, p, (3, 64), dtype=torch.int64)
        assert torch.equal(exact.intt(exact.ntt(x, t), t), x)
    v = torch.tensor([-(2 ** 60) + 1, -1, 0, 1, 2 ** 60 - 1])
    assert torch.equal(exact.crt_signed(v % exact.PRIMES[0], v % exact.PRIMES[1]), v)


def test_agrees_with_the_ports_plain_path():
    from concrete_ntt_tpu_torch import native64, prime64

    gen = torch.Generator().manual_seed(7)
    for n in (64, 2048):
        plan = native64.Plan32.try_new(n, device="cpu")
        w = torch.randint(-2 ** 31, 2 ** 31, (4, 2, n), dtype=torch.int32, generator=gen).view(torch.uint32)
        lo, hi = plan.negacyclic_polymul((w[0], w[1]), (w[2], w[3]))
        rlo, rhi = products.polymul_u64(*(exact.u32_to_i64(x) for x in (w[0], w[1], w[2], w[3])))
        assert torch.equal(exact.u32_to_i64(lo), rlo) and torch.equal(exact.u32_to_i64(hi), rhi)
    pbs = spec.load_module("entries", "pbs_external_product")
    n = 2048
    plan = prime64.Plan.new(n, P, "cpu")
    d = torch.randint(-2 ** 22, 2 ** 22, (2, 2, n), generator=gen)
    k = pbs._uniform(gen, (4, n), "cpu")
    acc = pbs._uniform(gen, (2, 2, n), "cpu")
    fd, fk = plan.fwd(pbs._limbs(*pbs._residue(d))), plan.normalize(plan.fwd(pbs._limbs(*k)))
    outs = []
    for j in range(2):
        a = torch.zeros((2, n, 2), dtype=torch.uint32)
        for i in range(2):
            a = plan.mul_accumulate(a, fd[:, i], fk[2 * i + j])
        outs.append(a)
    got = pbs._halves(plan.inv(torch.stack(outs, dim=1)))
    s = products.external_product((torch.zeros_like(acc[0]), torch.zeros_like(acc[1])),
                                  [(d, (k[0][None], k[1][None]))])
    assert torch.equal(got[0], s[0]) and torch.equal(got[1], s[1])
    work_out = pbs.Workload.step(_Stub(plan, fk), pbs._limbs(*pbs._residue(d)), 0, pbs._limbs(*acc))
    want = products.external_product(acc, [(d, (k[0][None], k[1][None]))])
    assert torch.equal(pbs._halves(work_out)[0], want[0]) and torch.equal(pbs._halves(work_out)[1], want[1])


class _Stub:
    """What `Workload.step` reads, for one key row."""

    def __init__(self, plan, key):
        from concrete_ntt_tpu_torch.ops import u32

        self.plan, self.u32, self.key = plan, u32, key[None]
        self.zero = torch.zeros((2, plan.n, 2), dtype=torch.uint32)


def test_the_control_is_wrong_where_the_reference_is_right():
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 2 ** 32, (4, 2, 256), generator=gen)
    ref = products.polymul_u64(x[0, 0], x[0, 1], x[1, 0], x[1, 1])
    ctl = float64.polymul_u64(x[0, 0], x[0, 1], x[1, 0], x[1, 1])
    assert int(((ref[0] != ctl[0]) | (ref[1] != ctl[1])).sum()) > 128
    pbs = spec.load_module("entries", "pbs_external_product")
    acc = pbs._uniform(gen, (2, 2, 256), "cpu")
    d = torch.randint(-2 ** 22, 2 ** 22, (2, 2, 256), generator=gen)
    k = tuple(h[None] for h in pbs._uniform(gen, (4, 256), "cpu"))
    ref, ctl = products.external_product(acc, [(d, k)]), float64.external_product(acc, d, k)
    assert int(((ref[0] != ctl[0]) | (ref[1] != ctl[1])).sum()) > 256


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(ROOT, "ntt_bench", "reference")
    for fname in os.listdir(ref_dir):
        if fname.endswith(".py"):
            assert _imports(os.path.join(ref_dir, fname)) <= {"__future__", "functools", "math",
                                                               "torch"}, fname
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import ntt_bench.reference.exact, ntt_bench.reference.products, "
            "ntt_bench.reference.float64\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"concrete_ntt_tpu_torch", "concrete_ntt_tpu", "jax", "jaxlib", "flax"}
