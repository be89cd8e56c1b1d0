"""The committed dense-oracle fixture (tests/fixtures/dense_oracle_2048.json)
on the port's plain path: native32 Plan32, native64 Plan32 and Plan52,
native128 Plan32 and native_binary64 Plan32 at N = 2048 (the K1 route's
smallest size) with device="cpu", against the SHA-256 digests of the exact
wrapping products. The rows are tools/gpu_parity.py's fixture rows, which
`chip_smoke.py` runs on the card; the inputs are drawn as
tools/make_dense_fixture.py and tests/test_dense_fixture.py draw them.
"""

import importlib.util
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("gpu_parity",
                                               os.path.join(_ROOT, "tools", "gpu_parity.py"))
gp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gp)

ROWS = gp.fixture_rows()


@pytest.mark.parametrize("row", ROWS, ids=[r.name.split()[1] for r in ROWS])
def test_dense_fixture_digest(row):
    assert gp.check_row(gp.Ctx("cpu", quick=False, seed=0), row) == "SHA-256 digest equal"


def test_fixture_inputs_follow_the_jax_test():
    """The tool draws the fixture's inputs as tests/test_dense_fixture.py does."""
    import numpy as np

    fix = gp.dense_fixture()
    rng = np.random.default_rng(fix["seed"])
    n = fix["n"]
    a64 = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    inputs = gp.dense_inputs(fix)
    assert inputs["native64"][0] == a64.tolist()
    assert set(inputs["native_binary64"][1]) <= {0, 1}
    assert all(v < 1 << 128 for v in inputs["native128"][1])
