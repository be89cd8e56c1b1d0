"""The port's examples (`examples/*_torch.py`, twins of the JAX package's
three) run to their `ok:` line with `--device cpu`, each in a subprocess of
its own with its own time limit. On the card `chip_smoke.py` runs them
without the flag."""

import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["mul_poly_native_torch.py", "mul_poly_prime_torch.py",
                                  "mul_poly_product_accumulate_torch.py"])
def test_example_runs_on_cpu(name):
    done = subprocess.run([sys.executable, str(ROOT / "examples" / name), "--device", "cpu"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.startswith("ok:") and "on cpu" in done.stdout
