"""The repo's static gate (tools/lint.py, `make lint`) on the port: every
`.py` of `concrete_ntt_tpu_torch/`, `chip_smoke.py` and tools/gpu_parity.py,
one case a file. The gate's own scope (`SCOPES`) predates the port; this
test holds the port's files to the same checks."""

import importlib.util
import os
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("repo_lint", _ROOT / "tools" / "lint.py")
lint = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lint)

FILES = sorted(p.relative_to(_ROOT).as_posix()
               for p in (_ROOT / "concrete_ntt_tpu_torch").rglob("*.py")
               if "_build" not in p.parts)
FILES += ["chip_smoke.py", os.path.join("tools", "gpu_parity.py")]


@pytest.mark.parametrize("rel", FILES)
def test_port_file_is_lint_clean(rel):
    assert lint.lint_file(_ROOT / rel) == []
