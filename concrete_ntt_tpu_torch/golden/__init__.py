"""Golden (oracle) models: exact bigint and numpy implementations.

The port's kernels and plain paths are asserted bit-exact against these.
"""

from . import crt, ntt, polymul

__all__ = ["crt", "ntt", "polymul"]
