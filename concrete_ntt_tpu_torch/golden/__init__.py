"""Golden (oracle) models: exact bigint and numpy implementations.

The port's kernels and plain paths are asserted bit-exact against these.
"""

from . import ntt, polymul

__all__ = ["ntt", "polymul"]
