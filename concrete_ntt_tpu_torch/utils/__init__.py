"""Host-side number theory and constant-generation utilities.

Copies of `concrete_ntt_tpu/utils/{bitrev,fastdiv,prime,roots}.py`: plain
Python integers, nothing here touches a device.
"""

from . import bitrev, fastdiv, prime, roots

__all__ = ["bitrev", "fastdiv", "prime", "roots"]
