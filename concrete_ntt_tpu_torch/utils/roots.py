"""Primitive-root finding for NTT twiddle construction (host-side).

Capability parity with the reference's src/roots.rs: factor p-1 = q*2^s
(roots.rs:6-15), find a quadratic non-residue (roots.rs:17-28), Tonelli–Shanks
modular square root (roots.rs:31-66), and `find_primitive_root64(p, degree)`
(roots.rs:68-91) which walks up from -1 (a primitive 2nd root of unity) by
repeated modular square roots until a primitive `degree`-th root is reached.

Runs at plan-build time on the host; plain Python integers.
"""

from __future__ import annotations


def get_q_s(p: int) -> tuple[int, int]:
    """Factor p - 1 = q * 2^s with q odd (reference: get_q_s64, roots.rs:6-15)."""
    q = p - 1
    s = 0
    while q % 2 == 0:
        q //= 2
        s += 1
    return q, s


def quadratic_nonresidue(p: int) -> int:
    """Smallest quadratic non-residue mod odd prime p (reference: get_z64, roots.rs:17-28)."""
    # Euler's criterion: z is a non-residue iff z^((p-1)/2) == p - 1.
    e = (p - 1) // 2
    z = 2
    while pow(z, e, p) != p - 1:
        z += 1
    return z


def sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli–Shanks modular square root mod odd prime p.

    Returns x with x*x ≡ a (mod p), or None if a is a non-residue.
    Reference: sqrt_mod_ex64, roots.rs:31-66.
    """
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = get_q_s(p)
    if s == 1:
        return pow(a, (p + 1) // 4, p)
    z = quadratic_nonresidue(p)
    m = s
    c = pow(z, q, p)
    t = pow(a, q, p)
    r = pow(a, (q + 1) // 2, p)
    while t != 1:
        # Find least i in (0, m) with t^(2^i) == 1.
        i = 0
        t2 = t
        while t2 != 1:
            t2 = (t2 * t2) % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m = i
        c = (b * b) % p
        t = (t * c) % p
        r = (r * b) % p
    return r


def find_primitive_root64(p: int, degree: int) -> int | None:
    """Find a primitive `degree`-th root of unity mod p (degree a power of two).

    Reference: find_primitive_root64, roots.rs:68-91 — starts from p-1
    (a primitive 2nd root of unity) and takes log2(degree)-1 square roots,
    each time picking a root that remains primitive. Returns None if
    degree does not divide p-1 (no such root exists; plan construction fails).
    """
    if degree & (degree - 1) != 0 or degree < 2:
        raise ValueError("degree must be a power of two >= 2")
    if (p - 1) % degree != 0:
        return None
    w = p - 1  # primitive 2nd root of unity
    k = 2
    while k < degree:
        w_next = sqrt_mod(w, p)
        if w_next is None:
            return None
        w = w_next
        k *= 2
    # w is now a degree-th root of unity; primitive because each sqrt of a
    # primitive 2^j-th root is a primitive 2^(j+1)-th root.
    return w


def is_primitive_root(w: int, degree: int, p: int) -> bool:
    """Check order(w) == degree exactly (test helper)."""
    if pow(w, degree, p) != 1:
        return False
    return pow(w, degree // 2, p) != 1
