"""Number-theoretic utilities: primality, NTT-friendly prime search, roots of unity.

Host-side (pure Python integers, exact at any bit width).

Semantics mirror the reference library's `src/core/lib/math/nbtheory.cpp`:
- ``first_prime(nbits, m)``  : smallest prime p ≡ 1 (mod m) with p > 2^nbits
  (nbtheory.cpp:481-519).
- ``previous_prime(q, m)``   : largest prime p ≡ 1 (mod m) with p < q, reached by
  stepping down in multiples of m from a q ≡ 1 (mod m) (nbtheory.cpp:562-576).
- ``root_of_unity(order, q)``: a primitive ``order``-th root of unity mod prime q.
  (The specific primitive root chosen does not affect any user-visible result;
  it only fixes the internal evaluation-domain ordering.)
"""

from __future__ import annotations

import functools


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit moduli)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    # This base set is a proven deterministic witness set for n < 3,317,044,064,679,887,385,961,981.
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def first_prime(nbits: int, m: int) -> int:
    """Smallest prime ≡ 1 (mod m) strictly greater than 2^nbits."""
    q = 1 << nbits
    r = q % m
    cand = q + (m - r) + 1 if r > 0 else q + 1
    while not is_prime(cand):
        cand += m
    return cand


@functools.lru_cache(maxsize=None)
def previous_prime(q: int, m: int) -> int:
    """Largest prime ≡ 1 (mod m) strictly less than q (q must be ≡ 1 mod m)."""
    cand = q - m
    while not is_prime(cand):
        cand -= m
        if cand <= 0:
            raise ValueError("Moduli size is not sufficient! Must be increased.")
    return cand


@functools.lru_cache(maxsize=None)
def ntt_prime(nbits: int, m: int) -> int:
    """The modulus used by the reference for parameter sets:
    PreviousPrime(FirstPrime(nbits, m), m) — i.e. the largest prime ≡ 1 (mod m)
    below 2^nbits (binfhecontext.cpp:95,167-168)."""
    return previous_prime(first_prime(nbits, m), m)


def _factorize(n: int) -> list[int]:
    """Distinct prime factors of n (trial division + Pollard rho)."""
    factors: set[int] = set()

    def rho(n: int) -> int:
        import random

        if n % 2 == 0:
            return 2
        while True:
            x = random.randrange(2, n)
            y = x
            c = random.randrange(1, n)
            d = 1
            while d == 1:
                x = (x * x + c) % n
                y = (y * y + c) % n
                y = (y * y + c) % n
                d = _gcd(abs(x - y), n)
            if d != n:
                return d

    def _gcd(a: int, b: int) -> int:
        while b:
            a, b = b, a % b
        return a

    stack = [n]
    while stack:
        v = stack.pop()
        if v == 1:
            continue
        if is_prime(v):
            factors.add(v)
            continue
        for p in (2, 3, 5, 7, 11, 13):
            if v % p == 0:
                factors.add(p)
                while v % p == 0:
                    v //= p
                if v > 1:
                    stack.append(v)
                break
        else:
            d = rho(v)
            stack.append(d)
            stack.append(v // d)
    return sorted(factors)


@functools.lru_cache(maxsize=None)
def root_of_unity(order: int, modulus: int) -> int:
    """A principal `order`-th root of unity mod `modulus`.

    For prime moduli (order | modulus-1): derived deterministically from the
    smallest generator of Z_modulus^*. For squarefree odd composites whose
    prime factors are each ≡ 1 (mod order) — e.g. the TPU-native RNS ring
    modulus Q = q1*q2 of the accelerated parameter sets — the per-prime roots
    are CRT-combined; psi^(order/2) ≡ -1 mod every factor, so every negacyclic
    NTT identity holds mod the composite exactly as it does mod a prime.
    """
    if not is_prime(modulus):
        factors = _factorize(modulus)
        rem = modulus
        for p in factors:
            rem //= p
        if rem != 1:
            raise ValueError(f"modulus {modulus} is not squarefree")
        root, prod = 0, 1
        for p in factors:
            rp = root_of_unity(order, p)
            # CRT: root ≡ rp (mod p), keep previous residues
            if prod == 1:
                root, prod = rp, p
            else:
                inc = ((rp - root) * pow(prod, -1, p)) % p
                root, prod = root + prod * inc, prod * p
        if pow(root, order, modulus) != 1:
            raise ValueError(
                f"CRT-assembled root has wrong order for modulus {modulus}")
        # negacyclic check only makes sense for even orders (2N-th roots)
        if order % 2 == 0 and pow(root, order // 2, modulus) != modulus - 1:
            raise ValueError(
                f"no negacyclic {order}-th root of unity mod {modulus}")
        return root
    if (modulus - 1) % order != 0:
        raise ValueError(f"{order} does not divide {modulus}-1")
    phi = modulus - 1
    prime_factors = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // p, modulus) != 1 for p in prime_factors):
            break
        g += 1
    root = pow(g, phi // order, modulus)
    assert pow(root, order, modulus) == 1 and pow(root, order // 2, modulus) != 1
    return root
