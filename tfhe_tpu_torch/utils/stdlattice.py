"""HE-standard lattice parameter table (ternary secret distribution).

Mirrors `src/core/lib/lattice/stdlatticeparms.cpp:110-187` and the lookup rule
`StdLatticeParm::FindRingDim` (stdlatticeparms.h:151-166): the smallest ring
dimension whose max log2(Q) bound is >= the requested logQ.
"""

from __future__ import annotations


class SecurityError(ValueError):
    """A (ring_dim, logQ) pair violates the requested HE-standard level."""


# {security level: [(ring_dim, max_logQ), ...]} for ternary secrets
# (stdlatticeparms.cpp:110-130 classic, 170-187 quantum)
_TERNARY_MAX_LOGQ = {
    "128_classic": [(1024, 27), (2048, 54), (4096, 109), (8192, 218), (16384, 438), (32768, 881), (65536, 1772)],
    "192_classic": [(1024, 19), (2048, 37), (4096, 75), (8192, 152), (16384, 305), (32768, 611), (65536, 1228)],
    "256_classic": [(1024, 14), (2048, 29), (4096, 58), (8192, 118), (16384, 237), (32768, 476), (65536, 956)],
    "128_quantum": [(1024, 25), (2048, 51), (4096, 101), (8192, 202), (16384, 411), (32768, 827)],
    "192_quantum": [(1024, 17), (2048, 35), (4096, 70), (8192, 141), (16384, 284), (32768, 571)],
    "256_quantum": [(1024, 13), (2048, 27), (4096, 54), (8192, 109), (16384, 220), (32768, 443)],
}

SECURITY_LEVELS = tuple(_TERNARY_MAX_LOGQ) + ("NotSet",)


def find_ring_dim(sec_level: str, log_q: int) -> int:
    """Smallest standard ring dimension satisfying `sec_level` for modulus size log_q."""
    table = _TERNARY_MAX_LOGQ[sec_level]
    prev = 0
    n = 0
    for ring_dim, max_log_q in table:
        if log_q <= max_log_q and log_q > prev:
            return ring_dim
        prev = max_log_q
        n = ring_dim
    return 2 * n


def max_log_q(sec_level: str, ring_dim: int) -> int:
    """Largest log2(Q) the HE standard allows at `ring_dim` (0 if the ring
    dim is below every table row's reach)."""
    if sec_level == "NotSet":
        return 1 << 30
    best = 0
    for rd, mq in _TERNARY_MAX_LOGQ[sec_level]:
        if rd <= ring_dim:
            best = mq          # table rows are sorted by ring_dim
    return best


def validate_security(sec_level: str, ring_dim: int, log_qp: int) -> None:
    """Raise SecurityError unless (ring_dim, log_qp) meets `sec_level`.

    `log_qp` must count the FULL modulus the attacker sees — Q times any
    hybrid-key-switching special modulus P (the reference counts logQP the
    same way in its parameter generation)."""
    if sec_level == "NotSet":
        return
    if sec_level not in _TERNARY_MAX_LOGQ:
        raise ValueError(f"unknown security level {sec_level!r}; "
                         f"one of {SECURITY_LEVELS}")
    bound = max_log_q(sec_level, ring_dim)
    if log_qp > bound:
        raise SecurityError(
            f"logQP={log_qp} at ring dimension {ring_dim} exceeds the "
            f"HE-standard {sec_level} bound of {bound} bits; increase the "
            f"ring dimension (>= {find_ring_dim(sec_level, log_qp)}) or "
            f"shrink the modulus chain")
