"""Hybrid (GHS-style) key switching over DCRT polynomials.

Port of `tfhe_tpu/pke/keyswitch.py`, the counterpart of the reference's
`KeySwitchHYBRID` (src/pke/lib/keyswitch/keyswitch-hybrid.cpp:1-484): the Q
chain is split into `dnum` digit groups with products D_j; the switching key encrypts
P * (Q/D_j) * s_from under s_to over the extended basis PQ, a switch costs
`dnum` multiplications instead of Q_bits/w gadget digits, and the result is
scaled back down by the special modulus P (ModDown with centered rounding).
Noise per switch ~ dnum * D * sigma / P + ||s||/2, so P is sized one limb
larger than the largest digit group.

Exactness-first host implementation: digits and ModDown go through exact
big-int CRT interpolation (DCRTPoly.to_bigint); the per-limb arithmetic is
numpy-vectorized.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .dcrt import DCRTParams, DCRTPoly, _moduli_chain


def negacyclic_square_signed(s: np.ndarray) -> np.ndarray:
    """s(X)^2 in Z[X]/(X^N+1) for a small signed coefficient vector."""
    s = np.asarray(s, dtype=np.int64)
    N = s.shape[-1]
    full = np.convolve(s, s)                      # degree 2N-2
    out = full[:N].copy()
    out[: N - 1] -= full[N:]
    return out


def relin_key_gen_hybrid(rng, q_params: DCRTParams, s_signed: np.ndarray,
                         dnum: int = 2, std: float = 3.19,
                         limb_bits: int = 40) -> "HybridKSKey":
    """Hybrid relinearization key: switch s^2 -> s."""
    return hybrid_ks_gen(rng, q_params, negacyclic_square_signed(s_signed),
                         s_signed, dnum, std, limb_bits)


def automorph_signed(s: np.ndarray, k: int) -> np.ndarray:
    """s(X) -> s(X^k) on a signed coefficient vector."""
    s = np.asarray(s, dtype=np.int64)
    N = s.shape[-1]
    idx = (np.arange(N) * k) % (2 * N)
    tgt = idx % N
    sign = np.where(idx >= N, -1, 1)
    out = np.zeros(N, dtype=np.int64)
    out[tgt] = sign * s
    return out


def galois_key_gen_hybrid(rng, q_params: DCRTParams, s_signed: np.ndarray,
                          k: int, dnum: int = 2, std: float = 3.19,
                          limb_bits: int = 40) -> "HybridKSKey":
    """Hybrid automorphism key: switch s(X^k) -> s."""
    return hybrid_ks_gen(rng, q_params, automorph_signed(s_signed, k),
                         s_signed, dnum, std, limb_bits)


@dataclass
class HybridKSKey:
    """dnum pairs (b_j, a_j) over the PQ chain with b_j = -a_j s_to + e_j +
    P * (Q/D_j) * s_from."""
    bs: list
    as_: list
    pq_params: DCRTParams
    q_params: DCRTParams
    P: int
    groups: list            # list of (start, end) limb index ranges of Q


def _digit_groups(L: int, dnum: int) -> list[tuple[int, int]]:
    per = (L + dnum - 1) // dnum
    return [(i, min(i + per, L)) for i in range(0, L, per)]


def hybrid_ks_params(q_params: DCRTParams, dnum: int,
                     limb_bits: int = 40) -> tuple[DCRTParams, int, list]:
    """Extended PQ chain: the Q limbs plus enough disjoint special limbs to
    cover the largest digit group with one limb of margin. P is sized by
    BITS, not limb count — the chain limbs can be wider than the special
    limbs (e.g. 59-bit bootstrap chains vs 40-bit P limbs), and a P smaller
    than the digit makes the key-switch noise blow up by D/P."""
    groups = _digit_groups(q_params.L, dnum)
    group_bits = max(sum(q_params.moduli[i].bit_length()
                         for i in range(s, e)) for s, e in groups)
    n_p = (group_bits + limb_bits - 1) // limb_bits + 1
    p_moduli = _moduli_chain(q_params.N, n_p, limb_bits, skip=q_params.L)
    P = 1
    for m in p_moduli:
        P *= m
    pq = DCRTParams(N=q_params.N, moduli=q_params.moduli + tuple(p_moduli))
    return pq, P, groups


def hybrid_ks_gen(rng, q_params: DCRTParams, s_from_signed: np.ndarray,
                  s_to_signed: np.ndarray, dnum: int = 2, std: float = 3.19,
                  limb_bits: int = 40) -> HybridKSKey:
    """Switching key from s_from to s_to (s_from = s^2 for relinearization,
    s(X^k) for automorphisms — pass the signed coefficient vectors)."""
    pq, P, groups = hybrid_ks_params(q_params, dnum, limb_bits)
    N = q_params.N
    Q = q_params.Q
    s_to = DCRTPoly.from_signed(pq, s_to_signed, eval_form=True)
    s_from = DCRTPoly.from_signed(pq, s_from_signed, eval_form=True)
    bs, as_ = [], []
    for (g0, g1) in groups:
        D = 1
        for m in q_params.moduli[g0:g1]:
            D *= m
        qhat = (Q // D) * P                 # P * Q/D_j
        a = DCRTPoly(pq, np.stack([rng.discrete_uniform(N, m)
                                   for m in pq.moduli]).astype(np.uint64),
                     eval_form=False).to_eval()
        e = DCRTPoly.from_signed(pq, rng.discrete_gaussian_signed(N, std),
                                 eval_form=True)
        bs.append(-(a * s_to + e) + s_from.mul_scalar(qhat % pq.Q))
        as_.append(a)
    return HybridKSKey(bs, as_, pq, q_params, P, groups)


def hybrid_key_switch(ksk: HybridKSKey, c2: DCRTPoly,
                      level_params: DCRTParams) -> tuple[DCRTPoly, DCRTPoly]:
    """(delta0, delta1) over the (possibly reduced) Q chain such that
    delta0 + delta1*s ~ c2*s_from (up to the documented switch noise)."""
    qp = ksk.q_params
    lp = level_params
    assert qp.moduli[:lp.L] == lp.moduli, "level chain must prefix the key chain"
    Q = qp.Q
    c2_big = c2.to_bigint()
    # lift from the working level back to full-Q digits: residues mod the
    # level modulus are valid representatives mod Q for digiting because
    # digits are taken per group against full-Q CRT factors
    acc0 = acc1 = None
    for (g0, g1), b, a in zip(ksk.groups, ksk.bs, ksk.as_):
        D = 1
        for m in qp.moduli[g0:g1]:
            D *= m
        inv = pow((Q // D) % D, -1, D)
        digit = [(c * inv) % D for c in c2_big]
        dp = DCRTPoly.from_bigint(ksk.pq_params, digit).to_eval()
        t0, t1 = b * dp, a * dp
        acc0 = t0 if acc0 is None else acc0 + t0
        acc1 = t1 if acc1 is None else acc1 + t1
    # ModDown: centered rounding by P, restricted to the working level chain
    out = []
    for acc in (acc0, acc1):
        c = acc.to_centered_bigint()
        P = ksk.P
        scaled = [((2 * x + P) // (2 * P)) for x in c]      # round(x / P)
        out.append(DCRTPoly.from_bigint(
            lp, [x % lp.Q for x in scaled]).to_eval())
    return out[0], out[1]
