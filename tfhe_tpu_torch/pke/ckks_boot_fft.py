"""FFT-factored (levelBudget) CoeffsToSlots/SlotsToCoeffs and sparse packing
for CKKS bootstrapping.

Port of `tfhe_tpu/pke/ckks_boot_fft.py`, host numpy as there.
Counterpart of the reference's remaining EvalBootstrap configurations
(src/pke/lib/scheme/ckksrns/ckksrns-fhe.cpp: EvalBootstrapSetup with
levelBudget > 1 -> EvalCoeffsToSlots/EvalSlotsToCoeffs over the collapsed
FFT factors from ckksrns-utils.cpp GetCollapsedFFTParams; the sparsely
packed case slots < N/2 with its PartialSum fold, ckksrns-fhe.cpp
EvalBootstrap "SPARSELY PACKED CASE"), re-derived for this host CKKS.

The algebra (no code in common with the reference):

- **Complex-pair coefficients.** With v_j := m_j + i m_{j+s} (j < s = N/2)
  and the 5-orbit slot roots zeta_k = exp(i pi e_k / N), e_k = 5^k mod 2N,
  zeta_k^s = i for every k, so the decode map is purely C-linear:
      z = E v,   E[k, j] = zeta_k^j            (s x s, invertible).
  CoeffsToSlots is multiplication by E^{-1} and SlotsToCoeffs by E —
  NO conjugation inside either transform (the conjugate is only needed
  once, to split v into its real/imag halves before EvalMod), which is
  what makes the radix-2 factorization below possible.

- **Radix-2 factorization.** Splitting v into even/odd coefficients gives
  z_k = A_k + w_k B_k, z_{k+m/2} = A_k - w_k B_k with A, B half-size
  transforms of the same shape and twiddles w_k = exp(i pi (5^k mod 4m)
  / (2m)) at size m. Iterated bottom-up on bit-reversed input this is a
  product of log2(s) butterfly stages, each a matrix with generalized
  (cyclic, in the 5-orbit slot ordering) diagonals at offsets
  {0, +len, -len}. The bit-reversal permutations of E and E^{-1} cancel
  between CoeffsToSlots and SlotsToCoeffs because EvalMod is slotwise.

- **levelBudget.** Consecutive stages are multiplied together (in diagonal
  form) into `level_budget` grouped matrices; each group costs one
  multiplicative level and is evaluated with BSGS over its ~2^(k/budget)
  diagonals. budget = 1 recovers the dense single-level transform,
  budget = log2(s) the 3-diagonal per-level extreme — the same
  depth-vs-rotations dial as the reference's levelBudget.

- **Sparse packing.** A message replicated with period s' < s lives in the
  index-[N/(2s')] subring. After ModRaise, the trace Sum_t sigma_{5^{t s'}}
  (PartialSum: log2(s/s') rotations by multiples of s') projects the
  q0*I part into the subring, multiplying it by F = s/s'. The whole
  pipeline then runs at size s' with the same stage machinery (diagonals
  tiled to the full slot count; rotations by r < s' act on the replicated
  vector exactly as subring rotations), EvalMod sees F*m + r*integer, and
  1/F is folded into SlotsToCoeffs.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import gcd

import numpy as np

from .ckks import CKKSCiphertext, CKKSContext
from .ckks_boot import (BootstrapPrecom, add_ct, conj_element,
                        eval_automorphism, eval_bootstrap_setup,
                        eval_conjugate, eval_mod_ps, galois_element,
                        mod_raise, mult_const, mult_plain_vec, sub_ct)


# -- stage construction (diagonal form) -------------------------------------

def _twiddles(m: int) -> np.ndarray:
    """Size-m butterfly twiddles w_i = exp(i pi (5^i mod 4m)/(2m)), i < m/2."""
    e = np.empty(m // 2, dtype=np.int64)
    cur = 1
    for i in range(m // 2):
        e[i] = cur
        cur = (cur * 5) % (4 * m)
    return np.exp(1j * np.pi * e / (2 * m))


def _bit_reverse(s: int) -> np.ndarray:
    """Permutation p with p[k] = bit-reverse of k over log2(s) bits."""
    bits = s.bit_length() - 1
    p = np.zeros(s, dtype=np.int64)
    for k in range(s):
        p[k] = int(format(k, f"0{bits}b")[::-1], 2) if bits else 0
    return p


def fft_stage_diags(s: int) -> list[dict[int, np.ndarray]]:
    """The log2(s) forward butterfly stages of E (DIT, bit-reversed input),
    each as {cyclic offset: diagonal vector [s]} with
    M[k, (k+off) % s] = d[off][k]. Stage t combines strides len = 2^t."""
    assert s >= 2 and s & (s - 1) == 0
    stages = []
    for t in range(s.bit_length() - 1):
        ln = 1 << t
        m = 2 * ln
        w = _twiddles(m)
        local = np.arange(s) % m
        top = local < ln                      # first half of each block
        d0 = np.where(top, 1.0 + 0j, -w[(np.arange(s) % m) - ln])
        d: dict[int, np.ndarray] = {0: d0}
        dp = np.zeros(s, dtype=np.complex128)
        dp[top] = w[local[top]]               # out_k += w * x_{k+len}
        dm = np.zeros(s, dtype=np.complex128)
        dm[~top] = 1.0                        # out_k += x_{k-len}
        if ln % s == (s - ln) % s:            # len == s/2: offsets coincide
            d[ln % s] = dp + dm
        else:
            d[ln] = dp
            d[s - ln] = dm
        stages.append(d)
    return stages


def fft_stage_diags_inv(s: int) -> list[dict[int, np.ndarray]]:
    """Inverses of the forward stages (same offsets {0, +-len}):
    x_k = (y_k + y_{k+len})/2 (top) and x_k = (y_{k-len} - y_k)/(2w)."""
    stages = []
    for t in range(s.bit_length() - 1):
        ln = 1 << t
        m = 2 * ln
        w = _twiddles(m)
        local = np.arange(s) % m
        top = local < ln
        inv2w = 1.0 / (2.0 * w)
        d0 = np.where(top, 0.5 + 0j, -inv2w[local - ln])
        d: dict[int, np.ndarray] = {0: d0}
        dp = np.zeros(s, dtype=np.complex128)
        dp[top] = 0.5
        dm = np.zeros(s, dtype=np.complex128)
        dm[~top] = inv2w[local[~top] - ln]
        if ln % s == (s - ln) % s:
            d[ln % s] = dp + dm
        else:
            d[ln] = dp
            d[s - ln] = dm
        stages.append(d)
    return stages


def diag_matmul(A: dict[int, np.ndarray], B: dict[int, np.ndarray],
                s: int) -> dict[int, np.ndarray]:
    """(A @ B) in diagonal form: C[p+q][k] = sum A[p][k] * B[q][(k+p) % s]."""
    C: dict[int, np.ndarray] = {}
    for p, ap in A.items():
        for q, bq in B.items():
            off = (p + q) % s
            v = ap * np.roll(bq, -p)
            if off in C:
                C[off] = C[off] + v
            else:
                C[off] = v
    return {o: v for o, v in C.items() if np.any(np.abs(v) > 1e-14)}


def diag_to_dense(d: dict[int, np.ndarray], s: int) -> np.ndarray:
    M = np.zeros((s, s), dtype=np.complex128)
    k = np.arange(s)
    for off, v in d.items():
        M[k, (k + off) % s] = v
    return M


def pair_matrix(s: int) -> np.ndarray:
    """E[k, j] = zeta_k^j at size s (zeta_k the size-s 5-orbit roots):
    z = E v with v_j = m_j + i m_{j+s} — the C-linear decode map."""
    e = np.empty(s, dtype=np.int64)
    cur = 1
    for k in range(s):
        e[k] = cur
        cur = (cur * 5) % (4 * s)
    zeta = np.exp(1j * np.pi * e / (2 * s))
    return zeta[:, None] ** np.arange(s)[None, :]


def _split_groups(n: int, budget: int) -> list[tuple[int, int]]:
    """Balanced contiguous partition of range(n) into `budget` groups."""
    budget = max(1, min(budget, n))
    sizes = [n // budget + (1 if i < n % budget else 0) for i in range(budget)]
    out, a = [], 0
    for sz in sizes:
        out.append((a, a + sz))
        a += sz
    return out


@dataclass
class DiagMatrix:
    """A slot linear map in generalized-diagonal form, with its BSGS plan."""
    s: int                               # transform size (s' when sparse)
    diags: dict[int, np.ndarray]         # canonical offset -> [s] diagonal
    babies: list[int]                    # baby rotation amounts
    plan: list[tuple[int, int, int]]     # (offset, giant, baby) triples


def _bsgs_plan(s: int, diags: dict[int, np.ndarray]) -> DiagMatrix:
    """Decompose each offset as giant + baby over the offsets' common stride
    (offsets of a grouped FFT factor are multiples of 2^a in a +-2^b range,
    so babies stay O(sqrt(#diagonals)))."""
    offs = sorted(diags)
    signed = [o if o <= s // 2 else o - s for o in offs]
    base = 0
    for v in signed:
        base = gcd(base, abs(v))
    base = base or 1
    nb = max(1, int(np.ceil(np.sqrt(len(offs)))))
    plan, babies = [], set()
    for o, sv in zip(offs, signed):
        i = sv // base                        # floor toward -inf
        g = (i // nb) * nb * base
        r = sv - g                            # in [0, nb*base)
        plan.append((o, g % s, r))
        babies.add(r)
    return DiagMatrix(s, diags, sorted(babies), plan)


def group_stages(stages: list[dict[int, np.ndarray]], s: int,
                 budget: int) -> list[DiagMatrix]:
    """Multiply consecutive stages into `budget` grouped matrices (applied
    in list order: out = G_last(...(G_0 x)))."""
    groups = []
    for a, b in _split_groups(len(stages), budget):
        acc = stages[a]
        for t in range(a + 1, b):
            acc = diag_matmul(stages[t], acc, s)   # later stage on the left
        groups.append(_bsgs_plan(s, acc))
    return groups


def bootstrap_depth(level_budget: tuple[int, int] = (1, 1),
                    cheb_deg: int = 22, double_angles: int = 3,
                    slots: int | None = None) -> int:
    """Multiplicative levels one bootstrap consumes — the chain-sizing
    helper users call before picking mult_depth (FHECKKSRNS::
    GetBootstrapDepth, ckksrns-fhe.cpp). Budgeted transforms cost one
    level per group; EvalMod costs the Paterson-Stockmeyer tree depth
    (ceil(log2 deg) + 1), the double-angle squarings, the re/im split
    constant, the recombination, and the final r/(2 pi) scaling.
    Pass `slots` (the transform size; the sparse s' when sparsely packed)
    to clamp each budget to its log2(slots) stage count, matching what
    group_stages actually builds."""
    lb = list(level_budget)
    if slots is not None:
        n_stages = max(1, slots.bit_length() - 1)
        lb = [min(b, n_stages) for b in lb]
    # the deepest PS node is the top giant T_e, e = 2^floor(log2 deg),
    # multiplied once by the quotient branch
    ps_depth = int(np.floor(np.log2(max(2, cheb_deg)))) + 1
    return (lb[0] + lb[1]
            + 1                      # re/im split (x 0.5 / x -0.5i)
            + ps_depth
            + double_angles
            + 1                      # r/(2 pi) rescale
            + 1)                     # im recombination (x 1j)


# -- homomorphic evaluation --------------------------------------------------

def _rotate(ctx: CKKSContext, ct: CKKSCiphertext, r: int,
            keys: dict) -> CKKSCiphertext:
    if r % ctx.params.slots == 0:
        return ct
    a = galois_element(r, ctx.params.N)
    return eval_automorphism(ctx, ct, a, keys[a])


def eval_diag_transform(ctx: CKKSContext, ct: CKKSCiphertext, g: DiagMatrix,
                        keys: dict, scale_mul: complex = 1.0,
                        plain_scale: float | None = None) -> CKKSCiphertext:
    """out = M ct on slots (one rescale level): BSGS over the plan's baby/
    giant rotations. Diagonals of a size-s' (sparse) map are tiled to the
    full slot count; rotations < s' act identically on the replicated
    vector (EvalCoeffsToSlots/EvalSlotsToCoeffs inner loop)."""
    s_full = ctx.params.slots
    reps = s_full // g.s
    bab = {0: ct}
    for r in g.babies:
        if r % s_full and r not in bab:
            bab[r] = _rotate(ctx, ct, r, keys)
    acc = None
    for gg in sorted({p[1] for p in g.plan}):
        inner = None
        for off, gi, r in g.plan:
            if gi != gg:
                continue
            d = np.tile(g.diags[off], reps) * scale_mul
            term = mult_plain_vec(ctx, bab[r], np.roll(d, gg),
                                  rescale=False, plain_scale=plain_scale)
            inner = term if inner is None else add_ct(inner, term)
        inner = ctx.rescale(inner)
        if gg % s_full:
            inner = _rotate(ctx, inner, gg, keys)
        acc = inner if acc is None else add_ct(acc, inner)
    return acc


# -- setup / keygen ----------------------------------------------------------

@dataclass
class BootstrapFFTPrecom:
    cts_groups: list[DiagMatrix]     # CoeffsToSlots factors, in apply order
    stc_groups: list[DiagMatrix]     # SlotsToCoeffs factors, in apply order
    base: BootstrapPrecom            # EvalMod pieces (cheb/K/r/q0/g)
    sparse_slots: int                # s' (== N/2 for full packing)
    level_budget: tuple[int, int]


def eval_bootstrap_setup_fft(ctx: CKKSContext,
                             level_budget: tuple[int, int] = (2, 2),
                             sparse_slots: int | None = None,
                             K: float = 8.0, cheb_deg: int = 22,
                             double_angles: int = 3) -> BootstrapFFTPrecom:
    """EvalBootstrapSetup(levelBudget, slots): build the grouped FFT factors
    of E^{-1} (CoeffsToSlots; bit-reversed output) and E (SlotsToCoeffs;
    bit-reversed input — the permutations cancel across EvalMod)."""
    s_full = ctx.params.slots
    sp = s_full if sparse_slots is None else sparse_slots
    assert 2 <= sp <= s_full and s_full % sp == 0 and sp & (sp - 1) == 0
    base = eval_bootstrap_setup(ctx, K=K, cheb_deg=cheb_deg,
                                double_angles=double_angles)
    fwd = fft_stage_diags(sp)
    inv = fft_stage_diags_inv(sp)
    # CTS = M_0^{-1} ... M_{k-1}^{-1} applied high stage first
    cts = group_stages(list(reversed(inv)), sp, level_budget[0])
    stc = group_stages(fwd, sp, level_budget[1])
    # fold the EvalMod normalization 1/(K r) into the first CTS factor and
    # the sparse trace multiplicity 1/F into the first STC factor
    norm = 1.0 / (base.K * base.r)
    cts[0] = DiagMatrix(cts[0].s,
                        {o: v * norm for o, v in cts[0].diags.items()},
                        cts[0].babies, cts[0].plan)
    F = s_full // sp
    if F > 1:
        stc[0] = DiagMatrix(stc[0].s,
                            {o: v / F for o, v in stc[0].diags.items()},
                            stc[0].babies, stc[0].plan)
    return BootstrapFFTPrecom(cts, stc, base, sp, level_budget)


def fft_key_indices(ctx: CKKSContext, pre: BootstrapFFTPrecom) -> list[int]:
    """Galois elements for every rotation the pipeline performs: group baby
    and giant steps, the sparse PartialSum strides, and conjugation
    (FindBootstrapRotationIndices)."""
    N = ctx.params.N
    s_full = ctx.params.slots
    rots = set()
    for g in pre.cts_groups + pre.stc_groups:
        rots.update(r for r in g.babies if r % s_full)
        rots.update(gi for _, gi, _ in g.plan if gi % s_full)
    j = 1
    while j < s_full // pre.sparse_slots:
        rots.add(j * pre.sparse_slots)
        j <<= 1
    ks = {galois_element(r, N) for r in rots}
    ks.add(conj_element(N))
    return sorted(ks)


def eval_bootstrap_keygen_fft(ctx: CKKSContext, sk,
                              pre: BootstrapFFTPrecom, dnum: int = 3,
                              ks_limb_bits: int = 40) -> dict:
    from .keyswitch import galois_key_gen_hybrid
    return {k: galois_key_gen_hybrid(ctx.rng, ctx.params.dcrt, sk[1], k,
                                     dnum, limb_bits=ks_limb_bits)
            for k in fft_key_indices(ctx, pre)}


# -- bootstrap ----------------------------------------------------------------

def eval_bootstrap_fft(ctx: CKKSContext, ct: CKKSCiphertext,
                       pre: BootstrapFFTPrecom, keys: dict,
                       rlk) -> CKKSCiphertext:
    """EvalBootstrap with FFT-factored transforms; handles both the fully
    packed and the sparsely packed (slots = s' < N/2, message replicated
    with period s') cases."""
    p = ctx.params
    ct1 = mod_raise(ctx, ct)

    sp = pre.sparse_slots
    F = p.slots // sp
    if F > 1:
        # PartialSum: trace onto the subring — q0*I becomes q0*(integer
        # subring poly), the message picks up the factor F
        j = 1
        while j < F:
            ct1 = add_ct(ct1, _rotate(ctx, ct1, j * sp, keys))
            j <<= 1

    ct_w = ct1
    for g in pre.cts_groups:
        ct_w = eval_diag_transform(ctx, ct_w, g, keys)

    w_c = eval_conjugate(ctx, ct_w, keys)
    ct_re = mult_const(ctx, add_ct(ct_w, w_c), 0.5)
    ct_im = mult_plain_vec(ctx, sub_ct(ct_w, w_c),
                           np.full(p.slots, -0.5j))
    m_re = eval_mod_ps(ctx, ct_re, pre.base, rlk)
    m_im = eval_mod_ps(ctx, ct_im, pre.base, rlk)
    recomb = add_ct(m_re, mult_plain_vec(ctx, m_im, np.full(p.slots, 1j)))

    out = recomb
    for i, g in enumerate(pre.stc_groups):
        ps = None
        if i == len(pre.stc_groups) - 1:
            # land the refreshed ciphertext on exactly Delta
            q_last = out.level_params.moduli[-1]
            ps = float(q_last) * p.scale / out.scale
        out = eval_diag_transform(ctx, out, g, keys, plain_scale=ps)
    return out
