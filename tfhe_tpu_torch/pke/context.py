"""Unified CryptoContext factory for the pke schemes.

Port of `tfhe_tpu/pke/context.py`: it returns the port's contexts
(`BFVRnsContext`, `BFVBehzContext`, `CKKSAutoContext`, ...), whose device
forms (`BFVDeviceContext`, `CKKSDeviceContext`, ...) run on the card.

The analogue of the reference's `GenCryptoContext` / `CCParams<...>` front
door (gen-cryptocontext.h, cryptocontextfactory.cpp), including the
security-driven parameter generation the reference runs inside it
(schemebase/base-parametergeneration.cpp + per-scheme parametergen): one
entry point that dispatches to BFV/BGV/CKKS, deriving the ring dimension and
moduli chain from (mult_depth, security_level) when they are not given, and
rejecting explicit choices that violate the requested HE-standard level.
"""

from __future__ import annotations

from .bfv import BFVContext, BFVParams
from .bgv import BGVContext, BGVParams
from .ckks import CKKSContext, CKKSParams
from .dcrt import DCRTParams, _moduli_chain_pattern
from .parametergen import (SecurityError, derive_bfv, derive_bgv,
                           derive_ckks)

__all__ = ["gen_crypto_context", "SecurityError"]


def gen_crypto_context(scheme: str, *, N: int | None = None,
                       mult_depth: int = 1, plaintext_modulus: int = 257,
                       scale_bits: int = 40, first_mod_bits: int = 60,
                       limb_bits: int = 54,
                       security_level: str | None = None,
                       key_switch: str = "bv",
                       scaling_technique: str = "fixedmanual",
                       multiplication_technique: str | None = None,
                       dnum: int = 2,
                       bootstrapping: bool = False,
                       level_budget: tuple[int, int] = (2, 2),
                       seed: int | None = None):
    """GenCryptoContext analogue.

    scheme: "BFV" | "BGV" | "CKKS".
    For BFV/BGV: `plaintext_modulus` (prime t = 1 mod 2N enables packed
    encoding). For CKKS: `scale_bits` sets the default encoding scale and
    `first_mod_bits` the wide first limb; `scaling_technique` picks the
    rescaling mode ("fixedmanual" returns the plain context; "fixedauto" /
    "flexibleauto" return a `CKKSAutoContext` over the pure-RNS evaluator
    with `dnum` hybrid key-switch digits — ckksrns-leveledshe.cpp's
    ScalingTechnique).

    `bootstrapping=True` (CKKS only) sizes the chain for `mult_depth`
    usable levels AFTER a refresh — mult_depth is widened by
    GetBootstrapDepth for the given `level_budget` and the sparse-secret
    EvalMod defaults, and the chosen configuration is attached as
    `cc.bootstrap_config` (pass it to eval_bootstrap_setup_fft).

    Parameter generation: when `N` is omitted, the ring dimension and the
    moduli chain are derived from (`mult_depth`, `security_level`) — the
    default level is 128_classic, like the reference's HEStd_128_classic
    default. When `N` is given explicitly, it is validated against
    `security_level` if one is requested (pass "NotSet" — or leave the
    default, None, which only skips the check for explicit-N calls — to run
    toy/test dimensions).
    """
    s = scheme.upper()
    if multiplication_technique is not None:
        # BFV-only switch, like the reference's SetMultiplicationTechnique
        # (constants.h MultiplicationTechnique; bfvrns-leveledshe.cpp routes
        # EvalMult on it). "hps" -> pure-RNS HPS (bfv_rns.py), "behz" ->
        # BEHZ (bfv_behz.py); None keeps the exact big-int context.
        mt = multiplication_technique.lower()
        if s not in ("BFV", "BFVRNS"):
            raise ValueError("multiplication_technique is a BFV option")
        if mt not in ("hps", "behz"):
            raise ValueError(f"unknown multiplication_technique {mt!r} "
                             "(hps or behz)")
        if limb_bits > 30:
            raise ValueError(
                "the pure-RNS BFV pipelines keep host and device "
                "bit-identical with 32-bit-word arithmetic, which needs "
                "limb_bits <= 30 (add limbs for capacity)")
    boot_cfg = None
    if bootstrapping:
        # size the chain for `mult_depth` USABLE levels after a refresh:
        # add the levels one bootstrap consumes (the reference's
        # SetMultiplicativeDepth(levelsUsed + GetBootstrapDepth(...)) idiom,
        # iterative-ckks-bootstrapping.cpp:106-111)
        if s not in ("CKKS", "CKKSRNS"):
            raise ValueError("bootstrapping=True is a CKKS option")
        from .ckks_boot_fft import bootstrap_depth
        boot_cfg = {"level_budget": tuple(level_budget), "K": 28.0,
                    "cheb_deg": 44, "double_angles": 3,
                    "secret_dist": "sparse"}
        mult_depth = mult_depth + bootstrap_depth(
            boot_cfg["level_budget"], cheb_deg=boot_cfg["cheb_deg"],
            double_angles=boot_cfg["double_angles"])
        # bootstrap chains use uniform scale-sized limbs: rescale divides
        # by q_l ~ 2^limb_bits, so limbs wider than the scale would decay
        # the tracked scale each level (the reference likewise pairs
        # scalingModSize with dcrtBits for bootstrapping)
        limb_bits = scale_bits
    if security_level is None:
        # explicit-N callers keep their hand-picked (often toy) dimensions
        # unchecked, exactly like the reference's HEStd_NotSet escape hatch
        security_level = "NotSet" if N is not None else "128_classic"
    if security_level == "NotSet" and N is None:
        raise ValueError("N must be given when security_level is 'NotSet'")

    if s in ("BFV", "BFVRNS"):
        def _wrap_bfv(cc_exact):
            if multiplication_technique is None:
                return cc_exact
            from .bfv_behz import BFVBehzContext
            from .bfv_rns import BFVRnsContext
            cls = (BFVBehzContext
                   if multiplication_technique.lower() == "behz"
                   else BFVRnsContext)
            return cls(cc_exact, dnum=dnum, ks_limb_bits=limb_bits)

        if security_level == "NotSet":
            return _wrap_bfv(BFVContext(
                BFVParams.create(N=N, t=plaintext_modulus,
                                 mult_depth=mult_depth,
                                 limb_bits=limb_bits), seed=seed))
        d = derive_bfv(mult_depth, plaintext_modulus, security_level,
                       ring_dim=N, limb_bits=limb_bits)
        params = BFVParams(N=d.ring_dim, t=plaintext_modulus,
                           dcrt=DCRTParams.create(d.ring_dim, d.n_limbs,
                                                  limb_bits))
        cc = _wrap_bfv(BFVContext(params, seed=seed))
    elif s in ("BGV", "BGVRNS"):
        if security_level == "NotSet":
            return BGVContext(BGVParams.create(N=N, t=plaintext_modulus,
                                               mult_depth=mult_depth,
                                               limb_bits=limb_bits), seed=seed)
        d = derive_bgv(mult_depth, plaintext_modulus, security_level,
                       ring_dim=N)
        params = BGVParams(N=d.ring_dim, t=plaintext_modulus,
                           dcrt=DCRTParams.create(d.ring_dim, d.n_limbs,
                                                  d.limb_bits[0],
                                                  extra_mod=plaintext_modulus))
        cc = BGVContext(params, seed=seed)
    elif s in ("CKKS", "CKKSRNS"):
        if scaling_technique not in ("fixedmanual", "fixedauto",
                                     "flexibleauto"):
            raise ValueError(f"unknown scaling_technique "
                             f"{scaling_technique!r}")

        def _wrap(base):
            if scaling_technique == "fixedmanual":
                return base
            from .ckks_auto import CKKSAutoContext
            from .ckks_rns import CKKSRnsContext
            return CKKSAutoContext(CKKSRnsContext(base, dnum=dnum),
                                   technique=scaling_technique)

        if security_level == "NotSet":
            cc = _wrap(CKKSContext(
                CKKSParams.create(N=N, mult_depth=mult_depth,
                                  scale_bits=scale_bits,
                                  limb_bits=min(limb_bits, 50)),
                seed=seed))
            if boot_cfg is not None:
                cc.bootstrap_config = boot_cfg
            return cc
        d = derive_ckks(mult_depth, scale_bits, first_mod_bits,
                        security_level, ring_dim=N, key_switch=key_switch)
        params = CKKSParams(
            N=d.ring_dim,
            dcrt=DCRTParams(N=d.ring_dim,
                            moduli=_moduli_chain_pattern(d.ring_dim,
                                                         d.limb_bits)),
            scale=float(1 << scale_bits))
        cc = CKKSContext(params, seed=seed)
        if boot_cfg is not None:
            cc.bootstrap_config = boot_cfg
        if scaling_technique != "fixedmanual":
            wrapped = _wrap(cc)
            wrapped.derived = d
            if boot_cfg is not None:
                wrapped.bootstrap_config = boot_cfg
            return wrapped
    else:
        raise ValueError(f"unknown scheme {scheme!r} (BFV, BGV, or CKKS)")
    cc.derived = d               # inspection hook (CCParams print analogue)
    return cc
