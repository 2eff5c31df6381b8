"""Ring-sharded negacyclic NTT and CKKS multiplication over a ("limb",) mesh.

Port of `tfhe_tpu/parallel/limb_ntt.py`. The reference's only long axis is
the ring dimension N inside one bootstrap, which its GPU splits across
cooperative thread blocks with grid.sync() between phases
(bootstrapping.cu:120-401). Here the coefficient axis is split across the
devices of a `("limb",)` `Mesh` (`parallel/mesh.py`): shard i of D holds
coefficients [i*S, (i+1)*S), S = N/D, on `mesh.devices[i]`, and a sharded
tower is a list of D int64 tensors [L, ..., S] (`scatter`, `join`).

- The forward transform is the twist by psi^j, then the Gentleman-Sande
  (DIF) stages of `ops/ntt_sched.py` with half-lengths N/2 .. 1, into the
  bit-reversed evaluation order. Its first log2(D) stages pair coefficients
  on different shards: each is one exchange of shard tensors between devices
  (the JAX package's `jax.lax.ppermute`) followed by the butterflies; the
  rest are local to a shard. The inverse runs the Cooley-Tukey (DIT) stages
  with half-lengths 1 .. N/2, the last log2(D) of them across shards, then
  the untwist.
- The CKKS tensor product, the hybrid key switch's base conversions and
  ModDown, and the rescale are coefficient-wise, so every shard runs them
  on its own slice with `_make_fbc` and `_make_rescale` of
  `pke/ckks_device.py`.

Every value is kept fully reduced in int64, where the JAX package keeps lazy
u32 values in [0, 2Q) or [0, 4Q); the outputs are the same residues. The
moduli must stay below 2^30, as there, so both packages refuse the same
inputs. The one shard index that decides a shard's half of a cross-shard
butterfly is its position in the mesh's list (a device may repeat).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.ntt_sched import schedule
from .mesh import Mesh


def scatter(mesh: Mesh, x) -> list[torch.Tensor]:
    """A tower [..., N] (numpy residues or a tensor) -> D int64 shards
    [..., S], shard i on mesh.devices[i]."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=np.uint64).astype(np.int64))
    D = len(mesh.devices)
    S = x.shape[-1] // D
    return [x[..., i * S:(i + 1) * S].to(dev) for i, dev in enumerate(mesh.devices)]


def join(shards: list[torch.Tensor], device: str | torch.device = "cpu") -> torch.Tensor:
    """D shards [..., S] -> the tower [..., N] on `device`."""
    return torch.cat([s.to(device) for s in shards], dim=-1)


# -- tables ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _host_tables(N: int, Q: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """int64 [logN + 1, N] forward rows (the twist, then the logN DIF stage
    vectors) and inverse rows (the logN DIT stage vectors, then the untwist
    with N^-1 folded in), and the bit reversal of the evaluation order
    (`_tables` and `_inv_tables` of the JAX module)."""
    sch = schedule(N, Q)
    fwd = np.concatenate([sch["twist"][None], sch["fwd_w"]]).astype(np.int64)
    inv = np.concatenate([sch["inv_w"], sch["untwist"][None]]).astype(np.int64)
    return fwd, inv, sch["bitrev"]


class _ShardTables:
    """One shard's tables for a tuple of moduli: forward and inverse rows
    [L, logN + 1, S] and the moduli [L], on the shard's device."""

    def __init__(self, fwd: torch.Tensor, inv: torch.Tensor, q: torch.Tensor):
        self.fwd, self.inv, self.q = fwd, inv, q

    def limbs(self, lo: int, hi: int) -> "_ShardTables":
        return _ShardTables(self.fwd[lo:hi], self.inv[lo:hi], self.q[lo:hi])


@functools.lru_cache(maxsize=None)
def _shard_tables(N: int, moduli: tuple, devices: tuple) -> list[_ShardTables]:
    D = len(devices)
    S = N // D
    if S * D != N or S % 2 or D & (D - 1):
        raise ValueError(f"N = {N} does not split into {D} shards of an even size")
    fwd = np.stack([_host_tables(N, m)[0] for m in moduli])
    inv = np.stack([_host_tables(N, m)[1] for m in moduli])
    q = torch.tensor(moduli, dtype=torch.int64)
    return [_ShardTables(torch.from_numpy(fwd[..., i * S:(i + 1) * S].copy()).to(dev),
                         torch.from_numpy(inv[..., i * S:(i + 1) * S].copy()).to(dev),
                         q.to(dev))
            for i, dev in enumerate(devices)]


def _tables_for(N: int, moduli: tuple, mesh: Mesh) -> list[_ShardTables]:
    return _shard_tables(N, tuple(int(m) for m in moduli),
                         tuple(str(d) for d in mesh.devices))


# -- residue arithmetic on [L, ..., S] with per-limb moduli -----------------

def _bq(q: torch.Tensor, nd: int) -> torch.Tensor:
    return q.reshape((q.shape[0],) + (1,) * (nd - 1))


def _bw(w: torch.Tensor, nd: int) -> torch.Tensor:
    """A per-limb row [L, S] against an operand [L, ..., S]."""
    return w.reshape((w.shape[0],) + (1,) * (nd - 2) + (w.shape[-1],))


def _add(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def _sub(a, b, q):
    s = a - b
    return torch.where(s < 0, s + q, s)


def _mul(a, b, q):
    return torch.remainder(a * b, q)


# -- the sharded transforms ------------------------------------------------

def _upper(i: int, bit: int) -> bool:
    return bool((i >> bit) & 1)


def _fwd(xs: list[torch.Tensor], tabs: list[_ShardTables], N: int) -> list[torch.Tensor]:
    """Forward DIF on shards [L, ..., S] of residues in natural
    coefficient order -> shards of the bit-reversed evaluation order."""
    D = len(xs)
    S = N // D
    logn, logd = N.bit_length() - 1, D.bit_length() - 1
    xs = [_mul(x, _bw(t.fwd[:, 0], x.ndim), _bq(t.q, x.ndim)) for x, t in zip(xs, tabs)]
    # stages across shards: h = N/2 .. S, partners `shift` shards apart
    for k in range(logd):
        shift = (N >> (k + 1)) // S
        new = []
        for i, (x, t) in enumerate(zip(xs, tabs)):
            q = _bq(t.q, x.ndim)
            if _upper(i, logd - 1 - k):     # odd half: w * (x[p - h] - x)
                partner = xs[i - shift].to(x.device, non_blocking=True)
                new.append(_mul(_sub(partner, x, q), _bw(t.fwd[:, k + 1], x.ndim), q))
            else:                           # even half: x + x[p + h]
                partner = xs[i + shift].to(x.device, non_blocking=True)
                new.append(_add(x, partner, q))
        xs = new
    # stages inside a shard: h = S/2 .. 1
    for k in range(logd, logn):
        h = N >> (k + 1)
        xs = [_dif_local(x, t.fwd[:, k + 1], h, _bq(t.q, x.ndim + 1))
              for x, t in zip(xs, tabs)]
    return xs


def _blocks(x: torch.Tensor, h: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (x.shape[-1] // (2 * h), 2, h))


def _odd_w(w: torch.Tensor, h: int, nd: int) -> torch.Tensor:
    """The odd-half lanes of a stage row [L, S] -> [L, 1.., S/2h, h]
    against the halves of an operand [L, ..., S] of `nd` dims."""
    wb = _blocks(w, h)[..., 1, :]
    return wb.reshape((wb.shape[0],) + (1,) * (nd - 2) + tuple(wb.shape[1:]))


def _dif_local(x, w, h: int, q):
    """One DIF stage of half-length h inside a shard: even lanes u + v,
    odd lanes w * (u - v). q broadcasts against the [L, ..., S/2h, h]
    halves."""
    y = _blocks(x, h)
    u, v = y[..., 0, :], y[..., 1, :]
    t = _mul(_sub(u, v, q), _odd_w(w, h, x.ndim), q)
    return torch.stack([_add(u, v, q), t], dim=-2).reshape(x.shape)


def _dit_local(x, w, h: int, q):
    """One DIT stage of half-length h inside a shard: u +- w * v."""
    y = _blocks(x, h)
    u, v = y[..., 0, :], y[..., 1, :]
    t = _mul(v, _odd_w(w, h, x.ndim), q)
    return torch.stack([_add(u, t, q), _sub(u, t, q)], dim=-2).reshape(x.shape)


def _inv(xs: list[torch.Tensor], tabs: list[_ShardTables], N: int) -> list[torch.Tensor]:
    """Inverse DIT on shards [L, ..., S] of the bit-reversed evaluation
    order -> shards of natural-order coefficients."""
    D = len(xs)
    S = N // D
    logn, logd = N.bit_length() - 1, D.bit_length() - 1
    # stages inside a shard: h = 1 .. S/2
    for k in range(logn - logd):
        xs = [_dit_local(x, t.inv[:, k], 1 << k, _bq(t.q, x.ndim + 1))
              for x, t in zip(xs, tabs)]
    # stages across shards: h = S .. N/2, the pair bit m of the shard index
    for m in range(logd):
        k = logn - logd + m
        shift = (1 << k) // S
        # the odd half's products w * x, made on their own shard
        ts = [_mul(x, _bw(t.inv[:, k], x.ndim), _bq(t.q, x.ndim)) if _upper(i, m) else None
              for i, (x, t) in enumerate(zip(xs, tabs))]
        new = []
        for i, (x, t) in enumerate(zip(xs, tabs)):
            q = _bq(t.q, x.ndim)
            if _upper(i, m):                # odd half: x[p - h] - t
                new.append(_sub(xs[i - shift].to(x.device, non_blocking=True), ts[i], q))
            else:                           # even half: x + t[p + h]
                new.append(_add(x, ts[i + shift].to(x.device, non_blocking=True), q))
        xs = new
    return [_mul(x, _bw(t.inv[:, logn], x.ndim), _bq(t.q, x.ndim)) for x, t in zip(xs, tabs)]


def build_limb_ntt(N: int, Q: int, mesh: Mesh):
    """The forward negacyclic NTT mod Q < 2^30 over the mesh: shards
    [..., S] of natural-order coefficients -> shards of the bit-reversed
    evaluation order of `ops/ntt_sched.py` (`apply_forward_np`)."""
    assert Q < (1 << 30), "the limb-sharded NTT needs a modulus < 2^30"
    tabs = _tables_for(N, (Q,), mesh)
    return lambda xs: [y[0] for y in _fwd([x[None] for x in xs], tabs, N)]


def build_limb_intt(N: int, Q: int, mesh: Mesh):
    """The inverse of `build_limb_ntt` (`apply_inverse_np`): shards of the
    bit-reversed evaluation order -> shards of natural-order coefficients."""
    assert Q < (1 << 30), "the limb-sharded NTT needs a modulus < 2^30"
    tabs = _tables_for(N, (Q,), mesh)
    return lambda xs: [y[0] for y in _inv([x[None] for x in xs], tabs, N)]


def _products(ea, eb, q):
    """Evaluation-domain (a0, a1) and (b0, b1) stacked on dim 1 of [L, 2, S]
    -> d0, d1, d2 [L, S] (EvalMultCore, rns-leveledshe.cpp)."""
    a0, a1, b0, b1 = ea[:, 0], ea[:, 1], eb[:, 0], eb[:, 1]
    return (_mul(a0, b0, q), _add(_mul(a0, b1, q), _mul(a1, b0, q), q), _mul(a1, b1, q))


def _stacked(*shard_lists) -> list[torch.Tensor]:
    """k shard lists of [L, S] -> one shard list of [L, k, S]."""
    return [torch.stack(parts, dim=1) for parts in zip(*shard_lists)]


def build_limb_ckks_kernels(params, mesh: Mesh) -> dict:
    """The CKKS multiplication's tensor product and rescale with the ring
    dimension sharded over the mesh (`params`: DCRTParams, every limb
    < 2^30). Functions of sharded natural-order coefficient towers:

    - "tensor": (a0, a1, b0, b1) [L, S] shards -> (d0, d1, d2) [L, S]
      shards, the tensor product: the four forward transforms, the
      pointwise products and the three inverse transforms;
    - "rescale": [L, S] shards -> [L - 1, S] shards, the RNS ModReduce of
      `ckks_rns.rescale_rns` on each shard's coefficients.

    The relinearization of d2 composes on the gathered towers
    (`CKKSRnsContext.eval_mult_limb`)."""
    from ..pke.ckks_device import _make_rescale

    N, mods = params.N, tuple(int(m) for m in params.moduli)
    assert all(m < (1 << 30) for m in mods), \
        "limb-sharded pipeline needs moduli < 2^30 (lazy-reduction headroom)"
    tabs = _tables_for(N, mods, mesh)
    rescales = [_make_rescale(mods, str(dev)) for dev in mesh.devices]

    def tensor(a0, a1, b0, b1):
        ea = _fwd(_stacked(a0, a1), tabs, N)
        eb = _fwd(_stacked(b0, b1), tabs, N)
        prods = [torch.stack(_products(x, y, _bq(t.q, 2)), dim=1)
                 for x, y, t in zip(ea, eb, tabs)]
        d = _inv(prods, tabs, N)
        return tuple([x[:, j] for x in d] for j in range(3))

    def rescale(rows):
        return [r(x) for r, x in zip(rescales, rows)]

    return {"tensor": tensor, "rescale": rescale}


def _pack_key_np(key) -> tuple[np.ndarray, np.ndarray]:
    """RnsHybridKey -> its towers b and a as int64 [G, L_pq, N], the rows
    permuted from the canonical evaluation order into the schedule's
    bit-reversed order, so they line up with `_fwd`'s outputs (the JAX
    module's `_pack_key_np`, without its Shoup companions: the port
    multiplies with an exact remainder)."""
    pq = key.pq_params.moduli
    assert all(m < (1 << 30) for m in pq), \
        "limb-sharded keyswitch needs all PQ limbs < 2^30 " \
        "(build the context with ks_limb_bits <= 29)"
    G, L_pq, N = len(key.bs), len(pq), key.pq_params.N
    kb = np.zeros((G, L_pq, N), dtype=np.int64)
    ka = np.zeros((G, L_pq, N), dtype=np.int64)
    for g in range(G):
        for i, m in enumerate(pq):
            br = _host_tables(N, int(m))[2]
            kb[g, i, br] = np.asarray(key.bs[g].rns[i], dtype=np.int64)
            ka[g, i, br] = np.asarray(key.as_[g].rns[i], dtype=np.int64)
    return kb, ka


def build_limb_mult(params, key, mesh: Mesh):
    """The whole CKKS eval_mult with the ring dimension sharded over the
    mesh: the tensor product, the hybrid relinearization (per-group fast
    base conversion to PQ, the inner product with the key towers, ModDown
    by P) and the RNS rescale, with no gathered tower anywhere (the base
    conversions, ModDown and rescale are coefficient-wise). Reference
    parity: rns-leveledshe.cpp EvalMultCore + keyswitch-hybrid.cpp:1-484 +
    ModReduce.

    params: DCRTParams of the ciphertext's chain; key: the RnsHybridKey for
    that chain, every PQ limb < 2^30. Returns (mult, key_shards):
    ``mult(a0, a1, b0, b1, key_shards)`` maps [L, S] shards of
    natural-order coefficient towers to the rescaled [L - 1, S] shards
    (c0, c1); the key shards ([G, L_pq, 2, S]: b then a) are packed once
    per key and mesh."""
    N = params.N
    lvl = tuple(int(m) for m in params.moduli)
    p_moduli = tuple(int(m) for m in key.p_moduli)
    groups = tuple(tuple(g) for g in key.groups)
    pq = lvl + p_moduli
    assert all(m < (1 << 30) for m in pq), \
        "limb-sharded pipeline needs moduli < 2^30 (lazy-reduction headroom)"
    assert tuple(key.q_moduli) == lvl, \
        "use the hybrid key generated for this level chain"
    devices = tuple(str(d) for d in mesh.devices)
    packed = key.__dict__.setdefault("_limb_packed", {})
    if devices not in packed:
        kb, ka = _pack_key_np(key)
        kbka = torch.from_numpy(np.stack([kb, ka], axis=2))       # [G, L_pq, 2, N]
        packed[devices] = scatter(mesh, kbka)
    return _limb_mult(N, lvl, p_moduli, groups, devices), packed[devices]


@functools.lru_cache(maxsize=None)
def _limb_mult(N: int, lvl: tuple, p_moduli: tuple, groups: tuple, devices: tuple):
    from ..pke.ckks_device import _make_fbc, _make_rescale

    pq = lvl + p_moduli
    n_q = len(lvl)
    tabs = _shard_tables(N, pq, devices)
    tabs_q = [t.limbs(0, n_q) for t in tabs]
    P = 1
    for m in p_moduli:
        P *= m
    pinv = [pow(P % m, -1, m) for m in lvl]
    per_dev = {}
    for dev in dict.fromkeys(devices):
        per_dev[dev] = {
            "fbcs": [_make_fbc(lvl[g0:g1], pq, dev) for g0, g1 in groups],
            "fbc_p": _make_fbc(p_moduli, lvl, dev),
            "rescale": _make_rescale(lvl, dev),
            "pinv": torch.tensor(pinv, dtype=torch.int64, device=dev)[:, None, None],
        }
    shard_fns = [per_dev[dev] for dev in devices]

    def mult(a0, a1, b0, b1, kbka):
        ea = _fwd(_stacked(a0, a1), tabs_q, N)
        eb = _fwd(_stacked(b0, b1), tabs_q, N)
        d01, d2e = [], []
        for x, y, t in zip(ea, eb, tabs_q):
            d0, d1, d2 = _products(x, y, _bq(t.q, 2))
            d01.append(torch.stack([d0, d1], dim=1))
            d2e.append(d2[:, None])
        d2c = [d[:, 0] for d in _inv(d2e, tabs_q, N)]
        # hybrid key switch of d2: per group, FBC to PQ, forward, inner
        # product with (b, a) of the key, accumulated in evaluation form
        acc = None
        for g, (g0, g1) in enumerate(groups):
            ext = [f["fbcs"][g](d[g0:g1]) for f, d in zip(shard_fns, d2c)]
            dp = _fwd([e[:, None] for e in ext], tabs, N)             # [L_pq, 1, S]
            terms = [_mul(x, k[g], _bq(t.q, 3)) for x, k, t in zip(dp, kbka, tabs)]
            acc = terms if acc is None else [_add(s, u, _bq(t.q, 3))
                                             for s, u, t in zip(acc, terms, tabs)]
        sw = _inv(acc, tabs, N)                                       # [L_pq, 2, S]
        c01 = _inv(d01, tabs_q, N)                                    # [L, 2, S]
        outs = []
        for f, s, c, t in zip(shard_fns, sw, c01, tabs_q):
            q = _bq(t.q, 3)
            conv = f["fbc_p"](s[n_q:])                                # ModDown by P
            down = _mul(_sub(s[:n_q], conv, q), f["pinv"], q)
            outs.append(f["rescale"](_add(c, down, q)))               # [L - 1, 2, S]
        return [o[:, 0] for o in outs], [o[:, 1] for o in outs]

    return mult
