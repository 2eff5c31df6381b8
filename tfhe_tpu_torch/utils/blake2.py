"""BLAKE2XB extendable-output function, implemented from RFC 7693 + the
BLAKE2X spec, vectorized with numpy.

Provides byte-stream parity with the reference's PRNG engine
(`src/core/include/utils/prng/blake2engine.h`: each 4096-byte refill is
`blake2xb(out, 4096, in=LE64 counter, key=64-byte seed)`), validated against
golden vectors produced by the reference's own blake2xb-ref.c (see
tests/test_distributions.py).

Python's hashlib cannot express the BLAKE2X output blocks (their parameter
block uses depth=0, which hashlib rejects), so the compression function F is
implemented directly. The hot path — the 64 independent output-block
compressions per refill — runs as one numpy-vectorized call; the root chain
is 2 scalar compressions. ~100 MB/s, plenty for host key generation.
"""

from __future__ import annotations

import numpy as np

_IV = np.array([
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179], dtype=np.uint64)

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def _rotr(x: np.ndarray, r: int) -> np.ndarray:
    return (x >> np.uint64(r)) | (x << np.uint64(64 - r))


def _compress(h: np.ndarray, m: np.ndarray, t: int, last: bool) -> np.ndarray:
    """BLAKE2b compression F (RFC 7693 section 3.2), vectorized over the
    leading axes of h [..., 8] / m [..., 16]. t < 2^64 (t_hi always 0 here)."""
    v = np.concatenate([h, np.broadcast_to(_IV, h.shape)], axis=-1).copy()
    v[..., 12] ^= np.uint64(t)
    if last:
        v[..., 14] = ~v[..., 14]

    def G(a, b, c, d, x, y):
        v[..., a] = v[..., a] + v[..., b] + x
        v[..., d] = _rotr(v[..., d] ^ v[..., a], 32)
        v[..., c] = v[..., c] + v[..., d]
        v[..., b] = _rotr(v[..., b] ^ v[..., c], 24)
        v[..., a] = v[..., a] + v[..., b] + y
        v[..., d] = _rotr(v[..., d] ^ v[..., a], 16)
        v[..., c] = v[..., c] + v[..., d]
        v[..., b] = _rotr(v[..., b] ^ v[..., c], 63)

    for r in range(12):
        s = _SIGMA[r % 10]
        G(0, 4, 8, 12, m[..., s[0]], m[..., s[1]])
        G(1, 5, 9, 13, m[..., s[2]], m[..., s[3]])
        G(2, 6, 10, 14, m[..., s[4]], m[..., s[5]])
        G(3, 7, 11, 15, m[..., s[6]], m[..., s[7]])
        G(0, 5, 10, 15, m[..., s[8]], m[..., s[9]])
        G(1, 6, 11, 12, m[..., s[10]], m[..., s[11]])
        G(2, 7, 8, 13, m[..., s[12]], m[..., s[13]])
        G(3, 4, 9, 14, m[..., s[14]], m[..., s[15]])
    return h ^ v[..., :8] ^ v[..., 8:]


def _param_h0(digest_length: int, key_length: int, fanout: int, depth: int,
              leaf_length: int, node_offset: int, xof_length: int,
              node_depth: int, inner_length: int) -> np.ndarray:
    pb = bytearray(64)
    pb[0], pb[1], pb[2], pb[3] = digest_length, key_length, fanout, depth
    pb[4:8] = int(leaf_length).to_bytes(4, "little")
    pb[8:12] = int(node_offset).to_bytes(4, "little")
    pb[12:16] = int(xof_length).to_bytes(4, "little")
    pb[16], pb[17] = node_depth, inner_length
    return _IV ^ np.frombuffer(bytes(pb), dtype="<u8")


def _block_words(data: bytes) -> np.ndarray:
    assert len(data) <= 128
    return np.frombuffer(data.ljust(128, b"\x00"), dtype="<u8")


def blake2xb(outlen: int, msg: bytes, key: bytes = b"") -> bytes:
    """blake2xb(out, outlen, msg, key) of the reference (blake2xb-ref.c:137):
    root = keyed BLAKE2b-512 of msg with xof_length=outlen in the parameter
    block, then output block i = unkeyed BLAKE2b(root) with node_offset=i,
    leaf_length=inner_length=64, fanout=depth=0."""
    assert 0 < outlen < (1 << 32) - 1 and len(key) <= 64

    # root hash (sequential chain: padded key block, then the message blocks;
    # t counts real message bytes, with the key block counting as a full 128)
    h = _param_h0(64, len(key), 1, 1, 0, 0, outlen, 0, 0)
    blocks: list[tuple[bytes, int]] = []     # (block bytes, cumulative t)
    base = 0
    if key:
        blocks.append((bytes(key).ljust(128, b"\x00"), 128))
        base = 128
    n_msg = max(1, (len(msg) + 127) // 128)
    for i in range(n_msg):
        chunk = msg[128 * i:128 * (i + 1)]
        blocks.append((chunk, base + min(len(msg), 128 * i + len(chunk))))
    if key and len(msg) == 0:
        blocks = blocks[:1]                  # keyed empty message: key block is final
    for i, (b, t) in enumerate(blocks):
        h = _compress(h, _block_words(b), t, last=(i == len(blocks) - 1))
    root = h.astype("<u8").tobytes()

    # output blocks: independent single compressions, vectorized
    n_blocks = (outlen + 63) // 64
    h0 = np.stack([
        _param_h0(min(64, outlen - 64 * i), 0, 0, 0, 64, i, outlen, 0, 64)
        for i in range(n_blocks)])
    m = np.broadcast_to(_block_words(root), (n_blocks, 16))
    out_h = _compress(h0, m, 64, True).astype("<u8")
    raw = out_h.tobytes()
    return raw[:outlen]


class Blake2XbEngine:
    """Bit-exact counterpart of the reference `Blake2Engine`
    (blake2engine.h:102-150): a buffer of 1024 uint32 values refilled by
    blake2xb(4096 bytes, in = LE64 counter, key = 16 LE u32 seed words);
    the counter increments once per refill."""

    BUFFER_U32 = 1024

    def __init__(self, seed, counter: int = 0):
        if np.isscalar(seed) or isinstance(seed, int):
            s = np.zeros(16, dtype=np.uint32)
            s[0] = np.uint32(seed)
        else:
            s = np.asarray(seed, dtype=np.uint32)
            assert s.shape == (16,)
        self._key = s.astype("<u4").tobytes()
        self._counter = int(counter)
        self._buf = np.empty(0, dtype=np.uint32)
        self._idx = 0

    def _refill(self) -> None:
        raw = blake2xb(self.BUFFER_U32 * 4,
                       int(self._counter).to_bytes(8, "little"), self._key)
        self._buf = np.frombuffer(raw, dtype="<u4")
        self._counter += 1
        self._idx = 0

    def next_u32(self, count: int) -> np.ndarray:
        out = np.empty(count, dtype=np.uint32)
        filled = 0
        while filled < count:
            if self._idx >= len(self._buf):
                self._refill()
            take = min(count - filled, len(self._buf) - self._idx)
            out[filled:filled + take] = self._buf[self._idx:self._idx + take]
            self._idx += take
            filled += take
        return out
