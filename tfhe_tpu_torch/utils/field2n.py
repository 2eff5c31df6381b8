"""Power-of-two cyclotomic field elements over complex doubles.

Port of `tfhe_tpu/utils/field2n.py`: the same numpy host code, held
to it by tests/test_torch_lattice.py.

Counterpart of the reference's `Field2n`
(`src/core/lib/lattice/field2n.cpp:40-345`,
`src/core/include/lattice/field2n.h:49-345`): elements of
K = Q[X]/(X^n + 1) embedded into C^n, used by the Fourier-domain
perturbation samplers (utils/dgsampling.py). Two formats:

- COEFFICIENT: the n (real) polynomial coefficients;
- EVALUATION: values at the n primitive 2n-th roots of unity
  zeta^(2j+1), zeta = e^(i*pi/n) — the same points the reference's
  ``DiscreteFourierTransform::ForwardTransform`` produces (it zero-pads to
  2n, runs a negative-exponent FFT and keeps the odd bins in reverse order,
  dftransform.cpp:194-215, which algebraically equals evaluation at
  zeta^(2j+1) with positive exponent).

Instead of the reference's scalar loops and 2n-point FFT, the transform is
one n-point FFT with a zeta^j pre/post twist, and every operation is a
whole-vector numpy expression.
"""

from __future__ import annotations

import numpy as np

COEFF = "coeff"
EVAL = "eval"


class Field2n:
    """Immutable-ish field element: complex128 vector + format tag."""

    __slots__ = ("v", "fmt")

    def __init__(self, v, fmt: str = COEFF):
        self.v = np.asarray(v, dtype=np.complex128)
        if fmt not in (COEFF, EVAL):
            raise ValueError(f"unknown format {fmt!r}")
        self.fmt = fmt

    @property
    def n(self) -> int:
        return self.v.shape[-1]

    def _twist(self):
        n = self.n
        return np.exp(1j * np.pi * np.arange(n) / n)

    # -- format switching (SwitchFormat, field2n.cpp:318-338) --------------

    def to_eval(self) -> "Field2n":
        if self.fmt == EVAL:
            return self
        # p(zeta^(2k+1)) = sum_j (a_j zeta^j) e^(2*pi*i jk/n) = n*ifft(a*tw)
        return Field2n(np.fft.ifft(self.v * self._twist()) * self.n, EVAL)

    def to_coeff(self) -> "Field2n":
        if self.fmt == COEFF:
            return self
        return Field2n(np.fft.fft(self.v) / self.n * self._twist().conj(),
                       COEFF)

    # -- arithmetic --------------------------------------------------------

    def _need(self, fmt):
        if self.fmt != fmt:
            raise ValueError(f"operation requires {fmt} format")

    def __add__(self, rhs):
        if isinstance(rhs, Field2n):
            if rhs.fmt != self.fmt:
                raise ValueError("format mismatch")
            return Field2n(self.v + rhs.v, self.fmt)
        # scalar adds to the constant coefficient (field2n.cpp:148-159)
        self._need(COEFF)
        w = self.v.copy()
        w[0] += rhs
        return Field2n(w, COEFF)

    def __sub__(self, rhs):
        if rhs.fmt != self.fmt:
            raise ValueError("format mismatch")
        return Field2n(self.v - rhs.v, self.fmt)

    def __neg__(self):
        return Field2n(-self.v, self.fmt)

    def __mul__(self, rhs):
        if isinstance(rhs, Field2n):
            self._need(EVAL)
            rhs._need(EVAL)
            return Field2n(self.v * rhs.v, EVAL)
        return Field2n(self.v * rhs, self.fmt)     # ScalarMult

    __rmul__ = __mul__

    def inverse(self) -> "Field2n":
        """Pointwise inverse in EVALUATION format (field2n.cpp:119-130)."""
        self._need(EVAL)
        return Field2n(1.0 / self.v, EVAL)

    def shift_right(self) -> "Field2n":
        """Multiply by X: negacyclic right shift (field2n.cpp:193-206)."""
        self._need(COEFF)
        w = np.roll(self.v, 1)
        w[0] = -w[0]
        return Field2n(w, COEFF)

    def automorphism(self, i: int) -> "Field2n":
        """X -> X^i on the evaluation grid (field2n.cpp:209-230): the value
        at root zeta^j lands at the position of zeta^(j*i mod 2n)."""
        self._need(EVAL)
        if i % 2 == 0:
            raise ValueError("automorphism index must be odd")
        m = 2 * self.n
        j = 2 * np.arange(self.n) + 1
        dest = ((j * i) % m - 1) // 2
        w = np.empty_like(self.v)
        w[dest] = self.v
        return Field2n(w, EVAL)

    def transpose(self) -> "Field2n":
        """X -> X^(2n-1) (section VI.B4 of eprint 2017/844;
        field2n.cpp:234-247). In EVALUATION format this is the conjugate
        automorphism; in COEFFICIENT it negates and reverses the tail."""
        if self.fmt == EVAL:
            return self.automorphism(2 * self.n - 1)
        w = np.empty_like(self.v)
        w[0] = self.v[0]
        w[1:] = -self.v[:0:-1]
        return Field2n(w, COEFF)

    # -- even/odd splitting for the Fourier sampler ------------------------

    def extract_even(self) -> "Field2n":
        self._need(COEFF)
        return Field2n(self.v[0::2], COEFF)

    def extract_odd(self) -> "Field2n":
        self._need(COEFF)
        return Field2n(self.v[1::2], COEFF)

    def permute(self) -> "Field2n":
        """[evens..., odds...] reordering (Algorithm 4 of eprint 2017/844,
        field2n.cpp:276-297)."""
        self._need(COEFF)
        return Field2n(np.concatenate([self.v[0::2], self.v[1::2]]), COEFF)

    def inverse_permute(self) -> "Field2n":
        self._need(COEFF)
        h = self.n // 2
        w = np.empty_like(self.v)
        w[0::2] = self.v[:h]
        w[1::2] = self.v[h:]
        return Field2n(w, COEFF)


def inverse_permute_ints(p: np.ndarray) -> np.ndarray:
    """Integer-vector InversePermute (dgsampling.cpp:473-494): interleave
    the first and second halves back into even/odd positions."""
    p = np.asarray(p)
    h = len(p) // 2
    w = np.empty_like(p)
    w[0::2] = p[:h]
    w[1::2] = p[h:]
    return w
