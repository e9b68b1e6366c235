"""Evaluation domains over the scalar field (FFT/IFFT by matrix product).

Counterpart of `ark_mpc_tpu/algebra/domain.py`.  The Curve25519 scalar
field has 2-adicity 2, so only small smooth evaluation domains exist: sizes
dividing the smooth part of l - 1 (2^2 * 3 * 11 = 132).  A transform is one
Vandermonde matrix product (`Scalar.matmul`); share-wise transforms act on
the share and MAC vectors apart, which keeps authenticated sharings valid.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from .fields import SCALAR_FIELD
from .scalar import Scalar
from .share import ScalarShare

L = SCALAR_FIELD.modulus
_SMOOTH = 132  # smooth part of l - 1: 2^2 * 3 * 11


def _find_generator_of_order(n: int) -> int:
    if (L - 1) % n != 0:
        raise ValueError(f"no multiplicative subgroup of size {n}")
    primes, t, d = set(), n, 2
    while d * d <= t:
        if t % d == 0:
            primes.add(d)
            while t % d == 0:
                t //= d
        d += 1
    if t > 1:
        primes.add(t)
    g = 2
    while True:
        w = pow(g, (L - 1) // n, L)
        # primitive: w^(n/p) != 1 for every prime p | n (and w != 1)
        if w != 1 and all(pow(w, n // p, L) != 1 for p in primes):
            return w
        g += 1


class EvaluationDomain:
    """Multiplicative-subgroup evaluation domain of size n (n | 132) whose
    Vandermonde matrices live on `device` (default: the CUDA card)."""

    def __init__(self, n: int, device=None):
        if _SMOOTH % n != 0:
            raise ValueError(
                f"domain size {n} unsupported: the Curve25519 scalar field "
                f"only has smooth subgroups of size dividing {_SMOOTH}")
        self.n = n
        self.device = resolve_device(device)
        w = _find_generator_of_order(n)
        self.group_gen = w
        fwd = [[pow(w, i * j, L) for j in range(n)] for i in range(n)]
        n_inv, w_inv = pow(n, -1, L), pow(w, -1, L)
        inv = [[n_inv * pow(w_inv, i * j, L) % L for j in range(n)]
               for i in range(n)]
        self._fwd = Scalar.from_ints(np.array(fwd, dtype=object), device=self.device)
        self._inv = Scalar.from_ints(np.array(inv, dtype=object), device=self.device)

    def fft(self, coeffs: Scalar) -> Scalar:
        """Coefficients -> evaluations on the domain (one matrix product)."""
        if coeffs.shape[0] != self.n:
            raise ValueError(f"expected {self.n} coefficients, got {coeffs.shape[0]}")
        return (self._fwd @ coeffs.reshape(self.n, 1)).reshape(self.n)

    def ifft(self, evals: Scalar) -> Scalar:
        if evals.shape[0] != self.n:
            raise ValueError(f"expected {self.n} evaluations, got {evals.shape[0]}")
        return (self._inv @ evals.reshape(self.n, 1)).reshape(self.n)

    def fft_shares(self, x: ScalarShare, forward: bool = True) -> ScalarShare:
        """Share-wise (I)FFT: transform the share and MAC vectors apart."""
        f = self.fft if forward else self.ifft
        return ScalarShare(f(x.share), f(x.mac), x.replicated)
