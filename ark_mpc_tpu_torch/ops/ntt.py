"""Number-theoretic transforms over RNS primes.

Counterpart of `ark_mpc_tpu/ops/ntt.py`: the polynomial engine of the
t-generic prototype BGV stack (`offline/bgv/params.py`, `rns.py`,
`bgv.py`).  Residues are int64 tensors of shape (..., N) with values below
q (`ops/modular32.py`); every transform is batched over the leading axes.

Radix-2 decimation-in-time Cooley-Tukey: a bit-reversal gather, then
log2(N) butterfly stages, each a reshape to (..., N / m, m) and one
Montgomery product of the upper halves by the stage's twiddles.  The
negacyclic form (X^N + 1, the BGV ring) twists by the powers of a
primitive 2N-th root psi before the forward transform and untwists after
the inverse one.  The tables are the reference's (Montgomery form, the
same roots from `primitive_root_of_unity`), built on the host with Python
ints and placed on the plan's device, so every output equals the
reference's bit for bit.  The reference computes the NTT in XLA, outside
any Pallas kernel; here it is plain PyTorch.

A plan of several primes of one length holds their tables side by side,
so that a (..., L, N) RNS polynomial goes through one transform for all L
primes (the same values as L transforms, one prime at a time).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .modular32 import PrimeSpec, add32, mont_mul32, primitive_root_of_unity, sub32

I64 = torch.int64


class _Moduli:
    """The constants `mont_mul32`/`add32`/`sub32` read (q and -q^-1 mod
    2^32), as tensors that broadcast against one residue axis."""

    def __init__(self, q: torch.Tensor, qinv_neg: torch.Tensor):
        self.q = q
        self.qinv_neg = qinv_neg


def _tables(q: int, n: int, negacyclic: bool) -> dict:
    """One prime's tables as Python-int lists (Montgomery form)."""
    w = primitive_root_of_unity(q, n)
    r = (1 << 32) % q

    def mont(x):
        return x * r % q

    w_inv = pow(w, q - 2, q)
    tw, tw_inv = [], []
    for stage in range(n.bit_length() - 1):
        m = 2 << stage
        base, base_inv = pow(w, n // m, q), pow(w_inv, n // m, q)
        tw.append([mont(pow(base, j, q)) for j in range(m // 2)])
        tw_inv.append([mont(pow(base_inv, j, q)) for j in range(m // 2)])
    out = {"tw": tw, "tw_inv": tw_inv, "n_inv": mont(pow(n, q - 2, q))}
    if negacyclic:
        psi = primitive_root_of_unity(q, 2 * n)
        psi_inv = pow(psi, q - 2, q)
        out["psi"] = [mont(pow(psi, j, q)) for j in range(n)]
        out["psi_inv"] = [mont(pow(psi_inv, j, q)) for j in range(n)]
    return out


def _bit_reverse_perm(n: int) -> list:
    bits = n.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)]


class NttPlan:
    """Precomputed tables for (q, N, negacyclic) transforms, on `device`
    (the CUDA card unless given).  `q` is one prime, for residues of shape
    (..., N), or a sequence of L primes of one length, for residues of
    shape (..., L, N) whose row i is taken modulo prime i.  The tables are
    (P, ...) for its P primes: twiddles (P, 1, m/2) per stage, psi powers
    (P, N), n^-1 and R^2 (P, 1)."""

    def __init__(self, q, n: int, negacyclic: bool = True, device=None):
        if n & (n - 1) or n < 1:
            raise ValueError(f"N must be a power of two, got {n}")
        self.stacked = not isinstance(q, (int, np.integer))
        primes = tuple(int(p) for p in q) if self.stacked else (int(q),)
        order = 2 * n if negacyclic else n
        for p in primes:
            if (p - 1) % order:
                raise ValueError(f"q = {p} is not 1 mod {order}")
        self.primes, self.n, self.negacyclic = primes, n, negacyclic
        self.device = device = resolve_device(device)
        tabs = [_tables(p, n, negacyclic) for p in primes]

        def t(rows):
            return torch.tensor(rows, dtype=I64, device=device)

        qs = t(primes)
        qinv = t([PrimeSpec(p).qinv_neg for p in primes])
        self.mod2 = _Moduli(qs.reshape(-1, 1), qinv.reshape(-1, 1))        # (P, N)
        self.mod3 = _Moduli(qs.reshape(-1, 1, 1), qinv.reshape(-1, 1, 1))  # (P, N/m, m)
        n_stages = n.bit_length() - 1
        self.tw = [t([tb["tw"][s] for tb in tabs]).unsqueeze(1) for s in range(n_stages)]
        self.tw_inv = [t([tb["tw_inv"][s] for tb in tabs]).unsqueeze(1)
                       for s in range(n_stages)]
        self.n_inv = t([tb["n_inv"] for tb in tabs]).reshape(-1, 1)
        self.r2 = t([PrimeSpec(p).r2 for p in primes]).reshape(-1, 1)
        if negacyclic:
            self.psi = t([tb["psi"] for tb in tabs])
            self.psi_inv = t([tb["psi_inv"] for tb in tabs])
        self.perm = t(_bit_reverse_perm(n))

    def __hash__(self):
        return hash((self.primes, self.stacked, self.n, self.negacyclic))

    def __eq__(self, other):
        return (isinstance(other, NttPlan) and other.primes == self.primes
                and other.stacked == self.stacked and other.n == self.n
                and other.negacyclic == self.negacyclic)

    def _rows(self, x) -> torch.Tensor:
        """x on the plan's device as int64 rows (..., P, N)."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x.astype(np.int64))
        x = torch.as_tensor(x, device=self.device).to(I64)
        return x if self.stacked else x.unsqueeze(-2)

    def _unrows(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.stacked else x.squeeze(-2)

    def _run(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """x (..., P, N) residues -> their transforms, per prime."""
        n = self.n
        if x.shape[-1] != n:
            raise ValueError(f"expected a last axis of {n}, got shape {tuple(x.shape)}")
        mod2, mod3 = self.mod2, self.mod3
        if self.negacyclic and not inverse:
            x = mont_mul32(mod2, x, self.psi)
        x = x[..., self.perm]
        lead = x.shape[:-1]
        for stage, tw in enumerate(self.tw_inv if inverse else self.tw):
            m = 2 << stage
            y = x.reshape(lead + (n // m, m))
            lo, hi = y[..., :m // 2], y[..., m // 2:]
            hi_t = mont_mul32(mod3, hi, tw)
            x = torch.cat([add32(mod3, lo, hi_t), sub32(mod3, lo, hi_t)], dim=-1
                          ).reshape(lead + (n,))
        if inverse:
            x = mont_mul32(mod2, x, self.n_inv)
            if self.negacyclic:
                x = mont_mul32(mod2, x, self.psi_inv)
        return x


def ntt(plan: NttPlan, x, inverse: bool = False) -> torch.Tensor:
    """Forward/inverse NTT over the last axis of residues below q (standard
    domain; the twiddles act in Montgomery form inside): x of shape (..., N)
    for a one-prime plan, (..., L, N) for a plan of L primes."""
    return plan._unrows(plan._run(plan._rows(x), inverse))


def poly_mul_mod(plan: NttPlan, a, b) -> torch.Tensor:
    """Polynomial product in Z_q[X]/(X^N + 1) (negacyclic) or /(X^N - 1):
    NTT -> pointwise Montgomery product -> INTT, batched over leading axes.
    As in the reference, the pointwise product's 2^-32 is undone by a
    Montgomery product with R^2 mod q."""
    fa, fb = plan._run(plan._rows(a), False), plan._run(plan._rows(b), False)
    prod = mont_mul32(plan.mod2, mont_mul32(plan.mod2, fa, fb), plan.r2)
    return plan._unrows(plan._run(prod, True))
