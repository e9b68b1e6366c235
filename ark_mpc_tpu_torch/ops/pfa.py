"""Good-Thomas prime-factor DFT over Z_q for smooth non-power-of-2 lengths.

Counterpart of `ark_mpc_tpu/ops/pfa.py`.  With m = prod m_i pairwise
coprime and c_i = (m/m_i) ((m/m_i)^-1 mod m_i) the CRT idempotents,
w^(n k) = prod_i (w^(c_i))^(n_i k_i), so the length-m DFT is: reshape by
n -> (n mod m_1, ..., n mod m_k), independent small DFTs along each axis
with root w^(c_i) (order m_i), reshape out by k -> (k mod m_i).  No
twiddle factors; m sum(m_i) modular products per transform instead of m^2.

The roots are the reference's (`primitive_root_of_unity` is
deterministic), so the outputs equal its bit for bit.  Each axis product
is an exact int64 sum of reduced products (the reference assembles the
same sum from 16-bit halves in uint32); the matrices hold plain residues.
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device
from .modular32 import PrimeSpec, primitive_root_of_unity

I64 = torch.int64


def _coprime_factors(m: int) -> list[int]:
    """m as a product of pairwise-coprime prime powers."""
    out, t, p = [], m, 2
    while p * p <= t:
        if t % p == 0:
            pk = 1
            while t % p == 0:
                t //= p
                pk *= p
            out.append(pk)
        p += 1
    if t > 1:
        out.append(t)
    return out


class PfaPlan:
    """Precomputed Good-Thomas plan for one (q, m), on `device` (the CUDA
    card unless given)."""

    def __init__(self, q: int, m: int, device=None):
        if (q - 1) % m:
            raise ValueError(f"q = {q} is not 1 mod {m}")
        self.spec = PrimeSpec(q)
        self.m = m
        self.device = resolve_device(device)
        self.factors = _coprime_factors(m)
        assert math.prod(self.factors) == m
        w = primitive_root_of_unity(q, m)

        def t(rows):
            return torch.tensor(rows, dtype=I64, device=self.device)

        self.axis_mats, self.axis_mats_inv = [], []  # the inverse holds 1/m_i
        for mi in self.factors:
            rest = m // mi
            wi = pow(w, rest * pow(rest, -1, mi) % m, q)       # order m_i
            wi_inv, mi_inv = pow(wi, q - 2, q), pow(mi, q - 2, q)
            self.axis_mats.append(t([[pow(wi, a * b % mi, q) for b in range(mi)]
                                     for a in range(mi)]))
            self.axis_mats_inv.append(t([[pow(wi_inv, a * b % mi, q) * mi_inv % q
                                          for b in range(mi)] for a in range(mi)]))

        # the CRT multi-index idx(n) of (n mod m_i), for input and output:
        #   grid_flat[idx(n)] = x[n]   and   X[k] = out_flat[idx(k)]
        perm = []
        for n in range(m):
            idx = 0
            for mi in self.factors:
                idx = idx * mi + (n % mi)
            perm.append(idx)
        self.perm_out = t(perm)
        self.perm_in = torch.empty_like(self.perm_out)
        self.perm_in[self.perm_out] = torch.arange(m, device=self.device)
        self.grid_shape = tuple(self.factors)

    def __hash__(self):
        return hash((self.spec.q, self.m))

    def __eq__(self, other):
        return (isinstance(other, PfaPlan) and other.spec.q == self.spec.q
                and other.m == self.m)


def _axis_matvec(plan: PfaPlan, mat: torch.Tensor, x: torch.Tensor, axis: int):
    """Apply an (m_i x m_i) modular matrix along `axis` of x: each product
    reduced mod q (< 2^31), then an exact int64 sum of m_i < 2^32 of them."""
    q = plan.spec.q
    x = x.movedim(axis, -1)
    out = torch.remainder(x[..., None, :] * mat, q).sum(-1) % q
    return out.movedim(-1, axis)


def pfa_dft(plan: PfaPlan, x, inverse: bool = False) -> torch.Tensor:
    """Length-m DFT over the last axis via the prime-factor algorithm.
    x: (..., m) residues < q."""
    x = torch.as_tensor(x, device=plan.device).to(I64)
    batch = tuple(x.shape[:-1])
    grid = x[..., plan.perm_in].reshape(batch + plan.grid_shape)
    for i, mat in enumerate(plan.axis_mats_inv if inverse else plan.axis_mats):
        grid = _axis_matvec(plan, mat, grid, axis=len(batch) + i)
    return grid.reshape(batch + (plan.m,))[..., plan.perm_out]
