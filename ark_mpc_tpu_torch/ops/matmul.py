"""Modular matrix multiplication over a Montgomery field.

Counterpart of `ark_mpc_tpu/ops/matmul.py` (`mont_matmul`), the product
behind `Scalar.matmul`, shared matrix multiplication and the evaluation
domains.  The JAX package computes it outside any Pallas kernel (one
`lax.dot_general` over byte planes on the MXU), so here it is a PyTorch
matrix product plus plain carry and REDC code:

    A (m, k), B (k, n) over F_m, both in Montgomery form (values < m):
    1. the 16 limb planes of each operand as float64 matrices,
       A2 (16 m, k) and B2 (k, 16 n); ONE float64 product A2 @ B2 gives all
       16 x 16 plane pairs.  Each entry is a sum of k products of 16-bit
       values, below 2^32 k, and float64 adds integers exactly below 2^53,
       so the product is exact for k < 2^21 in any summation order.
    2. anti-diagonal sums of the plane pairs: 31 int64 columns of 16-bit
       weight (each below 2^36 k).
    3. REDC with 17 iterations (`limbs._redc`): T * 2^-272 mod m, valid while
       T < k m^2 < m 2^272; then one Montgomery product by 2^272 mod m
       restores Montgomery form.

k is chunked at K_CHUNK = 2^17, which keeps both bounds for every modulus
below 2^255 (k m < 2^272); the chunks are summed by field adds.  The result
is the canonical Montgomery form of sum_t A[i, t] B[t, j], so it equals the
JAX package's bit for bit whatever the order of the sums.

On the card the product is cuBLAS DGEMM (float64 tensor cores); there is no
exact integer GEMM through `torch.matmul` on CUDA.  m is chunked so that the
(16 m, 16 n) float64 product stays within _MAX_INTER_BYTES.
"""

from __future__ import annotations

import torch

from ..algebra import limbs as lb
from ..algebra.limbs import NLIMBS, FieldSpec

REDC_ITERS = 17
K_CHUNK = 1 << 17
_MAX_INTER_BYTES = 1 << 28  # the float64 (16 m, 16 n) product of one m chunk
ROUTE = "fp64"


def _mont_correction(spec: FieldSpec):
    """Canonical limbs (numpy) of 2^(16 * REDC_ITERS) mod m."""
    return lb.int_to_limbs(pow(2, 16 * REDC_ITERS, spec.modulus))


def mont_matmul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field matmul: a (16, m, k) @ b (16, k, n) -> (16, m, n), Montgomery."""
    if spec.pm_c:
        raise ValueError("mont_matmul is Montgomery-form only")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != NLIMBS or b.shape[0] != NLIMBS:
        raise ValueError(f"expected (16, m, k) @ (16, k, n), got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    k = a.shape[2]
    if k == 0 or b.shape[1] != k:
        raise ValueError(f"inner dimensions {k} and {b.shape[1]} must agree and be > 0")
    acc = None
    for k0 in range(0, k, K_CHUNK):
        part = _chunk(spec, a[:, :, k0:k0 + K_CHUNK], b[:, k0:k0 + K_CHUNK, :])
        acc = part if acc is None else lb.add(spec, acc, part)
    return acc


def _chunk(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m, k, n = a.shape[1], a.shape[2], b.shape[2]
    bf = b.permute(1, 0, 2).reshape(k, NLIMBS * n).to(torch.float64)
    mb = max(1, min(m, _MAX_INTER_BYTES // (8 * NLIMBS * NLIMBS * max(1, n))))
    outs = [_core(spec, a[:, m0:m0 + mb, :], bf, n) for m0 in range(0, m, mb)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _core(spec: FieldSpec, a: torch.Tensor, bf: torch.Tensor, n: int) -> torch.Tensor:
    mb, k = a.shape[1], a.shape[2]
    prod = a.reshape(NLIMBS * mb, k).to(torch.float64) @ bf  # (16 mb, 16 n)
    planes = prod.to(torch.int64).reshape(NLIMBS, mb, NLIMBS, n)
    cols = planes.new_zeros((2 * NLIMBS - 1, mb, n))
    for i in range(NLIMBS):  # plane pair (i, j) lands in column i + j
        cols[i:i + NLIMBS] += planes[i].permute(1, 0, 2)
    red = lb._redc(spec, cols, iters=REDC_ITERS)
    return lb.mont_mul(spec, red, lb.const_like(_mont_correction(spec), red))
