"""Flagship MPC circuits.

Counterpart of `ark_mpc_tpu/models/circuits.py`: an inner product, shared
matrix multiplication by a matrix Beaver triple, and evaluation of a shared
polynomial at a public point.
"""

from __future__ import annotations

from ..algebra.scalar import Scalar
from ..algebra.share import ScalarShare
from ..fabric.context import MpcFabric


def inner_product(fabric: MpcFabric, x: ScalarShare, y: ScalarShare,
                  defer_check: bool = True) -> ScalarShare:
    """<x, y> with one Beaver round + local tree sum."""
    return fabric.mul(x, y).sum()


def shared_matmul(fabric: MpcFabric, a: ScalarShare, b: ScalarShare) -> ScalarShare:
    """C = A @ B over shared matrices.

    Matrix Beaver protocol with a matrix triple ([P], [Q], [P@Q]): open
    D = A - P and E = B - Q in ONE coalesced round (O(mk + kn) elements),
    then locally [AB] = D@[Q] + [P]@E + [P@Q] + add_public(D@E): five field
    matrix products (`ops/matmul.py`)."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: ({m}, {k}) @ ({k2}, {n})")
    p, q, c = fabric.offline.next_matrix_triplet(m, k, n)
    d_flat = (a - p).reshape(m * k)
    e_flat = (b - q).reshape(k * n)
    opened = fabric.open(ScalarShare.concatenate([d_flat, e_flat]))
    d = opened[: m * k].reshape(m, k)
    e = opened[m * k:].reshape(k, n)
    res = q.matmul_public_left(d) + p.matmul_public_right(e) + c
    return fabric.add_public(res, d @ e)


def poly_eval(fabric: MpcFabric, coeffs: ScalarShare, x: Scalar) -> ScalarShare:
    """Evaluate a shared polynomial at a public point (Horner, local)."""
    n = coeffs.size
    acc = coeffs[n - 1]
    for i in range(n - 2, -1, -1):
        acc = acc.mul_public(x) + coeffs[i]
    return acc
