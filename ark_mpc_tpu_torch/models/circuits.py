"""Flagship MPC circuits.

Counterpart of `ark_mpc_tpu/models/circuits.py`: an inner product, shared
matrix multiplication by a matrix Beaver triple, and evaluation of a shared
polynomial at a public point.  Each runs on a mesh-attached fabric too
(`fabric/context.py`), with the reference's values at every position.
"""

from __future__ import annotations

from ..algebra.scalar import Scalar
from ..algebra.share import ScalarShare
from ..fabric.context import MpcFabric
from ..parallel.step import batch_sharding, gather


def inner_product(fabric: MpcFabric, x: ScalarShare, y: ScalarShare,
                  defer_check: bool = True) -> ScalarShare:
    """<x, y> with one Beaver round + local tree sum (on a mesh the sum
    reduces over the party's ranks; the result is replicated)."""
    return fabric.mul(x, y).sum()


def shared_matmul(fabric: MpcFabric, a: ScalarShare, b: ScalarShare) -> ScalarShare:
    """C = A @ B over shared matrices.

    Matrix Beaver protocol with a matrix triple ([P], [Q], [P@Q]): open
    D = A - P and E = B - Q in ONE coalesced round (O(mk + kn) elements),
    then locally [AB] = D@[Q] + [P]@E + [P@Q] + add_public(D@E): five field
    matrix products (`ops/matmul.py`).

    On a mesh of N ranks both operands are row-sharded: `a` is the rank's
    m/N rows of A (its shard of the flat m*k batch, reshaped to (-1, k)),
    `b` its k/N rows of B.  The triple keeps the rank's rows of P and C and
    the whole Q; each rank pair opens its rows of D and E, E is all-gathered
    over the party's ranks (it is public), and the result is the rank's
    rows of [AB] = D_r@[Q] + [P]_r@E + [C]_r + D_r@E, row-sharded."""
    mesh = fabric.mesh
    size = 1 if mesh is None else mesh.size
    (m, k), (k2, n) = a.shape, b.shape
    m, k2 = m * size, k2 * size
    if k != k2:
        raise ValueError(f"inner dimensions differ: ({m}, {k}) @ ({k2}, {n})"
                         + (f" (global shapes on the {size}-rank mesh)" if mesh else ""))
    p, q, c = fabric.offline.next_matrix_triplet(m, k, n)
    q_rows = q
    if mesh is not None:
        rows = batch_sharding(mesh, k)
        q_rows = ScalarShare(q.share[rows], q.mac[rows])
    d_flat = (a - p).reshape(a.size)
    e_flat = (b - q_rows).reshape(b.size)
    opened = fabric.open(ScalarShare.concatenate([d_flat, e_flat]))
    d = opened[: a.size].reshape(*a.shape)
    e = opened[a.size:].reshape(*b.shape)
    if mesh is not None:
        e = gather(e, mesh)
    res = q.matmul_public_left(d) + p.matmul_public_right(e) + c
    return fabric.add_public(res, d @ e)


def poly_eval(fabric: MpcFabric, coeffs: ScalarShare, x: Scalar) -> ScalarShare:
    """Evaluate a shared polynomial at a public point (Horner, local).  On a
    mesh the coefficients are first gathered over the party's ranks (the
    party's own shares: nothing crosses parties); the result is
    replicated."""
    if fabric.mesh is not None:
        coeffs = gather(coeffs, fabric.mesh)
    n = coeffs.size
    acc = coeffs[n - 1]
    for i in range(n - 2, -1, -1):
        acc = acc.mul_public(x) + coeffs[i]
    return acc
