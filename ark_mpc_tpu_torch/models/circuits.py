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
from ..parallel.step import gather, shard, small


def inner_product(fabric: MpcFabric, x: ScalarShare, y: ScalarShare,
                  defer_check: bool = True) -> ScalarShare:
    """<x, y> with one Beaver round + local tree sum (on a mesh the sum
    reduces over the party's ranks; the result is replicated)."""
    return fabric.mul(x, y).sum()


def global_shape(x, mesh) -> tuple:
    """x's global shape: a shard's rows times the mesh size, a replicated
    value's own (its local shape without a mesh)."""
    if mesh is None or x.replicated or not x.shape:
        return tuple(x.shape)
    return (x.shape[0] * mesh.size,) + tuple(x.shape[1:])


def shared_matmul(fabric: MpcFabric, a: ScalarShare, b: ScalarShare) -> ScalarShare:
    """C = A @ B over shared matrices.

    Matrix Beaver protocol with a matrix triple ([P], [Q], [P@Q]): open
    D = A - P and E = B - Q in ONE coalesced round (O(mk + kn) elements),
    then locally [AB] = D@[Q] + [P]@E + [P@Q] + add_public(D@E): five field
    matrix products (`ops/matmul.py`).

    On a mesh of N ranks the global (m, k) and (k, n) are read from the
    operands' placement (`global_shape`), and the triple is the reference
    dealer's for them.  Where the mesh size divides m, the rows are
    sharded: the triple keeps the rank's rows of P and C and the whole Q,
    a replicated A gives the rank its rows, each rank pair opens its rows
    of D, and the result is the rank's rows of C.  Otherwise (m below the
    mesh size, or one it does not divide, where A can only be replicated)
    the triple is drawn whole and C is replicated.  E is the rank's rows of
    B - Q where B is a shard (then all-gathered: it is public), else whole;
    D and E go in one exchange either way."""
    mesh = fabric.mesh
    (m, k), (k2, n) = global_shape(a, mesh), global_shape(b, mesh)
    if k != k2:
        raise ValueError(f"inner dimensions differ: ({m}, {k}) @ ({k2}, {n})"
                         + (f" (global shapes on the {mesh.size}-rank mesh)" if mesh else ""))
    if mesh is not None and (small(mesh, m) or m % mesh.size):
        p, q, c = fabric.offline.draw_whole("next_matrix_triplet", m, k, n)
    else:
        p, q, c = fabric.offline.next_matrix_triplet(m, k, n)
        if mesh is not None and a.replicated:
            a = shard(a, mesh)
    q_b = q if mesh is None or b.replicated else shard(q, mesh)  # B's rows of Q
    d_flat = (a - p).local.reshape(a.size)
    e_flat = (b - q_b).local.reshape(b.size)
    if d_flat.replicated == e_flat.replicated:
        opened = fabric.open(ScalarShare.concatenate([d_flat, e_flat]))
        d_open, e_open = opened.local[: a.size], opened.local[a.size:]
    else:  # one exchange, each in its own placement
        d_open, e_open = fabric.open_many([d_flat, e_flat])
    d = d_open.local.reshape(*a.shape)
    e = e_open.local.reshape(*b.shape)
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
