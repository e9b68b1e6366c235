"""Prefix products of shared values.

Counterpart of `ark_mpc_tpu/gadgets/products.py` (Bar-Ilan & Beaver blinded
telescoping products): blind v_i as b_inv[i-1] * v_i * b[i], open the
blinded values, build PUBLIC prefix products, then unblind with b[0] (left)
and b_inv[i] (right).  Two Beaver rounds + one authenticated open round +
one Beaver round, independent of n; the public prefix scan is a log-depth
Hillis-Steele scan of batched Montgomery products.

On a mesh it runs where the reference's does without a sharded pair batch
whose slices would cross ranks: a replicated batch of n with n + 1 <= the
mesh size, the n + 1 pairs drawn whole (`_inverse_pairs`).
"""

from __future__ import annotations

import torch

from ..algebra import limbs as lb
from ..algebra.fields import SCALAR_FIELD
from ..algebra.scalar import Scalar
from ..algebra.share import ScalarShare
from ..fabric.context import MpcFabric
from ..fabric.scheduler import TracedShare, replicated_at_trace
from ..parallel.step import refuse_on_mesh


def _public_prefix_products(values: Scalar) -> Scalar:
    """Inclusive prefix product of public values, Hillis-Steele scan."""
    x = values.limbs  # (16, n)
    n = x.shape[1]
    one = lb.const_like(SCALAR_FIELD.one_mont, x[:, :1])
    shift = 1
    while shift < n:
        shifted = torch.cat([one.expand(x.shape[0], shift), x[:, :n - shift]], dim=1)
        x = lb.mont_mul(SCALAR_FIELD, x, shifted)
        shift *= 2
    return Scalar(x)


def _broadcast_share(s: ScalarShare, n: int) -> ScalarShare:
    return ScalarShare(s.share.broadcast_to((n,)), s.mac.broadcast_to((n,)), s.replicated)


def _inverse_pairs(fabric: MpcFabric, values):
    """The n + 1 inverse pairs for a batch of n.  On a mesh they are drawn
    whole (replicated, the reference dealer's limbs), which needs a
    replicated batch with n + 1 <= the mesh size; anything larger raises
    `NotImplementedError` naming the mesh."""
    if isinstance(values, TracedShare):
        if len(values.shape) != 1:
            raise ValueError("traced prefix_product expects a 1-D batch")
        n, rep = int(values.shape[0]), replicated_at_trace(values)
    else:
        n, rep = values.size, values.replicated
    if fabric.mesh is not None and not rep:
        n *= fabric.mesh.size  # a shard: the global batch
    if fabric.mesh is not None and n + 1 > fabric.mesh.size:
        refuse_on_mesh(
            f"prefix_product of {n} elements", fabric.mesh,
            "it runs only where the n + 1 inverse pairs fit the mesh: it draws "
            "them whole and slices them, and the reference draws "
            "random_inverse_pairs(n + 1) (ark_mpc_tpu/gadgets/products.py:52), "
            "which it shards over the mesh from n + 1 = the mesh size and "
            "refuses where n + 1 does not divide it "
            "(ark_mpc_tpu/fabric/context.py:151-156)")
    return fabric._draw("next_shared_inverse_pair_batch", n + 1, fabric.mesh is not None)


def prefix_product(fabric: MpcFabric, values, defer_check: bool = False):
    """[v_1], ..., [v_n] -> [v_1], [v_1 v_2], ..., [prod v_i].

    Takes a `TracedShare` too: the blinded open then flows through the
    tracer's mid-circuit `as_public()` path and the public scan runs at
    flush time, so the gadget fuses with level-mates in a larger circuit."""
    b, b_inv = _inverse_pairs(fabric, values)
    if isinstance(values, TracedShare):
        return _prefix_product_traced(values, b, b_inv)
    n = values.size
    flat = values.local.reshape(n)

    # blinded_i = b_inv[i-1] * v_i * b[i]  (two Beaver rounds)
    partial = fabric.mul(b_inv[:n], flat)
    blinded = fabric.mul(partial, b[1:])
    blinded_open = fabric.open_authenticated(blinded, defer=defer_check)
    prefixes = _public_prefix_products(blinded_open)

    # unblind: prefix_i * b[0] (a share scaled by the public prefix), then
    # one Beaver round with b_inv[i+1] to cancel the right blinder
    left = _broadcast_share(b[0], n).mul_public(prefixes)
    out = fabric.mul(left, b_inv[1:])
    return out.local.reshape(*values.shape)


def _prefix_product_traced(values: TracedShare, b, b_inv):
    """The same blinded-open protocol as traced nodes: its rounds fuse with
    the surrounding circuit and the public scan runs on the mid-circuit
    opened value."""
    tracer = values.tracer
    n = int(values.shape[0])

    blinded = (tracer.wrap(b_inv[:n]) * values) * tracer.wrap(b[1:])
    prefixes = blinded.open().as_public().apply(_public_prefix_products)
    left = tracer.wrap(_broadcast_share(b[0], n))
    return (left * prefixes) * tracer.wrap(b_inv[1:])
