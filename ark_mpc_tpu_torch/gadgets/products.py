"""Prefix products of shared values.

Counterpart of `ark_mpc_tpu/gadgets/products.py` (Bar-Ilan & Beaver blinded
telescoping products): blind v_i as b_inv[i-1] * v_i * b[i], open the
blinded values, build PUBLIC prefix products, then unblind with b[0] (left)
and b_inv[i] (right).  Two Beaver rounds + one authenticated open round +
one Beaver round, independent of n; the public prefix scan is a log-depth
Hillis-Steele scan of batched Montgomery products.

On a mesh it takes the reference's rule: it draws the n + 1 inverse pairs
of the global batch (`random_inverse_pairs`, which raises `ValueError`
naming the mesh where the reference's `_place` raises: n + 1 at least the
mesh size and not a multiple of it) and slices `b_inv[:n]`, `b[1:]` and
`b[0]` by global position (the global view).  So it runs wherever the
reference runs, a batch of n that is held replicated (n below the mesh
size, or one the mesh size does not divide, such as `x[:7]` of an
8-element shard on 4 ranks) among them.
"""

from __future__ import annotations

import torch

from ..algebra import limbs as lb
from ..algebra.fields import SCALAR_FIELD
from ..algebra.scalar import Scalar
from ..algebra.share import ScalarShare
from ..fabric.context import MpcFabric
from ..fabric.scheduler import TracedShare, replicated_at_trace


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


def _broadcast_share(s: ScalarShare, like) -> ScalarShare:
    """The single shared value s (the same on every rank) broadcast to the
    shape and placement of `like` (a share or a traced share)."""
    rep = like.replicated if isinstance(like, ScalarShare) else replicated_at_trace(like)
    shape = tuple(like.shape)
    return ScalarShare(s.share.broadcast_to(shape), s.mac.broadcast_to(shape), rep)


def _inverse_pairs(fabric: MpcFabric, values):
    """The n + 1 inverse pairs (b, b_inv) for the global batch of n of
    `values` (a shard's rows times the mesh size on a mesh), as the
    reference draws them; -> (b, b_inv, n)."""
    if isinstance(values, TracedShare):
        if len(values.shape) != 1:
            raise ValueError("traced prefix_product expects a 1-D batch")
        n, rep = int(values.shape[0]), replicated_at_trace(values)
    else:
        n, rep = values.size, values.replicated
    if fabric.mesh is not None and not rep:
        n *= fabric.mesh.size  # a shard: the global batch
    b, b_inv = fabric.random_inverse_pairs(n + 1)
    return b, b_inv, n


def prefix_product(fabric: MpcFabric, values, defer_check: bool = False):
    """[v_1], ..., [v_n] -> [v_1], [v_1 v_2], ..., [prod v_i].

    Takes a `TracedShare` too: the blinded open then flows through the
    tracer's mid-circuit `as_public()` path and the public scan runs at
    flush time, so the gadget fuses with level-mates in a larger circuit."""
    b, b_inv, n = _inverse_pairs(fabric, values)
    if isinstance(values, TracedShare):
        return _prefix_product_traced(values, b, b_inv, n)
    flat = values.local.reshape(values.size)

    # blinded_i = b_inv[i-1] * v_i * b[i]  (two Beaver rounds)
    partial = fabric.mul(b_inv[:n], flat)
    blinded = fabric.mul(partial, b[1:])
    blinded_open = fabric.open_authenticated(blinded, defer=defer_check)
    prefixes = _public_prefix_products(blinded_open)

    # unblind: prefix_i * b[0] (a share scaled by the public prefix), then
    # one Beaver round with b_inv[i+1] to cancel the right blinder
    left = _broadcast_share(b[0], blinded).mul_public(prefixes)
    out = fabric.mul(left, b_inv[1:])
    return out.local.reshape(*values.shape)


def _prefix_product_traced(values: TracedShare, b, b_inv, n: int):
    """The same blinded-open protocol as traced nodes: its rounds fuse with
    the surrounding circuit and the public scan runs on the mid-circuit
    opened value."""
    tracer = values.tracer
    blinded = (tracer.wrap(b_inv[:n]) * values) * tracer.wrap(b[1:])
    prefixes = blinded.open().as_public().apply(_public_prefix_products)
    left = tracer.wrap(_broadcast_share(b[0], values))
    return (left * prefixes) * tracer.wrap(b_inv[1:])
