"""Prefix products of shared values.

Counterpart of `ark_mpc_tpu/gadgets/products.py` (Bar-Ilan & Beaver blinded
telescoping products): blind v_i as b_inv[i-1] * v_i * b[i], open the
blinded values, build PUBLIC prefix products, then unblind with b[0] (left)
and b_inv[i] (right).  Two Beaver rounds + one authenticated open round +
one Beaver round, independent of n; the public prefix scan is a log-depth
Hillis-Steele scan of batched Montgomery products.
"""

from __future__ import annotations

import torch

from ..algebra import limbs as lb
from ..algebra.fields import SCALAR_FIELD
from ..algebra.scalar import Scalar
from ..algebra.share import ScalarShare
from ..fabric.context import MpcFabric
from ..fabric.scheduler import TracedShare
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
    return ScalarShare(s.share.broadcast_to((n,)), s.mac.broadcast_to((n,)))


def prefix_product(fabric: MpcFabric, values, defer_check: bool = False):
    """[v_1], ..., [v_n] -> [v_1], [v_1 v_2], ..., [prod v_i].

    Takes a `TracedShare` too: the blinded open then flows through the
    tracer's mid-circuit `as_public()` path and the public scan runs at
    flush time, so the gadget fuses with level-mates in a larger circuit."""
    refuse_on_mesh(
        "prefix_product", fabric.mesh,
        "it draws n + 1 inverse pairs, and n + 1 is no multiple of the mesh size "
        "when n is; the reference raises there too (ark_mpc_tpu/gadgets/"
        "products.py:52 draws random_inverse_pairs(n + 1), and "
        "ark_mpc_tpu/fabric/context.py:152-158 refuses a batch that does not "
        "divide the mesh)")
    if isinstance(values, TracedShare):
        return _prefix_product_traced(values)
    n = values.size
    flat = values.reshape(n)
    b, b_inv = fabric.random_inverse_pairs(n + 1)

    # blinded_i = b_inv[i-1] * v_i * b[i]  (two Beaver rounds)
    partial = fabric.mul(b_inv[:n], flat)
    blinded = fabric.mul(partial, b[1:])
    blinded_open = fabric.open_authenticated(blinded, defer=defer_check)
    prefixes = _public_prefix_products(blinded_open)

    # unblind: prefix_i * b[0] (a share scaled by the public prefix), then
    # one Beaver round with b_inv[i+1] to cancel the right blinder
    left = _broadcast_share(b[0], n).mul_public(prefixes)
    out = fabric.mul(left, b_inv[1:])
    return out.reshape(*values.shape)


def _prefix_product_traced(values: TracedShare):
    """The same blinded-open protocol as traced nodes: its rounds fuse with
    the surrounding circuit and the public scan runs on the mid-circuit
    opened value."""
    tracer = values.tracer
    fabric = tracer.fabric
    if len(values.shape) != 1:
        raise ValueError("traced prefix_product expects a 1-D batch")
    n = int(values.shape[0])
    b, b_inv = fabric.random_inverse_pairs(n + 1)

    blinded = (tracer.wrap(b_inv[:n]) * values) * tracer.wrap(b[1:])
    prefixes = blinded.open().as_public().apply(_public_prefix_products)
    left = tracer.wrap(_broadcast_share(b[0], n))
    return (left * prefixes) * tracer.wrap(b_inv[1:])
