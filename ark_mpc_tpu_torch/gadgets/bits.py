"""Bitwise gadgets over shared bits.

Counterpart of `ark_mpc_tpu/gadgets/bits.py`.  All inputs are authenticated
shares of values in {0, 1}, batch-first; each gadget also takes
`TracedShare` operands, whose products fuse with their level-mates.
Constants are made on the device of the operand.
"""

from __future__ import annotations

from ..algebra.scalar import Scalar
from ..fabric.context import MpcFabric
from ..fabric.scheduler import TracedShare


def bit_xor(fabric: MpcFabric, a, b):
    """a ^ b = a + b - 2ab for shared bits: one Beaver round over the
    batch."""
    two = Scalar.from_ints(2, device=fabric.device)
    if isinstance(a, TracedShare):
        return a + b - (a * b) * two
    ab = fabric.mul(a, b)
    return a + b - ab.mul_public(two)


def bit_xor_public(fabric: MpcFabric, a, b: Scalar):
    """a ^ b with b public; no communication."""
    two = Scalar.from_ints(2, device=b.device)
    # a + b - 2ab = a*(1 - 2b) + b
    one_minus_2b = Scalar.ones(b.shape, device=b.device) - b * two
    if isinstance(a, TracedShare):
        return a * one_minus_2b + b
    return fabric.add_public(a.mul_public(one_minus_2b), b)
