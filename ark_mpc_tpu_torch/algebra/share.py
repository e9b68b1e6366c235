"""SPDZ secret-share algebra: (share, MAC) pairs with local linear ops.

Counterpart of `ark_mpc_tpu/algebra/share.py`.  A `ScalarShare` holds a
batch of authenticated shares as two limb tensors; every op is local (no
communication):

  - linear ops act on share and MAC together;
  - `add_public` adds to party 0's share only, while BOTH parties add
    `mac_key_share * rhs` to the MAC — the party-0 asymmetry that makes
    additive shares of public constants well-defined.

On a mesh a share is the rank's shard or `replicated` (`placement.py`);
element-wise ops carry the placement and refuse to mix the two, and `sum`
over a shard's batch axis reduces over the party's ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .placement import placement, same_placement, thread_mesh, with_public
from .scalar import FieldArray, Scalar

PARTY0 = 0
PARTY1 = 1


@dataclass
class ScalarShare:
    """Additive share + SPDZ MAC share of a batch of field elements.

    Generic over the share field: the contained `FieldArray` subclass
    carries the field spec.  `replicated`: on a mesh, every rank of the
    party holds the whole batch (else the rank's shard)."""

    share: Scalar
    mac: Scalar
    replicated: bool = False

    def __post_init__(self):
        self.replicated = bool(self.replicated)  # a public value's mark may be None

    @property
    def field(self):
        return type(self.share)

    @property
    def shape(self):
        return self.share.shape

    @property
    def size(self):
        return self.share.size

    @property
    def device(self):
        return self.share.device

    # -- linear algebra (local) -------------------------------------------
    def __add__(self, other: "ScalarShare"):
        rep = placement(self, other)  # before the shapes meet
        return ScalarShare(self.share + other.share, self.mac + other.mac, rep)

    def __sub__(self, other: "ScalarShare"):
        rep = placement(self, other)  # before the shapes meet
        return ScalarShare(self.share - other.share, self.mac - other.mac, rep)

    def __neg__(self):
        return ScalarShare(-self.share, -self.mac, self.replicated)

    def mul_public(self, rhs):
        """Multiply by a public value: scales share and MAC."""
        if isinstance(rhs, int):
            rhs = self.field.from_ints(rhs, device=self.device)
        rep = with_public(self, rhs)
        return ScalarShare(self.share * rhs, self.mac * rhs, rep)

    def __mul__(self, rhs):
        if isinstance(rhs, FieldArray):
            return self.mul_public(rhs)
        return NotImplemented

    __rmul__ = __mul__

    def add_public(self, rhs: Scalar, mac_key: Scalar, party_id: int):
        """Add a public value: party 0 updates the share, both parties
        update the MAC by `mac_key_share * rhs`."""
        rep = with_public(self, rhs)
        if party_id == PARTY0:
            share = self.share + rhs
        else:  # party 1's share takes the result's shape, as party 0's does
            shape = tuple(torch.broadcast_shapes(self.shape, rhs.shape))
            share = self.share if shape == self.shape else type(self.share)(
                self.share.broadcast_to(shape).limbs.contiguous())
        return ScalarShare(share, self.mac + mac_key * rhs, rep)

    def sub_public(self, rhs: Scalar, mac_key: Scalar, party_id: int):
        return self.add_public(-rhs, mac_key, party_id)

    def matmul_public_right(self, rhs: Scalar) -> "ScalarShare":
        """[X] @ E for public E: linear, applies to share and MAC.  The
        rows, and so the placement, are [X]'s."""
        return ScalarShare(self.share @ rhs, self.mac @ rhs, self.replicated)

    def matmul_public_left(self, lhs: Scalar) -> "ScalarShare":
        """D @ [X] for public D; the rows, and so the placement, are D's."""
        return ScalarShare(lhs @ self.share, lhs @ self.mac, lhs.replicated)

    # -- batch structure ---------------------------------------------------
    def __getitem__(self, idx):
        return ScalarShare(self.share[idx], self.mac[idx], self.replicated)

    def reshape(self, *shape):
        return ScalarShare(self.share.reshape(*shape), self.mac.reshape(*shape),
                           self.replicated)

    @classmethod
    def concatenate(cls, items, axis=0):
        f = type(items[0].share)
        return cls(
            f.concatenate([it.share for it in items], axis=axis),
            f.concatenate([it.mac for it in items], axis=axis),
            same_placement(items),
        )

    def sum(self, axis=0):
        """Share-wise sum.  Over the batch axis of a shard on a mesh it
        reduces over the party's ranks (`parallel.step.sharded_sum`); the
        result is replicated."""
        mesh = thread_mesh()
        if mesh is not None and axis == 0 and self.shape and not self.replicated:
            from ..parallel.step import sharded_sum

            return ScalarShare(sharded_sum(mesh, self.share), sharded_sum(mesh, self.mac),
                               True)
        return ScalarShare(self.share.sum(axis), self.mac.sum(axis), self.replicated)

    @classmethod
    def zeros(cls, shape=(), field=Scalar, device=None, replicated: bool = False):
        return cls(field.zeros(shape, device=device),
                   field.zeros(shape, device=device), replicated)

    def __repr__(self):
        rep = ", replicated" if self.replicated else ""
        return f"ScalarShare(shape={self.shape}{rep})"
