"""SPDZ secret-share algebra: (share, MAC) pairs with local linear ops.

Counterpart of `ark_mpc_tpu/algebra/share.py`.  A `ScalarShare` holds a
batch of authenticated shares as two limb tensors; every op is local (no
communication):

  - linear ops act on share and MAC together;
  - `add_public` adds to party 0's share only, while BOTH parties add
    `mac_key_share * rhs` to the MAC — the party-0 asymmetry that makes
    additive shares of public constants well-defined.
"""

from __future__ import annotations

from dataclasses import dataclass

from .scalar import FieldArray, Scalar

PARTY0 = 0
PARTY1 = 1


@dataclass
class ScalarShare:
    """Additive share + SPDZ MAC share of a batch of field elements.

    Generic over the share field: the contained `FieldArray` subclass
    carries the field spec."""

    share: Scalar
    mac: Scalar

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
        return ScalarShare(self.share + other.share, self.mac + other.mac)

    def __sub__(self, other: "ScalarShare"):
        return ScalarShare(self.share - other.share, self.mac - other.mac)

    def __neg__(self):
        return ScalarShare(-self.share, -self.mac)

    def mul_public(self, rhs):
        """Multiply by a public value: scales share and MAC."""
        if isinstance(rhs, int):
            rhs = self.field.from_ints(rhs, device=self.device)
        return ScalarShare(self.share * rhs, self.mac * rhs)

    def __mul__(self, rhs):
        if isinstance(rhs, FieldArray):
            return self.mul_public(rhs)
        return NotImplemented

    __rmul__ = __mul__

    def add_public(self, rhs: Scalar, mac_key: Scalar, party_id: int):
        """Add a public value: party 0 updates the share, both parties
        update the MAC by `mac_key_share * rhs`."""
        share = self.share + rhs if party_id == PARTY0 else self.share
        return ScalarShare(share, self.mac + mac_key * rhs)

    def sub_public(self, rhs: Scalar, mac_key: Scalar, party_id: int):
        return self.add_public(-rhs, mac_key, party_id)

    def matmul_public_right(self, rhs: Scalar) -> "ScalarShare":
        """[X] @ E for public E: linear, applies to share and MAC."""
        return ScalarShare(self.share @ rhs, self.mac @ rhs)

    def matmul_public_left(self, lhs: Scalar) -> "ScalarShare":
        """D @ [X] for public D."""
        return ScalarShare(lhs @ self.share, lhs @ self.mac)

    # -- batch structure ---------------------------------------------------
    def __getitem__(self, idx):
        return ScalarShare(self.share[idx], self.mac[idx])

    def reshape(self, *shape):
        return ScalarShare(self.share.reshape(*shape), self.mac.reshape(*shape))

    @classmethod
    def concatenate(cls, items, axis=0):
        f = type(items[0].share)
        return cls(
            f.concatenate([it.share for it in items], axis=axis),
            f.concatenate([it.mac for it in items], axis=axis),
        )

    def sum(self, axis=0):
        """Share-wise sum (refused on a mesh: `parallel.step.refuse_on_mesh`)."""
        from ..parallel.step import refuse_on_mesh

        refuse_on_mesh("ScalarShare.sum")
        return ScalarShare(self.share.sum(axis), self.mac.sum(axis))

    @classmethod
    def zeros(cls, shape=(), field=Scalar, device=None):
        return cls(field.zeros(shape, device=device),
                   field.zeros(shape, device=device))

    def __repr__(self):
        return f"ScalarShare(shape={self.shape})"
