"""SPDZ shares of curve points.

Counterpart of `ark_mpc_tpu/algebra/point_share.py`: a point share is an
additive share of a point plus a MAC point (mac_key * P shared additively).
Linear ops mirror the scalar case; `add_public` keeps the party-0
asymmetry.  Curve-generic: the contained point batch carries the group law.

Where the share and the MAC are multiplied by the same scalar or the same
point, both products go through one batched scalar multiplication (one
kernel launch on the card); the values are those of two separate calls.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .curve import CurvePoint
from .scalar import Scalar
from .share import PARTY0


def _mul_both(points, scalars):
    """[p.mul(s) for p, s in zip(points, scalars)] through one batched
    scalar multiplication."""
    shape = torch.broadcast_shapes(*(tuple(p.shape) for p in points),
                                   *(tuple(s.shape) for s in scalars))
    n = int(np.prod(shape)) if shape else 1
    pts = type(points[0]).concatenate(
        [p.broadcast_to(shape).reshape(n) for p in points])
    scs = type(scalars[0]).concatenate(
        [s.broadcast_to(shape).reshape(n) for s in scalars])
    out = pts.mul(scs)
    return [out[i * n:(i + 1) * n].reshape(*shape) for i in range(len(points))]


@dataclass
class PointShare:
    """Additive share + MAC share of a batch of curve points."""

    share: CurvePoint
    mac: CurvePoint

    @property
    def shape(self):
        return self.share.shape

    @property
    def size(self):
        return self.share.size

    @property
    def device(self):
        return self.share.device

    def __add__(self, other: "PointShare"):
        return PointShare(self.share + other.share, self.mac + other.mac)

    def __sub__(self, other: "PointShare"):
        return PointShare(self.share - other.share, self.mac - other.mac)

    def __neg__(self):
        return PointShare(-self.share, -self.mac)

    def mul_public(self, rhs: Scalar):
        """Scale by a public scalar."""
        return PointShare(*_mul_both([self.share, self.mac], [rhs, rhs]))

    def add_public(self, rhs: CurvePoint, mac_key: Scalar, party_id: int):
        """Add a public point: party 0 updates the share; both parties add
        mac_key_share * rhs to the MAC."""
        share = self.share + rhs if party_id == PARTY0 else self.share
        return PointShare(share, self.mac + rhs.mul(mac_key))

    def sub_public(self, rhs: CurvePoint, mac_key: Scalar, party_id: int):
        return self.add_public(-rhs, mac_key, party_id)

    def __getitem__(self, idx):
        return PointShare(self.share[idx], self.mac[idx])

    def reshape(self, *shape):
        return PointShare(self.share.reshape(*shape), self.mac.reshape(*shape))

    def sum(self, axis=0):
        return PointShare(self.share.sum(axis), self.mac.sum(axis))

    @classmethod
    def concatenate(cls, items, axis=0):
        curve = items[0].curve
        return cls(curve.concatenate([i.share for i in items], axis),
                   curve.concatenate([i.mac for i in items], axis))

    @classmethod
    def identity(cls, shape=(), curve=CurvePoint, device=None):
        return cls(curve.identity(shape, device=device),
                   curve.identity(shape, device=device))

    @property
    def curve(self):
        return type(self.share)

    def __repr__(self):
        return f"PointShare(shape={self.shape})"


def scalar_share_mul_point(scalar_share, point: CurvePoint) -> PointShare:
    """[x] * P for public P -> PointShare."""
    return PointShare(*_mul_both([point, point],
                                 [scalar_share.share, scalar_share.mac]))
