"""SPDZ shares of curve points.

Counterpart of `ark_mpc_tpu/algebra/point_share.py`: a point share is an
additive share of a point plus a MAC point (mac_key * P shared additively).
Linear ops mirror the scalar case; `add_public` keeps the party-0
asymmetry.  Curve-generic: the contained point batch carries the group law.

Where the share and the MAC are multiplied by the same scalar or the same
point, both products go through one batched scalar multiplication (one
kernel launch on the card); the values are those of two separate calls.

On a mesh a point share is the rank's shard or `replicated`, as a scalar
share is (`placement.py`); `sum` over a shard's batch axis adds the
party's ranks' partials (`parallel.step.sharded_point_sum`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .curve import CurvePoint
from .placement import GlobalView, placement, same_placement, thread_mesh, with_public
from .scalar import Scalar
from .share import PARTY0


def _mul_both(points, scalars):
    """[p.mul(s) for p, s in zip(points, scalars)] through one batched
    scalar multiplication."""
    shape = torch.broadcast_shapes(*(tuple(p.shape) for p in points),
                                   *(tuple(s.shape) for s in scalars))
    n = int(np.prod(shape)) if shape else 1
    pts = type(points[0]).concatenate(
        [p.broadcast_to(shape).local.reshape(n) for p in points])
    scs = type(scalars[0]).concatenate(
        [s.broadcast_to(shape).local.reshape(n) for s in scalars])
    out = pts.mul(scs)
    return [out.local[i * n:(i + 1) * n].local.reshape(*shape) for i in range(len(points))]


@dataclass
class PointShare(GlobalView):
    """Additive share + MAC share of a batch of curve points; `replicated`
    as for `ScalarShare`."""

    share: CurvePoint
    mac: CurvePoint
    replicated: bool = False

    def __post_init__(self):
        self.replicated = bool(self.replicated)  # a public value's mark may be None

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
        rep = placement(self, other)  # before the shapes meet
        return PointShare(self.share + other.share, self.mac + other.mac, rep)

    def __sub__(self, other: "PointShare"):
        rep = placement(self, other)  # before the shapes meet
        return PointShare(self.share - other.share, self.mac - other.mac, rep)

    def __neg__(self):
        return PointShare(-self.share, -self.mac, self.replicated)

    def mul_public(self, rhs: Scalar):
        """Scale by a public scalar."""
        rep = with_public(self, rhs)
        return PointShare(*_mul_both([self.share, self.mac], [rhs, rhs]), rep)

    def add_public(self, rhs: CurvePoint, mac_key: Scalar, party_id: int):
        """Add a public point: party 0 updates the share; both parties add
        mac_key_share * rhs to the MAC."""
        rep = with_public(self, rhs)
        if party_id == PARTY0:
            share = self.share + rhs
        else:  # party 1's share takes the result's shape, as party 0's does
            shape = tuple(torch.broadcast_shapes(self.shape, rhs.shape))
            share = self.share if shape == self.shape else type(self.share)(
                *(type(c)(c.limbs.contiguous())
                  for c in self.share.broadcast_to(shape)._coords()))
        return PointShare(share, self.mac + rhs.mul(mac_key), rep)

    def sub_public(self, rhs: CurvePoint, mac_key: Scalar, party_id: int):
        return self.add_public(-rhs, mac_key, party_id)

    def _take(self, idx):
        return PointShare(self.share.local[idx], self.mac.local[idx], self.replicated)

    def _reshape(self, shape: tuple):
        return PointShare(self.share._reshape(shape), self.mac._reshape(shape),
                          self.replicated)

    def sum(self, axis=0):
        """Share-wise point sum; over the batch axis of a shard on a mesh,
        over the party's ranks (the result is replicated)."""
        mesh = thread_mesh()
        if mesh is not None and axis == 0 and self.shape and not self.replicated:
            from ..parallel.step import sharded_point_sum

            return PointShare(sharded_point_sum(mesh, self.share),
                              sharded_point_sum(mesh, self.mac), True)
        return PointShare(self.share.sum(axis), self.mac.sum(axis), self.replicated)

    @classmethod
    def concatenate(cls, items, axis=0):
        curve = items[0].curve
        return cls(curve.concatenate([i.share for i in items], axis),
                   curve.concatenate([i.mac for i in items], axis),
                   same_placement(items))

    @classmethod
    def identity(cls, shape=(), curve=CurvePoint, device=None, replicated: bool = False):
        return cls(curve.identity(shape, device=device),
                   curve.identity(shape, device=device), replicated)

    @property
    def curve(self):
        return type(self.share)

    def __repr__(self):
        rep = ", replicated" if self.replicated else ""
        return f"PointShare(shape={self.shape}{rep})"


def scalar_share_mul_point(scalar_share, point: CurvePoint) -> PointShare:
    """[x] * P for public P -> PointShare."""
    rep = with_public(scalar_share, point)
    return PointShare(*_mul_both([point, point],
                                 [scalar_share.share, scalar_share.mac]), rep)
