"""Batched Ed25519 group arithmetic on torch limb tensors.

Counterpart of `ark_mpc_tpu/algebra/curve.py`: the twisted Edwards curve
-x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255 - 19), whose prime-order subgroup
has order l (the scalar field).  A `CurvePoint` holds a batch of points in
extended coordinates (X, Y, Z, T), each a `BaseFelt` of canonical limbs.

The group law is the complete unified add/double for a = -1 (RFC 8032
5.1.4) in plain torch, as it is plain XLA in the reference.  Scalar
multiplication (`mul`, and the subgroup check) runs the `windowed_mul`
kernel on the card; `msm` takes one of three routes (`ARK_MSM_FORCE`).
On the CPU every kernel runs its plain version.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve_kernels as ck
from . import limbs as lb
from .fields import ED25519_PRIME
from .limbs import NLIMBS
from .placement import GlobalView
from .scalar import BaseFelt, Scalar

P = ED25519_PRIME
ED_D = ck.ED_D
ED_2D = ck.ED_2D
SQRT_M1 = pow(2, (P - 1) // 4, P)
GEN_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202
GEN_Y = 46316835694926478169428394003475163141307993866256225615783033603165251855960

# ARK_MSM_FORCE values: "" and "ladder" take the windowed kernel plus a tree
# sum (the default), "bucket" the bucketed Pippenger, "winsum" the window-sum
# kernel.  Anything else raises.  As in the reference, the route named
# "ladder" runs `windowed_mul`; the ladder kernel is reached through
# `ops.curve_kernels.scalar_mul(..., kernel="ladder")`.
MSM_ROUTES = ("", "ladder", "bucket", "winsum")


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _felt(t: torch.Tensor) -> BaseFelt:
    return BaseFelt(t)


def msm_route() -> str:
    route = os.environ.get("ARK_MSM_FORCE", "")
    if route not in MSM_ROUTES:
        raise ValueError(f"ARK_MSM_FORCE={route!r}: expected one of "
                         f"{', '.join(repr(r) for r in MSM_ROUTES)}")
    return route


@dataclass
class CurvePoint(GlobalView):
    """Batch of Ed25519 points, extended coordinates (X, Y, Z, T), T=XY/Z."""

    X: BaseFelt
    Y: BaseFelt
    Z: BaseFelt
    T: BaseFelt

    base_field = BaseFelt  # the coordinate field (class attribute)

    # -- constructors ------------------------------------------------------
    @classmethod
    def identity(cls, shape=(), device=None):
        shape = _shape(shape)
        return cls(BaseFelt.zeros(shape, device), BaseFelt.ones(shape, device),
                   BaseFelt.ones(shape, device), BaseFelt.zeros(shape, device))

    @classmethod
    def generator(cls, shape=(), device=None):
        g = cls.from_affine_ints(GEN_X, GEN_Y, device=device)
        return g.broadcast_to(_shape(shape))

    @classmethod
    def random(cls, shape=(), rng=None, device=None):
        """Uniform prime-subgroup points by hash-to-curve of random bytes
        (discrete logs unknown even to the sampler)."""
        shape = _shape(shape)
        n = int(np.prod(shape)) if shape else 1
        if rng is None:
            import secrets

            seed = secrets.token_bytes(32)
        else:
            seed = rng.bytes(32)
        return hash_to_curve(seed, n, device=device).reshape(*shape)

    @classmethod
    def from_affine(cls, x: BaseFelt, y: BaseFelt):
        return cls(x, y, BaseFelt.ones(x.shape, x.device), x * y)

    @classmethod
    def from_affine_ints(cls, x, y, device=None):
        return cls.from_affine(BaseFelt.from_ints(x, device),
                               BaseFelt.from_ints(y, device))

    @classmethod
    def from_wire_affine(cls, xc: torch.Tensor, yc: torch.Tensor):
        """Points from canonical affine limb tensors off the wire (the
        Ed25519 identity is the valid affine point (0, 1))."""
        return cls.from_affine(BaseFelt(xc), BaseFelt(yc))

    @classmethod
    def from_coords(cls, coords, shape):
        """Four (16, n) limb tensors -> a point batch of `shape`."""
        shape = _shape(shape)
        return cls(*(_felt(c.reshape((NLIMBS,) + shape)) for c in coords))

    # -- shape -------------------------------------------------------------
    @property
    def shape(self):
        return self.X.shape

    @property
    def size(self):
        return self.X.size

    @property
    def device(self) -> torch.device:
        return self.X.device

    def _coords(self):
        return (self.X, self.Y, self.Z, self.T)

    @property
    def replicated(self) -> bool:
        """On a mesh: every rank holds the whole batch (`placement.py`);
        carried by the coordinates, so slices and reshapes keep it."""
        return self.X.replicated

    @replicated.setter
    def replicated(self, flag: bool) -> None:
        for c in self._coords():
            c.replicated = flag

    def _limbs(self):
        return tuple(c.limbs for c in self._coords())

    def broadcast_to(self, shape):
        return CurvePoint(*(c.broadcast_to(_shape(shape)) for c in self._coords()))

    def _take(self, idx):
        return CurvePoint(*(c.local[idx] for c in self._coords()))

    def _reshape(self, shape: tuple):
        return CurvePoint(*(c._reshape(shape) for c in self._coords()))

    @classmethod
    def concatenate(cls, items, axis=0):
        return cls(*(BaseFelt.concatenate([it._coords()[i] for it in items], axis)
                     for i in range(4)))

    # -- group law (plain torch) ------------------------------------------
    def _add_raw(self, other: "CurvePoint") -> "CurvePoint":
        """Complete unified addition (RFC 8032 5.1.4)."""
        return CurvePoint(*map(_felt, ck.to_canonical(*ck._padd(*self._limbs(),
                                                         *other._limbs()))))

    def _double_raw(self) -> "CurvePoint":
        return CurvePoint(*map(_felt, ck.to_canonical(*ck._double(*self._limbs()))))

    def __add__(self, other: "CurvePoint") -> "CurvePoint":
        return self._add_raw(other)

    def double(self) -> "CurvePoint":
        return self._double_raw()

    def __neg__(self) -> "CurvePoint":
        return CurvePoint(-self.X, self.Y, self.Z, -self.T)

    def __sub__(self, other: "CurvePoint") -> "CurvePoint":
        return self._add_raw(-other)

    def select(self, mask, other: "CurvePoint") -> "CurvePoint":
        """Element-wise: mask ? self : other (mask shape = batch shape)."""
        mask = torch.as_tensor(mask, device=self.device)
        return CurvePoint(*(_felt(torch.where(mask[None], a.limbs, b.limbs))
                            for a, b in zip(self._coords(), other._coords())))

    def mul(self, scalar: Scalar) -> "CurvePoint":
        """Variable-base scalar multiplication (the `windowed_mul` kernel
        on the card, its plain version on the CPU)."""
        return ck.scalar_mul(self, scalar)

    def __mul__(self, scalar: Scalar) -> "CurvePoint":
        return self.mul(scalar)

    __rmul__ = __mul__

    @staticmethod
    def msm(scalars: Scalar, points: "CurvePoint") -> "CurvePoint":
        """sum_i scalars[i] * points[i] by the route `ARK_MSM_FORCE` names:
        the windowed kernel plus a tree sum by default (and for "ladder"),
        the bucketed Pippenger ("bucket") or the window-sum kernel
        ("winsum").  Unknown values raise `ValueError`."""
        route = msm_route()
        shape = torch.broadcast_shapes(tuple(points.shape), tuple(scalars.shape))
        n = int(np.prod(shape)) if shape else 1
        pts = points.broadcast_to(shape).local.reshape(n)
        sc = scalars.broadcast_to(shape).local.reshape(n)
        if route == "bucket":
            from ..ops.msm_kernels import msm_bucket

            return msm_bucket(pts, sc)
        if route == "winsum":
            return ck.msm_windowsum(pts, sc)
        return pts.mul(sc).sum()

    def sum(self, axis=0) -> "CurvePoint":
        """Tree-reduction point sum along a batch axis."""
        pt = self
        n = pt.shape[axis]
        while n > 1:
            half = n // 2
            s = pt._slice(axis, 0, half) + pt._slice(axis, half, 2 * half)
            if n % 2:
                s = CurvePoint.concatenate([s, pt._slice(axis, 2 * half, n)], axis)
            pt = s
            n = pt.shape[axis]
        return CurvePoint(*(_felt(c.limbs.squeeze(axis + 1)) for c in pt._coords()))

    def _slice(self, axis, start, stop):
        return self.local[(slice(None),) * axis + (slice(start, stop),)]

    # -- conversion / comparison ------------------------------------------
    def to_affine(self):
        """(x, y) affine coordinates; batched Fermat inversion of Z."""
        zinv = ck.inverse25519(self.Z.limbs)
        x, y = ck.to_canonical(*ck._mul((self.X.limbs, zinv), (self.Y.limbs, zinv)))
        return _felt(x), _felt(y)

    def normalize(self) -> "CurvePoint":
        return CurvePoint.from_affine(*self.to_affine())

    def equals(self, other: "CurvePoint"):
        """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
        a, b, c, d = ck.to_canonical(*ck._mul(
            (self.X.limbs, other.Z.limbs), (other.X.limbs, self.Z.limbs),
            (self.Y.limbs, other.Z.limbs), (other.Y.limbs, self.Z.limbs)))
        return lb.eq(a, b) & lb.eq(c, d)

    def is_identity(self):
        return self.X.is_zero() & self.Y.equals(self.Z)

    def is_on_curve(self):
        """Projective curve membership + extended-coordinate consistency:
        (Y^2 - X^2) Z^2 == Z^4 + d X^2 Y^2  and  T Z == X Y.

        Points received off the wire must pass this and the subgroup check
        before use (invalid-curve and small-subgroup attacks on the MAC-key
        share)."""
        X, Y, Z, T = self._limbs()
        xx, yy, zz, tz, xy = ck._mul((X, X), (Y, Y), (Z, Z), (T, Z), (X, Y))
        lhs, z4, dxx = ck._mul((lb.lazy_sub25519(yy, xx), zz), (zz, zz),
                               (ck._const(ED_D, xx), xx))
        rhs = lb.lazy_add25519(z4, lb.lazy_mul25519(dxx, yy))
        lhs, rhs, tz, xy = ck.to_canonical(lhs, rhs, tz, xy)
        return lb.eq(lhs, rhs) & lb.eq(tz, xy)

    def is_in_prime_subgroup(self):
        """l * P == identity (l the prime group order): with `is_on_curve`
        the full validation of a received point."""
        return ck.mul_by_order(self).is_identity()

    def compress(self) -> bytes:
        """Ed25519 compressed encoding: 32 bytes LE y with the sign of x."""
        x, y = self.to_affine()
        out = bytearray()
        for xv, yv in zip(x.to_ints(), y.to_ints()):
            out += (int(yv) | ((int(xv) & 1) << 255)).to_bytes(32, "little")
        return bytes(out)

    @classmethod
    def decompress(cls, data: bytes, device=None) -> "CurvePoint":
        """Inverse of `compress` (host-side; sqrt via the p = 5 mod 8 trick)."""
        pts_x, pts_y = [], []
        for off in range(0, len(data), 32):
            enc = int.from_bytes(data[off:off + 32], "little")
            sign = enc >> 255
            y = enc & ((1 << 255) - 1)
            if y >= P:
                raise ValueError("invalid y")
            y2 = y * y % P
            u = (y2 - 1) % P
            v = (ED_D * y2 + 1) % P
            x2 = u * pow(v, -1, P) % P
            x = pow(x2, (P + 3) // 8, P)
            if x * x % P != x2:
                x = x * SQRT_M1 % P
            if x * x % P != x2:
                raise ValueError("not on curve")
            if x & 1 != sign:
                x = (-x) % P
            pts_x.append(x)
            pts_y.append(y)
        return cls.from_affine_ints(pts_x, pts_y, device=device)

    def __repr__(self):
        return f"CurvePoint(shape={self.shape})"


def hash_to_curve(data: bytes, n: int = 1, device=None) -> CurvePoint:
    """Map uniform bytes to prime-subgroup points (Elligator2 to the
    Montgomery curve, then Edwards, then the cofactor 8 cleared).
    Host-side, as in the reference."""
    pts = []
    for i in range(n):
        ctr = 0
        while True:
            h = hashlib.sha3_512(data + i.to_bytes(4, "little")
                                 + ctr.to_bytes(4, "little")).digest()
            pt = _elligator2(int.from_bytes(h, "little") % P)
            if pt is not None:
                pts.append(pt)
                break
            ctr += 1
    pt = CurvePoint.from_affine_ints([p[0] for p in pts], [p[1] for p in pts],
                                     device=device)
    return pt.double().double().double()


def _elligator2(r: int):
    """Elligator2 map r -> Montgomery curve point -> Edwards (x, y) ints."""
    A = 486662
    rr2 = (2 * r * r) % P
    denom = (1 + rr2) % P
    if denom == 0:
        return None
    u = (-A * pow(denom, -1, P)) % P
    gu = (u * u % P * u + A * u % P * u + u) % P

    def legendre(a):
        return pow(a, (P - 1) // 2, P)

    if legendre(gu) != 1:
        u = (-A - u) % P
        gu = (u * u % P * u + A * u % P * u + u) % P
        if legendre(gu) != 1 and gu != 0:
            return None
    v = pow(gu, (P + 3) // 8, P)
    if v * v % P != gu:
        v = v * SQRT_M1 % P
    if v * v % P != gu:
        return None
    c = pow((-486664) % P, (P + 3) // 8, P)
    if c * c % P != (-486664) % P:
        c = c * SQRT_M1 % P
    if v == 0 or (u + 1) % P == 0:
        return (0, 1)
    x = c * u % P * pow(v, -1, P) % P
    y = (u - 1) * pow(u + 1, -1, P) % P
    return (x, y)


# field -> curve link used by the generic point protocols (`fabric/points.py`)
Scalar.curve = CurvePoint
