"""BN254 (alt_bn128): the second field and curve instantiation.

Counterpart of `ark_mpc_tpu/algebra/bn254.py`: the same limb engine
(`limbs.py`) at BN254's base field q and scalar field r, both ~254-bit
primes far from pseudo-Mersenne, so every product takes the Montgomery
path (the `mont_mul` kernel on the card).  G1 is y^2 = x^3 + 3 over F_q in
Jacobian coordinates (X, Y, Z), the point at infinity Z = 0, represented
(1, 1, 0); generator (1, 2); cofactor 1.  Formulas: dbl-2009-l and
add-2007-bl with branch-free selects, in plain torch as they are plain XLA
in the reference.  They compute the reference's field values, so every
coordinate is bit-identical, with each level's products batched into one
call (one `mont_mul` launch on the card).

The batching is why the formulas are generators run side by side by
`_run`, and why D is 4·X1·B and each small multiple k·v a product with
k·R (so it joins its level's call): a ladder step makes 11 product calls
where the reference's straight-line formulas make 30 (7 for the doubling,
16 for the addition, 7 for the doubling its equal-point select needs).
A plain product is a few hundred tensor ops however wide the batch,
so the CPU tests' time budget needs the fewer calls; on the card they are
fewer `mont_mul` launches.  A CUDA G1 ladder would replace all of this
(ROADMAP, performance work).

Constructors take a `device` (default: the CUDA card).
"""

from __future__ import annotations

import functools

import torch

from . import limbs as lb
from .limbs import NLIMBS, FieldSpec
from .placement import GlobalView
from .scalar import FieldArray, _shape

BN254_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

BN254_BASE = FieldSpec(BN254_Q, "bn254-fq")
BN254_SCALAR = FieldSpec(BN254_R, "bn254-fr")


class Fq(FieldArray):
    """BN254 base-field element(s)."""

    spec = BN254_BASE


class Fr(FieldArray):
    """BN254 scalar-field element(s)."""

    spec = BN254_SCALAR


_CONSTS: dict = {}


def _const(k: int, like: torch.Tensor) -> torch.Tensor:
    """k * R mod q (the Montgomery form of k) broadcast to `like`'s shape: a
    product with it is the multiple k * v.  Made once per device."""
    key = (k, str(like.device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.from_numpy(
            lb.int_to_limbs(k * BN254_BASE.r % BN254_Q).astype("int32")).to(like.device)
    return _CONSTS[key].reshape((NLIMBS,) + (1,) * (like.dim() - 1)).expand(like.shape)


def _batched(fn, pairs):
    """[fn(q, x, y) for x, y in pairs] through one call on the pairs stacked
    along a new batch axis (one kernel launch for products on the card)."""
    shapes = {t.shape for pair in pairs for t in pair}
    shape = shapes.pop() if len(shapes) == 1 else torch.broadcast_shapes(*shapes)
    if len(pairs) == 1:
        x, y = pairs[0]
        return (fn(BN254_BASE, x.expand(shape), y.expand(shape)),)
    x = torch.stack([p[0].expand(shape) for p in pairs], 1)
    y = torch.stack([p[1].expand(shape) for p in pairs], 1)
    return fn(BN254_BASE, x, y).unbind(1)


_LEVEL_OPS = {"mul": lb.mont_mul, "sub": lb.sub}


def _run(*formulas):
    """Run formula generators side by side.  A formula yields each of its
    levels as ("mul" or "sub", pairs) and is sent back the products or
    differences of the pairs; each round, the requests of one kind from
    every formula still running go through one batched call.  -> the
    formulas' return values."""
    results = [None] * len(formulas)
    pending = {i: f.send(None) for i, f in enumerate(formulas)}
    while pending:
        replies = {}
        for kind, fn in _LEVEL_OPS.items():
            ids = [i for i, (k, _) in pending.items() if k == kind]
            if not ids:
                continue
            out = _batched(fn, [pair for i in ids for pair in pending[i][1]])
            at = 0
            for i in ids:
                n = len(pending[i][1])
                replies[i], at = out[at:at + n], at + n
        for i, values in replies.items():
            try:
                pending[i] = formulas[i].send(values)
            except StopIteration as stop:
                results[i] = stop.value
                del pending[i]
    return results


def _double(X1, Y1, Z1):
    """dbl-2009-l (a = 0) over limb tensors, as a formula for `_run`:
    A = X1^2, B = Y1^2, C = B^2, D = 2((X1 + B)^2 - A - C), E = 3A,
    F = E^2, X3 = F - 2D, Y3 = E (D - X3) - 8C, Z3 = 2 Y1 Z1.  The same field
    values, so the same canonical limbs, in fewer calls: D as 4 X1 B (the
    square expands to it), and each multiple k v as the product of v with
    k R, batched with the other products of its level."""
    A, B, YZ = yield "mul", ((X1, X1), (Y1, Y1), (Y1, Z1))
    k = functools.partial(_const, like=A)
    C, XB, E, Z3 = yield "mul", ((B, B), (X1, B), (A, k(3)), (YZ, k(2)))
    F, D, D2, C8 = yield "mul", ((E, E), (XB, k(4)), (XB, k(8)), (C, k(8)))
    (X3,) = yield "sub", ((F, D2),)
    (DX,) = yield "sub", ((D, X3),)
    (EDX,) = yield "mul", ((E, DX),)
    (Y3,) = yield "sub", ((EDX, C8),)
    return X3, Y3, Z3


def _add(X1, Y1, Z1, X2, Y2, Z2):
    """add-2007-bl over limb tensors without the special cases, as a
    formula for `_run`: U1 = X1 Z2^2, U2 = X2 Z1^2, S1 = Y1 Z2^3,
    S2 = Y2 Z1^3, H = U2 - U1, I = (2H)^2, J = H I, r = 2(S2 - S1),
    V = U1 I, X3 = r^2 - J - 2V, Y3 = r (V - X3) - 2 S1 J,
    Z3 = ((Z1 + Z2)^2 - Z1^2 - Z2^2) H = 2 Z1 Z2 H, batched as `_double`
    is.  -> (X3, Y3, Z3, H, S2 - S1)."""
    Z1Z1, Z2Z2, Y1Z2, Y2Z1, Z1Z2 = yield "mul", (
        (Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1), (Z1, Z2))
    k = functools.partial(_const, like=Z1Z1)
    U1, U2, S1, S2, Z1Z2x2 = yield "mul", (
        (X1, Z2Z2), (X2, Z1Z1), (Y1Z2, Z2Z2), (Y2Z1, Z1Z1), (Z1Z2, k(2)))
    H, dS = yield "sub", ((U2, U1), (S2, S1))
    HH, rr, Z3, U1x2, S1x2 = yield "mul", (
        (H, H), (dS, k(2)), (Z1Z2x2, H), (U1, k(2)), (S1, k(2)))
    I, rr2, S1x2H = yield "mul", ((HH, k(4)), (rr, rr), (S1x2, H))  # noqa: E741
    J, V, Vx2, S1Jx2 = yield "mul", ((H, I), (U1, I), (U1x2, I), (S1x2H, I))
    (X3,) = yield "sub", ((rr2, J),)
    (X3,) = yield "sub", ((X3, Vx2),)
    (VX,) = yield "sub", ((V, X3),)
    (rVX,) = yield "mul", ((rr, VX),)
    (Y3,) = yield "sub", ((rVX, S1Jx2),)
    return X3, Y3, Z3, H, dS


class G1(GlobalView):
    """BN254 G1 point batch in Jacobian coordinates (X, Y, Z); the point at
    infinity is Z == 0, represented (1, 1, 0).

    The same batch-point interface as `CurvePoint` (shape, reshape,
    concatenate, sum, mul, wire conversion), so the point protocols of
    `fabric/points.py` run over either curve."""

    base_field = None   # set below (Fq)
    scalar_field = None  # set below (Fr)

    def __init__(self, X: Fq, Y: Fq, Z: Fq):
        self.X, self.Y, self.Z = X, Y, Z

    @classmethod
    def generator(cls, shape=(), device=None) -> "G1":
        shape = _shape(shape)
        return cls(Fq.from_ints(1, device=device).broadcast_to(shape),
                   Fq.from_ints(2, device=device).broadcast_to(shape),
                   Fq.ones(shape, device=device))

    @classmethod
    def identity(cls, shape=(), device=None) -> "G1":
        shape = _shape(shape)
        return cls(Fq.ones(shape, device=device), Fq.ones(shape, device=device),
                   Fq.zeros(shape, device=device))

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
        return (self.X, self.Y, self.Z)

    @property
    def replicated(self) -> bool:
        """On a mesh: every rank holds the whole batch (`placement.py`);
        carried by the coordinates, so slices and reshapes keep it."""
        return self.X.replicated

    @replicated.setter
    def replicated(self, flag: bool) -> None:
        for c in self._coords():
            c.replicated = flag

    def _take(self, idx):
        return G1(*(c.local[idx] for c in self._coords()))

    def _reshape(self, shape: tuple):
        return G1(*(c._reshape(shape) for c in self._coords()))

    @classmethod
    def concatenate(cls, items, axis=0):
        return cls(*(Fq.concatenate([it._coords()[i] for it in items], axis)
                     for i in range(3)))

    def _slice(self, axis, start, stop):
        return self.local[(slice(None),) * axis + (slice(start, stop),)]

    def _squeeze(self, axis):
        return G1(*(Fq(c.limbs.squeeze(axis + 1)) for c in self._coords()))

    def sum(self, axis=0) -> "G1":
        """Tree-reduction point sum along a batch axis."""
        pt = self
        n = pt.shape[axis]
        while n > 1:
            half = n // 2
            s = pt._slice(axis, 0, half) + pt._slice(axis, half, 2 * half)
            if n % 2:
                s = G1.concatenate([s, pt._slice(axis, 2 * half, n)], axis)
            pt = s
            n = pt.shape[axis]
        return pt._squeeze(axis)

    def is_identity(self):
        return self.Z.is_zero()

    def _limbs(self):
        return tuple(c.limbs for c in self._coords())

    def double(self) -> "G1":
        """dbl-2009-l (a = 0)."""
        (out,) = _run(_double(*self._limbs()))
        return G1(*map(Fq, out))

    def __add__(self, other: "G1") -> "G1":
        """add-2007-bl with the identity, equal and opposite points handled
        by selects (the branch-free form batches need)."""
        # the doubling of self, which the equal-point select needs, shares
        # the addition's calls level by level
        (X3, Y3, Z3, H, dS), dbl = _run(_add(*self._limbs(), *other._limbs()),
                                         _double(*self._limbs()))
        out, dbl = G1(Fq(X3), Fq(Y3), Fq(Z3)), G1(*map(Fq, dbl))
        same_x = lb.is_zero(BN254_BASE, H)
        same_y = lb.is_zero(BN254_BASE, dS)
        id1, id2 = self.is_identity(), other.is_identity()
        both = ~id1 & ~id2
        # equal points -> double; opposite points -> identity
        out = out.select(~(same_x & same_y & both), dbl)
        out = out.select(~(same_x & ~same_y & both),
                         G1.identity(out.shape, device=out.device))
        out = out.select(~id1, other)
        return out.select(~id2, self)

    def __sub__(self, other: "G1") -> "G1":
        return self + (-other)

    def select(self, cond, alt: "G1") -> "G1":
        """Element-wise: cond ? self : alt."""
        cond = torch.as_tensor(cond, device=self.device)

        def sel(a: Fq, b: Fq) -> Fq:
            shape = torch.broadcast_shapes(a.limbs.shape[1:], b.limbs.shape[1:])
            c = cond.expand(shape)
            return Fq(torch.where(c[None], a.limbs, b.limbs))

        return G1(sel(self.X, alt.X), sel(self.Y, alt.Y), sel(self.Z, alt.Z))

    def __neg__(self) -> "G1":
        return G1(self.X, -self.Y, self.Z)

    def mul(self, scalar: Fr) -> "G1":
        """MSB-first double-and-select ladder over the canonical scalar bits,
        the reference's `_g1_scalar_mul` step for step.  It starts at the
        batch's highest set bit: above it every accumulator is the identity
        (1, 1, 0), which doubling and the select keep bit for bit."""
        shape = torch.broadcast_shapes(self.shape, scalar.shape)
        pt = self.broadcast_to(shape)
        canon = lb.from_mont(BN254_SCALAR, scalar.broadcast_to(shape).limbs)
        acc = G1.identity(shape, device=self.device)
        flat = canon.reshape(NLIMBS, -1)
        nonzero = (flat != 0).any(dim=1)
        if not bool(nonzero.any()):
            return acc
        top_limb = int(torch.nonzero(nonzero).max())
        top = 16 * top_limb + int(flat[top_limb].max()).bit_length() - 1
        for bit_index in range(top, -1, -1):
            bit = (canon[bit_index >> 4] >> (bit_index & 15)) & 1
            acc = acc.double()
            acc = (acc + pt).select(bit == 1, acc)
        return acc

    __mul__ = mul
    __rmul__ = mul

    def broadcast_to(self, shape) -> "G1":
        return G1(*(c.broadcast_to(shape) for c in self._coords()))

    def to_affine(self):
        zinv = self.Z.inverse()
        zi2 = zinv.square()
        return self.X * zi2, self.Y * zi2 * zinv

    def normalize(self) -> "G1":
        x, y = self.to_affine()
        pt = G1.from_affine(x, y)
        return pt.select(~self.is_identity(), G1.identity(pt.shape, device=pt.device))

    def __repr__(self):
        return f"G1(shape={self.shape})"

    def equals(self, other: "G1"):
        """Jacobian equality: X1 Z2^2 == X2 Z1^2, Y1 Z2^3 == Y2 Z1^3."""
        Z1Z1, Z2Z2 = self.Z.square(), other.Z.square()
        ex = (self.X * Z2Z2).equals(other.X * Z1Z1)
        ey = (self.Y * Z2Z2 * other.Z).equals(other.Y * Z1Z1 * self.Z)
        both_id = self.is_identity() & other.is_identity()
        return both_id | (ex & ey & ~self.is_identity() & ~other.is_identity())

    def is_on_curve(self):
        """Jacobian curve membership: Y^2 == X^3 + 3 Z^6 (or the identity)."""
        z2 = self.Z.square()
        z6 = z2.square() * z2
        b3 = Fq.from_ints(3, device=self.device).broadcast_to(self.shape)
        rhs = self.X.square() * self.X + b3 * z6
        return self.Y.square().equals(rhs) | self.is_identity()

    def is_in_prime_subgroup(self):
        """Cofactor 1: every F_q-rational point is in the prime-order group,
        so with `is_on_curve` this is the full check.  All true."""
        return torch.ones(self.shape, dtype=torch.bool, device=self.device)

    @classmethod
    def from_affine(cls, x: Fq, y: Fq) -> "G1":
        return cls(x, y, Fq.ones(x.shape, device=x.device))

    @classmethod
    def from_wire_affine(cls, xc: torch.Tensor, yc: torch.Tensor) -> "G1":
        """Points from canonical affine limb tensors off the wire.  The
        identity travels as (0, 0), which is not a curve point (0 != 3)."""
        x = Fq(lb.to_mont(BN254_BASE, xc))
        y = Fq(lb.to_mont(BN254_BASE, yc))
        is_id = x.is_zero() & y.is_zero()
        pt = cls.from_affine(x, y)
        return pt.select(~is_id, cls.identity(pt.shape, device=pt.device))


G1.base_field = Fq
G1.scalar_field = Fr
# field -> curve link used by the point protocols (`fabric/points.py`): a
# fabric over Fr shares speaks G1 points.
Fr.curve = G1
