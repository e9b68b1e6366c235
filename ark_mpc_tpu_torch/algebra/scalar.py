"""User-facing field-element arrays on torch tensors.

Counterpart of `ark_mpc_tpu/algebra/scalar.py`: a `FieldArray` holds an
arbitrary batch shape of field elements as one ``(16, *batch)`` int32 limb
tensor in Montgomery form (see `limbs.py`).  Constructors take a `device`
(default: the CUDA card, raising without one); operations run where their
operands lie.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import limbs as lb
from .fields import BASE_FIELD, SCALAR_FIELD
from .limbs import NLIMBS
from .placement import GlobalView


_KEEP = object()  # `_like`: keep the operand's placement


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


class FieldArray(GlobalView):
    """An array of elements of one prime field (Montgomery-form limbs)."""

    spec = None  # set by subclass
    # on a mesh: True held whole by every rank, False a shard, None unmarked
    # (made locally; `placement.py`)
    replicated = None

    __array_priority__ = 1000  # win against numpy operator dispatch

    def __init__(self, limbs: torch.Tensor):
        self.limbs = limbs  # (16, *batch) int32, Montgomery form

    # -- construction ------------------------------------------------------
    @classmethod
    def from_ints(cls, values, device=None):
        if isinstance(values, (int, np.integer)):
            arr = lb.pack_ints(cls.spec, [int(values)], device=device)
            return cls(arr.reshape(NLIMBS))
        vals = np.asarray(values, dtype=object)
        flat = [int(v) for v in vals.reshape(-1)]
        packed = lb.pack_ints(cls.spec, flat, device=device)
        return cls(packed.reshape((NLIMBS,) + vals.shape))

    @classmethod
    def zeros(cls, shape=(), device=None):
        return cls(torch.zeros((NLIMBS,) + _shape(shape), dtype=lb.LIMB_DTYPE,
                               device=resolve_device(device)))

    @classmethod
    def ones(cls, shape=(), device=None):
        shape = _shape(shape)
        one = torch.tensor(cls.spec.one_mont.astype(np.int32),
                           device=resolve_device(device))
        return cls(one.reshape((NLIMBS,) + (1,) * len(shape))
                   .expand((NLIMBS,) + shape).contiguous())

    @classmethod
    def random(cls, shape=(), rng: np.random.Generator | None = None,
               device=None):
        """Uniform field elements (negligible bias via 448-bit reduction).

        Draws from a host generator exactly as the reference does, so the
        same generator state gives the same elements bit for bit.  Defaults
        to an OS-entropy CSPRNG (`utils.csprng`): these values are protocol
        secrets.  Tests may pass a seeded generator explicitly."""
        shape = _shape(shape)
        device = resolve_device(device)
        if rng is None:
            from ..utils.csprng import default_crypto_rng

            rng = default_crypto_rng()
        n = int(np.prod(shape)) if shape else 1
        wide = np.zeros((32, n), dtype=np.uint32)
        wide[:28] = rng.integers(0, 1 << 16, size=(28, n), dtype=np.uint32)
        wide_t = torch.from_numpy(wide.astype(np.int32)).to(device)
        canon = lb.reduce_wide(cls.spec, wide_t)
        mont = lb.to_mont(cls.spec, canon)
        return cls(mont.reshape((NLIMBS,) + shape))

    # -- shape -------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.limbs.shape[1:])

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def device(self) -> torch.device:
        return self.limbs.device

    def _like(self, limbs: torch.Tensor, replicated=_KEEP):
        """A value of this field and placement (or of `replicated`)."""
        out = type(self)(limbs)
        flag = self.replicated if replicated is _KEEP else replicated
        if flag is not None:
            out.replicated = flag
        return out

    def _reshape(self, shape: tuple):
        return self._like(self.limbs.reshape((NLIMBS,) + shape))

    def _take(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return self._like(self.limbs[(slice(None),) + idx])

    @classmethod
    def concatenate(cls, items, axis=0):
        out = cls(torch.cat([it.limbs for it in items], dim=axis + 1))
        if all(it.replicated for it in items):
            out.replicated = True
        elif any(it.replicated is False for it in items):
            out.replicated = False
        return out

    def broadcast_to(self, shape):
        shape = _shape(shape)
        lead = (1,) * (len(shape) - len(self.shape))
        return self._like(self.limbs.reshape((NLIMBS,) + lead + self.shape)
                          .expand((NLIMBS,) + shape))

    # -- arithmetic --------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, FieldArray):
            if type(other) is not type(self):
                raise TypeError("mixed fields")
            return other
        if isinstance(other, (int, np.integer)):
            return type(self).from_ints(int(other), device=self.device)
        return NotImplemented

    def _bin(self, other, fn):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        a, b = self.limbs, other.limbs
        if a.shape != b.shape:
            a, b = _broadcast_limbs(a, b)
        # a public result is marked replicated where each operand is marked
        # or 0-d, else a shard where an operand is one (public values never
        # raise on mixing: `placement.py`)
        rep = (self.replicated or other.replicated) and (
            (self.replicated or not self.shape) and (other.replicated or not other.shape))
        if not rep:
            rep = False if False in (self.replicated, other.replicated) else None
        return self._like(fn(self.spec, a, b), rep)

    def __add__(self, other):
        return self._bin(other, lb.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._bin(other, lb.sub)

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        return self._bin(other, lb.mont_mul)

    __rmul__ = __mul__

    def __neg__(self):
        return self._like(lb.neg(self.spec, self.limbs))

    def __truediv__(self, other):
        other = self._coerce(other)
        return self * other.inverse()

    def inverse(self):
        """Multiplicative inverse (0 -> 0); Fermat pow, fully batched."""
        return self._like(lb.inverse(self.spec, self.limbs))

    def pow(self, e: int):
        """Fixed public exponent e >= 0 (square-and-multiply over the bits
        of e).  A negative e raises `ValueError` (take `inverse()` first)."""
        e = public_exponent(e)
        if e == 0:
            return type(self).ones(self.shape, device=self.device)
        bits = tuple((e >> i) & 1 for i in range(e.bit_length()))
        return type(self)(lb.mont_pow_fixed(self.spec, self.limbs, bits))

    def square(self):
        return self * self

    def sqrt(self):
        """Square roots (host-side Tonelli-Shanks).

        Returns (roots, is_square): the canonical (smaller) root where one
        exists, 0 elsewhere, plus a numpy bool mask of which elements are
        quadratic residues."""
        p = self.spec.modulus
        roots, mask = [], []
        for v in self.to_ints():
            if v == 0:
                roots.append(0)
                mask.append(True)
            elif pow(v, (p - 1) // 2, p) != 1:
                roots.append(0)
                mask.append(False)
            else:
                r = _tonelli_shanks(v, p)
                roots.append(min(r, p - r))
                mask.append(True)
        out = type(self).from_ints(roots, device=self.device).reshape(*self.shape)
        mask_arr = (np.array(mask).reshape(self.shape) if self.shape
                    else np.bool_(mask[0]))
        return out, mask_arr

    def matmul(self, other: "FieldArray") -> "FieldArray":
        """Field matrix product (m, k) @ (k, n) (`ops/matmul.py`)."""
        other = self._coerce(other)
        from ..ops.matmul import mont_matmul

        return type(self)(mont_matmul(self.spec, self.limbs, other.limbs))

    def __matmul__(self, other):
        return self.matmul(other)

    def sum(self, axis=0):
        """Tree-reduction sum along a batch axis (log-depth modular adds)."""
        return type(self)(lb.tree_sum(self.spec, self.limbs, axis + 1))

    # -- comparison / export ----------------------------------------------
    def equals(self, other):
        other = self._coerce(other)
        a, b = self.limbs, other.limbs
        if a.shape != b.shape:
            a, b = _broadcast_limbs(a, b)
        return lb.eq(a, b)

    def is_zero(self):
        return lb.is_zero(self.spec, self.limbs)

    def to_ints(self):
        return lb.unpack_ints(self.spec, self.limbs.reshape(NLIMBS, -1))

    def to_int(self):
        if self.size != 1:
            raise ValueError(f"to_int needs one element, got shape {self.shape}")
        return self.to_ints()[0]

    def canonical_limbs(self):
        """Canonical (non-Montgomery) limb tensor, for hashing/serialization."""
        return lb.from_mont(self.spec, self.limbs)

    def _canonical_numpy(self) -> np.ndarray:
        return self.canonical_limbs().cpu().numpy().reshape(NLIMBS, -1)

    def to_bytes_be(self) -> bytes:
        """Canonical big-endian 32-byte encoding per element (flat batch order)."""
        return self._canonical_numpy().astype(">u2")[::-1].T.tobytes()

    @classmethod
    def from_be_bytes_mod_order(cls, data: bytes, device=None):
        """Hash-output -> field element, reducing a 32-byte BE value mod m."""
        v = int.from_bytes(data, "big")
        return cls.from_ints(v % cls.spec.modulus, device=device)

    def to_bytes_le(self) -> bytes:
        """Canonical little-endian 32-byte encoding per element."""
        return self._canonical_numpy().astype("<u2").T.tobytes()

    @classmethod
    def from_bytes_le(cls, data: bytes, device=None):
        """Inverse of `to_bytes_le` (batch: concatenated 32-byte chunks);
        values must be canonical (< modulus)."""
        vals = []
        for off in range(0, len(data), 32):
            v = int.from_bytes(data[off:off + 32], "little")
            if v >= cls.spec.modulus:
                raise ValueError("non-canonical encoding")
            vals.append(v)
        return cls.from_ints(vals, device=device)

    # -- biguint / radix-string conversions: Python ints are arbitrary
    # precision, so these are thin canonical wrappers over to/from_ints.

    def to_biguint(self) -> int:
        """Canonical integer value (single element)."""
        return self.to_int()

    @classmethod
    def from_biguint(cls, v: int, device=None):
        """Integer (any size) reduced mod the field order."""
        return cls.from_ints(int(v) % cls.spec.modulus, device=device)

    @classmethod
    def from_radix_string(cls, s: str, radix: int = 10, device=None):
        """Parse a radix-`radix` string (2..36) and reduce mod the order."""
        return cls.from_biguint(int(s.strip(), radix), device=device)

    def to_radix_string(self, radix: int = 10) -> str:
        if not 2 <= radix <= 36:
            raise ValueError("radix must be in [2, 36]")
        v = self.to_biguint()
        digits = "0123456789abcdefghijklmnopqrstuvwxyz"
        out = []
        while True:
            v, r = divmod(v, radix)
            out.append(digits[r])
            if v == 0:
                return "".join(reversed(out))

    def __repr__(self):
        if self.size <= 4:
            return f"{type(self).__name__}({self.to_ints()})"
        return f"{type(self).__name__}(shape={self.shape})"


def public_exponent(e) -> int:
    """A public exponent as a Python int; negative ones raise."""
    e = int(e)
    if e < 0:
        raise ValueError(f"exponent must be >= 0, got {e}")
    return e


def _tonelli_shanks(v: int, p: int) -> int:
    """Square root of a known QR mod odd prime p."""
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    c = pow(z, q, p)
    t = pow(v, q, p)
    r = pow(v, (q + 1) // 2, p)
    m = s
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        r = r * b % p
        c = b * b % p
        t = t * c % p
        m = i
    return r


def _broadcast_limbs(a: torch.Tensor, b: torch.Tensor):
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    full = (NLIMBS,) + tuple(shape)

    def expand(x):
        lead = (1,) * (len(shape) - (x.dim() - 1))
        return x.reshape(x.shape[:1] + lead + x.shape[1:]).expand(full)

    return expand(a), expand(b)


class Scalar(FieldArray):
    """Element(s) of the Curve25519 scalar field (SPDZ value field)."""

    spec = SCALAR_FIELD


class BaseFelt(FieldArray):
    """Element(s) of GF(2^255 - 19), the Ed25519 coordinate field."""

    spec = BASE_FIELD
