"""Limb-decomposed prime-field arithmetic on torch tensors.

Counterpart of `ark_mpc_tpu/algebra/limbs.py`, with the same layout at every
public function: a batch of field elements is one tensor of shape
``(16,) + batch_shape`` holding 16-bit little-endian limbs, in Montgomery
form with R = 2^256 (canonical for pseudo-Mersenne fields).  Every value
therefore compares bit for bit with the JAX package.

Limbs are stored as ``int32`` holding values < 2^16 (64 bytes per element,
as in the reference): CPU torch cannot add, shift or compare ``uint32``.
The plain arithmetic below widens to ``int64``, where a column of up to 32
unsplit 16x16-bit products plus carries stays far below 2^63, so no
lo/hi splitting is needed.

On a CUDA tensor, `mont_mul` for a Montgomery field runs the hand-written
kernel in `ops/fp_kernels.py`; everything else here is plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

# 16 limbs x 16 bits = 256-bit values (moduli here are <= 255 bits).
NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
LIMB_DTYPE = torch.int32


def int_to_limbs(value: int, n_limbs: int = NLIMBS) -> np.ndarray:
    """Decompose a python int into little-endian 16-bit limbs (numpy)."""
    if value >> (LIMB_BITS * n_limbs):
        raise ValueError("value does not fit in limbs")
    return np.array([(value >> (LIMB_BITS * i)) & LIMB_MASK
                     for i in range(n_limbs)], dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    """Recompose python int from little-endian 16-bit limb array (limb axis 0)."""
    limbs = np.asarray(limbs)
    acc = 0
    for i in reversed(range(limbs.shape[0])):
        acc = (acc << LIMB_BITS) | int(limbs[i])
    return acc


class FieldSpec:
    """Precomputed constants for one prime field (hashable/eq by modulus)."""

    def __init__(self, modulus: int, name: str):
        # All bounds in this module only need 2m < 2^256, i.e. m < 2^255.
        if modulus.bit_length() > NLIMBS * LIMB_BITS - 1:
            raise ValueError("modulus too large for 16x16-bit limbs")
        self.modulus = modulus
        self.name = name
        # Pseudo-Mersenne fast path: when 2^256 = c (mod m) for tiny c
        # (Ed25519's p = 2^255 - 19 gives c = 38), products reduce by folding
        # high limbs x c, and values are stored CANONICALLY.
        c = (1 << (NLIMBS * LIMB_BITS)) % modulus
        self.pm_c = c if modulus.bit_length() >= 250 and c < (1 << 10) else None
        self.r = (1 << (NLIMBS * LIMB_BITS)) % modulus  # R mod m
        self.r2 = (self.r * self.r) % modulus
        # n0 = -m^{-1} mod 2^16 (16-bit REDC); the CUDA kernels run 32-bit
        # CIOS words and need n0_32 = -m^{-1} mod 2^32.
        self.n0 = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.n0_32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self.mod_limbs = int_to_limbs(modulus)
        self.r2_limbs = int_to_limbs(self.r2)
        # internal-form 1: Montgomery R for generic fields, literal 1 for
        # pseudo-Mersenne (canonical) fields
        self.one_mont = int_to_limbs(1 if self.pm_c else self.r)
        # Exponent bits of m-2 (for Fermat inversion), LSB first.
        e = modulus - 2
        self.inv_exp_bits = tuple((e >> i) & 1 for i in range(modulus.bit_length()))
        self._mod_cols = {}

    def mod_column(self, device, ndim: int) -> torch.Tensor:
        """The modulus limbs as an int64 (16, 1, ...) column on `device`."""
        key = (str(device), ndim)
        if key not in self._mod_cols:
            self._mod_cols[key] = torch.tensor(
                self.mod_limbs.astype(np.int64), device=device).reshape(
                    (NLIMBS,) + (1,) * ndim)
        return self._mod_cols[key]

    def __hash__(self):
        return hash(self.modulus)

    def __eq__(self, other):
        return isinstance(other, FieldSpec) and other.modulus == self.modulus

    def __repr__(self):
        return f"FieldSpec({self.name})"


# ---------------------------------------------------------------------------
# carry / borrow chains (int64 rows)
# ---------------------------------------------------------------------------


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def _carry(t: torch.Tensor):
    """Propagate carries over non-negative int64 columns -> (limbs, carry)."""
    out = torch.empty_like(t)
    carry = torch.zeros_like(t[0])
    for i in range(t.shape[0]):
        v = t[i] + carry
        out[i] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return out, carry


def _sub_mod_limbs(spec: FieldSpec, x: torch.Tensor):
    """x - m limb-wise over (16, ...) int64 -> (result limbs, borrow in {0,1})."""
    out = torch.empty_like(x)
    borrow = torch.zeros_like(x[0])
    for i in range(NLIMBS):
        v = x[i] - int(spec.mod_limbs[i]) - borrow
        out[i] = v & LIMB_MASK
        borrow = -(v >> LIMB_BITS)  # arithmetic shift: -1 when v < 0
    return out, borrow


def _cond_sub(spec: FieldSpec, s: torch.Tensor) -> torch.Tensor:
    """Subtract m once where s >= m (s < 2m, 16 normalized int64 limbs)."""
    d, borrow = _sub_mod_limbs(spec, s)
    return torch.where(borrow == 0, d, s)


# ---------------------------------------------------------------------------
# add / sub / compare (canonical OR montgomery form: both live in [0, m))
# ---------------------------------------------------------------------------


def add(spec: FieldSpec, x, y):
    """(x + y) mod m, inputs/outputs in [0, m)."""
    s, _ = _carry(_i64(x) + _i64(y))
    return _cond_sub(spec, s).to(LIMB_DTYPE)


def sub(spec: FieldSpec, x, y):
    """(x - y) mod m."""
    out = torch.empty_like(_i64(x))
    borrow = torch.zeros_like(out[0])
    xi, yi = _i64(x), _i64(y)
    for i in range(NLIMBS):
        v = xi[i] - yi[i] - borrow
        out[i] = v & LIMB_MASK
        borrow = -(v >> LIMB_BITS)
    # add m back where the subtraction borrowed
    s, _ = _carry(out + spec.mod_column(out.device, out.dim() - 1))
    return torch.where(borrow == 1, s, out).to(LIMB_DTYPE)


def neg(spec: FieldSpec, x):
    """(-x) mod m; maps 0 -> 0."""
    zero = torch.zeros_like(x)
    return sub(spec, zero, x)


def tree_sum(spec: FieldSpec, x, axis: int = 1):
    """Modular sum along a batch axis of a limb tensor (log-depth tree of
    adds, the same pairing as the reference's `Scalar.sum`)."""
    n = x.shape[axis]
    while n > 1:
        half = n // 2
        s = add(spec, x.narrow(axis, 0, half), x.narrow(axis, half, half))
        if n % 2:
            s = torch.cat([s, x.narrow(axis, 2 * half, n - 2 * half)], dim=axis)
        x = s
        n = x.shape[axis]
    return x.squeeze(axis)


def is_zero(spec: FieldSpec, x):
    return (x == 0).all(dim=0)


def eq(x, y):
    return (x == y).all(dim=0)


# ---------------------------------------------------------------------------
# Montgomery multiply (plain form)
# ---------------------------------------------------------------------------


def _conv(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Full 256x256-bit product as 33 un-carried int64 columns.

    Column k sums the unsplit 32-bit products x_i*y_j with i+j == k (< 2^36)."""
    cols = x.new_zeros((2 * NLIMBS + 1,) + x.shape[1:])
    for i in range(NLIMBS):
        cols[i:i + NLIMBS] += x[i] * y
    return cols


def _redc(spec: FieldSpec, cols: torch.Tensor, iters: int = NLIMBS):
    """Montgomery reduction of int64 16-bit columns -> 16 canonical limbs.

    Computes T * 2^(-16*iters) mod m for T given as (possibly un-carried)
    columns.  Precondition: T < m * 2^(16*iters), so the result is < 2m."""
    total = iters + NLIMBS + 2
    t = cols.new_zeros((max(total, cols.shape[0]),) + cols.shape[1:])
    t[:cols.shape[0]] = cols
    n = spec.mod_column(t.device, t.dim() - 1)
    for i in range(iters):
        m_i = ((t[i] & LIMB_MASK) * spec.n0) & LIMB_MASK
        t[i:i + NLIMBS] += m_i * n
        # column i is final (divisible by 2^16); fold its carry upward
        t[i + 1] += t[i] >> LIMB_BITS
    res, _ = _carry(t[iters:iters + NLIMBS])
    return _cond_sub(spec, res).to(LIMB_DTYPE)


def _pm_fold(spec: FieldSpec, cols: torch.Tensor):
    """Pseudo-Mersenne reduction of int64 16-bit columns (at most 33): fold
    columns >= 16 down by x c (2^256 = c mod m), carry-propagate, fold the
    carry-outs, conditional subtracts.  Exact."""
    c = spec.pm_c
    low = cols[:NLIMBS].clone()
    high = cols[NLIMBS:2 * NLIMBS]
    low[:high.shape[0]] += high * c
    extra = cols[2 * NLIMBS] * c if cols.shape[0] > 2 * NLIMBS else 0
    res, carry = _carry(low)
    res[0] += (carry + extra) * c
    res, carry2 = _carry(res)
    # a second-order carry-out (value in [2^256, 2^256 + 2^48)) folds once
    # more; the final chain then clears completely
    res[0] += carry2 * c
    res, _ = _carry(res)
    for _ in range(2):  # value < 2^256 < 2m + c: at most two subtractions
        res = _cond_sub(spec, res)
    return res.to(LIMB_DTYPE)


def mont_mul_plain(spec: FieldSpec, x, y):
    """Plain torch field product in internal form (any device)."""
    cols = _conv(_i64(x), _i64(y))
    if spec.pm_c:
        return _pm_fold(spec, cols)
    return _redc(spec, cols)


def mont_mul(spec: FieldSpec, x, y):
    """Field product in internal form: Montgomery (x*y*R^{-1}) for generic
    moduli, plain canonical product for pseudo-Mersenne moduli.

    A Montgomery product of CUDA tensors runs the `mont_mul` kernel; the
    pseudo-Mersenne product stays plain torch (the reference computes it in
    XLA, not in a Pallas kernel)."""
    if spec.pm_c:
        return mont_mul_plain(spec, x, y)
    from ..ops import fp_kernels

    return fp_kernels.mont_mul(spec, x, y)


def const_like(np_limbs, like: torch.Tensor) -> torch.Tensor:
    """A (16,) constant broadcast to `like`'s shape (a view)."""
    c = torch.tensor(np_limbs.astype(np.int32), device=like.device)
    return c.reshape((NLIMBS,) + (1,) * (like.dim() - 1)).expand(like.shape)


def to_mont(spec: FieldSpec, x):
    """Canonical -> internal form (identity for pseudo-Mersenne fields)."""
    if spec.pm_c:
        return x
    return mont_mul(spec, x, const_like(spec.r2_limbs, x))


def from_mont(spec: FieldSpec, x):
    """Internal -> canonical form (identity for pseudo-Mersenne fields):
    the Montgomery product with a canonical 1 is exactly x * R^-1."""
    if spec.pm_c:
        return x
    return mont_mul(spec, x, const_like(int_to_limbs(1), x))


def reduce_wide(spec: FieldSpec, wide):
    """Reduce a wide value given as 16-bit columns ``(k, batch)`` mod m.

    Requires value < m * 2^256 (true for k <= 28).  Returns the CANONICAL
    value X mod m (convert with `to_mont` if needed)."""
    cols = _i64(wide)
    if spec.pm_c:
        return _pm_fold(spec, cols)
    y = _redc(spec, cols)  # X * R^{-1}
    return mont_mul(spec, y, const_like(spec.r2_limbs, y))  # X mod m


def mont_pow_fixed(spec: FieldSpec, x, exp_bits: tuple):
    """x^e in Montgomery domain, e given as a tuple of bits (LSB first)."""
    acc = const_like(spec.one_mont, x).contiguous()
    base = x
    for i, bit in enumerate(exp_bits):
        if bit:
            acc = mont_mul(spec, acc, base)
        if i != len(exp_bits) - 1:
            base = mont_mul(spec, base, base)
    return acc


def inverse(spec: FieldSpec, x):
    """x^{-1} (Montgomery domain in/out) by Fermat: x^(m-2); 0 maps to 0."""
    acc = mont_pow_fixed(spec, x, spec.inv_exp_bits)
    return torch.where(is_zero(spec, x), torch.zeros_like(acc), acc)


# ---------------------------------------------------------------------------
# host-side conversions
# ---------------------------------------------------------------------------


def ints_to_limb_array(values) -> np.ndarray:
    """Python ints in [0, 2^256) -> (16, n) uint32 limb array (numpy)."""
    data = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(data, "<u2").reshape(-1, NLIMBS).T.astype(np.uint32)


def limb_array_to_ints(arr) -> list:
    """(16, ...) limb array (numpy) -> python ints (flattened batch)."""
    data = np.asarray(arr).reshape(NLIMBS, -1).T.astype("<u2").tobytes()
    return [int.from_bytes(data[o:o + 32], "little")
            for o in range(0, len(data), 32)]


def pack_ints(spec: FieldSpec, values, mont: bool = True, device=None):
    """Python ints -> limb tensor (16, n). Values taken mod m."""
    arr = ints_to_limb_array([int(v) % spec.modulus for v in values])
    x = torch.from_numpy(arr.astype(np.int32)).to(resolve_device(device))
    return to_mont(spec, x) if mont else x


def unpack_ints(spec: FieldSpec, x, mont: bool = True):
    """Limb tensor (16, ...) -> list of python ints (flattened batch)."""
    if mont:
        x = from_mont(spec, x)
    return limb_array_to_ints(x.cpu().numpy())
