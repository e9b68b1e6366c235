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
P25519 = (1 << 255) - 19


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
        if self.pm_c and modulus != P25519:
            raise ValueError("the pseudo-Mersenne arithmetic here is written "
                             "for 2^255 - 19 only")
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
    if spec.pm_c:
        return add25519(x, y)
    s, _ = _carry(_i64(x) + _i64(y))
    return _cond_sub(spec, s).to(LIMB_DTYPE)


def sub(spec: FieldSpec, x, y):
    """(x - y) mod m."""
    if spec.pm_c:
        return sub25519(x, y)
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


# ---------------------------------------------------------------------------
# p = 2^255 - 19 (the Ed25519 base field): few-op plain arithmetic
#
# The curve layer runs thousands of base-field ops per scalar multiplication,
# so these avoid the 16-step carry loops above.  Between ops a value is kept
# LAZY: int64 limbs below 2^17 - 80 whose value is only congruent mod p;
# carries move in whole-tensor passes.  `canon25519` brings a lazy value to
# canonical limbs, resolving the last exact carry chain by a look-ahead (the
# carry into limb i comes from the nearest limb below it that is not
# 0xFFFF).  Canonical outputs are bit-identical to every other route.
# This is the one field with `FieldSpec.pm_c` (2^256 = 38 mod p).
# ---------------------------------------------------------------------------

# 8p with every limb in [2^18 - 152, 2^18): x + 8p - y has no negative limb
# for lazy y.
_EIGHTP = [(1 << 18) - 152] + [(1 << 18) - 4] * (NLIMBS - 1)
_const_cache: dict = {}
_MUL_CHUNK = 1 << 20  # elements per plain product call


def _limb_const(values, like: torch.Tensor) -> torch.Tensor:
    key = (tuple(values), str(like.device))
    if key not in _const_cache:
        _const_cache[key] = torch.tensor(values, dtype=torch.int64,
                                         device=like.device)
    return _const_cache[key].reshape((NLIMBS,) + (1,) * (like.dim() - 1))


def _wrap_pass(v: torch.Tensor) -> torch.Tensor:
    """One carry pass over int64 limbs, the carry out of limb 15 folded
    into limb 0 as x 38 (2^256 = 38 mod p).  Congruent mod p."""
    c = v >> LIMB_BITS
    out = v & LIMB_MASK
    out[1:] += c[:-1]
    out[0] += 38 * c[-1]
    return out


def _normalize(v: torch.Tensor):
    """Exact carry propagation of int64 limbs in [0, 2^17 - 1) ->
    (16 limbs < 2^16, carry out of limb 15 in {0, 1})."""
    g = v >> LIMB_BITS  # each limb generates at most one carry
    r = v & LIMB_MASK
    idx = _limb_const(list(range(NLIMBS)), r)
    # a limb that is not 0xFFFF passes on exactly its own carry; 0xFFFF
    # limbs pass on the carry they receive
    last = torch.cummax(torch.where(r != LIMB_MASK, idx, -1), dim=0).values
    c = torch.gather(g, 0, last.clamp(min=0)) * (last >= 0)
    r[1:] += c[:-1]
    return r & LIMB_MASK, c[-1]


def canon25519(v: torch.Tensor) -> torch.Tensor:
    """Lazy int64 limbs (< 2^17 - 80) -> canonical int32 limbs mod p."""
    v = v.clone()
    top = v[-1] >> 15
    v[-1] &= 0x7FFF
    v[0] += 19 * top  # 2^255 = 19 (mod p); the value is now < 2p
    # normalize v and v + 19 together: v >= p  <=>  v + 19 >= 2^255
    w = torch.stack([v, v], dim=1)
    w[0, 1] += 19
    w, _ = _normalize(w)
    r, u = w[:, 0], w[:, 1]
    ge = (u[-1] >> 15) == 1
    u[-1] &= 0x7FFF
    return torch.where(ge, u, r).to(LIMB_DTYPE)


def lazy_mul25519(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Product of lazy (or canonical) limb tensors, lazy int64 out."""
    x, y = torch.broadcast_tensors(_i64(x), _i64(y))
    shape = x.shape
    xf, yf = x.reshape(NLIMBS, -1), y.reshape(NLIMBS, -1)
    n = xf.shape[1]
    if n > _MUL_CHUNK:  # bound the (16, 33, n) int64 intermediate
        return torch.cat([lazy_mul25519(xf[:, i:i + _MUL_CHUNK], yf[:, i:i + _MUL_CHUNK])
                          for i in range(0, n, _MUL_CHUNK)], 1).reshape(shape)
    outer = xf[:, None, :] * yf[None, :, :]  # (16, 16, n), each < 2^34
    # skew row i right by i (pad rows to 33, read back as rows of 32) and
    # sum: column k = sum_{i+j=k} x_i y_j < 2^38
    skew = torch.cat([outer, outer.new_zeros(NLIMBS, NLIMBS + 1, n)], 1)
    cols = skew.reshape(NLIMBS * 33, n)[:NLIMBS * 32].reshape(NLIMBS, 32, n).sum(0)
    v = cols[:NLIMBS] + 38 * cols[NLIMBS:]  # < 2^43.3
    # three passes: limbs < 2^32.6, then < 2^17.4, then < 2^16 + 39
    return _wrap_pass(_wrap_pass(_wrap_pass(v))).reshape(shape)


def lazy_add25519(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _wrap_pass(_i64(x) + _i64(y))  # limbs < 2^16 + 114


def lazy_sub25519(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = _i64(x)
    return _wrap_pass(x + _limb_const(_EIGHTP, x) - _i64(y))  # < 2^16 + 190


def lazy_addsub25519(x: torch.Tensor, y: torch.Tensor,
                     sub: torch.Tensor) -> torch.Tensor:
    """x + y where `sub` is False, x - y where True (`sub` broadcasts over
    the limb axis): several sums and differences in one pass."""
    x, y = _i64(x), _i64(y)
    y = torch.where(sub, _limb_const(_EIGHTP, y) - y, y)
    return _wrap_pass(x + y)


def mul25519(x, y):
    """Canonical product mod 2^255 - 19 of (16, *batch) limb tensors."""
    return canon25519(lazy_mul25519(x, y))


def add25519(x, y):
    return canon25519(lazy_add25519(x, y))


def sub25519(x, y):
    return canon25519(lazy_sub25519(x, y))


def mont_mul_plain(spec: FieldSpec, x, y):
    """Plain torch field product in internal form (any device)."""
    if spec.pm_c:
        return mul25519(x, y)
    return _redc(spec, _conv(_i64(x), _i64(y)))


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
    if spec.pm_c:  # fold columns >= 16 down x 38: limbs < 39 * 2^16
        pad = cols.new_zeros((2 * NLIMBS - cols.shape[0],) + cols.shape[1:])
        v = torch.cat([cols, pad])
        return canon25519(_wrap_pass(v[:NLIMBS] + 38 * v[NLIMBS:]))
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


def limbs_below(arr: np.ndarray, modulus: int) -> bool:
    """Every column of a (16, ...) integer array is 16-bit limbs of a value
    below `modulus`: the range check of each limb, then a lexicographic
    compare with the modulus' limbs, most significant first, over the whole
    batch at once."""
    arr = np.asarray(arr)
    if arr.size == 0:
        return True
    if (not np.issubdtype(arr.dtype, np.integer) or int(arr.min()) < 0
            or int(arr.max()) > LIMB_MASK):
        return False
    mod = int_to_limbs(modulus)
    below = np.zeros(arr.shape[1:], dtype=bool)
    equal = np.ones(arr.shape[1:], dtype=bool)
    for i in reversed(range(NLIMBS)):
        below |= equal & (arr[i] < mod[i])
        equal &= arr[i] == mod[i]
    return bool(below.all())


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
