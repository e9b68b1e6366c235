"""Modular arithmetic for word-size (< 2^31) RNS primes on torch tensors.

Counterpart of `ark_mpc_tpu/ops/modular32.py`.  The BGV offline phase works
in RNS: the ciphertext modulus q is a product of ~30-bit primes q_i = 1
(mod m), and a polynomial coefficient is one residue per prime.  Residues are
held in ``int64`` tensors with values below 2^32 (canonical ones below q_i):
CPU torch has no ``uint32`` arithmetic, and a product of two residues below
2^31 fits an int64 exactly, so no 16-bit halves are needed.

`mont_mul32` keeps the reference's semantics bit for bit, the 2^-32 factor
included, for any inputs below 2^32 (its arithmetic wraps at 2^32 where the
reference's uint32 arithmetic does).  `add32`/`sub32` take canonical inputs.

`residue_matmul` is the matrix product behind every per-prime linear map of
the rings (coefficient <-> evaluation transforms, DFTs, plaintext lifts).
The reference computes those in XLA, outside any Pallas kernel; here they
are float64 matrix products (cuBLAS DGEMM on the card, there is no integer
GEMM on CUDA), made exact by splitting each matrix entry into 11-bit thirds:
a product of a residue below 2^31 and a third is below 2^42, and a sum of
k < 2^11 such products stays below 2^53, where float64 adds integers exactly
in any order.
"""

from __future__ import annotations

import torch

MASK32 = (1 << 32) - 1
SPLIT_BITS = 11
MAX_INNER = 1 << SPLIT_BITS  # inner dimension below which the product is exact


class PrimeSpec:
    """Precomputed constants for one RNS prime q < 2^31 (hashable)."""

    def __init__(self, q: int):
        self.q = q
        self.r = (1 << 32) % q            # Montgomery R mod q
        self.r2 = self.r * self.r % q
        self.qinv_neg = (-pow(q, -1, 1 << 32)) % (1 << 32)  # -q^-1 mod 2^32

    def __hash__(self):
        return hash(self.q)

    def __eq__(self, other):
        return isinstance(other, PrimeSpec) and other.q == self.q


def _mul_lo32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a < 2^32 and a constant c < 2^32, without
    leaving int64: c is split into 16-bit halves."""
    lo = a * (c & 0xFFFF)                      # < 2^48
    hi = (a * (c >> 16)) & 0xFFFF              # < 2^16
    return (lo + (hi << 16)) & MASK32


def mont_mul32(spec: PrimeSpec, a, b) -> torch.Tensor:
    """Montgomery product a*b*2^-32 mod q of int64 tensors with values below
    2^32, as the reference computes it in uint32 (outputs < q whenever
    a*b < q*2^32, e.g. for inputs below q)."""
    dev = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)), None)
    a, b = (torch.as_tensor(x, dtype=torch.int64, device=dev) for x in (a, b))
    a, b = torch.broadcast_tensors(a, b)
    # a*b as (hi, lo) 32-bit words: a = a1 2^16 + a0, each partial < 2^48
    a0, a1 = a & 0xFFFF, a >> 16
    p0, p1 = a0 * b, a1 * b
    low = p0 + ((p1 & 0xFFFF) << 16)           # < 2^49
    lo = low & MASK32
    hi = (low >> 32) + (p1 >> 16)
    m = _mul_lo32(lo, spec.qinv_neg)
    mq = m * spec.q                            # < 2^63
    # lo + (mq mod 2^32) == 0 (mod 2^32): a carry unless lo was zero
    t = (hi + (mq >> 32) + (lo != 0).to(torch.int64)) & MASK32
    return torch.where(t >= spec.q, t - spec.q, t)


def to_uint32(x: torch.Tensor):
    """Residues below 2^31 (on any device) -> the reference's uint32 numpy
    array (its wire form and hash input), with one device-to-host copy."""
    return x.to(torch.int32).cpu().numpy().view("uint32")


def to_mont32(spec: PrimeSpec, x) -> torch.Tensor:
    return mont_mul32(spec, x, spec.r2)


def from_mont32(spec: PrimeSpec, x) -> torch.Tensor:
    return mont_mul32(spec, x, 1)


def add32(spec: PrimeSpec, a, b) -> torch.Tensor:
    s = a + b
    return torch.where(s >= spec.q, s - spec.q, s)


def sub32(spec: PrimeSpec, a, b) -> torch.Tensor:
    return torch.where(a >= b, a - b, a + spec.q - b)


# ---------------------------------------------------------------------------
# exact per-prime matrix products (float64, 11-bit thirds of the matrix)
# ---------------------------------------------------------------------------


def split_matrices(mats: torch.Tensor) -> torch.Tensor:
    """Per-prime matrices (L, out, in) of residues < 2^31 -> the float64
    operand of `residue_matmul`: (L, in, 3 out), the transposed 11-bit thirds
    side by side."""
    if mats.shape[-1] >= MAX_INNER:
        raise ValueError(f"inner dimension {mats.shape[-1]} >= {MAX_INNER}: "
                         "float64 sums would not be exact")
    mats = mats.to(torch.int64)
    mask = (1 << SPLIT_BITS) - 1
    thirds = [(mats >> (SPLIT_BITS * j)) & mask for j in range(3)]
    return torch.cat(thirds, dim=1).transpose(1, 2).to(torch.float64).contiguous()


def residue_matmul(x: torch.Tensor, mats3: torch.Tensor, q_col: torch.Tensor) -> torch.Tensor:
    """x (L, ..., in) residues < 2^31 -> (L, ..., out): sum_k M_i[o, k]
    x_i[..., k] mod q_i for each prime i, exactly.  `mats3` comes from
    `split_matrices`; `q_col` is the primes as an (L, 1, 1) int64 tensor."""
    out = mats3.shape[-1] // 3
    xf = x.to(torch.float64, memory_format=torch.contiguous_format)
    s = torch.bmm(xf.reshape(x.shape[0], -1, x.shape[-1]), mats3)
    del xf
    s = s.to(torch.int64)                                      # (L, N, 3 out)
    s0, s1, s2 = s[..., :out], s[..., out:2 * out], s[..., 2 * out:]
    acc = s0 + torch.remainder(s1, q_col) * (1 << SPLIT_BITS)
    acc += torch.remainder(s2, q_col) * (1 << (2 * SPLIT_BITS))  # < 2^54
    return torch.remainder(acc, q_col).reshape(x.shape[:-1] + (out,))


# ---------------------------------------------------------------------------
# host helpers (framework-free, as in the reference)
# ---------------------------------------------------------------------------


def find_primes(n_primes: int, order: int, bits: int = 30) -> list[int]:
    """Primes q = 1 (mod order), q < 2^31, descending from 2^bits."""
    def is_prime(v: int) -> bool:
        if v < 2:
            return False
        for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
            if v % p == 0:
                return v == p
        d, s = v - 1, 0
        while d % 2 == 0:
            d //= 2
            s += 1
        for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
            x = pow(a, d, v)
            if x in (1, v - 1):
                continue
            for _ in range(s - 1):
                x = x * x % v
                if x == v - 1:
                    break
            else:
                return False
        return True

    out = []
    k = (1 << bits) // order
    while len(out) < n_primes and k > 0:
        q = k * order + 1
        if q < (1 << 31) and is_prime(q):
            out.append(q)
        k -= 1
    if len(out) < n_primes:
        raise ValueError("not enough NTT primes")
    return out


def prime_factors(n: int) -> set:
    out, d = set(), 2
    while d * d <= n:
        if n % d == 0:
            out.add(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.add(n)
    return out


def primitive_root_of_unity(q: int, order: int) -> int:
    """A primitive `order`-th root of unity mod prime q (q = 1 mod order)."""
    if (q - 1) % order:
        raise ValueError(f"{order} does not divide q - 1")
    pfs = prime_factors(order)
    for g in range(2, 1000):
        w = pow(g, (q - 1) // order, q)
        if all(pow(w, order // p, q) != 1 for p in pfs):
            return w
    raise ValueError("no root found")
