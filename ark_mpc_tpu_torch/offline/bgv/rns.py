"""RNS polynomial arithmetic for the prototype BGV ciphertext ring.

Counterpart of `ark_mpc_tpu/offline/bgv/rns.py`: a polynomial in
R_q = Z_q[X]/(X^N + 1) is an int64 tensor of shape (L, N), one row of
residues below q_i per RNS prime, on the parameter set's device; a batch is
(B, L, N) and every operation broadcasts over leading axes.  The reference
loops over the primes; here each operation covers all L rows at once (the
primes as an (L, 1) column, the NTT through the stacked plan
`BgvParams.q_ntt`), with the same values.

The deterministic functions equal the reference's bit for bit, including
`from_signed_coeffs`' uint32 wrap of values below -q_i (which no sampler
here feeds it: `sample_uniform_bounded` lifts its words exactly).  The
samplers take an explicit `torch.Generator` on the device where the
reference takes a `jax.random` key: the distributions are the reference's,
the streams are not.  torch's generators are not cryptographic streams;
seed them from `os.urandom` outside tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import modular32 as m32
from ...ops.ntt import poly_mul_mod
from .params import BgvParams

I64 = torch.int64
MASK32 = (1 << 32) - 1


def zero(params: BgvParams, batch: tuple = ()) -> torch.Tensor:
    return torch.zeros(tuple(batch) + (len(params.q_primes), params.n), dtype=I64,
                       device=params.device)


def rns_add(params: BgvParams, a, b) -> torch.Tensor:
    s = a + b
    return torch.where(s >= params._q, s - params._q, s)


def rns_sub(params: BgvParams, a, b) -> torch.Tensor:
    return torch.where(a >= b, a - b, a + params._q - b)


def rns_neg(params: BgvParams, a) -> torch.Tensor:
    return rns_sub(params, zero(params, tuple(a.shape[:-2])), a)


def rns_mul(params: BgvParams, a, b) -> torch.Tensor:
    """Negacyclic polynomial product per RNS prime (NTT pointwise)."""
    return poly_mul_mod(params.q_ntt, a, b)


def rns_scalar_mul(params: BgvParams, a, scalar: int) -> torch.Tensor:
    """Multiply by a public integer scalar (e.g. the plaintext modulus t)."""
    sm = torch.tensor([(scalar % s.q) * s.r % s.q for s in params.q_specs], dtype=I64,
                      device=params.device).reshape(-1, 1)  # Montgomery form of s
    return m32.mont_mul32(params.q_ntt.mod2, a, sm)


# ---------------------------------------------------------------------------
# lifting / sampling
# ---------------------------------------------------------------------------


def _on_device(params: BgvParams, x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x.astype(np.int64))
    return torch.as_tensor(x, device=params.device).to(I64)


def from_signed_coeffs(params: BgvParams, coeffs) -> torch.Tensor:
    """Small signed integer coefficients (..., N) -> RNS residues (..., L, N).

    As the reference: a negative c becomes c + q_i, taken mod 2^32 as its
    uint32 cast does (so a c below -q_i wraps through 2^32), then mod q_i."""
    c = _on_device(params, coeffs).unsqueeze(-2)
    r = torch.where(c < 0, c + params._q, c) & MASK32
    return torch.remainder(r, params._q)


def from_plaintext(params: BgvParams, pt) -> torch.Tensor:
    """Plaintext coefficients (..., N) (< t) -> RNS residues (..., L, N).

    Centered lift: values > t/2 map to value - t (negative), which keeps the
    embedded message small, as the noise bounds need."""
    pt = _on_device(params, pt).unsqueeze(-2)
    q = params._q
    pos = torch.remainder(pt, q)
    neg = torch.remainder(pt + q - params._t_mod, q)
    return torch.where(pt > params.t // 2, neg, pos)


def _randint(params, gen, low: int, high: int, shape) -> torch.Tensor:
    return torch.randint(low, high, tuple(shape), generator=gen, device=params.device,
                         dtype=I64)


def sample_uniform(params: BgvParams, gen: torch.Generator, batch: tuple = ()) -> torch.Tensor:
    """Uniform element of R_q (per-prime uniform residues)."""
    return torch.stack([_randint(params, gen, 0, q, tuple(batch) + (params.n,))
                        for q in params.q_primes], dim=-2)


def sample_ternary(params: BgvParams, gen: torch.Generator, batch: tuple = ()) -> torch.Tensor:
    """Ternary {-1, 0, 1} secret/encryption randomness, lifted to RNS."""
    return from_signed_coeffs(params, ternary_coeffs(params, gen, batch))


def ternary_coeffs(params: BgvParams, gen: torch.Generator, batch: tuple = ()) -> torch.Tensor:
    return _randint(params, gen, -1, 2, tuple(batch) + (params.n,))


def cbd_coeffs(params: BgvParams, gen: torch.Generator, batch: tuple = ()) -> torch.Tensor:
    """Centered-binomial coefficients (sigma ~ sqrt(k/2)), (..., N) int64."""
    k = params.cbd_k
    a = _randint(params, gen, 0, 2, (2 * k,) + tuple(batch) + (params.n,))
    return a[:k].sum(0) - a[k:].sum(0)


def sample_cbd(params: BgvParams, gen: torch.Generator, batch: tuple = (),
               scale: int = 1) -> torch.Tensor:
    """Centered-binomial noise, optionally scaled, lifted to RNS."""
    return from_signed_coeffs(params, cbd_coeffs(params, gen, batch) * scale)


def sample_uniform_bounded(params: BgvParams, gen: torch.Generator, bound_bits: int,
                           batch: tuple = ()) -> torch.Tensor:
    """Uniform signed coefficients in [-2^bound_bits, 2^bound_bits] for
    drowning noise, composed from 30-bit words.  Each word is lifted
    exactly (mod q_i): a word reaches -2^30, below the primes, where the
    reference's lift through `from_signed_coeffs` wraps through 2^32 and
    the noise is no longer small (some of its drownings at N = 1024 then
    fail to decrypt: `tests/_drowning_rate.py`)."""
    acc = None
    for w in range((bound_bits + 29) // 30):
        bits = min(30, bound_bits - 30 * w)
        v = _randint(params, gen, -(1 << bits), (1 << bits) + 1,
                     tuple(batch) + (params.n,))
        r = torch.remainder(v.unsqueeze(-2), params._q)
        if w:
            r = rns_scalar_mul(params, r, 1 << (30 * w))
        acc = r if acc is None else rns_add(params, acc, r)
    return acc


def lift_ints(params: BgvParams, arr) -> torch.Tensor:
    """(..., N) integers of any magnitude (a numpy object or int64 array)
    -> (..., L, N) residues (the proofs' responses and masks)."""
    arr = np.asarray(arr)
    if arr.dtype != object:
        return torch.remainder(_on_device(params, arr).unsqueeze(-2), params._q)
    rows = [np.asarray(np.mod(arr, q), dtype=np.int64) for q in params.q_primes]
    return torch.from_numpy(np.stack(rows, axis=-2)).to(params.device)


# ---------------------------------------------------------------------------
# host-side CRT (tests / decode)
# ---------------------------------------------------------------------------


def to_ints(params: BgvParams, poly) -> list[int]:
    """CRT-recompose (L, N) residues to centered ints in (-q/2, q/2]."""
    arr = poly.cpu().numpy() if isinstance(poly, torch.Tensor) else np.asarray(poly)
    if arr.ndim != 2:
        raise ValueError(f"expected one (L, N) polynomial, got shape {arr.shape}")
    q = params.q
    out = []
    for j in range(params.n):
        v = 0
        for i, p in enumerate(params.q_primes):
            v += params.q_hat[i] * (params.q_hat_inv[i] * int(arr[i, j]) % p)
        v %= q
        if v > q // 2:
            v -= q
        out.append(v)
    return out
