"""BGV with the Curve25519 group order l as plaintext modulus.

Counterpart of `ark_mpc_tpu/offline/bgv/bgv_l.py`: the instantiation LowGear
needs, whose plaintext slots are elements of the MPC share field F_l, so
homomorphic slot products give the cross terms of SPDZ triples.  Works on
both ring backends (`PowerfulRing`, the production eval-form ring, and the
`CyclotomicRing` prototype).

Keys and noise are drawn from an explicit `torch.Generator` on the ring's
device, where the reference takes a `jax.random` key.  The distributions are
the reference's (ternary secret, centred binomial noise with k = cbd_k,
uniform residues, wide uniform drowning noise from 24-bit words); the streams
are not, so values cross between the packages only through exported keys and
`encrypt_with_randomness_l`.  torch's generators are not cryptographic
streams: seed them from `os.urandom` (or a CSPRNG) outside tests.

Noise budget: fresh phase ~ t E_fresh with E_fresh ~ cbd_k phi; after
ct x pt: * (t/2) phi; drowning multiplies by 2^sec.  `PowerfulRing` sizes
its RNS basis for drowning at its `drown_bits` (`powerful.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ...algebra import limbs as lb
from ...algebra.fields import SCALAR_FIELD
from ...algebra.scalar import Scalar
from .cyclotomic import I64, CyclotomicRing
from .powerful import PowerfulRing


@dataclass
class CiphertextL:
    c0: torch.Tensor  # (..., L, phi)
    c1: torch.Tensor


@dataclass
class KeypairL:
    ring: object
    sk: torch.Tensor
    pk_a: torch.Tensor
    pk_b: torch.Tensor


def default_ring(m: int = 132, n_q_primes: int = 21, device=None) -> CyclotomicRing:
    return CyclotomicRing(m, n_q_primes=n_q_primes, device=device)


def production_ring(n_q_primes: int | None = None, device=None) -> PowerfulRing:
    """The RLWE-secure production ring: m = 118965 (phi = 48960, 24480
    GF(l^2) slots), powerful basis, drown sec 128, RNS basis auto-sized to
    the noise budget (docs/security_params.md)."""
    return PowerfulRing(118965, n_q_primes=n_q_primes, drown_sec=128, device=device)


def medium_ring(n_q_primes: int | None = None, device=None) -> PowerfulRing:
    """Mid-size ring with the production code paths (powerful basis,
    d = 2): m = 1155 = 3*5*7*11, phi = 480, 240 slots.  For tests."""
    return PowerfulRing(1155, n_q_primes=n_q_primes, drown_sec=128, device=device)


def rlwe_secure_128(ring) -> bool:
    """Conservative classical 128-bit RLWE check (ternary secret,
    HomomorphicEncryption.org tables): log2(q) up to 25 bits per 1024 ring
    dimensions.  The production ring passes; m = 132 and m = 1155 do not."""
    phi = getattr(ring, "phi", 0)
    log2_q = getattr(ring, "log2_q", None)
    if log2_q is None:
        log2_q = sum(int(p).bit_length() for p in ring.q_primes)
    return 1024 * log2_q <= 25 * phi


# -- sampling ---------------------------------------------------------------


def _randint(ring, gen: torch.Generator, low: int, high: int, shape) -> torch.Tensor:
    return torch.randint(low, high, tuple(shape), generator=gen, device=ring.device, dtype=I64)


def _sample_ternary(ring, gen, batch=()):
    v = _randint(ring, gen, -1, 2, batch + (ring.phi,))
    return ring.lift_signed(v), v


def _sample_cbd(ring, gen, batch=()):
    k = ring.cbd_k
    a = _randint(ring, gen, 0, 2, (2 * k,) + batch + (ring.phi,))
    v = a[:k].sum(0) - a[k:].sum(0)
    return ring.lift_signed(v), v


def _sample_uniform(ring, gen, batch=()):
    """Uniform residues in [0, q_i), (..., L, phi)."""
    return torch.stack([_randint(ring, gen, 0, q, batch + (ring.phi,))
                        for q in ring.q_primes], dim=-2)


def _sample_wide_uniform(ring, gen, bound_bits: int, batch=()):
    """Uniform signed noise with |e| < 2^bound_bits, composed from 24-bit
    words through per-prime powers of 2^24 (drowning noise), accumulated as
    coefficient residues and lifted once."""
    acc = None
    for w in range((bound_bits + 23) // 24):
        bits = min(24, bound_bits - 24 * w)
        v = _randint(ring, gen, -(1 << bits), (1 << bits) + 1, batch + (ring.phi,))
        part = torch.remainder(v.unsqueeze(-2), ring._q)
        if w:
            part = part * ring._pow2_col(24 * w) % ring._q
        acc = part if acc is None else ring.add(acc, part)
    return ring.lift_residues(acc)


# -- scheme -----------------------------------------------------------------


def keygen_l(ring, gen: torch.Generator) -> KeypairL:
    s, _ = _sample_ternary(ring, gen)
    e, _ = _sample_cbd(ring, gen)
    a = _sample_uniform(ring, gen)
    b = ring.sub(ring.scalar_mul_t(e), ring.mul(a, s))
    return KeypairL(ring, s, a, b)


def encode_slots_l(ring, slots: Scalar) -> Scalar:
    """F_l slot values (..., ring.slots) -> plaintext coefficients (..., phi)."""
    return ring.encode_slots(slots)


def decode_slots_l(ring, coeffs: Scalar) -> Scalar:
    return ring.decode_slots(coeffs)


def _pt_to_rns(ring, coeffs: Scalar):
    """Plaintext coefficients (..., phi) -> centred residues, canonical form."""
    return ring.lift_plaintext_limbs(lb.from_mont(SCALAR_FIELD, coeffs.limbs))


def encrypt_with_randomness_l(ring, pk_a, pk_b, m_rns, u_rns, e0_rns, e1_rns) -> CiphertextL:
    """Deterministic encryption from explicit lifted randomness (the ZKPoK
    verifier re-runs this equation)."""
    c0 = ring.add(ring.add(ring.mul(pk_b, u_rns), ring.scalar_mul_t(e0_rns)), m_rns)
    c1 = ring.add(ring.mul(pk_a, u_rns), ring.scalar_mul_t(e1_rns))
    return CiphertextL(c0, c1)


def encrypt_l(ring, pk_a, pk_b, pt_coeffs: Scalar, gen: torch.Generator,
              return_randomness: bool = False):
    """Encrypt plaintext coefficients (..., phi); leading batch dims get
    independent randomness."""
    batch = tuple(pt_coeffs.limbs.shape[1:-1])
    u, u_raw = _sample_ternary(ring, gen, batch)
    e0, e0_raw = _sample_cbd(ring, gen, batch)
    e1, e1_raw = _sample_cbd(ring, gen, batch)
    ct = encrypt_with_randomness_l(ring, pk_a, pk_b, _pt_to_rns(ring, pt_coeffs), u, e0, e1)
    if return_randomness:
        return ct, (u_raw, e0_raw, e1_raw)
    return ct


def encrypt_returning_randomness_l(ring, pk_a, pk_b, pt_coeffs: Scalar, gen):
    """`encrypt_l(..., return_randomness=True)`: (ct, (u, e0, e1)) with the
    raw small integer randomness (the ZKPoK prover's witness)."""
    return encrypt_l(ring, pk_a, pk_b, pt_coeffs, gen, True)


def decrypt_l(ring, sk, ct: CiphertextL) -> Scalar:
    """-> plaintext coefficients as a Scalar (..., phi); leading batch dims
    decrypt stacked ciphertexts."""
    return ring.phase_to_pt(ring.add(ct.c0, ring.mul(ct.c1, sk)))


def add_ct_l(ring, x: CiphertextL, y: CiphertextL) -> CiphertextL:
    return CiphertextL(ring.add(x.c0, y.c0), ring.add(x.c1, y.c1))


def add_pt_l(ring, x: CiphertextL, pt_coeffs: Scalar) -> CiphertextL:
    return CiphertextL(ring.add(x.c0, _pt_to_rns(ring, pt_coeffs)), x.c1)


def mul_pt_l(ring, x: CiphertextL, pt_coeffs: Scalar) -> CiphertextL:
    m = _pt_to_rns(ring, pt_coeffs)
    return CiphertextL(ring.mul(x.c0, m), ring.mul(x.c1, m))


def rerandomize_l(ring, pk_a, pk_b, ct: CiphertextL, gen: torch.Generator,
                  drown_bits: int | None = None) -> CiphertextL:
    """Drowning: add enc(0) whose noise statistically hides the
    ciphertext's post-product noise (bound ~ 2^sec E_mult)."""
    if drown_bits is None:
        drown_bits = getattr(ring, "drown_bits", None)
        if drown_bits is not None and not getattr(ring, "budget_ok", True):
            raise ValueError(
                f"RNS basis too small for drowning at this security level: "
                f"log2(q) = {ring.log2_q} < 253 + {drown_bits} + 18; add "
                f"primes (n_q_primes) or lower drown_sec/zk_sec")
    if drown_bits is None:
        # E_mult ~ phi (t/2) cbd_k phi  ->  ~ 253 + 2 log2(phi) + 4
        drown_bits = ring.drown_sec + 253 + 2 * int(math.log2(ring.phi)) + 8
    batch = tuple(ct.c0.shape[:-2])  # leading dims: independent drownings
    u, _ = _sample_ternary(ring, gen, batch)
    e0 = _sample_wide_uniform(ring, gen, drown_bits, batch)
    e1, _ = _sample_cbd(ring, gen, batch)
    z0 = ring.add(ring.mul(pk_b, u), ring.scalar_mul_t(e0))
    z1 = ring.add(ring.mul(pk_a, u), ring.scalar_mul_t(e1))
    return CiphertextL(ring.add(ct.c0, z0), ring.add(ct.c1, z1))


# -- ciphertext x ciphertext (relinearized) ----------------------------------
# The degree-2 tensor product is three pointwise eval-form products; the s^2
# component is relinearized with RNS-digit key switching (one digit per RNS
# prime: D_i(c) = [c qhat_i^-1]_{q_i} lifted back to the full basis, with
# sum_i D_i qhat_i = c (mod q) by CRT).  LowGear never multiplies two
# ciphertexts; multiplying a drowned ciphertext exceeds the budget by design.


@dataclass
class RelinKeyL:
    """Key-switching key for s^2 -> s: row i encrypts qhat_i s^2 under s
    (b_i + a_i s = t e_i + qhat_i s^2)."""

    b: torch.Tensor  # (L, L, phi) eval form
    a: torch.Tensor  # (L, L, phi)


def gen_relin_key_l(ring, sk, gen: torch.Generator) -> RelinKeyL:
    """The relinearization key: one (b_i, a_i) row per RNS prime."""
    n_q = len(ring.q_primes)
    s2 = ring.mul(sk, sk)
    a = _sample_uniform(ring, gen, (n_q,))                      # (L_dig, L, phi)
    e, _ = _sample_cbd(ring, gen, (n_q,))
    # qhat_i s^2 in RNS: qhat_i vanishes mod every q_j but q_i, so row i
    # survives only at prime i, scaled by qhat_i mod q_i
    qhat_mod = torch.tensor([qh % q for qh, q in zip(ring.q_hat, ring.q_primes)],
                            dtype=I64, device=ring.device).reshape(-1, 1)
    qhat_s2 = torch.diag_embed((s2 * qhat_mod % ring._q).T).permute(1, 2, 0)
    b = ring.sub(ring.add(ring.scalar_mul_t(e), qhat_s2), ring.mul(a, sk))
    return RelinKeyL(b, a)


def _rns_digits(ring, c):
    """RNS digits of an eval-form element (..., L, phi): digit i is
    [c qhat_i^-1]_{q_i} as an integer polynomial below q_i, re-lifted to the
    full basis in eval form -> (..., L_dig, L, phi).  Exact by CRT:
    sum_i digit_i qhat_i = c (mod q)."""
    coeff = ring.from_eval(c * ring._qhat_inv_col % ring._q)     # (..., L, phi)
    digs = torch.remainder(coeff.unsqueeze(-2), ring._q)        # (..., L_dig, L, phi)
    return ring.to_eval(digs)


def mul_ct_l(ring, rlk: RelinKeyL, x: CiphertextL, y: CiphertextL) -> CiphertextL:
    """Homomorphic ciphertext x ciphertext with relinearization."""
    e0 = ring.mul(x.c0, y.c0)
    e1 = ring.add(ring.mul(x.c0, y.c1), ring.mul(x.c1, y.c0))
    e2 = ring.mul(x.c1, y.c1)
    digits = _rns_digits(ring, e2)
    c0 = ring.add(e0, _sum_digit_axis(ring, ring.mul(digits, rlk.b)))
    c1 = ring.add(e1, _sum_digit_axis(ring, ring.mul(digits, rlk.a)))
    return CiphertextL(c0, c1)


def _sum_digit_axis(ring, x):
    """Modular sum over the digit axis (-3); sums of L residues < 2^31 stay
    far below 2^63, so one reduction suffices."""
    return x.sum(-3) % ring._q
