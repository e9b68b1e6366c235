"""BGV encryption over the prototype's RNS ring.

Counterpart of `ark_mpc_tpu/offline/bgv/bgv.py` (the reference's BGV FFI
surface, `mp-spdz-rs/src/fhe/{keys.rs,plaintext.rs,ciphertext.rs}`):
keypair generation, slot-packed plaintexts, encryption, decryption,
ciphertext addition, ciphertext x plaintext products and drowning
rerandomization, everything the prototype LowGear triples consume.

Scheme (standard BGV, plaintext in the low bits):
    sk: ternary s.            pk: (b, a) with a uniform, b = -(a*s) + t*e.
    enc(m): u ternary, e0/e1 CBD noise:
        c0 = b*u + t*e0 + m,  c1 = a*u + t*e1.
    dec: (c0 + c1*s mod q) centered, then mod t.
    ct x pt: multiply both components by the plaintext ring element.
    drown: add enc(0) whose noise is ~2^sec larger than the ct's noise.

Plaintext slots: t = 1 mod 2N, so the negacyclic NTT over Z_t is the slot
isomorphism: `encode_slots` is an inverse NTT of the slot vector,
`decode_slots` the forward NTT, and ring products act slot-wise.

Keys, encryption randomness and drowning noise come from an explicit
`torch.Generator` on the parameter set's device, where the reference takes
a `jax.random` key; `encrypt_with_randomness` is deterministic and equals
the reference's bit for bit.  Ciphertexts and keys are int64 residue
tensors (..., L, N); `decrypt` and `decrypt_slots` return numpy uint32 on
the host, as the reference's do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...ops.ntt import ntt
from . import rns
from .params import BgvParams


@dataclass
class Ciphertext:
    """(c0, c1) in R_q x R_q; tensors (L, N) or batched (B, L, N)."""

    c0: torch.Tensor
    c1: torch.Tensor

    def __add__(self, other: "Ciphertext"):
        raise TypeError("use bgv.add_ct(params, a, b)")


@dataclass
class Keypair:
    params: BgvParams
    sk: torch.Tensor  # (L, N) RNS of ternary s
    pk_a: torch.Tensor
    pk_b: torch.Tensor


def keygen(params: BgvParams, gen: torch.Generator) -> Keypair:
    s = rns.sample_ternary(params, gen)
    a = rns.sample_uniform(params, gen)
    e = rns.sample_cbd(params, gen)
    b = rns.rns_sub(params, rns.rns_scalar_mul(params, e, params.t),
                    rns.rns_mul(params, a, s))
    return Keypair(params, s, a, b)


# -- plaintext packing ------------------------------------------------------


def encode_slots(params: BgvParams, slots) -> torch.Tensor:
    """Slot values (..., N) (< t) -> plaintext ring coefficients: the inverse
    negacyclic NTT over Z_t (slot-wise products of encodings are ring
    products)."""
    return ntt(params.t_plan, rns._on_device(params, slots), inverse=True)


def decode_slots(params: BgvParams, coeffs) -> torch.Tensor:
    return ntt(params.t_plan, rns._on_device(params, coeffs))


# -- core operations --------------------------------------------------------


def encrypt_with_randomness(params: BgvParams, pk_a, pk_b, m_rns,
                            u_rns, e0_rns, e1_rns) -> Ciphertext:
    """Deterministic encryption from explicit randomness (all operands
    already lifted to RNS).  The ZKPoK verifier re-runs this equation."""
    c0 = rns.rns_add(
        params,
        rns.rns_add(params, rns.rns_mul(params, pk_b, u_rns),
                    rns.rns_scalar_mul(params, e0_rns, params.t)),
        m_rns,
    )
    c1 = rns.rns_add(params, rns.rns_mul(params, pk_a, u_rns),
                     rns.rns_scalar_mul(params, e1_rns, params.t))
    return Ciphertext(c0, c1)


def encrypt(params: BgvParams, pk_a, pk_b, pt_coeffs, gen: torch.Generator,
            return_randomness: bool = False):
    """Encrypt plaintext ring coefficients (..., N) (< t); leading batch
    dims get independent randomness.  With `return_randomness`, also the
    raw signed (u, e0, e1), (..., N) int64 (the proof's witness)."""
    pt = rns._on_device(params, pt_coeffs)
    batch = tuple(pt.shape[:-1])
    u_raw = rns.ternary_coeffs(params, gen, batch)
    e0_raw = rns.cbd_coeffs(params, gen, batch)
    e1_raw = rns.cbd_coeffs(params, gen, batch)
    ct = encrypt_with_randomness(
        params, pk_a, pk_b, rns.from_plaintext(params, pt),
        rns.from_signed_coeffs(params, u_raw),
        rns.from_signed_coeffs(params, e0_raw),
        rns.from_signed_coeffs(params, e1_raw),
    )
    if return_randomness:
        return ct, (u_raw, e0_raw, e1_raw)
    return ct


def decrypt(params: BgvParams, sk, ct: Ciphertext) -> np.ndarray:
    """-> plaintext coefficients (N,) uint32 (host-side CRT + centering)."""
    phase = rns.rns_add(params, ct.c0, rns.rns_mul(params, ct.c1, sk))
    t = params.t
    return np.array([v % t for v in rns.to_ints(params, phase)], dtype=np.uint32)


def add_ct(params: BgvParams, x: Ciphertext, y: Ciphertext) -> Ciphertext:
    return Ciphertext(rns.rns_add(params, x.c0, y.c0),
                      rns.rns_add(params, x.c1, y.c1))


def add_pt(params: BgvParams, x: Ciphertext, pt_coeffs) -> Ciphertext:
    return Ciphertext(rns.rns_add(params, x.c0, rns.from_plaintext(params, pt_coeffs)), x.c1)


def mul_pt(params: BgvParams, x: Ciphertext, pt_coeffs) -> Ciphertext:
    """ct x plaintext ring element (`ciphertext.rs` mul_plaintext)."""
    m = rns.from_plaintext(params, pt_coeffs)
    return Ciphertext(rns.rns_mul(params, x.c0, m), rns.rns_mul(params, x.c1, m))


def rerandomize(params: BgvParams, pk_a, pk_b, ct: Ciphertext,
                gen: torch.Generator, drown_bits: int | None = None) -> Ciphertext:
    """Drowning rerandomization (`ciphertext.rs` rerandomize): add a fresh
    encryption of zero whose noise statistically hides the ciphertext's:
    uniform noise of ~2^drown_sec x the post-product noise bound."""
    if drown_bits is None:
        drown_bits = params.drown_sec + 20
    batch = tuple(ct.c0.shape[:-2])
    u = rns.sample_ternary(params, gen, batch)
    e0 = rns.sample_uniform_bounded(params, gen, drown_bits, batch)
    e1 = rns.sample_cbd(params, gen, batch)
    z0 = rns.rns_add(params, rns.rns_mul(params, pk_b, u),
                     rns.rns_scalar_mul(params, e0, params.t))
    z1 = rns.rns_add(params, rns.rns_mul(params, pk_a, u),
                     rns.rns_scalar_mul(params, e1, params.t))
    return Ciphertext(rns.rns_add(params, ct.c0, z0), rns.rns_add(params, ct.c1, z1))


# -- convenience: slot-level API -------------------------------------------


def encrypt_slots(params: BgvParams, pk_a, pk_b, slot_values, gen: torch.Generator):
    return encrypt(params, pk_a, pk_b, encode_slots(params, slot_values), gen)


def decrypt_slots(params: BgvParams, sk, ct: Ciphertext) -> np.ndarray:
    coeffs = decrypt(params, sk, ct)
    return decode_slots(params, coeffs).cpu().numpy().astype(np.uint32)
