"""ZK proof of plaintext knowledge for the l-field BGV backend (prototype
form, coefficient responses as big integers).

Counterpart of `ark_mpc_tpu/offline/bgv/zkpok_l.py`: the amortized sigma
protocol of `zkpok.py` (see its docstring), instantiated for `bgv_l` over
the `CyclotomicRing` prototype.  The plaintext modulus is l ~ 2^253, so
response coefficients reach ~2^(sec + 255) and travel as 48-byte
fixed-width signed integers; the ciphertext side runs in the ring's RNS.
The production proof is the word-form `zkpok_words.py`.

The challenge hashes the ciphertexts' and commitments' residues as the
reference's uint32 arrays byte for byte, and the masks come from the same
numpy `host_rng` calls, so proofs verify across the packages in both
directions.  The encryption randomness comes from a `torch.Generator`.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ...algebra.fields import SCALAR_FIELD
from ...algebra.scalar import Scalar
from ...device import resolve_device
from ...ops.modular32 import to_uint32
from .bgv_l import CiphertextL, encrypt_l, encrypt_with_randomness_l
from .cyclotomic import CyclotomicRing

L_MOD = SCALAR_FIELD.modulus
_Z_BYTES = 48


@dataclass
class CiphertextWithProofL:
    cts: CiphertextL          # (U, L, phi)
    comm: CiphertextL         # (V, L, phi)
    z: np.ndarray             # (V, phi) object ints
    zu: np.ndarray            # (V, phi) int64
    ze0: np.ndarray
    ze1: np.ndarray


def _challenge(ring, cts: CiphertextL, comm: CiphertextL, v, u):
    h = hashlib.sha3_256()
    for a in (cts.c0, cts.c1, comm.c0, comm.c1):
        h.update(to_uint32(a).tobytes())
    seed = h.digest()
    bits, ctr = [], 0
    while len(bits) < v * u:
        d = hashlib.sha3_256(seed + ctr.to_bytes(4, "little")).digest()
        for byte in d:
            for j in range(8):
                bits.append((byte >> j) & 1)
        ctr += 1
    return np.array(bits[: v * u], dtype=np.int64).reshape(v, u)


def _lift_object(ring, arr) -> torch.Tensor:
    """(..., phi) integers of any magnitude (numpy object or int64) ->
    the ring's canonical form (..., L, phi)."""
    arr = np.asarray(arr)
    if arr.dtype == object:
        rows = np.stack([np.asarray(np.mod(arr, q), dtype=np.int64) for q in ring.q_primes],
                        axis=-2)
        res = torch.from_numpy(rows).to(ring.device)
    else:
        res = torch.remainder(torch.from_numpy(arr.astype(np.int64)).to(ring.device)
                              .unsqueeze(-2), ring._q)
    return ring.lift_residues(res)


def _centered_coeffs(coeffs: Scalar) -> np.ndarray:
    """(phi,)-batch Scalar -> centered Python-int coefficients (object)."""
    vals = np.array(coeffs.to_ints(), dtype=object).reshape(coeffs.shape)
    half = L_MOD // 2
    return np.array([[v - L_MOD if v > half else v for v in row]
                     for row in np.atleast_2d(vals)], dtype=object)


def encrypt_and_prove_batch_l(ring: CyclotomicRing, pk_a, pk_b, pt_coeff_list,
                              gen: torch.Generator, sec: int = 40, v: int = 32,
                              host_rng: np.random.Generator | None = None
                              ) -> CiphertextWithProofL:
    """pt_coeff_list: a list of U plaintext-coefficient Scalars (phi,)."""
    if host_rng is None:
        from ...utils.csprng import default_crypto_rng

        host_rng = default_crypto_rng()
    u_count = len(pt_coeff_list)
    phi = ring.phi
    tau = L_MOD // 2
    k = ring.cbd_k

    cts, raws = [], []
    for pt in pt_coeff_list:
        ct, raw = encrypt_l(ring, pk_a, pk_b, pt, gen, return_randomness=True)
        cts.append(ct)
        raws.append(raw)
    cts = CiphertextL(torch.stack([c.c0 for c in cts]), torch.stack([c.c1 for c in cts]))
    m_signed = np.concatenate([_centered_coeffs(pt) for pt in pt_coeff_list], axis=0)

    b_plain = (1 << sec) * tau * u_count
    b_u = (1 << sec) * u_count
    b_e = (1 << sec) * k * u_count
    span = 2 * b_plain + 1
    nbytes = (span.bit_length() + 15) // 8
    y = np.array(
        [[int.from_bytes(host_rng.bytes(nbytes), "little") % span - b_plain
          for _ in range(phi)] for _ in range(v)], dtype=object)
    su = host_rng.integers(-b_u, b_u + 1, size=(v, phi)).astype(np.int64)
    se0 = host_rng.integers(-b_e, b_e + 1, size=(v, phi)).astype(np.int64)
    se1 = host_rng.integers(-b_e, b_e + 1, size=(v, phi)).astype(np.int64)

    comm = encrypt_with_randomness_l(ring, pk_a, pk_b, _lift_object(ring, y),
                                     _lift_object(ring, su), _lift_object(ring, se0),
                                     _lift_object(ring, se1))
    w = _challenge(ring, cts, comm, v, u_count)

    def stacked(j):
        return np.stack([r[j].cpu().numpy().astype(np.int64) for r in raws])

    z = y + w @ m_signed
    zu = su + w @ stacked(0)
    ze0 = se0 + w @ stacked(1)
    ze1 = se1 + w @ stacked(2)
    return CiphertextWithProofL(cts, comm, z, zu, ze0, ze1)


def verify_proof_l(ring: CyclotomicRing, pk_a, pk_b,
                   proof: CiphertextWithProofL, sec: int = 40) -> bool:
    v, phi = proof.z.shape
    u_count = proof.cts.c0.shape[0]
    tau = L_MOD // 2
    k = ring.cbd_k
    b_plain = (1 << sec) * tau * u_count
    if int(np.max(np.abs(proof.z))) > b_plain + u_count * tau:
        return False
    if (np.abs(proof.zu).max() > (1 << sec) * u_count + u_count
            or np.abs(proof.ze0).max() > (1 << sec) * k * u_count + u_count * k
            or np.abs(proof.ze1).max() > (1 << sec) * k * u_count + u_count * k):
        return False
    w = _challenge(ring, proof.cts, proof.comm, v, u_count)
    lhs = encrypt_with_randomness_l(ring, pk_a, pk_b, _lift_object(ring, proof.z),
                                    _lift_object(ring, proof.zu),
                                    _lift_object(ring, proof.ze0),
                                    _lift_object(ring, proof.ze1))
    rhs0, rhs1 = proof.comm.c0, proof.comm.c1
    w_dev = torch.from_numpy(w).to(ring.device)
    for i in range(u_count):
        sel = (w_dev[:, i] == 1)[:, None, None]
        rhs0 = torch.where(sel, ring.add(rhs0, proof.cts.c0[i][None]), rhs0)
        rhs1 = torch.where(sel, ring.add(rhs1, proof.cts.c1[i][None]), rhs1)
    return bool(torch.equal(lhs.c0, rhs0)) and bool(torch.equal(lhs.c1, rhs1))


# -- wire serialization -----------------------------------------------------


def proof_to_arrays_l(proof: CiphertextWithProofL) -> list:
    v, phi = proof.z.shape
    zb = b"".join(int(proof.z[i, j]).to_bytes(_Z_BYTES, "little", signed=True)
                  for i in range(v) for j in range(phi))
    return [to_uint32(proof.cts.c0), to_uint32(proof.cts.c1),
            to_uint32(proof.comm.c0), to_uint32(proof.comm.c1), zb,
            np.asarray(proof.zu, np.int64), np.asarray(proof.ze0, np.int64),
            np.asarray(proof.ze1, np.int64)]


def proof_from_arrays_l(items: list, v: int, phi: int, device=None) -> CiphertextWithProofL:
    """The wire form back, its residues on `device` (the CUDA card unless
    given), taken as they are."""
    device = resolve_device(device)
    c0, c1, a0, a1, zb, zu, ze0, ze1 = items
    z = np.empty((v, phi), dtype=object)
    off = 0
    for i in range(v):
        for j in range(phi):
            z[i, j] = int.from_bytes(zb[off: off + _Z_BYTES], "little", signed=True)
            off += _Z_BYTES

    def dev(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)

    return CiphertextWithProofL(CiphertextL(dev(c0), dev(c1)), CiphertextL(dev(a0), dev(a1)),
                                z, zu, ze0, ze1)
