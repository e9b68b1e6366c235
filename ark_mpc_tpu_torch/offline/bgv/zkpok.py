"""Zero-knowledge proof of plaintext knowledge for the prototype's BGV
ciphertext batches.

Counterpart of `ark_mpc_tpu/offline/bgv/zkpok.py` (MP-SPDZ's
`encrypt_and_prove_batch` / `verify_proof_of_knowledge`): the amortized
SPDZ/TopGear-style sigma protocol, made non-interactive with Fiat-Shamir.

  statement:  C_i = Enc(m_i; u_i, e0_i, e1_i), i < U, with
              ||m||_inf <= t/2 and ternary/CBD randomness.
  prover:     masks y_k (|y| <= 2^sec (t/2) U) and masking randomness
              (2^sec bound U); A_k = Enc(y_k; s*_k).  W = H(C, A) in
              {0,1}^{V x U}; z_k = y_k + sum_i W_ki m_i over the integers,
              zu/ze0/ze1 likewise over the randomness.
  verifier:   recompute W; check the bounds; check
              Enc(z_k; zu_k, ze0_k, ze1_k) == A_k + sum_i W_ki C_i in R_q^2.

Proofs cross between the packages in both directions: the challenge hashes
the keys' and ciphertexts' residues as the reference's uint32 arrays byte
for byte (the port holds them as int64 tensors and converts before
hashing), and the masks come from the same numpy `host_rng` calls, so one
generator state draws the same masks in both.  The encryption randomness
comes from a `torch.Generator` (the reference's from a `jax.random` key).
Responses are big integers on the host (numpy object arrays); the
ciphertext algebra runs in RNS on the parameter set's device.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ...device import resolve_device
from ...ops.modular32 import to_uint32
from . import rns
from .bgv import Ciphertext, encrypt, encrypt_with_randomness
from .params import BgvParams


@dataclass
class CiphertextWithProof:
    """Batch of ciphertexts + proof (`CiphertextPoK` analog)."""

    cts: Ciphertext          # (U, L, N) tensors
    comm: Ciphertext         # A_k commitments, (V, L, N)
    z: np.ndarray            # (V, N) object ints: plaintext responses
    zu: np.ndarray           # (V, N) int64: ternary-randomness responses
    ze0: np.ndarray          # (V, N) int64
    ze1: np.ndarray          # (V, N) int64


def _challenge_matrix(params: BgvParams, cts: Ciphertext, comm: Ciphertext,
                      v: int, u: int, pk_a=None, pk_b=None) -> np.ndarray:
    """Fiat-Shamir binary challenge W in {0,1}^{V x U}, bound to the full
    statement (public keys, ring parameters and dimensions besides the
    ciphertexts)."""
    h = hashlib.sha3_256()
    qs = ",".join(str(s.q) for s in params.q_specs)
    h.update(f"ark-mpc-tpu-zkpok-proto-v1|n={params.n}|t={params.t}"
             f"|k={params.cbd_k}|q={qs}|V={v}|U={u}".encode())
    for a in (pk_a, pk_b):
        if a is not None:
            h.update(to_uint32(a).tobytes())
    for a in (cts.c0, cts.c1, comm.c0, comm.c1):
        h.update(to_uint32(a).tobytes())
    seed = h.digest()
    bits = []
    ctr = 0
    while len(bits) < v * u:
        d = hashlib.sha3_256(seed + ctr.to_bytes(4, "little")).digest()
        for byte in d:
            for j in range(8):
                bits.append((byte >> j) & 1)
        ctr += 1
    return np.array(bits[: v * u], dtype=np.int64).reshape(v, u)


def _centered(params: BgvParams, pt: np.ndarray) -> np.ndarray:
    """Coefficients < t -> centered signed Python ints."""
    pt = np.asarray(pt, dtype=np.int64)
    half = params.t // 2
    return np.where(pt > half, pt - params.t, pt).astype(object)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def encrypt_and_prove_batch(params: BgvParams, pk_a, pk_b, pt_batch,
                            gen: torch.Generator, sec: int = 40, v: int = 32,
                            host_rng: np.random.Generator | None = None
                            ) -> CiphertextWithProof:
    """Encrypt a batch of U plaintext coefficient vectors (U, N) and prove
    knowledge (`fhe/keys.rs` encrypt_and_prove_batch; `sec` is the
    reference's statistical parameter)."""
    if host_rng is None:
        from ...utils.csprng import default_crypto_rng

        host_rng = default_crypto_rng()
    pt_batch = _host(pt_batch).astype(np.int64)
    u_count, n = pt_batch.shape
    tau = params.t // 2
    k = params.cbd_k

    cts, (u_raw, e0_raw, e1_raw) = encrypt(params, pk_a, pk_b, pt_batch, gen,
                                           return_randomness=True)
    m_signed = _centered(params, pt_batch)  # (U, N) object

    b_plain = (1 << sec) * tau * u_count
    b_u = (1 << sec) * 1 * u_count
    b_e = (1 << sec) * k * u_count
    # masks (host): y big ints; the randomness masks fit int64 for sec <= 40
    y = np.array(
        [[int(host_rng.integers(-b_plain, b_plain + 1, dtype=np.int64))
          if b_plain < (1 << 62) else
          int.from_bytes(host_rng.bytes(16), "little") % (2 * b_plain + 1) - b_plain
          for _ in range(n)] for _ in range(v)], dtype=object)
    su = host_rng.integers(-b_u, b_u + 1, size=(v, n)).astype(np.int64)
    se0 = host_rng.integers(-b_e, b_e + 1, size=(v, n)).astype(np.int64)
    se1 = host_rng.integers(-b_e, b_e + 1, size=(v, n)).astype(np.int64)

    comm = encrypt_with_randomness(
        params, pk_a, pk_b, rns.lift_ints(params, y), rns.lift_ints(params, su),
        rns.lift_ints(params, se0), rns.lift_ints(params, se1))

    w = _challenge_matrix(params, cts, comm, v, u_count, pk_a, pk_b)  # (V, U)
    z = y + w @ m_signed
    zu = su + w @ _host(u_raw)
    ze0 = se0 + w @ _host(e0_raw)
    ze1 = se1 + w @ _host(e1_raw)
    return CiphertextWithProof(cts, comm, z, zu, ze0, ze1)


_Z_BYTES = 16  # fixed-width signed coefficient encoding on the wire


def proof_to_arrays(proof: CiphertextWithProof) -> list:
    """Wire form, the reference's: [c0, c1, A0, A1, z_bytes, zu, ze0, ze1]
    (residues as uint32 arrays)."""
    v, n = proof.z.shape
    zb = b"".join(int(proof.z[i, j]).to_bytes(_Z_BYTES, "little", signed=True)
                  for i in range(v) for j in range(n))
    return [to_uint32(proof.cts.c0), to_uint32(proof.cts.c1),
            to_uint32(proof.comm.c0), to_uint32(proof.comm.c1), zb,
            np.asarray(proof.zu, np.int64), np.asarray(proof.ze0, np.int64),
            np.asarray(proof.ze1, np.int64)]


def proof_from_arrays(items: list, v: int, n: int, device=None) -> CiphertextWithProof:
    """The wire form back, its residues on `device` (the CUDA card unless
    given).  The residues are taken as they are: a caller that receives
    them from a peer checks them first (`lowgear/triplets_bgv.py`)."""
    device = resolve_device(device)
    c0, c1, a0, a1, zb, zu, ze0, ze1 = items
    z = np.empty((v, n), dtype=object)
    off = 0
    for i in range(v):
        for j in range(n):
            z[i, j] = int.from_bytes(zb[off: off + _Z_BYTES], "little", signed=True)
            off += _Z_BYTES

    def dev(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)

    return CiphertextWithProof(Ciphertext(dev(c0), dev(c1)), Ciphertext(dev(a0), dev(a1)),
                               z, zu, ze0, ze1)


def verify_proof(params: BgvParams, pk_a, pk_b,
                 proof: CiphertextWithProof, sec: int = 40) -> bool:
    """`verify_proof_of_knowledge` analog: the bounds, then the linear
    encryption relation for every challenge row."""
    v, n = proof.z.shape
    u_count = proof.cts.c0.shape[0]
    tau = params.t // 2
    k = params.cbd_k
    b_plain = (1 << sec) * tau * u_count
    b_u = (1 << sec) * u_count
    b_e = (1 << sec) * k * u_count

    # 1. bounds (slack: masking bound + witness contribution)
    if int(np.max(np.abs(proof.z))) > b_plain + u_count * tau:
        return False
    if (np.abs(proof.zu).max() > b_u + u_count
            or np.abs(proof.ze0).max() > b_e + u_count * k
            or np.abs(proof.ze1).max() > b_e + u_count * k):
        return False

    # 2. recompute the challenge
    w = _challenge_matrix(params, proof.cts, proof.comm, v, u_count, pk_a, pk_b)

    # 3. Enc(z; zu, ze0, ze1) == A + W C  (in R_q x R_q)
    lhs = encrypt_with_randomness(
        params, pk_a, pk_b, rns.lift_ints(params, proof.z),
        rns.lift_ints(params, proof.zu), rns.lift_ints(params, proof.ze0),
        rns.lift_ints(params, proof.ze1))
    rhs0, rhs1 = proof.comm.c0, proof.comm.c1
    w_dev = torch.from_numpy(w).to(params.device)
    for i in range(u_count):
        sel = (w_dev[:, i] == 1)[:, None, None]
        rhs0 = torch.where(sel, rns.rns_add(params, rhs0, proof.cts.c0[i][None]), rhs0)
        rhs1 = torch.where(sel, rns.rns_add(params, rhs1, proof.cts.c1[i][None]), rhs1)
    return bool(torch.equal(lhs.c0, rhs0)) and bool(torch.equal(lhs.c1, rhs1))
