"""Vectorized ZK proof of plaintext knowledge (word-form responses).

Counterpart of `ark_mpc_tpu/offline/bgv/zkpok_words.py`; proofs cross
between the packages both ways.  The amortized sigma protocol: commit to V
masking encryptions, draw a binary Fiat-Shamir challenge matrix W in
{0,1}^(V x U), respond with z = y + W m over the integers; the verifier
re-runs the encryption equation on the lifted responses.  All big-integer
math is a fixed 48-bit word-plane representation:

  - a response vector is an int64 array (..., phi, W) of signed base-2^48
    digits (normalized to balanced digits before it leaves the prover);
  - z = y + W m is one numpy int64 einsum per word plane;
  - masks are balanced digits, EXACTLY uniform in [-2^(48W-1), 2^(48W-1)),
    drawn from the caller's host generator as the reference draws them;
  - lifting a word array into the ring is `ring.lift_words`.

The challenge hashes the ring's class name and parameters, the raw C-order
uint32 bytes of both public keys, of the ciphertexts and of the commitments,
and (V, U): the bytes the reference hashes, so both packages derive the same
challenge.  Soundness 2^-V (V = 128 in LowGear); zero-knowledge slack
2^zk_sec.  Commitments are computed on the ring's device in V-chunks and kept
on the host, as in the reference.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ...algebra import limbs as lb
from ...algebra.fields import SCALAR_FIELD
from ...algebra.scalar import Scalar
from ...device import resolve_device
from .bgv_l import CiphertextL, encrypt_returning_randomness_l, encrypt_with_randomness_l
from .cyclotomic import I64, L_MOD
from .powerful import zk_word_counts

W_PT = 6           # plaintext words: 16 x 16-bit limbs -> [3,3,3,3,3,1]
_HALF_L = L_MOD // 2
# Bytes of one V-chunk's (chunk, L, phi) int64 ciphertext pair; the device's
# peak is a small multiple of it.  At the production ring one row is 21 MB,
# so V = 128 is one chunk.
CHUNK_BYTES = 4 << 30
MAX_U = 1 << 21    # the fold's float64 sums of U residues < 2^31 stay exact


def _v_chunk(ring, v: int) -> int:
    """Challenge rows per device pass, a power of two."""
    row_bytes = len(ring.q_primes) * ring.phi * 8 * 2
    c = max(1, min(v, CHUNK_BYTES // row_bytes))
    return 1 << (c.bit_length() - 1)


def _u32(x) -> np.ndarray:
    """A residue array of either package (torch or numpy) -> uint32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.uint32)


def _residues(x, device) -> torch.Tensor:
    """A residue array (torch or numpy) -> int64 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I64)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


# ---------------------------------------------------------------------------
# word-plane helpers
# ---------------------------------------------------------------------------


def scalar_to_words(pt: Scalar, centered: bool = True) -> np.ndarray:
    """Scalar (...,) -> centered signed word planes (..., W_PT) int64."""
    canon = lb.from_mont(SCALAR_FIELD, pt.limbs).cpu().numpy().astype(np.int64)
    groups = [canon[3 * w:3 * w + 3] for w in range(5)] + [canon[15:16]]
    words = np.stack(
        [sum(g[i] << (16 * i) for i in range(g.shape[0])) for g in groups], axis=-1)
    if centered:
        # v > l/2 -> v - l (float64 classification: both branches satisfy
        # the bound near the threshold, so rare misclassification is safe)
        scale = np.float64(2.0) ** (48 * np.arange(W_PT))
        approx = (words.astype(np.float64) * scale).sum(-1)
        words = np.where(approx[..., None] > float(_HALF_L), words - _int_to_words(L_MOD, W_PT),
                         words)
    return words


def _int_to_words(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (48 * w)) & ((1 << 48) - 1) for w in range(n)], dtype=np.int64)


def small_to_words(arr) -> np.ndarray:
    """Small signed ints (...,) -> single-word planes (..., 1)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    return np.asarray(arr, dtype=np.int64)[..., None]


def sample_balanced_words(rng, shape: tuple, n_words: int) -> np.ndarray:
    """Uniform over [-2^(48n-1), 2^(48n-1)) as balanced base-2^48 digits
    (independent digits in [-2^47, 2^47) == exactly uniform value)."""
    n = int(np.prod(shape)) * n_words
    raw = np.frombuffer(rng.bytes(8 * n), dtype=np.uint64).astype(np.int64)
    digits = (raw & ((1 << 48) - 1)) - (1 << 47)
    return digits.reshape(shape + (n_words,))


def words_magnitude(words: np.ndarray) -> np.ndarray:
    """Approximate |value| as float64 (relative error < 2^-50; used for
    bound checks whose bounds already carry 2^zk_sec slack)."""
    scale = np.float64(2.0) ** (48 * np.arange(words.shape[-1]))
    return np.abs((words.astype(np.float64) * scale).sum(-1))


# Exact-lift digit range: the lift agrees with integer arithmetic only for
# digits in [-2^55, 2^55).  Honest (normalized) digits are <= ~2^48; the
# verifier rejects anything at or beyond 2^54.
DIGIT_BOUND = 1 << 54


def normalize_words(words: np.ndarray) -> np.ndarray:
    """Carry-propagate lazy signed base-2^48 digits into balanced form:
    digits 0..W-2 land in [-2^47, 2^47), the remainder in the last word.
    Value-preserving; keeps honest digits ~2^48 for any U."""
    out = np.empty_like(words)
    carry = np.zeros(words.shape[:-1], dtype=np.int64)
    half = np.int64(1) << 47
    mask = (np.int64(1) << 48) - 1
    for i in range(words.shape[-1] - 1):
        t = words[..., i] + carry
        lo = ((t + half) & mask) - half
        out[..., i] = lo
        carry = (t - lo) >> 48  # exact: t - lo is a multiple of 2^48
    out[..., -1] = words[..., -1] + carry
    return out


# ---------------------------------------------------------------------------
# the proof
# ---------------------------------------------------------------------------


@dataclass
class CiphertextWithProofW:
    cts: CiphertextL    # (U, L, phi) tensors on the ring's device
    comm: CiphertextL   # (V, L, phi) uint32 numpy (host)
    z: np.ndarray       # (V, phi, Wz) int64
    zu: np.ndarray      # (V, phi, Wu)
    ze0: np.ndarray
    ze1: np.ndarray


def _statement_tag(ring, pk_a, pk_b, v: int, u: int) -> bytes:
    """Bind the challenge to the full statement: both public keys, the
    ring's identity and parameters, and (V, U)."""
    h = hashlib.sha3_256()
    qs = ",".join(str(q) for q in ring.q_primes)
    h.update(
        f"ark-mpc-tpu-zkpok-v1|{type(ring).__name__}|m={ring.m}"
        f"|phi={ring.phi}|slots={ring.slots}|k={ring.cbd_k}"
        f"|q={qs}|V={v}|U={u}".encode())
    for a in (pk_a, pk_b):
        h.update(_u32(a).tobytes())
    return h.digest()


def _challenge(cts: CiphertextL, comm: CiphertextL, v: int, u: int, tag: bytes) -> np.ndarray:
    h = hashlib.sha3_256(tag)
    for a in (cts.c0, cts.c1, comm.c0, comm.c1):
        h.update(_u32(a).tobytes())
    seed = h.digest()
    n_blocks = -(-(v * u) // 256)
    raw = b"".join(hashlib.sha3_256(seed + ctr.to_bytes(4, "little")).digest()
                   for ctr in range(n_blocks))
    bits = np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="little")
    return bits[: v * u].astype(np.int64).reshape(v, u)


def _lifted_encryptions(ring, pk_a, pk_b, m_w, u_w, e0_w, e1_w) -> CiphertextL:
    return encrypt_with_randomness_l(ring, pk_a, pk_b, ring.lift_words(m_w),
                                     ring.lift_words(u_w), ring.lift_words(e0_w),
                                     ring.lift_words(e1_w))


def encrypt_and_prove_batch(ring, pk_a, pk_b, pt_coeff_list, gen: torch.Generator,
                            v: int = 128, sec: int | None = None,
                            host_rng=None) -> CiphertextWithProofW:
    """Encrypt U plaintext-coefficient Scalars (phi,) with randomness from
    `gen` and prove plaintext knowledge, amortized over the batch.  The
    masks come from `host_rng` (default: an OS-entropy CSPRNG)."""
    if host_rng is None:
        from ...utils.csprng import default_crypto_rng

        host_rng = default_crypto_rng()
    sec = sec if sec is not None else getattr(ring, "zk_sec", 64)
    u_count = len(pt_coeff_list)
    phi = ring.phi
    wz, wu = zk_word_counts(sec, max(u_count, 2), ring.cbd_k)

    pts = Scalar(torch.stack([p.reshape(phi).limbs for p in pt_coeff_list], dim=1))  # (U, phi)
    cts, (u_raw, e0_raw, e1_raw) = encrypt_returning_randomness_l(ring, pk_a, pk_b, pts, gen)

    m_words = scalar_to_words(pts)                          # (U, phi, 6)
    u_words = small_to_words(u_raw)
    e0_words = small_to_words(e0_raw)
    e1_words = small_to_words(e1_raw)

    y = sample_balanced_words(host_rng, (v, phi), wz)
    su = sample_balanced_words(host_rng, (v, phi), wu)
    se0 = sample_balanced_words(host_rng, (v, phi), wu)
    se1 = sample_balanced_words(host_rng, (v, phi), wu)

    cc0, cc1 = [], []
    vc = _v_chunk(ring, v)
    for beg in range(0, v, vc):
        sl = slice(beg, min(beg + vc, v))
        ch = _lifted_encryptions(ring, pk_a, pk_b, y[sl], su[sl], se0[sl], se1[sl])
        cc0.append(_u32(ch.c0))
        cc1.append(_u32(ch.c1))
        del ch
    comm = CiphertextL(np.concatenate(cc0), np.concatenate(cc1))

    tag = _statement_tag(ring, pk_a, pk_b, v, u_count)
    w = _challenge(cts, comm, v, u_count, tag)              # (V, U) binary

    def respond(mask, witness, w_mask):
        # (V, U) @ (U, phi, W) -> (V, phi, W), padded to the mask's width
        acc = np.einsum("vu,upw->vpw", w, witness).astype(np.int64)
        if acc.shape[-1] < w_mask:
            acc = np.pad(acc, ((0, 0), (0, 0), (0, w_mask - acc.shape[-1])))
        return normalize_words(mask + acc)

    return CiphertextWithProofW(cts, comm, respond(y, m_words, wz), respond(su, u_words, wu),
                                respond(se0, e0_words, wu), respond(se1, e1_words, wu))


def verify_proof(ring, pk_a, pk_b, proof: CiphertextWithProofW,
                 sec: int | None = None, v: int = 128,
                 expected_u: int | None = None) -> bool:
    """Verify an amortized proof.  `v` is the REQUIRED challenge-row count
    (soundness 2^-v), enforced against the proof, never read from it;
    `expected_u` pins the ciphertext count when the caller knows it."""
    sec = sec if sec is not None else getattr(ring, "zk_sec", 64)
    phi = ring.phi
    u_count = int(proof.cts.c0.shape[0])
    if expected_u is not None and u_count != expected_u:
        return False
    if u_count > MAX_U:
        raise ValueError(f"U = {u_count} ciphertexts exceed the fold's exact range ({MAX_U})")
    k = ring.cbd_k
    wz, wu = zk_word_counts(sec, max(u_count, 2), k)
    ct_tail = tuple(proof.cts.c0.shape[1:])
    if (proof.z.shape != (v, phi, wz)
            or proof.zu.shape != (v, phi, wu)
            or proof.ze0.shape != (v, phi, wu)
            or proof.ze1.shape != (v, phi, wu)
            or tuple(proof.cts.c1.shape) != (u_count,) + ct_tail
            or tuple(proof.comm.c0.shape) != (v,) + ct_tail
            or tuple(proof.comm.c1.shape) != (v,) + ct_tail):
        return False
    # per-digit exact-lift range: the value-level bound below cannot see
    # wrapping digit patterns that cancel in float64
    for arr in (proof.z, proof.zu, proof.ze0, proof.ze1):
        if int(np.abs(arr).max()) >= DIGIT_BOUND:
            return False
    b_y = 2.0 ** (48 * wz - 1)
    b_u = 2.0 ** (48 * wu - 1)
    eps = 1.0 + 2.0 ** -40
    if words_magnitude(proof.z).max() > (b_y + u_count * float(_HALF_L)) * eps:
        return False
    if words_magnitude(proof.zu).max() > (b_u + u_count) * eps:
        return False
    if max(words_magnitude(proof.ze0).max(),
           words_magnitude(proof.ze1).max()) > (b_u + u_count * k) * eps:
        return False

    tag = _statement_tag(ring, pk_a, pk_b, v, u_count)
    w = _challenge(proof.cts, proof.comm, v, u_count, tag)
    cts = [_residues(c, ring.device) for c in (proof.cts.c0, proof.cts.c1)]
    vc = _v_chunk(ring, v)
    for beg in range(0, v, vc):
        sl = slice(beg, min(beg + vc, v))
        lhs = _lifted_encryptions(ring, pk_a, pk_b, proof.z[sl], proof.zu[sl],
                                  proof.ze0[sl], proof.ze1[sl])
        w_dev = torch.as_tensor(w[sl], dtype=torch.float64, device=ring.device)
        for got, ct, com in zip((lhs.c0, lhs.c1), cts, (proof.comm.c0, proof.comm.c1)):
            rhs = ring.add(_residues(com[sl], ring.device), _fold(ring, w_dev, ct))
            if not bool(torch.equal(got, rhs)):
                return False
    return True


def _fold(ring, w: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """W @ ct-stack per RNS prime: (Vc, U) binary @ (U, L, phi) -> (Vc, L,
    phi) mod q_i.  Float64 sums of U residues < 2^31 are exact (U <= MAX_U)."""
    s = (w @ ct.reshape(ct.shape[0], -1).to(torch.float64)).to(I64)
    return s.reshape((w.shape[0],) + tuple(ct.shape[1:])) % ring._q


# ---------------------------------------------------------------------------
# wire serialization (plain numpy arrays)
# ---------------------------------------------------------------------------


def proof_to_arrays(proof) -> list:
    """A proof of either package -> [cts c0, c1, comm c0, c1 (uint32), z, zu,
    ze0, ze1 (int64)]: the wire format."""
    return [_u32(proof.cts.c0), _u32(proof.cts.c1), _u32(proof.comm.c0), _u32(proof.comm.c1),
            proof.z, proof.zu, proof.ze0, proof.ze1]


def proof_from_arrays(items: list, device=None) -> CiphertextWithProofW:
    """Inverse of `proof_to_arrays`: the ciphertexts go to `device` (the
    CUDA card unless given), the commitments stay on the host."""
    c0, c1, a0, a1, z, zu, ze0, ze1 = items
    dev = resolve_device(device)
    return CiphertextWithProofW(
        CiphertextL(_residues(c0, dev), _residues(c1, dev)),
        CiphertextL(np.asarray(a0, np.uint32), np.asarray(a1, np.uint32)),
        np.asarray(z, np.int64), np.asarray(zu, np.int64),
        np.asarray(ze0, np.int64), np.asarray(ze1, np.int64),
    )
