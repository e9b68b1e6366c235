"""The word-form ZK proof in the port (`offline/bgv/zkpok_words.py`) against
the JAX package: proofs cross both ways (a JAX proof verifies in the port and
a port proof in the JAX package), both derive the same statement tag and
challenge, the word helpers agree, and every rejection case of the
reference's `tests/test_powerful_zk.py` is rejected by the port.

The crossing proofs use the reference's 6-prime m = 35 ring (its JAX prover
compiles in seconds there); the rejection cases run the port alone at
`PowerfulRing(35)` with its production parameters, as the reference's do.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.algebra.scalar import Scalar as RefScalar
from ark_mpc_tpu.offline.bgv import powerful as ref_pow
from ark_mpc_tpu.offline.bgv import zkpok_words as ref_zk
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.algebra.fields import CURVE25519_ORDER as L
from ark_mpc_tpu_torch.algebra.scalar import Scalar
from ark_mpc_tpu_torch.offline.bgv import bgv_l, powerful
from ark_mpc_tpu_torch.offline.bgv import zkpok_words as zk

torch.set_num_threads(1)

CPU = torch.device("cpu")
V = 16


def _values(rng, n) -> np.ndarray:
    return np.array([int(v) * (L // 13) % L for v in rng.integers(0, 1 << 62, n, dtype=np.int64)],
                    dtype=object)


@functools.lru_cache(maxsize=None)
def crossing():
    """The 6-prime ring in both packages, a port keypair exported to the JAX
    package, and three plaintext coefficient vectors in both."""
    ref = ref_pow.PowerfulRing(35, n_q_primes=6)
    ring = powerful.PowerfulRing(35, n_q_primes=6, device=CPU)
    kp = bgv_l.keygen_l(ring, torch.Generator().manual_seed(40))
    ref_pk = [jnp.asarray(a) for a in convert.from_keypair(kp)[1:]]
    vals = _values(np.random.default_rng(41), 3 * ring.phi).reshape(3, ring.phi)
    ref_pts = [RefScalar.from_ints(v) for v in vals]
    pts = [Scalar.from_ints(v, device=CPU) for v in vals]
    return ref, ring, kp, ref_pk, ref_pts, pts


@functools.lru_cache(maxsize=None)
def jax_proof():
    ref, _, _, ref_pk, ref_pts, _ = crossing()
    return ref_zk.encrypt_and_prove_batch(ref, *ref_pk, ref_pts, jax.random.PRNGKey(42), v=V,
                                          host_rng=np.random.default_rng(43))


def test_jax_proof_verifies_in_port():
    _, ring, kp, _, _, _ = crossing()
    items = ref_zk.proof_to_arrays(jax_proof())
    assert zk.verify_proof(ring, kp.pk_a, kp.pk_b, convert.to_proof(ring, items), v=V)
    assert zk.verify_proof(ring, kp.pk_a, kp.pk_b, zk.proof_from_arrays(items, device=CPU), v=V,
                           expected_u=3)


def test_port_proof_verifies_in_jax():
    ref, ring, kp, ref_pk, _, pts = crossing()
    proof = zk.encrypt_and_prove_batch(ring, kp.pk_a, kp.pk_b, pts,
                                       torch.Generator().manual_seed(44), v=V,
                                       host_rng=np.random.default_rng(45))
    assert ref_zk.verify_proof(ref, *ref_pk, ref_zk.proof_from_arrays(zk.proof_to_arrays(proof)),
                               v=V, expected_u=3)


def test_statement_tag_and_challenge_equal():
    ref, ring, kp, ref_pk, _, _ = crossing()
    proof = jax_proof()
    tag = zk._statement_tag(ring, kp.pk_a, kp.pk_b, V, 3)
    assert tag == ref_zk._statement_tag(ref, *ref_pk, V, 3)
    assert tag != zk._statement_tag(ring, kp.pk_b, kp.pk_a, V, 3)
    port_proof = convert.to_proof(ring, ref_zk.proof_to_arrays(proof))
    got = zk._challenge(port_proof.cts, port_proof.comm, V, 3, tag)
    assert (got == ref_zk._challenge(proof.cts, proof.comm, V, 3, tag)).all()
    assert got.shape == (V, 3) and set(np.unique(got)) <= {0, 1}


def test_word_helpers_equal():
    rng = np.random.default_rng(46)
    vals = _values(rng, 40)
    vals[:4] = [0, L // 2, L // 2 + 1, L - 1]
    got = zk.scalar_to_words(Scalar.from_ints(vals.reshape(4, 10), device=CPU))
    assert (got == ref_zk.scalar_to_words(RefScalar.from_ints(vals.reshape(4, 10)))).all()
    assert (zk.scalar_to_words(Scalar.from_ints(vals, device=CPU), centered=False)
            == ref_zk.scalar_to_words(RefScalar.from_ints(vals), centered=False)).all()
    small = rng.integers(-10, 11, (3, 7))
    assert (zk.small_to_words(torch.as_tensor(small)) == ref_zk.small_to_words(small)).all()
    lazy = rng.integers(-(1 << 56), 1 << 56, (5, 7, 6), dtype=np.int64)
    norm = zk.normalize_words(lazy)
    assert (norm == ref_zk.normalize_words(lazy)).all()
    assert (np.abs(norm[..., :-1]) <= 1 << 47).all()
    assert (zk.words_magnitude(lazy) == ref_zk.words_magnitude(lazy)).all()
    a = zk.sample_balanced_words(np.random.default_rng(47), (3, 5), 4)
    assert (a == ref_zk.sample_balanced_words(np.random.default_rng(47), (3, 5), 4)).all()
    assert zk.DIGIT_BOUND == ref_zk.DIGIT_BOUND and zk.W_PT == ref_zk.W_PT


# -- the port alone at PowerfulRing(35), as tests/test_powerful_zk.py -------


@functools.lru_cache(maxsize=None)
def prod_env():
    ring = powerful.PowerfulRing(35, device=CPU)
    gen = torch.Generator().manual_seed(50)
    kp = bgv_l.keygen_l(ring, gen)
    rng = np.random.default_rng(51)
    slots = [_values(rng, ring.slots) for _ in range(3)]
    pts = [bgv_l.encode_slots_l(ring, Scalar.from_ints(s, device=CPU)) for s in slots]
    proof = zk.encrypt_and_prove_batch(ring, kp.pk_a, kp.pk_b, pts, gen, v=V,
                                       host_rng=np.random.default_rng(52))
    return ring, kp, slots, proof


def _copy(proof):
    return zk.proof_from_arrays([np.array(a, copy=True) for a in zk.proof_to_arrays(proof)],
                                device=CPU)


def test_proof_verifies_and_decrypts():
    ring, kp, slots, proof = prod_env()
    assert proof.z.shape[0] == V
    assert zk.verify_proof(ring, kp.pk_a, kp.pk_b, proof, v=V)
    got = bgv_l.decode_slots_l(ring, bgv_l.decrypt_l(ring, kp.sk, proof.cts))
    assert got.to_ints() == [int(v) for s in slots for v in s]


def test_wire_roundtrip():
    ring, kp, _, proof = prod_env()
    items = zk.proof_to_arrays(proof)
    assert [a.dtype for a in items] == [np.uint32] * 4 + [np.int64] * 4
    assert zk.verify_proof(ring, kp.pk_a, kp.pk_b, zk.proof_from_arrays(items, device=CPU), v=V)
    assert zk.verify_proof(ring, kp.pk_a, kp.pk_b, convert.to_proof(ring, items), v=V)


@pytest.mark.parametrize("attr,idx", [("z", (0, 0, 0)), ("zu", (1, 1, 0)),
                                      ("ze0", (2, 0, 0)), ("ze1", (3, 2, 0))])
def test_tampered_response_rejected(attr, idx):
    ring, kp, _, proof = prod_env()
    bad = _copy(proof)
    getattr(bad, attr)[idx] += 1
    assert not zk.verify_proof(ring, kp.pk_a, kp.pk_b, bad, v=V)


def test_oversize_response_rejected():
    ring, kp, _, proof = prod_env()
    bad = _copy(proof)
    bad.z[0, 0, -1] = 1 << 62
    assert not zk.verify_proof(ring, kp.pk_a, kp.pk_b, bad, v=V)


def test_short_proof_rejected():
    ring, kp, _, proof = prod_env()
    short = zk.CiphertextWithProofW(
        proof.cts, bgv_l.CiphertextL(proof.comm.c0[:1], proof.comm.c1[:1]),
        proof.z[:1], proof.zu[:1], proof.ze0[:1], proof.ze1[:1])
    assert not zk.verify_proof(ring, kp.pk_a, kp.pk_b, short, v=V)


def test_wrong_u_rejected():
    ring, kp, _, proof = prod_env()
    assert zk.verify_proof(ring, kp.pk_a, kp.pk_b, proof, v=V, expected_u=3)
    assert not zk.verify_proof(ring, kp.pk_a, kp.pk_b, proof, v=V, expected_u=2)


def test_transplanted_pk_rejected():
    ring, kp, _, proof = prod_env()
    kp2 = bgv_l.keygen_l(ring, torch.Generator().manual_seed(99))
    assert not zk.verify_proof(ring, kp2.pk_a, kp2.pk_b, proof, v=V)


def test_wrapping_digit_rejected():
    """A value-preserving digit rewrite below -2^55 (same integer, same float
    magnitude) would wrap the exact lift; DIGIT_BOUND rejects it first."""
    ring, kp, _, proof = prod_env()
    bad = _copy(proof)
    bad.z[0, 0, 0] -= np.int64(1) << 56
    bad.z[0, 0, 1] += np.int64(1) << 8
    assert not zk.verify_proof(ring, kp.pk_a, kp.pk_b, bad, v=V)


def test_large_u_normalized_accepted():
    """U = 130 amortized ciphertexts: the prover's balanced digits keep an
    honest proof inside DIGIT_BOUND, and it verifies."""
    ring, kp, _, _ = prod_env()
    rng = np.random.default_rng(53)
    pts = [Scalar.from_ints(_values(rng, ring.phi), device=CPU) for _ in range(130)]
    proof = zk.encrypt_and_prove_batch(ring, kp.pk_a, kp.pk_b, pts,
                                       torch.Generator().manual_seed(54), v=8,
                                       host_rng=np.random.default_rng(55))
    assert int(np.abs(proof.z).max()) < zk.DIGIT_BOUND
    assert zk.verify_proof(ring, kp.pk_a, kp.pk_b, proof, v=8, expected_u=130)
