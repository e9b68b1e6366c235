"""The port's prototype proofs of plaintext knowledge (`ark_mpc_tpu_torch/
offline/bgv/zkpok.py` over the t-generic BGV, `zkpok_l.py` over l) against
the JAX package's, on the CPU.

Proofs must cross between the packages: the Fiat-Shamir challenge hashes
the keys' and ciphertexts' residues as the reference's uint32 arrays, so
the challenge bits are equal for the same inputs, a proof made by either
package verifies in the other, and the wire forms are equal.  The cases of
`tests/test_zkpok.py` (completeness and three rejections) run at
`test_params(n=256)`.  The l-field proof's JAX prover takes minutes (the
reference's `tests/test_zkpok_l.py` is slow), so its cross-verification is
slow here too; its challenge bits, its wire form and the port's own
prover run in the fast tier.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.offline.bgv import bgv as ref_bgv
from ark_mpc_tpu.offline.bgv import params as ref_params
from ark_mpc_tpu.offline.bgv import zkpok as ref_zk
from ark_mpc_tpu.offline.bgv import zkpok_l as ref_zkl
from ark_mpc_tpu_torch.offline.bgv import bgv as port_bgv
from ark_mpc_tpu_torch.offline.bgv import params as port_params
from ark_mpc_tpu_torch.offline.bgv import zkpok as port_zk
from ark_mpc_tpu_torch.offline.bgv import zkpok_l as port_zkl

torch.set_num_threads(1)

N, V, U = 256, 16, 3


def to_port(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def to_ref(x) -> jnp.ndarray:
    return jnp.asarray(x.numpy().astype(np.uint32))


@pytest.fixture(scope="module")
def setting():
    """(ref params, port params, ref key pair, port key pair: the same keys)."""
    rp, pp = ref_params.test_params(N), port_params.test_params(N, device="cpu")
    kp = ref_bgv.keygen(rp, jax.random.PRNGKey(0))
    pkp = port_bgv.Keypair(pp, *(to_port(x) for x in (kp.sk, kp.pk_a, kp.pk_b)))
    return rp, pp, kp, pkp


@pytest.fixture(scope="module")
def plaintexts():
    return np.random.default_rng(11).integers(0, port_params.test_params(
        N, device="cpu").t, size=(U, N), dtype=np.uint32)


@pytest.fixture(scope="module")
def port_proof(setting, plaintexts):
    _, pp, _, pkp = setting
    return port_zk.encrypt_and_prove_batch(pp, pkp.pk_a, pkp.pk_b, plaintexts,
                                           torch.Generator().manual_seed(1), sec=40, v=V,
                                           host_rng=np.random.default_rng(2))


@pytest.fixture(scope="module")
def ref_proof(setting, plaintexts):
    rp, _, kp, _ = setting
    return ref_zk.encrypt_and_prove_batch(rp, kp.pk_a, kp.pk_b, plaintexts,
                                          jax.random.PRNGKey(1), sec=40, v=V,
                                          host_rng=np.random.default_rng(2))


def as_ref(proof: port_zk.CiphertextWithProof) -> ref_zk.CiphertextWithProof:
    return ref_zk.proof_from_arrays(port_zk.proof_to_arrays(proof), *proof.z.shape)


def test_challenge_bits_match_reference(setting, port_proof):
    rp, pp, kp, pkp = setting
    got = port_zk._challenge_matrix(pp, port_proof.cts, port_proof.comm, V, U,
                                    pkp.pk_a, pkp.pk_b)
    r = as_ref(port_proof)
    want = ref_zk._challenge_matrix(rp, r.cts, r.comm, V, U, kp.pk_a, kp.pk_b)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (V, U) and 0 < got.sum() < V * U


def test_zkpok_completeness_and_decrypt(setting, plaintexts, port_proof):
    """The port's proof verifies in the port and in the reference, and its
    ciphertexts decrypt to the committed plaintexts in both."""
    rp, pp, kp, pkp = setting
    assert port_zk.verify_proof(pp, pkp.pk_a, pkp.pk_b, port_proof, sec=40)
    assert ref_zk.verify_proof(rp, kp.pk_a, kp.pk_b, as_ref(port_proof), sec=40)
    for i in range(U):
        ct = port_bgv.Ciphertext(port_proof.cts.c0[i], port_proof.cts.c1[i])
        assert port_bgv.decrypt(pp, pkp.sk, ct).tolist() == plaintexts[i].tolist()
        rct = ref_bgv.Ciphertext(to_ref(ct.c0), to_ref(ct.c1))
        assert ref_bgv.decrypt(rp, kp.sk, rct).tolist() == plaintexts[i].tolist()


def test_reference_proof_verifies_in_the_port(setting, ref_proof):
    _, pp, _, pkp = setting
    back = port_zk.proof_from_arrays(ref_zk.proof_to_arrays(ref_proof), V, N, device="cpu")
    assert port_zk.verify_proof(pp, pkp.pk_a, pkp.pk_b, back, sec=40)


def test_wire_form_matches_reference(port_proof):
    """The port's wire arrays are the reference's (uint32 residues, 16-byte
    responses), and the round trip gives the same proof."""
    arrays = port_zk.proof_to_arrays(port_proof)
    want = ref_zk.proof_to_arrays(as_ref(port_proof))
    assert [a.dtype if isinstance(a, np.ndarray) else type(a) for a in arrays] == [
        np.dtype(np.uint32)] * 4 + [bytes] + [np.dtype(np.int64)] * 3
    for got, w in zip(arrays, want):
        if isinstance(w, bytes):
            assert got == w
        else:
            np.testing.assert_array_equal(got, w)
    back = port_zk.proof_from_arrays(arrays, V, N, device="cpu")
    assert torch.equal(back.comm.c1, port_proof.comm.c1)
    assert (back.z == port_proof.z).all()


def tampered(proof, **fields):
    return dataclasses.replace(proof, **fields)


def rejects(setting, proof) -> bool:
    """Whether both packages reject `proof`."""
    rp, pp, kp, pkp = setting
    port_ok = port_zk.verify_proof(pp, pkp.pk_a, pkp.pk_b, proof, sec=40)
    ref_ok = ref_zk.verify_proof(rp, kp.pk_a, kp.pk_b, as_ref(proof), sec=40)
    return not port_ok and not ref_ok


def test_zkpok_rejects_tampered_ciphertext(setting, port_proof):
    c0 = port_proof.cts.c0.clone()
    c0[0, 0, 0] = (c0[0, 0, 0] + 1) % setting[1].q_primes[0]
    assert rejects(setting, tampered(port_proof, cts=port_bgv.Ciphertext(c0, port_proof.cts.c1)))


def test_zkpok_rejects_tampered_response(setting, port_proof):
    z = port_proof.z.copy()
    z[0, 0] = int(z[0, 0]) + 1
    assert rejects(setting, tampered(port_proof, z=z))


def test_zkpok_rejects_out_of_bound_witness(setting, port_proof):
    """A 'plaintext' far beyond the t/2 slack fails the bound check."""
    z = port_proof.z.copy()
    z[0, 0] = (1 << 40) * (setting[1].t // 2) * 100
    assert rejects(setting, tampered(port_proof, z=z))


# -- the l-field prototype proof ----------------------------------------------


def random_proof_l(rng, n_q=3, phi=40, v=4, u=2) -> port_zkl.CiphertextWithProofL:
    """A proof-shaped record of random residues and responses (for the
    challenge and the wire form, which read no ring)."""
    q = 1 << 30

    def res(lead):
        return torch.from_numpy(rng.integers(0, q, size=(lead, n_q, phi)))

    z = np.array([[int(x) << 200 for x in row]
                  for row in rng.integers(-(1 << 40), 1 << 40, size=(v, phi))], dtype=object)
    small = [rng.integers(-(1 << 40), 1 << 40, size=(v, phi)) for _ in range(3)]
    return port_zkl.CiphertextWithProofL(
        port_zkl.CiphertextL(res(u), res(u)), port_zkl.CiphertextL(res(v), res(v)), z, *small)


def test_l_proof_challenge_and_wire_form_match_reference():
    proof = random_proof_l(np.random.default_rng(13))
    arrays = port_zkl.proof_to_arrays_l(proof)
    r = ref_zkl.proof_from_arrays_l(arrays, *proof.z.shape)
    np.testing.assert_array_equal(port_zkl._challenge(None, proof.cts, proof.comm, 4, 2),
                                  ref_zkl._challenge(None, r.cts, r.comm, 4, 2))
    for got, want in zip(arrays, ref_zkl.proof_to_arrays_l(r)):
        if isinstance(want, bytes):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
    back = port_zkl.proof_from_arrays_l(arrays, *proof.z.shape, device="cpu")
    assert torch.equal(back.cts.c0, proof.cts.c0) and (back.z == proof.z).all()


@pytest.fixture(scope="module")
def ring_l():
    from ark_mpc_tpu_torch.offline.bgv.bgv_l import default_ring

    return default_ring(device="cpu")


def test_l_proof_completeness_serde_and_rejection(ring_l):
    """The port's prover and verifier at the port's smallest ring
    (`default_ring()`, m = 132): the proof verifies, also after the wire
    round trip, the proven ciphertexts decrypt to the committed slots, and
    a tampered ciphertext is rejected."""
    from ark_mpc_tpu_torch.algebra.scalar import Scalar
    from ark_mpc_tpu_torch.offline.bgv import bgv_l

    gen = torch.Generator().manual_seed(7)
    kp = bgv_l.keygen_l(ring_l, gen)
    rng = np.random.default_rng(13)
    slots = [Scalar.random(ring_l.slots, rng, device="cpu") for _ in range(2)]
    proof = port_zkl.encrypt_and_prove_batch_l(
        ring_l, kp.pk_a, kp.pk_b, [bgv_l.encode_slots_l(ring_l, s) for s in slots], gen,
        v=16, host_rng=np.random.default_rng(8))
    assert port_zkl.verify_proof_l(ring_l, kp.pk_a, kp.pk_b, proof)
    back = port_zkl.proof_from_arrays_l(port_zkl.proof_to_arrays_l(proof), 16, ring_l.phi,
                                        device="cpu")
    assert port_zkl.verify_proof_l(ring_l, kp.pk_a, kp.pk_b, back)
    for i, s in enumerate(slots):
        ct = bgv_l.CiphertextL(proof.cts.c0[i], proof.cts.c1[i])
        got = bgv_l.decode_slots_l(ring_l, bgv_l.decrypt_l(ring_l, kp.sk, ct))
        assert got.to_ints() == s.to_ints()
    c0 = proof.cts.c0.clone()
    c0[0, 0, 0] = (c0[0, 0, 0] + 1) % ring_l.q_primes[0]
    bad = dataclasses.replace(proof, cts=bgv_l.CiphertextL(c0, proof.cts.c1))
    assert not port_zkl.verify_proof_l(ring_l, kp.pk_a, kp.pk_b, bad)


@pytest.mark.slow
def test_l_proofs_verify_across_the_packages(ring_l):
    """Under one key pair (the reference's, exported), the reference's
    proof verifies in the port and the port's in the reference (minutes:
    the JAX prover and verifier at m = 132 with 21 primes)."""
    from ark_mpc_tpu.algebra.scalar import Scalar as RefScalar
    from ark_mpc_tpu.offline.bgv import bgv_l as ref_bgv_l
    from ark_mpc_tpu_torch.algebra.scalar import Scalar
    from ark_mpc_tpu_torch.offline.bgv import bgv_l

    ref_ring = ref_bgv_l.default_ring()
    kp = ref_bgv_l.keygen_l(ref_ring, jax.random.PRNGKey(0))
    pk_a, pk_b = to_port(kp.pk_a), to_port(kp.pk_b)
    rng = np.random.default_rng(13)
    slots = [Scalar.random(ring_l.slots, rng, device="cpu") for _ in range(2)]
    coeffs = [bgv_l.encode_slots_l(ring_l, s) for s in slots]
    proof = port_zkl.encrypt_and_prove_batch_l(ring_l, pk_a, pk_b, coeffs,
                                               torch.Generator().manual_seed(7), v=16,
                                               host_rng=np.random.default_rng(8))
    as_ref_l = ref_zkl.proof_from_arrays_l(port_zkl.proof_to_arrays_l(proof), 16, ring_l.phi)
    assert ref_zkl.verify_proof_l(ref_ring, kp.pk_a, kp.pk_b, as_ref_l)
    ref_coeffs = [RefScalar(jnp.asarray(c.limbs.numpy().astype(np.uint32))) for c in coeffs]
    rproof = ref_zkl.encrypt_and_prove_batch_l(ref_ring, kp.pk_a, kp.pk_b, ref_coeffs,
                                               jax.random.PRNGKey(7), v=16,
                                               host_rng=np.random.default_rng(8))
    back = port_zkl.proof_from_arrays_l(ref_zkl.proof_to_arrays_l(rproof), 16, ring_l.phi,
                                        device="cpu")
    assert port_zkl.verify_proof_l(ring_l, pk_a, pk_b, back)
