"""The port's t-generic prototype BGV (`ark_mpc_tpu_torch/offline/bgv/
params.py`, `rns.py`, `bgv.py`) against the JAX package's, on the CPU.

The parameter sets, the RNS arithmetic and every deterministic function
equal the reference's exactly (tolerance 0).  Keys and noise come from
`jax.random` in the reference and from a `torch.Generator` in the port, so
the two packages meet through exported values: given the same keys and
the same randomness (`encrypt_with_randomness`) the ciphertexts are equal,
and under one secret key each package decrypts the other's ciphertexts.
The five cases of `tests/test_bgv.py` run that way at `test_params(n=256)`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.offline.bgv import bgv as ref_bgv
from ark_mpc_tpu.offline.bgv import params as ref_params
from ark_mpc_tpu.offline.bgv import rns as ref_rns
from ark_mpc_tpu_torch.offline import bgv as port_pkg
from ark_mpc_tpu_torch.offline.bgv import bgv as port_bgv
from ark_mpc_tpu_torch.offline.bgv import params as port_params
from ark_mpc_tpu_torch.offline.bgv import rns as port_rns

torch.set_num_threads(1)

N = 256


@pytest.fixture(scope="module")
def pp():
    return port_params.test_params(N, device="cpu")


@pytest.fixture(scope="module")
def rp():
    return ref_params.test_params(N)


@pytest.fixture(scope="module")
def keys(rp, pp):
    """The reference's key pair, and the same keys in the port."""
    kp = ref_bgv.keygen(rp, jax.random.PRNGKey(0))
    port_kp = port_bgv.Keypair(pp, *(to_port(x) for x in (kp.sk, kp.pk_a, kp.pk_b)))
    return kp, port_kp


def to_port(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def to_ref(x) -> jnp.ndarray:
    return jnp.asarray(x.numpy().astype(np.uint32))


def ref_ct(ct: port_bgv.Ciphertext) -> ref_bgv.Ciphertext:
    return ref_bgv.Ciphertext(to_ref(ct.c0), to_ref(ct.c1))


def port_ct(ct: ref_bgv.Ciphertext) -> port_bgv.Ciphertext:
    return port_bgv.Ciphertext(to_port(ct.c0), to_port(ct.c1))


def assert_same_ct(got: port_bgv.Ciphertext, want: ref_bgv.Ciphertext) -> None:
    np.testing.assert_array_equal(got.c0.numpy(), np.asarray(want.c0).astype(np.int64))
    np.testing.assert_array_equal(got.c1.numpy(), np.asarray(want.c1).astype(np.int64))


def slots(rng, p, shape=None):
    return rng.integers(0, p.t, size=shape or p.n, dtype=np.uint32)


@pytest.mark.parametrize("n", [256, 1024])
def test_params_match_reference(n):
    got, want = port_params.test_params(n, device="cpu"), ref_params.test_params(n)
    assert (got.t, got.q_primes, got.q, got.q_hat, got.q_hat_inv) == (
        want.t, want.q_primes, want.q, want.q_hat, want.q_hat_inv)
    assert got.slots == want.slots == n
    assert got.max_drown_noise_bits() == want.max_drown_noise_bits()
    assert got.to_dict() == want.to_dict()
    back = port_params.BgvParams.from_dict(want.to_dict(), device="cpu")
    assert back == got and hash(back) == hash(got) == hash(want)
    assert port_params.DEFAULT_DROWN_SEC == ref_params.DEFAULT_DROWN_SEC
    with pytest.raises(RuntimeError, match="CUDA"):
        port_params.test_params(n)


def test_rns_deterministic_functions_match_reference(rp, pp):
    rng = np.random.default_rng(31)
    a = np.stack([rng.integers(0, q, size=(2, N)) for q in pp.q_primes], axis=1)
    b = np.stack([rng.integers(0, q, size=(2, N)) for q in pp.q_primes], axis=1)
    ja, jb = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("rns_add", "rns_sub", "rns_mul"):
        got = getattr(port_rns, name)(pp, ta, tb)
        np.testing.assert_array_equal(got.numpy(), to_port(getattr(ref_rns, name)(rp, ja, jb)))
    np.testing.assert_array_equal(port_rns.rns_neg(pp, ta).numpy(),
                                  to_port(ref_rns.rns_neg(rp, ja)))
    for scalar in (pp.t, 1 << 90, 7):
        np.testing.assert_array_equal(port_rns.rns_scalar_mul(pp, ta, scalar).numpy(),
                                      to_port(ref_rns.rns_scalar_mul(rp, ja, scalar)))
    assert port_rns.zero(pp, (3,)).shape == ref_rns.zero(rp, (3,)).shape
    # signed coefficients over the whole int32 range: below -q_i the
    # reference's uint32 cast wraps, and the port's lift does the same
    signed = rng.integers(-(1 << 31), 1 << 31, size=(3, N)).astype(np.int32)
    signed[0, :8] = [-1, 0, 1, -(1 << 31), (1 << 31) - 1, -pp.q_primes[0], -pp.q_primes[0] - 1, 5]
    np.testing.assert_array_equal(port_rns.from_signed_coeffs(pp, signed).numpy(),
                                  to_port(ref_rns.from_signed_coeffs(rp, signed)))
    pt = slots(rng, pp, (3, N))
    pt[0, :3] = [0, pp.t // 2, pp.t // 2 + 1]
    np.testing.assert_array_equal(port_rns.from_plaintext(pp, pt).numpy(),
                                  to_port(ref_rns.from_plaintext(rp, pt)))
    assert port_rns.to_ints(pp, ta[0]) == ref_rns.to_ints(rp, ja[0])


def test_samplers_give_the_reference_distributions_ranges_and_shapes(pp):
    """The samplers are checked for range and shape (the streams are not
    the reference's): residues below their primes, ternary, centred
    binomial within +-k and bounded uniform within +-2^bits, each the same
    again from the same generator seed."""
    gen = torch.Generator().manual_seed(5)
    q_col = torch.tensor(pp.q_primes).reshape(-1, 1)
    u = port_rns.sample_uniform(pp, gen, (2,))
    assert u.shape == (2, len(pp.q_primes), N) and bool(((u >= 0) & (u < q_col)).all())
    for fn, bound in ((port_rns.sample_ternary, 1), (port_rns.sample_cbd, pp.cbd_k)):
        x = fn(pp, gen, (2,))
        assert x.shape == (2, len(pp.q_primes), N)
        vals = port_rns.to_ints(pp, x[0])
        assert max(abs(v) for v in vals) <= bound and min(vals) < 0 < max(vals)
    for bits in (20, 84):
        vals = port_rns.to_ints(pp, port_rns.sample_uniform_bounded(pp, gen, bits))
        assert max(abs(v) for v in vals) <= 1 << bits
        assert max(abs(v) for v in vals) > 1 << (bits - 4)
    again = port_rns.sample_uniform(pp, torch.Generator().manual_seed(5), (2,))
    assert torch.equal(again, u)


def test_slot_encoding_matches_reference(rp, pp):
    rng = np.random.default_rng(32)
    s = slots(rng, pp, (2, N))
    enc = port_bgv.encode_slots(pp, s)
    np.testing.assert_array_equal(enc.numpy(), to_port(ref_bgv.encode_slots(rp, s)))
    np.testing.assert_array_equal(port_bgv.decode_slots(pp, enc).numpy(),
                                  to_port(ref_bgv.decode_slots(rp, to_ref(enc))))
    assert port_bgv.decode_slots(pp, enc).tolist() == s.astype(np.int64).tolist()


def test_encrypt_with_randomness_matches_reference(rp, pp, keys):
    """The reference's encryption randomness, exported: the port's
    ciphertexts equal the reference's bit for bit, batched too, and so do
    ct + ct, ct + pt and ct x pt."""
    kp, pkp = keys
    rng = np.random.default_rng(33)
    pt = slots(rng, pp, (2, N))
    ct, (u, e0, e1) = ref_bgv.encrypt(rp, kp.pk_a, kp.pk_b, pt, jax.random.PRNGKey(9),
                                      return_randomness=True)
    got = port_bgv.encrypt_with_randomness(
        pp, pkp.pk_a, pkp.pk_b, port_rns.from_plaintext(pp, pt),
        *(port_rns.from_signed_coeffs(pp, to_port(r)) for r in (u, e0, e1)))
    assert_same_ct(got, ct)
    other = slots(rng, pp)
    assert_same_ct(port_bgv.add_ct(pp, got, got), ref_bgv.add_ct(rp, ct, ct))
    assert_same_ct(port_bgv.add_pt(pp, got, other), ref_bgv.add_pt(rp, ct, other))
    assert_same_ct(port_bgv.mul_pt(pp, got, other), ref_bgv.mul_pt(rp, ct, other))


def test_encrypt_decrypt_roundtrip(rp, pp, keys):
    """`test_bgv.py`'s first case, across the packages: the port's
    ciphertext decrypts to the plaintext in both, and so does the
    reference's in the port."""
    kp, pkp = keys
    rng = np.random.default_rng(34)
    pt = slots(rng, pp)
    ct = port_bgv.encrypt(pp, pkp.pk_a, pkp.pk_b, pt, torch.Generator().manual_seed(1))
    assert port_bgv.decrypt(pp, pkp.sk, ct).tolist() == pt.tolist()
    assert ref_bgv.decrypt(rp, kp.sk, ref_ct(ct)).tolist() == pt.tolist()
    ct_ref = ref_bgv.encrypt(rp, kp.pk_a, kp.pk_b, pt, jax.random.PRNGKey(1))
    assert port_bgv.decrypt(pp, pkp.sk, port_ct(ct_ref)).tolist() == pt.tolist()


def test_slot_roundtrip_and_add(rp, pp, keys):
    kp, pkp = keys
    rng = np.random.default_rng(35)
    a, b = slots(rng, pp), slots(rng, pp)
    gen = torch.Generator().manual_seed(2)
    ca = port_bgv.encrypt_slots(pp, pkp.pk_a, pkp.pk_b, a, gen)
    cb = port_ct(ref_bgv.encrypt_slots(rp, kp.pk_a, kp.pk_b, b, jax.random.PRNGKey(3)))
    want = ((a.astype(np.uint64) + b) % pp.t).tolist()
    total = port_bgv.add_ct(pp, ca, cb)
    assert port_bgv.decrypt_slots(pp, pkp.sk, total).tolist() == want
    assert ref_bgv.decrypt_slots(rp, kp.sk, ref_ct(total)).tolist() == want


def test_ct_pt_slotwise_product(rp, pp, keys):
    kp, pkp = keys
    rng = np.random.default_rng(36)
    a, b = slots(rng, pp), slots(rng, pp)
    ca = port_bgv.encrypt_slots(pp, pkp.pk_a, pkp.pk_b, a, torch.Generator().manual_seed(4))
    prod = port_bgv.mul_pt(pp, ca, port_bgv.encode_slots(pp, b))
    want = (a.astype(object) * b.astype(object) % pp.t).tolist()
    assert port_bgv.decrypt_slots(pp, pkp.sk, prod).astype(object).tolist() == want
    assert ref_bgv.decrypt_slots(rp, kp.sk, ref_ct(prod)).astype(object).tolist() == want


def test_add_pt_and_rerandomize(rp, pp, keys):
    kp, pkp = keys
    rng = np.random.default_rng(37)
    a, b = slots(rng, pp), slots(rng, pp)
    gen = torch.Generator().manual_seed(5)
    ca = port_bgv.encrypt_slots(pp, pkp.pk_a, pkp.pk_b, a, gen)
    ca = port_bgv.add_pt(pp, ca, port_bgv.encode_slots(pp, b))
    drowned = port_bgv.rerandomize(pp, pkp.pk_a, pkp.pk_b, ca, gen)
    assert not torch.equal(drowned.c0, ca.c0)
    want = ((a.astype(np.uint64) + b) % pp.t).tolist()
    assert port_bgv.decrypt_slots(pp, pkp.sk, drowned).tolist() == want
    assert ref_bgv.decrypt_slots(rp, kp.sk, ref_ct(drowned)).tolist() == want


def test_share_product_shape(rp, pp, keys):
    """The LowGear core step: enc(a) x b - mask, drowned, decrypts to
    a b - mask slot-wise, in both packages."""
    kp, pkp = keys
    rng = np.random.default_rng(38)
    a, b, mask = slots(rng, pp), slots(rng, pp), slots(rng, pp)
    gen = torch.Generator().manual_seed(7)
    ca = port_bgv.encrypt_slots(pp, pkp.pk_a, pkp.pk_b, a, gen)
    prod = port_bgv.mul_pt(pp, ca, port_bgv.encode_slots(pp, b))
    masked = port_bgv.add_pt(pp, prod, port_bgv.encode_slots(pp, (pp.t - mask) % pp.t))
    masked = port_bgv.rerandomize(pp, pkp.pk_a, pkp.pk_b, masked, gen)
    want = ((a.astype(object) * b - mask) % pp.t).tolist()
    assert port_bgv.decrypt_slots(pp, pkp.sk, masked).astype(object).tolist() == want
    assert ref_bgv.decrypt_slots(rp, kp.sk, ref_ct(masked)).astype(object).tolist() == want


def test_port_keys_decrypt_in_the_reference(rp, pp):
    """A key pair made by the port works in the reference: its
    encryptions decrypt there, and the reference's under the port's public
    key decrypt in the port."""
    kp = port_bgv.keygen(pp, torch.Generator().manual_seed(11))
    rng = np.random.default_rng(39)
    a = slots(rng, pp)
    ct = port_bgv.encrypt_slots(pp, kp.pk_a, kp.pk_b, a, torch.Generator().manual_seed(12))
    assert ref_bgv.decrypt_slots(rp, to_ref(kp.sk), ref_ct(ct)).tolist() == a.tolist()
    ct_ref = ref_bgv.encrypt_slots(rp, to_ref(kp.pk_a), to_ref(kp.pk_b), a,
                                   jax.random.PRNGKey(12))
    assert port_bgv.decrypt_slots(pp, kp.sk, port_ct(ct_ref)).tolist() == a.tolist()


def test_package_exports_the_reference_names():
    import ark_mpc_tpu.offline.bgv as ref_pkg

    assert set(ref_pkg.__all__) <= set(port_pkg.__all__)
    for name in ref_pkg.__all__:
        assert callable(getattr(port_pkg, name)), name


def test_drowning_at_n_1024_always_decrypts():
    """At `test_params()` (N = 1024) 30 rerandomized encryptions all decrypt
    and the drowning noise stays within +-2^bits: the port lifts each 30-bit
    noise word exactly.  The reference's lift wraps words below -q_i
    through 2^32 (`ark_mpc_tpu/offline/bgv/rns.py:79-81`), which fails
    some decryptions at this size (`tests/_drowning_rate.py` counts them),
    so 30 in a row would rarely pass there."""
    p = port_params.test_params(device="cpu")
    gen = torch.Generator().manual_seed(21)
    kp = port_bgv.keygen(p, gen)
    rng = np.random.default_rng(40)
    bits = p.drown_sec + 20
    noise = port_rns.sample_uniform_bounded(p, gen, bits, (30,))
    for row in noise:
        assert max(abs(v) for v in port_rns.to_ints(p, row)) <= 1 << bits
    for _ in range(30):
        a = slots(rng, p)
        ct = port_bgv.encrypt_slots(p, kp.pk_a, kp.pk_b, a, gen)
        drowned = port_bgv.rerandomize(p, kp.pk_a, kp.pk_b, ct, gen)
        assert port_bgv.decrypt_slots(p, kp.sk, drowned).tolist() == a.tolist()
