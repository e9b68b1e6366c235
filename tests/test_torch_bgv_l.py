"""BGV over l in the port (`offline/bgv/bgv_l.py`) against the JAX package
at `PowerfulRing(35)` (phi = 24, 12 GF(l^2) slots, production noise
parameters): a JAX keypair and relinearization key exported into the port,
identical ciphertexts from injected randomness, identical homomorphic ops,
decryption across the packages, and the port's own key generation.

Keys and noise come from `jax.random` in the reference and from a
`torch.Generator` in the port, so values cross through `convert` and
`encrypt_with_randomness_l`, never through equal random streams."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.algebra.scalar import Scalar as RefScalar
from ark_mpc_tpu.offline.bgv import bgv_l as ref_bgv
from ark_mpc_tpu.offline.bgv import powerful as ref_pow
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.algebra.fields import CURVE25519_ORDER as L
from ark_mpc_tpu_torch.algebra.scalar import Scalar
from ark_mpc_tpu_torch.offline.bgv import bgv_l, powerful

torch.set_num_threads(1)

CPU = torch.device("cpu")


class Env:
    """One ring in both packages, a JAX keypair exported into the port, and
    three slot vectors encoded in both."""

    def __init__(self):
        self.ref = ref_pow.PowerfulRing(35)
        self.ring = powerful.PowerfulRing(35, device=CPU)
        self.ref_kp = ref_bgv.keygen_l(self.ref, jax.random.PRNGKey(0))
        self.kp = convert.to_keypair(self.ring, convert.from_keypair(self.ref_kp))
        rng = np.random.default_rng(21)
        self.slots = [[int(v) * (L // 3) % L for v in rng.integers(0, 1 << 62, 12, dtype=np.int64)]
                      for _ in range(3)]
        self.ref_pts = [ref_bgv.encode_slots_l(self.ref, RefScalar.from_ints(s)) for s in self.slots]
        self.pts = [bgv_l.encode_slots_l(self.ring, Scalar.from_ints(s, device=CPU))
                    for s in self.slots]

    def port_ct(self, ct):
        return convert.to_ciphertext(self.ring, convert.from_ciphertext(ct))

    def decode(self, ct) -> list:
        """Slots of a port ciphertext, decrypted by the port."""
        return bgv_l.decode_slots_l(self.ring, bgv_l.decrypt_l(self.ring, self.kp.sk, ct)).to_ints()

    def ref_decode(self, ct) -> list:
        """Slots of a port ciphertext (L, phi), decrypted by the JAX package."""
        ref_ct = ref_bgv.CiphertextL(*(jnp.asarray(a) for a in convert.from_ciphertext(ct)))
        return ref_bgv.decode_slots_l(
            self.ref, ref_bgv.decrypt_l(self.ref, self.ref_kp.sk, ref_ct)).to_ints()


@functools.lru_cache(maxsize=None)
def env() -> Env:
    return Env()


@functools.lru_cache(maxsize=None)
def ring6():
    """The reference's 6-prime m = 35 ring (too small a modulus to decrypt
    products): homomorphic ops are compared on random residues there, where
    the JAX package compiles them quickly."""
    return ref_pow.PowerfulRing(35, n_q_primes=6), powerful.PowerfulRing(35, n_q_primes=6, device=CPU)


def _same(a, b) -> bool:
    return bool((convert.residues_to_numpy(a) == convert.residues_to_numpy(b)).all())


def _same_ct(ref_ct, ct) -> bool:
    return (tuple(ref_ct.c0.shape) == tuple(ct.c0.shape)
            and _same(ref_ct.c0, ct.c0) and _same(ref_ct.c1, ct.c1))


def _mul(xs, ys) -> list:
    return [x * y % L for x, y in zip(xs, ys)]


def test_jax_keypair_runs_in_port():
    """The exported JAX keypair encrypts and decrypts in the port, and the
    JAX package decrypts the port's ciphertext."""
    e = env()
    gen = torch.Generator().manual_seed(22)
    ct = bgv_l.encrypt_l(e.ring, e.kp.pk_a, e.kp.pk_b, e.pts[0], gen)
    assert e.decode(ct) == e.slots[0]
    assert e.ref_decode(ct) == e.slots[0]


@functools.lru_cache(maxsize=None)
def _injected():
    """Slots 0 and 1 encrypted by both packages with the same injected
    randomness (u, e0, e1) -> (JAX ciphertexts, port ciphertexts)."""
    e = env()
    rng = np.random.default_rng(23)
    u = rng.integers(-1, 2, (2, e.ring.phi)).astype(np.int32)
    e0, e1 = (rng.integers(-10, 11, (2, e.ring.phi)).astype(np.int32) for _ in range(2))
    pts = RefScalar.concatenate([p.reshape(1, e.ring.phi) for p in e.ref_pts[:2]])
    pts_port = Scalar.concatenate([p.reshape(1, e.ring.phi) for p in e.pts[:2]])
    want = ref_bgv.encrypt_with_randomness_l(
        e.ref, e.ref_kp.pk_a, e.ref_kp.pk_b, ref_bgv._pt_to_rns(e.ref, pts),
        *(e.ref.lift_signed(jnp.asarray(x)) for x in (u, e0, e1)))
    got = bgv_l.encrypt_with_randomness_l(
        e.ring, e.kp.pk_a, e.kp.pk_b, bgv_l._pt_to_rns(e.ring, pts_port),
        *(e.ring.lift_signed(torch.as_tensor(x)) for x in (u, e0, e1)))
    return want, got


def test_encrypt_with_injected_randomness_identical():
    want, got = _injected()
    assert _same_ct(want, got)


def test_port_decrypts_jax_ciphertexts():
    e = env()
    want, _ = _injected()
    cts = e.port_ct(want)
    for i in range(2):
        assert e.decode(bgv_l.CiphertextL(cts.c0[i], cts.c1[i])) == e.slots[i]
    # one batched decryption gives both
    batched = bgv_l.decrypt_l(e.ring, e.kp.sk, cts)
    assert bgv_l.decode_slots_l(e.ring, batched).to_ints() == e.slots[0] + e.slots[1]


def _random_ct(ring, rng, batch=()):
    return [np.stack([rng.integers(0, q, batch + (ring.phi,)) for q in ring.q_primes], axis=-2)
            for _ in range(2)]


@pytest.mark.parametrize("op", ["add_ct_l", "add_pt_l", "mul_pt_l"])
def test_homomorphic_ops_identical(op):
    ref, ring = ring6()
    rng = np.random.default_rng(24)
    ca, cb = (_random_ct(ring, rng, (2,)) for _ in range(2))
    ref_ca, ref_cb = (ref_bgv.CiphertextL(*(jnp.asarray(a.astype(np.uint32)) for a in c))
                      for c in (ca, cb))
    ca, cb = (convert.to_ciphertext(ring, c) for c in (ca, cb))
    if op == "add_ct_l":
        want, got = ref_bgv.add_ct_l(ref, ref_ca, ref_cb), bgv_l.add_ct_l(ring, ca, cb)
    else:
        vals = np.array([int(v) * (L // 11) % L for v in
                         rng.integers(0, 1 << 62, 2 * ring.phi, dtype=np.int64)], dtype=object)
        pt_ref = RefScalar.from_ints(vals.reshape(2, ring.phi))
        pt = Scalar.from_ints(vals.reshape(2, ring.phi), device=CPU)
        want = getattr(ref_bgv, op)(ref, ref_ca, pt_ref)
        got = getattr(bgv_l, op)(ring, ca, pt)
    assert _same_ct(want, got)


def test_rerandomize_decrypts_in_both():
    """The port's drowning (sec 128) of a ct x pt product of a JAX
    ciphertext decrypts to the product slot-wise in both packages."""
    e = env()
    want, _ = _injected()
    ca = e.port_ct(ref_bgv.CiphertextL(want.c0[0], want.c1[0]))
    gen = torch.Generator().manual_seed(25)
    prod = bgv_l.mul_pt_l(e.ring, ca, e.pts[1])
    drowned = bgv_l.rerandomize_l(e.ring, e.kp.pk_a, e.kp.pk_b, prod, gen)
    assert not _same(prod.c0, drowned.c0)
    product = _mul(e.slots[0], e.slots[1])
    assert e.decode(drowned) == product
    assert e.ref_decode(drowned) == product


def test_mul_ct_with_jax_relin_key_identical():
    """The JAX package's relinearization key, exported, gives the same
    ct x ct product in the port (on random residues at the 6-prime ring;
    `test_port_keygen_and_noise_ranges` decrypts a product)."""
    ref, ring = ring6()
    rng = np.random.default_rng(26)
    sk = ring.lift_signed(torch.as_tensor(rng.integers(-1, 2, ring.phi)))
    ref_rlk = ref_bgv.gen_relin_key_l(ref, jnp.asarray(convert.residues_to_numpy(sk)),
                                      jax.random.PRNGKey(26))
    rlk = convert.to_relin_key(ring, convert.from_relin_key(ref_rlk))
    ca, cb = (_random_ct(ring, rng) for _ in range(2))
    want = ref_bgv.mul_ct_l(ref, ref_rlk, *(ref_bgv.CiphertextL(
        *(jnp.asarray(a.astype(np.uint32)) for a in c)) for c in (ca, cb)))
    got = bgv_l.mul_ct_l(ring, rlk, *(convert.to_ciphertext(ring, c) for c in (ca, cb)))
    assert _same_ct(want, got)


def test_port_keygen_and_noise_ranges():
    """The port's own keys: a ternary secret, b + a s = l e with |e| <= 10,
    a relinearization key that works, and samplers in the reference's
    ranges."""
    ring = env().ring
    gen = torch.Generator().manual_seed(27)
    kp = bgv_l.keygen_l(ring, gen)
    assert set(ring.to_centered_ints(kp.sk)) <= {-1, 0, 1}
    noise = ring.to_centered_ints(ring.add(kp.pk_b, ring.mul(kp.pk_a, kp.sk)))
    assert all(v % L == 0 and abs(v // L) <= ring.cbd_k for v in noise)
    _, tern = bgv_l._sample_ternary(ring, gen, (50,))
    _, cbd = bgv_l._sample_cbd(ring, gen, (50,))
    assert set(tern.unique().tolist()) == {-1, 0, 1}
    assert int(cbd.abs().max()) <= ring.cbd_k
    uni = bgv_l._sample_uniform(ring, gen, (3,))
    assert bool((uni >= 0).all()) and bool((uni < ring._q).all())
    e = env()
    ct = bgv_l.encrypt_l(ring, kp.pk_a, kp.pk_b, e.pts[0], gen)
    rlk = bgv_l.gen_relin_key_l(ring, kp.sk, gen)
    sq = bgv_l.mul_ct_l(ring, rlk, ct, ct)
    got = bgv_l.decode_slots_l(ring, bgv_l.decrypt_l(ring, kp.sk, sq)).to_ints()
    assert got == _mul(e.slots[0], e.slots[0])


def test_entry_points_need_a_device(monkeypatch):
    """Without a card and without `device=`, the rings raise: nothing runs
    on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: powerful.PowerfulRing(35), bgv_l.default_ring,
                 bgv_l.medium_ring, bgv_l.production_ring):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_convert_rejects_bad_residues():
    ring = env().ring
    good = convert.from_keypair(env().kp)
    with pytest.raises(ValueError, match="canonical"):
        bad = [a.copy() for a in good]
        bad[1][0, 0] = ring.q_primes[0]
        convert.to_keypair(ring, bad)
    with pytest.raises(ValueError, match="residues must be"):
        convert.to_keypair(ring, [a[:, :-1] for a in good])


@pytest.mark.slow
def test_medium_ring_pipeline_matches():
    """m = 1155 (phi = 480, four axes): ct x pt, drowning and decryption
    with an exported JAX keypair; a JAX ciphertext's product is identical."""
    ref, ring = ref_bgv.medium_ring(), bgv_l.medium_ring(device=CPU)
    ref_kp = ref_bgv.keygen_l(ref, jax.random.PRNGKey(30))
    kp = convert.to_keypair(ring, convert.from_keypair(ref_kp))
    rng = np.random.default_rng(31)
    a, b = ([int(v) * (L // 3) % L for v in rng.integers(0, 1 << 62, ring.slots, dtype=np.int64)]
            for _ in range(2))
    ref_ct = ref_bgv.encrypt_l(ref, ref_kp.pk_a, ref_kp.pk_b,
                               ref_bgv.encode_slots_l(ref, RefScalar.from_ints(a)),
                               jax.random.PRNGKey(32))
    pt_b = bgv_l.encode_slots_l(ring, Scalar.from_ints(b, device=CPU))
    want = ref_bgv.mul_pt_l(ref, ref_ct, ref_bgv.encode_slots_l(ref, RefScalar.from_ints(b)))
    got = bgv_l.mul_pt_l(ring, convert.to_ciphertext(ring, convert.from_ciphertext(ref_ct)), pt_b)
    assert _same_ct(want, got)
    drowned = bgv_l.rerandomize_l(ring, kp.pk_a, kp.pk_b, got, torch.Generator().manual_seed(33))
    out = bgv_l.decode_slots_l(ring, bgv_l.decrypt_l(ring, kp.sk, drowned)).to_ints()
    assert out == _mul(a, b)
