"""The BGV-over-l rings in the port (`offline/bgv/cyclotomic.py`,
`offline/bgv/powerful.py`) against the JAX package, exactly: every
precomputed constant, and every ring operation on the same inputs.

Rings: `PowerfulRing(35)` (phi = 24, d = 2, 12 slots, production noise
parameters, 29 primes), the m = 132 prototype `CyclotomicRing` (d = 1) and
the m = 35 prototype (d = 2), as in the reference's fast tests.  Inputs are
drawn from seeded numpy generators and cross as uint32 / limb arrays.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.algebra.scalar import Scalar as RefScalar
from ark_mpc_tpu.offline.bgv import bgv_l as ref_bgv
from ark_mpc_tpu.offline.bgv import cyclotomic as ref_cyc
from ark_mpc_tpu.offline.bgv import powerful as ref_pow
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.fields import CURVE25519_ORDER as L
from ark_mpc_tpu_torch.algebra.scalar import Scalar
from ark_mpc_tpu_torch.offline.bgv import bgv_l, cyclotomic, powerful

torch.set_num_threads(1)

CPU = torch.device("cpu")
RINGS = {
    "powerful35": lambda: (ref_pow.PowerfulRing(35), powerful.PowerfulRing(35, device=CPU)),
    "cyclotomic132": lambda: (ref_bgv.default_ring(), bgv_l.default_ring(device=CPU)),
    "cyclotomic35": lambda: (ref_cyc.CyclotomicRing(35, n_q_primes=21),
                             cyclotomic.CyclotomicRing(35, n_q_primes=21, device=CPU)),
}
WORD_RING = {"powerful35_6": lambda: (ref_pow.PowerfulRing(35, n_q_primes=6),
                                      powerful.PowerfulRing(35, n_q_primes=6, device=CPU))}


ALL = list(RINGS)
MAIN = ["powerful35", "cyclotomic132"]   # the m = 35 prototype shares m = 132's code


@functools.lru_cache(maxsize=None)
def _rings(name: str):
    return {**RINGS, **WORD_RING}[name]()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x).astype(np.int64)


def _same(want, got) -> bool:
    want, got = _np(want), _np(got)
    return want.shape == got.shape and bool((want == got).all())


def _residues(ring, rng, batch=(2,)) -> np.ndarray:
    return np.stack([rng.integers(0, q, batch + (ring.phi,)) for q in ring.q_primes], axis=-2)


def _pair(arr):
    """One residue array for both packages: (uint32 jax, int64 torch)."""
    return jnp.asarray(arr.astype(np.uint32)), torch.as_tensor(arr)


def _slot_values(ring, rng, batch=2) -> list:
    return [[int(v) * (L // 7) % L for v in rng.integers(0, 1 << 62, ring.slots, dtype=np.int64)]
            for _ in range(batch)]


@pytest.mark.parametrize("name", ALL)
def test_ring_constants(name):
    ref, port = _rings(name)
    assert port.q_primes == ref.q_primes and port.q == ref.q
    assert (port.m, port.phi, port.d, port.slots, port.cbd_k) == (
        ref.m, ref.phi, ref.d, ref.slots, ref.cbd_k)
    assert port.q_hat == ref.q_hat and port.q_hat_inv == ref.q_hat_inv
    assert port.t_mod_q == ref.t_mod_q and port.neg_t_mod_q == ref.neg_t_mod_q
    assert _same(np.stack([np.asarray(w) for w in ref.limb_weights]), port.limb_weights)
    if isinstance(ref, ref_pow.PowerfulRing):
        assert (port.factors, port.axis_phis, port.units) == (ref.factors, ref.axis_phis, ref.units)
        assert (port.drown_bits, port.zk_wz, port.zk_wu) == (ref.drown_bits, ref.zk_wz, ref.zk_wu)
        assert (port.log2_q, port.budget_ok) == (ref.log2_q, ref.budget_ok)
        for a in range(len(ref.factors)):
            for want, got in ((ref.fwd_mats, port.fwd_mats), (ref.inv_mats, port.inv_mats)):
                assert _same(np.stack([np.asarray(per_prime[a]) for per_prime in want]), got[a])
        assert port.word_weights_q == ref.word_weights_q
        assert port.qhatinv_mont == [int(v) for v in ref.qhatinv_mont]
        assert _same(ref.qhat_mod_l.limbs, port.qhat_mod_l.limbs)
        assert _same(ref.q_mod_l.limbs, port.q_mod_l.limbs)
        assert (port.q_float_inv == ref.q_float_inv).all()
        ref._build_slot_maps()
        port._build_slot_maps()
        for name in ("frob_perm", "slot_reps", "slot_partner"):
            assert _same(getattr(ref, name), getattr(port, name))
        for a, p in enumerate(ref.axis_phis):
            for (mr, mi), blk in ((ref.gf_fwd[a], port.gf_fwd[a]), (ref.gf_inv[a], port.gf_inv[a])):
                assert _same(mr, blk[:, :p, :p]) and _same(mr, blk[:, p:, p:])
                assert _same(mi, blk[:, p:, :p])
                nr_mi = RefScalar(mi) * RefScalar.from_ints(ref_cyc._gf2_nr())
                assert _same(nr_mi.limbs, blk[:, :p, p:])
    else:
        for name in ("dft", "idft", "red"):
            assert _same(np.stack([np.asarray(x) for x in getattr(ref, name)]), getattr(port, name))
        assert _same(ref.encode_mat.limbs, port.encode_mat.limbs)
        assert _same(ref.decode_mat.limbs, port.decode_mat.limbs)
        assert port.prim_idx == ref.prim_idx
        ref._ensure_eval_mats()
        assert _same(np.stack([np.asarray(x) for x in ref.eval_mats]), port.eval_mats)
        assert _same(np.stack([np.asarray(x) for x in ref.eval_mats_inv]), port.eval_mats_inv)


@pytest.mark.parametrize("name", MAIN)
def test_transforms_and_pointwise_ops(name):
    ref, port = _rings(name)
    rng = np.random.default_rng(11)
    (ja, ta), (jb, tb) = _pair(_residues(port, rng)), _pair(_residues(port, rng))
    assert _same(ref.to_eval(ja), port.to_eval(ta))
    assert _same(ref.from_eval(ja), port.from_eval(ta))
    assert _same(ref.add(ja, jb), port.add(ta, tb))
    assert _same(ref.sub(ja, jb), port.sub(ta, tb))
    assert _same(ref.mul(ja, jb), port.mul(ta, tb))
    assert _same(ref.scalar_mul_t(ja), port.scalar_mul_t(ta))
    assert _same(ref.lift_residues(ja), port.lift_residues(ta))
    assert _same(ref.zero((3,)), port.zero((3,)))


@pytest.mark.parametrize("name", MAIN)
def test_lifts(name):
    ref, port = _rings(name)
    rng = np.random.default_rng(12)
    small = rng.integers(-10, 11, (2, port.phi)).astype(np.int32)
    assert _same(ref.lift_signed(jnp.asarray(small)), port.lift_signed(torch.as_tensor(small)))
    # plaintext limbs: random values, both sides of l/2 and the edges
    vals = [int(v) * (L // 5) % L for v in rng.integers(0, 1 << 62, 2 * port.phi, dtype=np.int64)]
    vals[:4] = [0, L // 2, L // 2 + 1, L - 1]
    limbs = lb.ints_to_limb_array(vals).reshape(16, 2, port.phi)
    assert _same(ref.lift_plaintext_limbs(jnp.asarray(limbs)),
                 port.lift_plaintext_limbs(torch.as_tensor(limbs.astype(np.int32))))
    if not isinstance(ref, ref_pow.PowerfulRing):  # PowerfulRing: test_lift_words
        words = rng.integers(-(1 << 62), 1 << 62, (2, port.phi, 9), dtype=np.int64)
        assert _same(ref.lift_words(words), port.lift_words(words))


@pytest.mark.parametrize("beyond", [False, True], ids=["in_bound", "beyond_bound"])
def test_lift_words(beyond):
    """The ZK word lift of `PowerfulRing` at the reference's own test ring
    (m = 35, 6 primes, 9 words): digits up to the exact-lift bound 2^55 and,
    beyond it, the wrapping of the reference's biased uint64 lift."""
    ref, port = _rings("powerful35_6")
    rng = np.random.default_rng(13)
    if beyond:
        words = rng.integers(-(1 << 62), 1 << 62, (3, port.phi, 9), dtype=np.int64)
        words[0, 0, :4] = [-(1 << 63), (1 << 63) - 1, -(1 << 55) - 1, (1 << 63) - (1 << 55)]
    else:
        words = rng.integers(-(1 << 54), 1 << 54, (3, port.phi, 9), dtype=np.int64)
        words[0, 0, 0], words[0, 1, 0], words[1, 0, 3] = (1 << 55) - 1, -(1 << 55) + 1, -(1 << 55)
    assert _same(ref.lift_words(words), port.lift_words(words))


@pytest.mark.parametrize("name", ALL)
def test_slot_encode_decode(name):
    ref, port = _rings(name)
    rng = np.random.default_rng(14)
    vals = _slot_values(port, rng)
    enc_ref = ref_bgv.encode_slots_l(ref, RefScalar.from_ints(np.array(vals, dtype=object)))
    enc = bgv_l.encode_slots_l(port, Scalar.from_ints(np.array(vals, dtype=object), device=CPU))
    assert _same(enc_ref.limbs, enc.limbs)
    dec = bgv_l.decode_slots_l(port, enc)
    assert _same(ref_bgv.decode_slots_l(ref, enc_ref).limbs, dec.limbs)
    assert dec.to_ints() == sum(vals, [])


@pytest.mark.parametrize("name", ALL)
def test_phase_to_pt_and_centered_ints(name):
    """Decryption's back end on real phases (a port encryption under a port
    key): the device RNS -> F_l conversion of `PowerfulRing` and the host CRT
    of the prototype give the reference's values."""
    ref, port = _rings(name)
    gen = torch.Generator().manual_seed(15)
    kp = bgv_l.keygen_l(port, gen)
    vals = _slot_values(port, np.random.default_rng(15))
    pt = bgv_l.encode_slots_l(port, Scalar.from_ints(np.array(vals, dtype=object), device=CPU))
    ct = bgv_l.encrypt_l(port, kp.pk_a, kp.pk_b, pt, gen)
    phase = port.add(ct.c0, port.mul(ct.c1, kp.sk))
    phase_j = jnp.asarray(phase.numpy().astype(np.uint32))
    assert ref.to_centered_ints(phase_j[0]) == port.to_centered_ints(phase[0])
    if isinstance(ref, ref_pow.PowerfulRing):
        want = ref.phase_to_pt(phase_j)
    else:
        want = ref_bgv.decrypt_l(ref, jnp.asarray(kp.sk.numpy().astype(np.uint32)),
                                 ref_bgv.CiphertextL(*(jnp.asarray(c.numpy().astype(np.uint32))
                                                       for c in (ct.c0, ct.c1))))
    got = port.phase_to_pt(phase)
    assert _same(want.limbs, got.limbs)
    assert _same(pt.limbs, got.limbs)
