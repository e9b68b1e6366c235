"""The port's dealer-free LowGear (bgv mode) on the CPU.

Port only (tier 1), at `PowerfulRing(35)` (the production ring's code
path) and the m = 132 prototype ring: the offline phase and an online
product over its prep, the triple-pair relations across the batch seam,
the independence of the stores from the BGV randomness (the ground of the
cross-package parity), a tampered proof, and setup persistence, whose blob
the JAX package loads.

Cross-package (`slow`): the JAX package's bgv-mode `LowGear` and the
port's, with the same numpy seeds, make bit-identical stores (tolerance
0).  The JAX side spends minutes in BGV compiles, hence the marker.
"""

import threading

import numpy as np
import pytest
import torch

import ark_mpc_tpu_torch as port
from ark_mpc_tpu.algebra.fields import CURVE25519_ORDER as L
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.fabric import messages
from ark_mpc_tpu_torch.offline.bgv.bgv_l import default_ring
from ark_mpc_tpu_torch.offline.bgv.powerful import PowerfulRing
from ark_mpc_tpu_torch.offline.errors import KeyExchangeError
from ark_mpc_tpu_torch.offline.lowgear import setup, triplets_l
from ark_mpc_tpu_torch.offline.lowgear.core import LowGear
from ark_mpc_tpu_torch.offline.structs import OfflineSizingParams

torch.set_num_threads(1)

SIZING = OfflineSizingParams(num_triples=4, num_inverse_pairs=2, num_bits=2,
                             num_randomness=4, num_input_masks=4)
XS = [int(v) for v in np.random.default_rng(201).integers(1, 1 << 62, size=2)]
YS = [int(v) for v in np.random.default_rng(202).integers(1, 1 << 62, size=2)]
RINGS = {"powerful35": lambda: PowerfulRing(35, device="cpu"),
         "proto132": lambda: default_ring(device="cpu")}


def gen(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def lowgear(fabric, ring, torch_seed: int = 600, np_seed: int = 80) -> LowGear:
    pid = fabric.party_id
    return LowGear(pid, fabric.transport, mode="bgv", ring=ring, allow_insecure_ring=True,
                   rng=np.random.default_rng(np_seed + pid), gen=gen(torch_seed + pid),
                   device="cpu")


def run(prog):
    return port.execute_mock_mpc(prog, device="cpu")


def offline_and_online(make_ring, torch_seed: int = 600):
    """run_offline_phase, then an online product over the prep on a fresh
    fabric (`tests/test_lowgear_powerful.py`) -> (stores, product)."""
    def prog(fabric):
        pid = fabric.party_id
        lg = lowgear(fabric, make_ring(), torch_seed)
        lg.run_offline_phase(SIZING)
        stores = convert.from_prep(lg.get_offline_result())
        online = port.MpcFabric(pid, fabric.transport, lg.get_offline_result(),
                                rng=np.random.default_rng(90 + pid), device="cpu")
        sx = online.share_values(port.Scalar.from_ints(XS, device="cpu") if pid == 0 else None,
                                 sender=0, n=2)
        sy = online.share_values(port.Scalar.from_ints(YS, device="cpu") if pid == 1 else None,
                                 sender=1, n=2)
        zv = online.open_authenticated(online.mul(sx, sy), defer=True)
        online.verify_deferred()
        return stores, zv.to_ints()

    return run(prog)


def assert_stores_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if k == "mac_key_share" or k == "my_masks_clear":
            np.testing.assert_array_equal(a[k], b[k])
            continue
        assert len(a[k]) == len(b[k])
        for (s0, m0), (s1, m1) in zip(a[k], b[k]):
            np.testing.assert_array_equal(s0, s1)
            np.testing.assert_array_equal(m0, m1)


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_offline_phase_drives_online_product(ring):
    (_, z0), (_, z1) = offline_and_online(RINGS[ring])
    assert z0 == z1 == [x * y % L for x, y in zip(XS, YS)]


def test_stores_do_not_depend_on_the_bgv_randomness():
    """Same numpy seeds, different torch seeds (other keys, encryption
    randomness and drowning): bit-identical stores in both parties."""
    a = offline_and_online(RINGS["powerful35"], torch_seed=600)
    b = offline_and_online(RINGS["powerful35"], torch_seed=7000)
    for pid in (0, 1):
        assert_stores_equal(a[pid][0], b[pid][0])
    # one call stocks 64 slot batches of 12 slots at m = 35; the inverse
    # tuples and bits used some
    left = 64 * 12 - SIZING.num_inverse_pairs - SIZING.num_bits
    assert a[0][0]["triples"][0][0].shape[1] == left


def test_triple_pairs_across_the_batch_seam():
    """Two slot batches under one proof, in 3 wire rounds as one batch
    takes: c = a*b and c' = a*b' hold on both sides of the seam, and every
    MAC checks (`tests/test_triples_l_online.py`)."""
    ring = RINGS["proto132"]()

    def prog(fabric):
        lg = lowgear(fabric, ring)
        rounds = []
        for u in (1, 2):
            before = lg.transport.stats.msgs_sent
            outs = triplets_l.generate_triple_pairs_batch_l(lg.transport, lg.setup, u,
                                                            lg.rng, lg.gen)
            rounds.append(lg.transport.stats.msgs_sent - before)
        assert rounds == [3, 3], rounds
        opened = [lg.fabric.open_authenticated(s, defer=True) for s in outs]
        lg.fabric.verify_deferred()
        return [o.to_ints() for o in opened]

    r0, r1 = run(prog)
    a, b, c, b2, c2 = r0
    assert r0 == r1 and len(a) == 2 * ring.slots
    assert c == [x * y % L for x, y in zip(a, b)]
    assert c2 == [x * y % L for x, y in zip(a, b2)]


def test_single_batch_triples_and_homomorphic_macs():
    """The single-batch forms: `generate_triples_l` opens to c = a*b,
    `generate_triple_pairs_l` makes one slot batch of pairs, and
    `authenticate_vec_l` gives MACs that check under the joint key."""
    ring = RINGS["proto132"]()

    def prog(fabric):
        lg = lowgear(fabric, ring)
        st = lg.setup
        a, b, c = triplets_l.generate_triples_l(lg.transport, st, lg.rng, lg.gen)
        pairs = triplets_l.generate_triple_pairs_l(lg.transport, st, lg.rng, lg.gen)
        values = port.Scalar.random(ring.slots, np.random.default_rng(7 + fabric.party_id),
                                    device="cpu")
        mac = triplets_l.authenticate_vec_l(lg.transport, st, values, lg.rng, lg.gen)
        opened = [lg.fabric.open_authenticated(s, defer=True)
                  for s in (a, b, c, port.ScalarShare(values, mac))]
        lg.fabric.verify_deferred()
        return [o.to_ints() for o in opened], [p.size for p in pairs]

    (r0, sizes), (r1, _) = run(prog)
    av, bv, cv, _ = r0
    assert r0 == r1 and sizes == [ring.slots] * 5
    assert cv == [x * y % L for x, y in zip(av, bv)]


def test_setup_frames_cross_as_numpy():
    from ark_mpc_tpu_torch.fabric.transport import LocalTransport
    from ark_mpc_tpu_torch.offline.lowgear import setup

    t0, t1 = LocalTransport.pair()
    arrays = [np.arange(12, dtype=np.uint32).reshape(3, 4), np.array([-5, 1 << 40])]
    setup._send_arrays(t0, *arrays)
    got = messages.decode_arrays(t1.recv())
    for g, w in zip(got, arrays):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_peer_residues_are_checked():
    """What the peer sends as residues must be uint32 of the expected shape,
    each below its prime; anything else raises `KeyExchangeError`."""
    ring = RINGS["proto132"]()
    q = np.asarray(ring.q_primes, np.uint32)[:, None]
    good = (np.arange(2 * len(ring.q_primes) * ring.phi, dtype=np.uint32)
            .reshape(2, len(ring.q_primes), ring.phi) % q)
    got = setup.peer_residues(ring._q, ring.phi, good, (2,))
    assert got.dtype == torch.int64 and torch.equal(got, torch.from_numpy(good.astype(np.int64)))
    high = good.copy()
    high[1, 3, 5] = q[3, 0]
    for bad, lead in ((good, (3,)), (good[0], (2,)), (good.astype(np.int64), (2,)),
                      (high, (2,)), ((good | np.uint32(1 << 31)), (2,))):
        with pytest.raises(KeyExchangeError):
            setup.peer_residues(ring._q, ring.phi, bad, lead)


def run_with_tampered_proof(edit):
    """Party 1 passes each proof it sends (8 arrays: cts, commitments, z,
    zu, ze0, ze1) through `edit` after an honest key exchange -> each
    party's outcome of one `generate_triples`."""
    ring = RINGS["powerful35"]()

    def prog(fabric):
        lg = lowgear(fabric, ring)
        if fabric.party_id == 1:
            exchange = fabric.transport.exchange

            def tampered(data):
                items = messages.decode_arrays(data)
                if len(items) == 8:
                    data = messages.encode_arrays(edit(items))
                return exchange(data)

            fabric.transport.exchange = tampered
        try:
            lg.generate_triples(1)
        except (KeyExchangeError, ConnectionError) as e:
            return type(e).__name__
        return "passed"

    return run(prog)


def test_tampered_proof_raises_key_exchange_error():
    """Party 1 changes one response digit of its enc(a) proof on the wire:
    party 0 raises `KeyExchangeError` and stops; party 1 then finds its
    peer gone."""
    def edit(items):
        items[4] = items[4].copy()
        items[4][0, 0, 0] += 1
        return items

    assert run_with_tampered_proof(edit) == ("KeyExchangeError", "ConnectionError")


def test_short_proof_raises_key_exchange_error(monkeypatch):
    """Party 1 proves its enc(a) honestly but with ZK_ROWS / 2 challenge
    rows (soundness 2^-64): the verifier holds every proof to ZK_ROWS, so
    party 0 raises `KeyExchangeError` and stops."""
    prove = triplets_l.encrypt_and_prove_batch
    short = threading.local()

    def prove_short_in_party_1(*args, **kw):
        if getattr(short, "on", False):
            kw["v"] = triplets_l.ZK_ROWS // 2
        return prove(*args, **kw)

    monkeypatch.setattr(triplets_l, "encrypt_and_prove_batch", prove_short_in_party_1)
    ring = RINGS["powerful35"]()

    def prog(fabric):
        lg = lowgear(fabric, ring)  # the key exchange's proofs are full
        short.on = fabric.party_id == 1
        try:
            lg.generate_triples(1)
        except (KeyExchangeError, ConnectionError) as e:
            return type(e).__name__
        return "passed"

    assert run(prog) == ("KeyExchangeError", "ConnectionError")


def test_setup_persistence_resumes_and_crosses_packages():
    """get_setup_params -> from_setup_params without a second key exchange
    (the lockstep transport would deadlock if one party tried), then more
    triples whose MACs verify under the persisted key (`tests/
    test_setup_persistence.py`).  The port's blob loads through the JAX
    package's `from_setup_params` with equal key arrays, and through
    `convert.to_setup`."""
    ring = RINGS["powerful35"]()

    def prog(fabric):
        pid = fabric.party_id
        lg = lowgear(fabric, ring)
        blob = lg.get_setup_params()
        lg2 = LowGear.from_setup_params(pid, fabric.transport, blob, allow_insecure_ring=True,
                                        rng=np.random.default_rng(190 + pid), gen=gen(5 + pid),
                                        device="cpu")
        assert type(lg2.ring).__name__ == "PowerfulRing"
        assert lg2.ring.m == ring.m and list(lg2.ring.q_primes) == list(ring.q_primes)
        assert lg2.mac_key_share.to_int() == lg.mac_key_share.to_int()
        lg2.generate_triples(ring.slots)
        a, b, c = lg2.prep.triples.take(len(lg2.prep.triples))
        opened = [lg2.fabric.open_authenticated(s, defer=True) for s in (a, b, c)]
        lg2.fabric.verify_deferred()
        return blob, convert.from_setup(lg.setup), convert.from_setup(lg2.setup), \
            [o.to_ints() for o in opened]

    r0, r1 = run(prog)
    for blob, before, after, (av, bv, cv) in (r0, r1):
        for k in before:
            np.testing.assert_array_equal(before[k], after[k])
        assert cv == [x * y % L for x, y in zip(av, bv)]
        again = convert.from_setup(convert.to_setup(ring, before))
        for k in before:
            np.testing.assert_array_equal(again[k], before[k])

    from ark_mpc_tpu.fabric.transport import LocalTransport
    from ark_mpc_tpu.offline.lowgear.core import LowGear as RefLowGear

    transports = LocalTransport.pair()
    for pid, (blob, before, _, _) in enumerate((r0, r1)):
        ref_lg = RefLowGear.from_setup_params(pid, transports[pid], blob,
                                              allow_insecure_ring=True,
                                              rng=np.random.default_rng(0))
        assert list(ref_lg.ring.q_primes) == list(ring.q_primes)
        got = convert.from_setup(ref_lg.setup)
        for k in before:
            np.testing.assert_array_equal(got[k], before[k])


@pytest.mark.slow  # ~5 min of the JAX package's BGV compiles on the CPU
def test_bgv_stores_match_reference():
    """The JAX package's bgv-mode LowGear at PowerfulRing(35) and the
    port's, with the same numpy seeds (the BGV randomness differs and
    cancels): every store bit-identical."""
    import jax

    from ark_mpc_tpu.fabric.simulator import execute_mock_mpc as ref_run
    from ark_mpc_tpu.offline.bgv.powerful import PowerfulRing as RefRing
    from ark_mpc_tpu.offline.lowgear.core import LowGear as RefLowGear

    def ref_prog(fabric):
        pid = fabric.party_id
        lg = RefLowGear(pid, fabric.transport, mode="bgv", ring=RefRing(35),
                        allow_insecure_ring=True, rng=np.random.default_rng(80 + pid),
                        jkey=jax.random.PRNGKey(600 + pid))
        lg.run_offline_phase(SIZING)
        return convert.from_prep(lg.get_offline_result())

    want = ref_run(ref_prog)
    got = offline_and_online(RINGS["powerful35"])
    for pid in (0, 1):
        assert_stores_equal(want[pid], got[pid][0])
