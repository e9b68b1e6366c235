"""The port's LowGear protocol layer in dealer mode, held to the JAX package
bit for bit on the CPU.

Both packages run the same programs under `execute_mock_mpc_dealer` with
the same dealer seed and the same host generators, so every protocol output
(share and MAC limbs) and every LowGear store must be identical, tolerance
0.  Preps saved by either package load in the other.  Port-only checks:
the sacrifice, the input-mask inventory, the ring policy and the rejection
of malformed public coins from the peer.
"""

import numpy as np
import pytest
import torch

import ark_mpc_tpu as ref
import ark_mpc_tpu_torch as port
from ark_mpc_tpu.algebra.fields import CURVE25519_ORDER as L
from ark_mpc_tpu.offline.lowgear import core as ref_core
from ark_mpc_tpu.offline.lowgear import protocols as ref_protocols
from ark_mpc_tpu.offline.structs import LowGearPrep as RefPrep
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.fabric.errors import AuthenticationError
from ark_mpc_tpu_torch.offline.bgv import bgv_l
from ark_mpc_tpu_torch.offline.errors import SacrificeError
from ark_mpc_tpu_torch.offline.lowgear import core, protocols, triplets_l
from ark_mpc_tpu_torch.offline.structs import LowGearPrep, OfflineSizingParams

torch.set_num_threads(1)

XS = [int(v) for v in np.random.default_rng(41).integers(1, 1 << 62, size=6)]
SIZING = OfflineSizingParams(num_triples=8, num_inverse_pairs=4, num_bits=4,
                             num_randomness=8, num_input_masks=2)


def is_port(fabric) -> bool:
    return isinstance(fabric, port.MpcFabric)


def pkg(fabric):
    return (port, protocols, core) if is_port(fabric) else (ref, ref_protocols, ref_core)


def ints(fabric, vals):
    if is_port(fabric):
        return port.Scalar.from_ints(vals, device=fabric.device)
    return ref.Scalar.from_ints(vals)


def both(prog, seed: int = 7):
    """-> ((ref party 0, party 1), (port party 0, party 1))."""
    from ark_mpc_tpu.fabric.simulator import execute_mock_mpc_dealer as ref_run

    return (ref_run(prog, seed=seed),
            port.execute_mock_mpc_dealer(prog, seed=seed, device="cpu"))


def share_limbs(s) -> tuple:
    return convert.from_field(s.share), convert.from_field(s.mac)


def assert_same(a, b):
    """Nested tuples/lists/dicts of arrays are equal, element for element."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the protocols ------------------------------------------------------------


def test_public_coins_match():
    def prog(fabric):
        _, proto, _ = pkg(fabric)
        return convert.from_field(proto.public_coin_scalars(fabric, 5))

    (r0, r1), (p0, p1) = both(prog)
    assert_same((r0, r0, r0), (r1, p0, p1))


def test_open_and_check_macs_match():
    def prog(fabric):
        _, proto, _ = pkg(fabric)
        sh = fabric.share_values(ints(fabric, XS) if fabric.party_id == 0 else None,
                                 sender=0, n=len(XS))
        opened = proto.open_and_check_macs(fabric, sh)
        return opened.to_ints(), convert.from_field(opened)

    (r0, r1), (p0, p1) = both(prog)
    assert r0[0] == r1[0] == p0[0] == p1[0] == XS
    assert_same((r0[1], r0[1]), (p0[1], p1[1]))


def test_open_and_check_macs_raises_invalid_mac():
    from ark_mpc_tpu_torch.offline.errors import InvalidMac

    def prog(fabric):
        sh = fabric.share_values(ints(fabric, XS) if fabric.party_id == 0 else None,
                                 sender=0, n=len(XS))
        if fabric.party_id == 1:
            sh = port.ScalarShare(sh.share, sh.mac + ints(fabric, [1] * len(XS)))
        try:
            protocols.open_and_check_macs(fabric, sh)
        except InvalidMac:
            return "InvalidMac"
        return "passed"

    assert port.execute_mock_mpc_dealer(prog, device="cpu") == ("InvalidMac", "InvalidMac")


def test_inverse_tuples_match():
    def prog(fabric):
        _, proto, _ = pkg(fabric)
        a, a_inv = proto.generate_inverse_tuples(fabric, 4)
        prod = fabric.open_authenticated(fabric.mul(a, a_inv)).to_ints()
        return share_limbs(a), share_limbs(a_inv), prod

    ref_out, port_out = both(prog)
    assert_same(ref_out, port_out)
    assert port_out[0][2] == [1] * 4


def test_shared_bits_match():
    def prog(fabric):
        _, proto, _ = pkg(fabric)
        bits = proto.generate_shared_bits(fabric, 8)
        return share_limbs(bits), fabric.open_authenticated(bits).to_ints()

    ref_out, port_out = both(prog)
    assert_same(ref_out, port_out)
    assert all(v in (0, 1) for v in port_out[0][1])


def test_sqrt_mod_l_host_matches():
    rng = np.random.default_rng(5)
    roots_in = [0, 1, L - 1] + [int.from_bytes(rng.bytes(32), "little") % L for _ in range(297)]
    squares = [r * r % L for r in roots_in]
    got = protocols._sqrt_mod_l_host(squares)
    assert got == ref_protocols._sqrt_mod_l_host(squares)
    assert all(r * r % L == v for r, v in zip(got, squares))
    assert got[0] == 0


# -- LowGear dealer mode ------------------------------------------------------


def test_lowgear_dealer_stores_match_and_cross_load(tmp_path):
    """`run_offline_phase` in both packages: every store equal; each
    package's saved prep loads in the other with equal arrays; the online
    multiply-and-invert of `tests/test_offline.py` runs on the port over
    the preps the JAX package saved."""
    x, y = XS[0], XS[1]

    def prog(fabric):
        _, _, co = pkg(fabric)
        kw = {"device": "cpu"} if is_port(fabric) else {}
        lg = co.LowGear(fabric.party_id, fabric.transport, rng=fabric.rng, **kw)
        lg.run_offline_phase(SIZING)
        prep = lg.get_offline_result()
        prep.save(str(tmp_path / f"{'port' if is_port(fabric) else 'ref'}_{fabric.party_id}.npz"))
        return convert.from_prep(prep)

    ref_out, port_out = both(prog)
    assert_same(ref_out, port_out)
    assert port_out[0]["triples"][0][0].shape == (16, SIZING.num_triples)
    for pid in (0, 1):
        from_port = RefPrep.load(str(tmp_path / f"port_{pid}.npz"))
        from_ref = LowGearPrep.load(str(tmp_path / f"ref_{pid}.npz"), device="cpu")
        assert_same(convert.from_prep(from_port), ref_out[pid])
        assert_same(convert.from_prep(from_ref), ref_out[pid])

    def online(fabric):
        sx = fabric.share_values(ints(fabric, [x, x]) if fabric.party_id == 0 else None,
                                 sender=0, n=2)
        sy = fabric.share_values(ints(fabric, [y, y]) if fabric.party_id == 1 else None,
                                 sender=1, n=2)
        sz = fabric.mul(sx, sy)
        inv = fabric.inverse(sz)
        return (fabric.open_authenticated(sz).to_ints(),
                fabric.open_authenticated(inv).to_ints())

    (p0, i0), (p1, i1) = port.execute_mock_mpc(
        online, device="cpu",
        offline_factory=lambda pid: LowGearPrep.load(str(tmp_path / f"ref_{pid}.npz"),
                                                     device="cpu"))
    want = x * y % L
    assert p0 == p1 == [want, want]
    assert i0 == i1 == [pow(want, -1, L)] * 2


def test_prep_dict_roundtrip():
    def prog(fabric):
        lg = core.LowGear(fabric.party_id, fabric.transport, rng=fabric.rng, device="cpu")
        lg.run_offline_phase(SIZING)
        arrays = convert.from_prep(lg.get_offline_result())
        assert_same(convert.from_prep(convert.to_prep(arrays, device="cpu")), arrays)
        return len(lg.prep.triples), len(lg.prep.randomness)

    assert port.execute_mock_mpc_dealer(prog, device="cpu")[0] == (8, 8)


def test_sacrifice_detects_bad_triple():
    """A consistently authenticated triple with c != a*b (both parties shift
    their c by a public constant, share and MAC alike) passes every MAC
    check and must fail the sacrifice, in both parties."""

    def prog(fabric):
        lg = core.LowGear(fabric.party_id, fabric.transport, rng=fabric.rng, device="cpu")
        a, b, c, b2, c2 = lg._raw_triple_pairs(4)
        c = c.add_public(port.Scalar.from_ints(1, device="cpu"), lg.fabric.mac_key,
                         fabric.party_id)
        lg._raw_triple_pairs = lambda n: (a, b, c, b2, c2)
        try:
            lg.generate_triples(4)
        except SacrificeError:
            return "SacrificeError", len(lg.prep.triples)
        return "passed", len(lg.prep.triples)

    assert port.execute_mock_mpc_dealer(prog, device="cpu") == (("SacrificeError", 0),) * 2


def test_input_mask_surplus_kept_as_inventory(monkeypatch):
    """bgv-mode input masks round up to whole chunks of slot batches and
    the surplus is KEPT: a later small request makes no new BGV exchange
    (after `tests/test_offline.py`'s stub of the BGV layer)."""
    S = 12  # stub ring slot count
    calls: list[int] = []

    def fake_masks(transport, setup, n, local_first, rng, gen):
        calls.append(n)
        n_chunks = max(4, -(-max(1, -(-n // S)) // 4) * 4)
        clear = port.Scalar.random(n_chunks * S, rng, device="cpu")
        zero = port.Scalar.zeros(n_chunks * S, device="cpu")
        return clear, port.ScalarShare(clear, clear), port.ScalarShare(zero, zero)

    monkeypatch.setattr(triplets_l, "generate_input_masks_l", fake_masks)
    lg = object.__new__(core.LowGear)
    lg.mode, lg.party_id, lg.transport, lg.setup = "bgv", 0, None, None
    lg.rng, lg.gen = np.random.default_rng(0), None
    lg.prep = LowGearPrep(mac_key_share=port.Scalar.from_ints([1], device="cpu"))

    lg.generate_input_masks(5)
    assert calls == [5]
    assert len(lg.prep.my_mask_shares) == 48  # 4 chunks x 12 slots kept
    lg.generate_input_masks(7)                # served from the inventory
    assert calls == [5]
    clear, share = lg.prep.next_local_input_mask_batch(7)
    assert clear.size == 7 and share.size == 7
    lg.generate_input_masks(60)               # only the deficit is made
    assert calls == [5, 60 - 41]


@pytest.mark.parametrize("m, want", [(35, 64), (132, 64), (1155, 64), (118965, 4)])
def test_stack_chunk_matches_reference(m, want):
    from ark_mpc_tpu.offline.lowgear.triplets_l import stack_chunk as ref_chunk

    class Shape:  # stack_chunk reads the basis size and phi only
        def __init__(self, n_q, phi):
            self.q_specs, self.phi = [None] * n_q, phi

    shapes = {35: (6, 24), 132: (21, 40), 1155: (16, 480), 118965: (29, 48960)}
    ring = Shape(*shapes[m])
    assert triplets_l.stack_chunk(ring) == ref_chunk(ring) == want


# -- ring policy (after tests/test_ring_policy.py) -----------------------------


def test_toy_and_medium_rings_fail_the_check():
    assert not bgv_l.rlwe_secure_128(bgv_l.default_ring(device="cpu"))
    assert not bgv_l.rlwe_secure_128(bgv_l.medium_ring(device="cpu"))


def test_default_ring_choice_is_secure():
    ring = core.resolve_bgv_ring(None, allow_insecure_ring=False, device="cpu")
    assert bgv_l.rlwe_secure_128(ring)
    assert ring.m == 118965 and ring.phi == 48960 and len(ring.q_primes) == 29


def test_insecure_ring_refused_without_flag_and_allowed_with_it():
    ring = bgv_l.default_ring(device="cpu")
    for r in (ring, bgv_l.medium_ring(device="cpu")):
        with pytest.raises(ValueError, match="RLWE"):
            core.resolve_bgv_ring(r, allow_insecure_ring=False)
    assert core.resolve_bgv_ring(ring, allow_insecure_ring=True) is ring


def test_lowgear_constructor_refuses_toy_ring():
    # the raise comes from ring resolution, BEFORE any transport use:
    # transport=None proves no key-exchange message is attempted
    with pytest.raises(ValueError, match="RLWE"):
        core.LowGear(0, None, mode="bgv", ring=bgv_l.default_ring(device="cpu"))
    with pytest.raises(ValueError, match="mode"):
        core.LowGear(0, None, mode="tpu", device="cpu")


# -- malformed public coins from the peer --------------------------------------


def _malformed(kind: str, canon: np.ndarray) -> np.ndarray:
    bad = canon.copy()
    if kind == "value >= l":   # the coin plus l: the same value mod l
        v = int(sum(int(bad[i, 0]) << (16 * i) for i in range(16))) + L
        bad[:, 0] = [(v >> (16 * i)) & 0xFFFF for i in range(16)]
    elif kind == "limb > 0xFFFF":
        bad[3, 1] += 1 << 16
    else:                      # one coin short
        bad = bad[:, :-1]
    return bad


@pytest.mark.parametrize("kind", ["value >= l", "limb > 0xFFFF", "wrong shape"])
def test_malformed_public_coins_raise_in_both_parties(kind):
    """Party 1 sends malformed coin limbs (its commitment covers its real
    coins).  Party 0 must raise `AuthenticationError` on receipt, before it
    reveals its blinder or uses any coin; party 1 then finds its peer gone.
    Neither returns coins."""
    def prog(fabric):
        if fabric.party_id == 1:
            exchange, calls = fabric._exchange_arrays, []

            def tampered(items):
                calls.append(1)
                if len(calls) == 2:  # commitment, COINS, blinder
                    items = [_malformed(kind, items[0])]
                return exchange(items)

            fabric._exchange_arrays = tampered
        try:
            return protocols.public_coin_scalars(fabric, 4)
        except (AuthenticationError, ConnectionError) as e:
            return type(e).__name__, fabric.n_rounds

    r0, r1 = port.execute_mock_mpc_dealer(prog, device="cpu")
    assert r0 == ("AuthenticationError", 2)   # raised on the coins' round
    assert r1 == ("ConnectionError", 3)
