"""The port's online slice against the JAX package, end to end on CPU.

Every program of `tests/test_online.py` runs through both packages'
`execute_mock_mpc(_dealer)` (the port with `device="cpu"`); opened values,
share and MAC limbs and round counts must be identical, and the opened
values must match Python-int arithmetic.  Both dealers draw the same
material from one seed, and the fused step `flagship_forward` agrees on the
same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_mpc_tpu as ref
import ark_mpc_tpu_torch as port
import _torch_wire_faults as wire_faults
from ark_mpc_tpu.algebra.fields import CURVE25519_ORDER as L
from ark_mpc_tpu.parallel import step as ref_step
from ark_mpc_tpu_torch.algebra import limbs as port_lb
from ark_mpc_tpu_torch.parallel import step as port_step

torch.set_num_threads(1)


def seeded_ints(seed: int, n: int, low: int = 0) -> list:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 9), dtype=np.uint64)
    return [low + sum(int(w) << (32 * k) for k, w in enumerate(row)) % (L - low)
            for row in words]


XS, YS = seeded_ints(1, 32), seeded_ints(2, 32)
INV_XS = seeded_ints(3, 5, low=1)


def is_port(fabric) -> bool:
    return isinstance(fabric, port.MpcFabric)


def ints(fabric, vals):
    if is_port(fabric):
        return fabric.field.from_ints(vals, device=fabric.device)
    return fabric.field.from_ints(vals)


def share_cls(fabric):
    return port.ScalarShare if is_port(fabric) else ref.ScalarShare


def limbs(x) -> np.ndarray:
    if isinstance(x.limbs, torch.Tensor):
        return x.limbs.cpu().numpy().astype(np.uint32)
    return np.asarray(x.limbs)


def share_in(fabric, vals, sender):
    n = len(vals)
    return fabric.share_values(ints(fabric, vals) if fabric.party_id == sender
                               else None, sender=sender, n=n)


# -- the programs of tests/test_online.py ------------------------------------


def prog_share_and_open(fabric):
    sh = share_in(fabric, [42, 27, L - 1, 0], 0)
    return {"open": fabric.open_authenticated(sh).to_ints(),
            "share": limbs(sh.share), "mac": limbs(sh.mac)}


def prog_share_both_directions(fabric):
    sa, sb = share_in(fabric, XS[:1], 0), share_in(fabric, YS[:1], 1)
    return {"open": fabric.open_authenticated(sa + sb).to_ints()}


def prog_readme_product(fabric):
    a, b = share_in(fabric, [2], 0), share_in(fabric, [3], 1)
    c = fabric.mul(a, b)
    return {"open": fabric.open_authenticated(c).to_ints(),
            "share": limbs(c.share), "mac": limbs(c.mac)}


def prog_batch_mul(fabric):
    sz = fabric.mul(share_in(fabric, XS, 0), share_in(fabric, YS, 1))
    return {"open": fabric.open_authenticated(sz).to_ints(),
            "share": limbs(sz.share), "mac": limbs(sz.mac)}


def prog_linear_ops_and_public(fabric):
    x, y, k = 1234567, 7654321, 31337
    sx, sy = share_in(fabric, [x], 0), share_in(fabric, [y], 1)
    expr = fabric.add_public((sx + sy - sy) * ints(fabric, k), ints(fabric, 5))
    expr = -fabric.sub_public(expr, ints(fabric, 2))
    out = fabric.open_authenticated(expr, defer=True).to_ints()
    fabric.verify_deferred()
    return {"open": out, "mac": limbs(expr.mac)}


def prog_deferred_check(fabric):
    sx = share_in(fabric, XS[:8], 0)
    sq = fabric.mul(sx, sx)
    v1 = fabric.open_authenticated(sq, defer=True)
    v2 = fabric.open_authenticated(sx, defer=True)
    fabric.verify_deferred()
    return {"open": v1.to_ints() + v2.to_ints(), "rounds": fabric.n_rounds}


def prog_folded_deferred_check(fabric):
    sz = fabric.mul(share_in(fabric, XS[:8], 0), share_in(fabric, YS[:8], 1))
    v = fabric.open_authenticated(sz, defer=True)
    fabric.verify_deferred(fold=True)
    return {"open": v.to_ints(), "rounds": fabric.n_rounds}


def prog_inverse(fabric):
    inv = fabric.inverse(share_in(fabric, INV_XS, 0))
    return {"open": fabric.open_authenticated(inv).to_ints(),
            "share": limbs(inv.share)}


def prog_pow(fabric):
    sx = share_in(fabric, XS[:1], 0)
    outs = [fabric.pow(sx, e) for e in (13, 1, 2, 0, 97)]
    return {"open": fabric.open_authenticated(
        share_cls(fabric).concatenate(outs)).to_ints()}


def prog_inner_product(fabric):
    prod = fabric.mul(share_in(fabric, XS[:16], 0), share_in(fabric, YS[:16], 1))
    return {"open": fabric.open_authenticated(prod.sum()).to_ints()}


def prog_bad_mac(fabric):
    sx = share_in(fabric, [5], 0)
    if fabric.party_id == 1:
        sx = share_cls(fabric)(sx.share, sx.mac + ints(fabric, 1))
    return fabric.open_authenticated(sx).to_ints()


def prog_bad_share(fabric):
    sx = share_in(fabric, [5], 0)
    if fabric.party_id == 0:
        sx = share_cls(fabric)(sx.share + ints(fabric, 1), sx.mac)
    return fabric.open_authenticated(sx).to_ints()


CASES = {
    # name: (program, dealer?, expected opened values)
    "share_and_open": (prog_share_and_open, False, [42, 27, L - 1, 0]),
    "share_both_directions": (prog_share_both_directions, True,
                              [(XS[0] + YS[0]) % L]),
    "readme_product": (prog_readme_product, False, [6]),
    "batch_mul": (prog_batch_mul, True, [x * y % L for x, y in zip(XS, YS)]),
    "linear_ops_and_public": (prog_linear_ops_and_public, True,
                              [(-(1234567 * 31337 + 3)) % L]),
    "deferred_check": (prog_deferred_check, True,
                       [x * x % L for x in XS[:8]] + XS[:8]),
    "folded_deferred_check": (prog_folded_deferred_check, True,
                              [x * y % L for x, y in zip(XS[:8], YS[:8])]),
    "inverse": (prog_inverse, True, [pow(x, -1, L) for x in INV_XS]),
    "pow": (prog_pow, True, [pow(XS[0], e, L) for e in (13, 1, 2, 0, 97)]),
    "inner_product": (prog_inner_product, True,
                      [sum(x * y for x, y in zip(XS[:16], YS[:16])) % L]),
}


def run(pkg, prog, dealer: bool):
    kw = {"device": "cpu"} if pkg is port else {}
    if dealer:
        return pkg.execute_mock_mpc_dealer(prog, **kw)
    return pkg.execute_mock_mpc(prog, **kw)


def assert_same_result(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("name", list(CASES))
def test_program_matches_reference(name):
    prog, dealer, expected = CASES[name]
    got = run(port, prog, dealer)
    want = run(ref, prog, dealer)
    for party in (0, 1):
        assert_same_result(got[party], want[party])
        assert got[party]["open"] == expected
    if name == "deferred_check":
        assert got[0]["rounds"] == 6


@pytest.mark.parametrize("prog", [prog_bad_mac, prog_bad_share],
                         ids=["bad_mac", "bad_share"])
def test_malicious_abort_matches_reference(prog):
    with pytest.raises(port.AuthenticationError):
        run(port, prog, True)
    with pytest.raises(ref.AuthenticationError):
        run(ref, prog, True)


def test_honest_product_under_the_wire_checks():
    got = run(port, wire_faults.product_program(), True)
    assert got[0] == got[1] == wire_faults.PRODUCTS


@pytest.mark.parametrize("fault", list(wire_faults.FAULTS))
def test_malformed_received_field_elements_abort(fault):
    """A peer's field elements shifted by a multiple of m, with a limb
    above 0xFFFF or of the wrong shape abort the run (the reference takes
    them: it opens a wrong product with every MAC check passing)."""
    with pytest.raises(port.AuthenticationError):
        run(port, wire_faults.FAULTS[fault], True)


@pytest.mark.parametrize("modulus", [L, (1 << 255) - 19], ids=["l", "p25519"])
def test_limbs_below_matches_python_ints(modulus):
    rng = np.random.default_rng(modulus % 1000)
    edge = [0, 1, modulus - 1, modulus, modulus + 1, modulus + (1 << 16),
            modulus - (1 << 240), (1 << 256) - 1, modulus >> 1]
    words = rng.integers(0, 1 << 16, size=(port_lb.NLIMBS, 64), dtype=np.uint32)
    randoms = port_lb.limb_array_to_ints(words)
    for vals in [[v] for v in edge] + [randoms, [v % modulus for v in randoms]]:
        arr = port_lb.ints_to_limb_array(vals)
        assert port_lb.limbs_below(arr, modulus) == all(v < modulus for v in vals)
    ok = port_lb.ints_to_limb_array([1, 2])
    wide = ok.copy()
    wide[0, 1] = 1 << 16
    assert not port_lb.limbs_below(wide, modulus)
    assert not port_lb.limbs_below(-ok.astype(np.int64), modulus)
    assert port_lb.limbs_below(ok[:, :0], modulus)


@pytest.mark.parametrize("party", [0, 1])
def test_dealer_material_matches_reference(party):
    """Same seed, same draws: the port's dealer serves the reference's
    material bit for bit."""
    p = port.TrustedDealerSource(party, seed=11, device="cpu")
    r = ref.TrustedDealerSource(party, seed=11)
    np.testing.assert_array_equal(limbs(p.get_mac_key_share()),
                                  limbs(r.get_mac_key_share()))
    draws = [
        lambda s: s.next_triplet_batch(16),
        lambda s: (s.next_shared_value_batch(8),),
        lambda s: s.next_shared_inverse_pair_batch(4),
        lambda s: (s.next_shared_bit_batch(8),),
        lambda s: s.next_local_input_mask_batch(4)[1:],
        lambda s: (s.next_counterparty_input_mask_batch(4),),
    ]
    for draw in draws:
        for ps, rs in zip(draw(p), draw(r)):
            np.testing.assert_array_equal(limbs(ps.share), limbs(rs.share))
            np.testing.assert_array_equal(limbs(ps.mac), limbs(rs.mac))


def test_partyid_source_matches_reference():
    for party in (0, 1):
        p = port.PartyIDBeaverSource(party, device="cpu")
        r = ref.PartyIDBeaverSource(party)
        for ps, rs in zip(p.next_triplet_batch(3), r.next_triplet_batch(3)):
            np.testing.assert_array_equal(limbs(ps.share), limbs(rs.share))
            np.testing.assert_array_equal(limbs(ps.mac), limbs(rs.mac))


def test_flagship_forward_matches_reference():
    n = 64
    rng = np.random.default_rng(50)
    arrays = [port.Scalar.random(n, rng, device="cpu") for _ in range(13)]
    key = port.Scalar.random((), rng, device="cpu")

    def as_ref(x):
        return ref.Scalar(jnp.asarray(limbs(x)))

    def shares(mk, cls, vals):
        return [cls(mk(vals[i]), mk(vals[i + 1])) for i in range(0, 10, 2)]

    p_sh = shares(lambda v: v, port.ScalarShare, arrays)
    r_sh = shares(as_ref, ref.ScalarShare, arrays)
    d, e, cf = arrays[10:13]
    pz, pt = port_step.flagship_forward(*p_sh, d, e, key, cf)
    rz, rt = ref_step.flagship_forward(*r_sh, as_ref(d), as_ref(e), as_ref(key),
                                       as_ref(cf))
    np.testing.assert_array_equal(limbs(pz.share), limbs(rz.share))
    np.testing.assert_array_equal(limbs(pz.mac), limbs(rz.mac))
    np.testing.assert_array_equal(limbs(pt), limbs(rt))


def test_entry_points_default_to_cuda():
    """Without a card, an entry point that is not given a device raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.Scalar.from_ints([1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.TrustedDealerSource(0, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.execute_mock_mpc(prog_readme_product)


# -- negative exponents: the port raises where the reference computes a
# positive power (`FieldArray.pow`) or never ends (`MpcFabric.pow`) --------


@pytest.mark.parametrize("e", [-1, -5])
def test_field_pow_rejects_negative_exponent(e):
    x = port.Scalar.from_ints([3, 7], device="cpu")
    with pytest.raises(ValueError, match="exponent"):
        x.pow(e)
    assert x.pow(5).to_ints() == [3 ** 5, 7 ** 5]


@pytest.mark.parametrize("e", [-1, -5])
def test_fabric_pow_rejects_negative_exponent_before_any_round(e):
    def prog(fabric):
        sx = share_in(fabric, XS[:2], 0)
        rounds = fabric.n_rounds
        stream = fabric.offline.rng.bit_generator.state
        with pytest.raises(ValueError, match="exponent"):
            fabric.pow(sx, e)
        assert fabric.n_rounds == rounds
        # no triple was drawn: the dealer's stream has not moved
        assert fabric.offline.rng.bit_generator.state == stream
        return fabric.open_authenticated(fabric.mul(sx, sx)).to_ints()

    r0, r1 = port.execute_mock_mpc_dealer(prog, device="cpu")
    assert r0 == r1 == [x * x % L for x in XS[:2]]
