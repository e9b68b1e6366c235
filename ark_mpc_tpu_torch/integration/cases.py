"""The registered integration cases: a copy of `ark_mpc_tpu/integration/
cases.py` (the ark-mpc inventory of `integration/src/main.rs:101-224`),
the slow dealer-free LowGear case included.

Every case runs on BOTH parties over the real wire; inputs come from
per-case seeded `random.Random`, so the parties agree without
communication, and every value is made on `fabric.device`.  Assertions
raise on failure; the malicious cases assert that BOTH parties abort with
`AuthenticationError`.
"""

from __future__ import annotations

import random

from ..algebra.curve import CurvePoint
from ..algebra.domain import EvaluationDomain
from ..algebra.fields import CURVE25519_ORDER as L
from ..algebra.poly import AuthenticatedDensePoly, DensePoly, poly_div, poly_mul, poly_open
from ..algebra.scalar import Scalar
from ..algebra.share import ScalarShare
from ..fabric.errors import AuthenticationError
from ..fabric.points import msm_public_points
from ..gadgets import bit_xor, bit_xor_public, prefix_product
from . import integration_test, slow_integration_test

# ---------------------------------------------------------------------------
# share / open family (`fabric.rs` + `authenticated_scalar.rs` tests)
# ---------------------------------------------------------------------------


def _share(fabric, vals, sender):
    return fabric.share_values(
        Scalar.from_ints(vals, device=fabric.device)
        if fabric.party_id == sender else None,
        sender=sender, n=len(vals))


@integration_test
def share_and_open(fabric):
    rng = random.Random(101)
    xs = [rng.randrange(L) for _ in range(4)]
    sx = _share(fabric, xs, sender=0)
    assert fabric.open(sx).to_ints() == xs


@integration_test
def share_and_open_authenticated(fabric):
    rng = random.Random(102)
    xs = [rng.randrange(L) for _ in range(4)]
    sx = _share(fabric, xs, sender=1)
    assert fabric.open_authenticated(sx).to_ints() == xs


@integration_test
def share_both_directions(fabric):
    rng = random.Random(103)
    a, b = rng.randrange(L), rng.randrange(L)
    sa = _share(fabric, [a], sender=0)
    sb = _share(fabric, [b], sender=1)
    assert fabric.open_authenticated(sa + sb).to_ints() == [(a + b) % L]


@integration_test
def share_public_and_constants(fabric):
    rng = random.Random(104)
    v, k = rng.randrange(L), rng.randrange(L)
    sv = fabric.share_public(Scalar.from_ints([v], device=fabric.device))
    r = fabric.add_public(sv.mul_public(Scalar.from_ints(k, device=fabric.device)),
                          Scalar.from_ints(1, device=fabric.device))
    assert fabric.open_authenticated(r).to_ints() == [(v * k + 1) % L]


@integration_test
def linear_ops(fabric):
    rng = random.Random(105)
    xs = [rng.randrange(L) for _ in range(8)]
    ys = [rng.randrange(L) for _ in range(8)]
    sx, sy = _share(fabric, xs, 0), _share(fabric, ys, 1)
    z = sx + sy - sx.mul_public(Scalar.from_ints(2, device=fabric.device))
    want = [(y - x) % L for x, y in zip(xs, ys)]
    assert fabric.open_authenticated(z).to_ints() == want


# ---------------------------------------------------------------------------
# multiplication family
# ---------------------------------------------------------------------------


@integration_test
def beaver_mul_batch(fabric):
    rng = random.Random(106)
    xs = [rng.randrange(L) for _ in range(32)]
    ys = [rng.randrange(L) for _ in range(32)]
    sx, sy = _share(fabric, xs, 0), _share(fabric, ys, 1)
    z = fabric.mul(sx, sy)
    want = [(x * y) % L for x, y in zip(xs, ys)]
    assert fabric.open_authenticated(z).to_ints() == want


@integration_test
def mul_chain(fabric):
    rng = random.Random(107)
    xs = [rng.randrange(L) for _ in range(4)]
    ys = [rng.randrange(L) for _ in range(4)]
    sx, sy = _share(fabric, xs, 0), _share(fabric, ys, 1)
    z = sx
    want = list(xs)
    for _ in range(3):
        z = fabric.mul(z, sy)
        want = [(w * y) % L for w, y in zip(want, ys)]
    assert fabric.open_authenticated(z).to_ints() == want


@integration_test
def inverse_batch(fabric):
    rng = random.Random(108)
    xs = [rng.randrange(1, L) for _ in range(8)]
    sx = _share(fabric, xs, 0)
    inv = fabric.inverse(sx)
    prod = fabric.mul(sx, inv)
    assert fabric.open_authenticated(prod).to_ints() == [1] * 8


@integration_test
def pow_public_exponent(fabric):
    rng = random.Random(109)
    x = rng.randrange(L)
    sx = _share(fabric, [x], 0)
    r = fabric.pow(sx, 13)
    assert fabric.open_authenticated(r).to_ints() == [pow(x, 13, L)]


@integration_test
def deferred_check_batch(fabric):
    rng = random.Random(110)
    xs = [rng.randrange(L) for _ in range(8)]
    ys = [rng.randrange(L) for _ in range(8)]
    sx, sy = _share(fabric, xs, 0), _share(fabric, ys, 1)
    o1 = fabric.open_authenticated(fabric.mul(sx, sy), defer=True)
    o2 = fabric.open_authenticated(sx + sy, defer=True)
    fabric.verify_deferred()
    assert o1.to_ints() == [(x * y) % L for x, y in zip(xs, ys)]
    assert o2.to_ints() == [(x + y) % L for x, y in zip(xs, ys)]


@integration_test
def deferred_check_folded(fabric):
    """Folded deferred check (public-coin RLC -> O(1) wire bytes) over the
    real wire, including the coin commit-reveal."""
    rng = random.Random(111)
    xs = [rng.randrange(L) for _ in range(16)]
    ys = [rng.randrange(L) for _ in range(16)]
    sx, sy = _share(fabric, xs, 0), _share(fabric, ys, 1)
    o = fabric.open_authenticated(fabric.mul(sx, sy), defer=True)
    fabric.verify_deferred(fold=True)
    assert o.to_ints() == [(x * y) % L for x, y in zip(xs, ys)]


# ---------------------------------------------------------------------------
# gadgets + polynomials (`gadgets.rs`, `poly.rs` analogs)
# ---------------------------------------------------------------------------


@integration_test
def gadget_bit_xor(fabric):
    rng = random.Random(112)
    a = [rng.randrange(2) for _ in range(8)]
    b = [rng.randrange(2) for _ in range(8)]
    sa, sb = _share(fabric, a, 0), _share(fabric, b, 1)
    r = bit_xor(fabric, sa, sb)
    p = bit_xor_public(fabric, sa, Scalar.from_ints(b, device=fabric.device))
    want = [x ^ y for x, y in zip(a, b)]
    assert fabric.open_authenticated(r).to_ints() == want
    assert fabric.open_authenticated(p).to_ints() == want


@integration_test
def gadget_prefix_product(fabric):
    rng = random.Random(113)
    vals = [rng.randrange(1, L) for _ in range(6)]
    sv = _share(fabric, vals, 0)
    res = prefix_product(fabric, sv)
    want, acc = [], 1
    for v in vals:
        acc = acc * v % L
        want.append(acc)
    assert fabric.open_authenticated(res).to_ints() == want


@integration_test
def poly_mul_authenticated(fabric):
    rng = random.Random(114)
    a = [rng.randrange(L) for _ in range(3)]
    b = [rng.randrange(L) for _ in range(4)]
    pa = AuthenticatedDensePoly(_share(fabric, a, 0))
    pb = AuthenticatedDensePoly(_share(fabric, b, 1))
    prod = poly_mul(fabric, pa, pb)
    got = poly_open(fabric, prod).to_ints()
    want = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            want[i + j] = (want[i + j] + ai * bj) % L
    assert got == want


# ---------------------------------------------------------------------------
# curve points (`authenticated_curve.rs` analogs)
# ---------------------------------------------------------------------------


def _rand_points(fabric, seed, n):
    rng = random.Random(seed)
    ks = [rng.randrange(L) for _ in range(n)]
    dev = fabric.device
    return CurvePoint.generator((n,), device=dev).mul(
        Scalar.from_ints(ks, device=dev)), ks


def _affine(pt):
    x, y = pt.to_affine()
    return list(zip(x.to_ints(), y.to_ints()))


@integration_test
def point_share_open(fabric):
    pts, _ = _rand_points(fabric, 115, 2)
    sp = fabric.share_points(pts if fabric.party_id == 0 else None,
                             sender=0, n=2)
    assert _affine(fabric.open_authenticated_points(sp)) == _affine(pts)


@integration_test
def point_scalar_mul(fabric):
    rng = random.Random(116)
    k = rng.randrange(L)
    pts, ks = _rand_points(fabric, 117, 1)
    sk = _share(fabric, [k], 0)
    sp = fabric.share_points(pts if fabric.party_id == 1 else None,
                             sender=1, n=1)
    r = fabric.mul_points(sk, sp)
    want = CurvePoint.generator((1,), device=fabric.device).mul(
        Scalar.from_ints([k * ks[0] % L], device=fabric.device))
    assert _affine(fabric.open_authenticated_points(r)) == _affine(want)


@integration_test
def point_generator_mul(fabric):
    rng = random.Random(118)
    k = rng.randrange(L)
    sk = _share(fabric, [k], 1)
    r = fabric.mul_generator(sk)
    want = CurvePoint.generator((1,), device=fabric.device).mul(
        Scalar.from_ints([k], device=fabric.device))
    assert _affine(fabric.open_authenticated_points(r)) == _affine(want)


# ---------------------------------------------------------------------------
# traced circuits (`fabric.rs` dataflow tests)
# ---------------------------------------------------------------------------


@integration_test
def traced_circuit(fabric):
    rng = random.Random(119)
    xs = [rng.randrange(L) for _ in range(4)]
    ys = [rng.randrange(L) for _ in range(4)]
    sx, sy = _share(fabric, xs, 0), _share(fabric, ys, 1)
    tr = fabric.tracer()
    x, y = tr.wrap(sx), tr.wrap(sy)
    a = x * y
    b = (a + x) * y
    oa, ob = a.open(), b.open()
    tr.run()
    want_a = [(x_ * y_) % L for x_, y_ in zip(xs, ys)]
    want_b = [((a_ + x_) * y_) % L for a_, x_, y_ in zip(want_a, xs, ys)]
    assert oa.value.to_ints() == want_a
    assert ob.value.to_ints() == want_b


# ---------------------------------------------------------------------------
# malicious aborts over the real wire (`integration` malicious configs)
# ---------------------------------------------------------------------------


@integration_test
def scalar_neg_sub(fabric):
    """test_neg / test_sub / test_batch_sub (`authenticated_scalar.rs`)."""
    rng = random.Random(123)
    xs = [rng.randrange(L) for _ in range(8)]
    ys = [rng.randrange(L) for _ in range(8)]
    sx, sy = _share(fabric, xs, 0), _share(fabric, ys, 1)
    want = [(-x - (x - y)) % L for x, y in zip(xs, ys)]
    assert fabric.open_authenticated(-sx - (sx - sy)).to_ints() == want


@integration_test
def public_add_then_mul(fabric):
    """test_public_add_then_mul (`integration/src/mpc.rs`): the add-public
    party-0 asymmetry must survive a downstream Beaver multiply."""
    rng = random.Random(124)
    x, y, k = (rng.randrange(L) for _ in range(3))
    sx, sy = _share(fabric, [x], 0), _share(fabric, [y], 1)
    z = fabric.mul(fabric.add_public(sx, Scalar.from_ints(k, device=fabric.device)), sy)
    assert fabric.open_authenticated(z).to_ints() == [(x + k) * y % L]


@integration_test
def point_linear_ops(fabric):
    """test_add / test_sub / test_negation on authenticated points
    (`authenticated_curve.rs`)."""
    # batch 2 everywhere in the point family: CPU jit-caches are
    # shape-specialized, so shared shapes keep the registry fast
    pa, _ = _rand_points(fabric, 125, 2)
    pb, _ = _rand_points(fabric, 126, 2)
    sa = fabric.share_points(pa if fabric.party_id == 0 else None,
                             sender=0, n=2)
    sb = fabric.share_points(pb if fabric.party_id == 1 else None,
                             sender=1, n=2)
    got = fabric.open_authenticated_points(sa + sb - (-sa))
    assert _affine(got) == _affine(pa + pb + pa)


@integration_test
def point_add_public(fabric):
    """test_addition_public_point / test_sub_public_point."""
    pa, _ = _rand_points(fabric, 127, 2)
    pub, _ = _rand_points(fabric, 128, 2)
    pub2, _ = _rand_points(fabric, 139, 2)
    sa = fabric.share_points(pa if fabric.party_id == 0 else None,
                             sender=0, n=2)
    r = sa.add_public(pub, fabric.mac_key_share(), fabric.party_id)
    r = r.sub_public(pub2, fabric.mac_key_share(), fabric.party_id)
    want = pa + pub - pub2
    assert _affine(fabric.open_authenticated_points(r)) == _affine(want)


@integration_test
def point_mul_public_scalar(fabric):
    """test_mul_public_scalar on a point share (`curve/share.rs:84-97`)."""
    rng = random.Random(129)
    k = rng.randrange(L)
    pa, ks = _rand_points(fabric, 130, 2)
    sa = fabric.share_points(pa if fabric.party_id == 1 else None,
                             sender=1, n=2)
    got = fabric.open_authenticated_points(
        sa.mul_public(Scalar.from_ints(k, device=fabric.device)))
    want = CurvePoint.generator((2,), device=fabric.device).mul(
        Scalar.from_ints([x * k % L for x in ks], device=fabric.device))
    assert _affine(got) == _affine(want)


@integration_test
def point_msm(fabric):
    """test_msm: authenticated MSM (shared scalars x shared points) over the
    wire (`authenticated_curve.rs:785-818`)."""
    rng = random.Random(131)
    n = 2
    ks = [rng.randrange(L) for _ in range(n)]
    pts, ps = _rand_points(fabric, 132, n)
    sk = _share(fabric, ks, 0)
    sp = fabric.share_points(pts if fabric.party_id == 1 else None,
                             sender=1, n=n)
    res = fabric.msm(sk, sp)
    acc = sum(k * p for k, p in zip(ks, ps)) % L
    want = CurvePoint.generator((1,), device=fabric.device).mul(
        Scalar.from_ints([acc], device=fabric.device))
    assert _affine(fabric.open_authenticated_points(res.reshape(1))) \
        == _affine(want)


@integration_test
def point_msm_public(fabric):
    """msm with PUBLIC points — local kernel, no extra rounds
    (`curve/curve.rs:616-657` msm_authenticated)."""
    rng = random.Random(133)
    n = 2
    ks = [rng.randrange(L) for _ in range(n)]
    pts, ps = _rand_points(fabric, 134, n)
    sk = _share(fabric, ks, 1)
    res = msm_public_points(sk, pts)
    acc = sum(k * p for k, p in zip(ks, ps)) % L
    want = CurvePoint.generator((1,), device=fabric.device).mul(
        Scalar.from_ints([acc], device=fabric.device))
    assert _affine(fabric.open_authenticated_points(res.reshape(1))) \
        == _affine(want)


@integration_test
def circuit_inner_product(fabric):
    """test_inner_product (`integration/src/circuits.rs`)."""
    rng = random.Random(135)
    n = 16
    xs = [rng.randrange(L) for _ in range(n)]
    ys = [rng.randrange(L) for _ in range(n)]
    sx, sy = _share(fabric, xs, 0), _share(fabric, ys, 1)
    tr = fabric.tracer()
    ip = (tr.wrap(sx) * tr.wrap(sy)).sum()
    o = ip.open()
    tr.run()
    want = sum(x * y for x, y in zip(xs, ys)) % L
    assert o.value.to_ints() == [want]


@integration_test
def poly_eval(fabric):
    """test_polynomial_eval: authenticated poly evaluated at a public point
    (`authenticated_poly.rs` eval)."""
    rng = random.Random(136)
    coeffs = [rng.randrange(L) for _ in range(5)]
    x = rng.randrange(L)
    p = AuthenticatedDensePoly(_share(fabric, coeffs, 0))
    got = fabric.open_authenticated(p.eval(Scalar.from_ints([x], device=fabric.device)))
    want = 0
    for c in reversed(coeffs):
        want = (want * x + c) % L
    assert got.to_ints() == [want]


@integration_test
def poly_div_public(fabric):
    """Floor division of a shared poly by a public poly over the wire
    (rev transform + Newton inverse, `authenticated_poly.rs:446-575`)."""
    rng = random.Random(137)
    q = [rng.randrange(L) for _ in range(3)]
    g = [rng.randrange(L) for _ in range(2)] + [1]  # monic divisor
    rem = [rng.randrange(L) for _ in range(2)]
    # f = q*g + rem  (deg f = 4)
    f = [0] * 5
    for i, qi in enumerate(q):
        for j, gj in enumerate(g):
            f[i + j] = (f[i + j] + qi * gj) % L
    for i, ri in enumerate(rem):
        f[i] = (f[i] + ri) % L
    sf = AuthenticatedDensePoly(_share(fabric, f, 0))
    quot = poly_div(fabric, sf, DensePoly.from_ints(g, device=fabric.device))
    assert poly_open(fabric, quot).to_ints()[:3] == q


@integration_test
def share_fft_roundtrip(fabric):
    """Share-wise FFT/IFFT keeps the authenticated sharing valid
    (`share.rs:168-191` fft_helper; `authenticated_scalar.rs:1010-1069`)."""
    rng = random.Random(138)
    n = 12
    xs = [rng.randrange(L) for _ in range(n)]
    sx = _share(fabric, xs, 0)
    dom = EvaluationDomain(n, device=fabric.device)
    back = dom.fft_shares(dom.fft_shares(sx, forward=True), forward=False)
    assert fabric.open_authenticated(back).to_ints() == xs


@integration_test
def offline_randomness_sources(fabric):
    """The preprocessing passthroughs over the wire: shared bits are bits,
    inverse pairs multiply to one, random shares open consistently
    (`fabric.rs:876-978` sampling APIs)."""
    bits = fabric.random_shared_bits(8)
    ob = fabric.open_authenticated(bits)
    assert all(b in (0, 1) for b in ob.to_ints())
    r, r_inv = fabric.random_inverse_pairs(4)
    prod = fabric.mul(r, r_inv)
    assert fabric.open_authenticated(prod).to_ints() == [1] * 4
    rv = fabric.random_shared_scalars(4)
    fabric.open_authenticated(rv)  # MAC-checked open must pass


@slow_integration_test
def lowgear_dealer_free_e2e(fabric):
    """test_setup_and_run_circuit (`integration/src/lowgear.rs:15-51`): the
    whole dealer-free flow over the real wire: BGV key exchange with its
    proofs, LowGear preprocessing at the prototype ring (m = 132), then an
    online product over a fresh fabric on the same transport, consuming the
    generated prep.  Registered as a slow case, run when named (`--tests
    lowgear_dealer_free_e2e`)."""
    import numpy as np

    from ..fabric.context import MpcFabric
    from ..offline.bgv.bgv_l import default_ring
    from ..offline.lowgear.core import LowGear
    from ..offline.structs import OfflineSizingParams

    pid, dev = fabric.party_id, fabric.device
    lg = LowGear(pid, fabric.transport, mode="bgv", ring=default_ring(device=dev),
                 allow_insecure_ring=True, rng=np.random.default_rng(140 + pid), device=dev)
    lg.run_offline_phase(OfflineSizingParams(
        num_triples=4, num_inverse_pairs=1, num_bits=1,
        num_randomness=2, num_input_masks=2))
    online = MpcFabric(pid, fabric.transport, lg.get_offline_result(), device=dev)
    sx = online.share_values(
        Scalar.from_ints([6, 7], device=dev) if pid == 0 else None, sender=0, n=2)
    sy = online.share_values(
        Scalar.from_ints([8, 9], device=dev) if pid == 1 else None, sender=1, n=2)
    z = online.open_authenticated(online.mul(sx, sy))
    assert z.to_ints() == [48, 63], z.to_ints()


@integration_test
def malicious_bad_mac_aborts(fabric):
    rng = random.Random(120)
    xs = [rng.randrange(L) for _ in range(4)]
    sx = _share(fabric, xs, 0)
    if fabric.party_id == 1:  # party 1 turns malicious
        sx = ScalarShare(sx.share,
                         sx.mac + Scalar.from_ints([1] * 4, device=fabric.device))
    try:
        fabric.open_authenticated(sx)
    except AuthenticationError:
        return  # both parties must land here
    raise AssertionError("bad MAC was not detected over the wire")


@integration_test
def malicious_bad_share_aborts(fabric):
    rng = random.Random(121)
    xs = [rng.randrange(L) for _ in range(4)]
    sx = _share(fabric, xs, 1)
    if fabric.party_id == 0:
        sx = ScalarShare(sx.share + Scalar.from_ints([3] * 4, device=fabric.device),
                         sx.mac)
    try:
        fabric.open_authenticated(sx)
    except AuthenticationError:
        return
    raise AssertionError("corrupted share was not detected over the wire")


@integration_test
def malicious_folded_check_aborts(fabric):
    rng = random.Random(122)
    xs = [rng.randrange(L) for _ in range(4)]
    sx = _share(fabric, xs, 0)
    if fabric.party_id == 1:
        sx = ScalarShare(sx.share,
                         sx.mac + Scalar.from_ints([2] * 4, device=fabric.device))
    try:
        fabric.open_authenticated(sx, defer=True)
        fabric.verify_deferred(fold=True)
    except AuthenticationError:
        return
    raise AssertionError("bad MAC survived the folded deferred check")
