"""The port's authenticated point protocols against the JAX package (CPU).

The programs of `tests/test_points.py` that the fast tier runs go through
both packages' `execute_mock_mpc_dealer` with the same dealer seed; the
opened affine points must be identical to each other and to Python-int
Edwards arithmetic.  The protocols the reference only runs in its slow tier
(share/open, authenticated MSM) run on the port alone, against Python ints,
as do the aborts on received points outside the prime-order subgroup.
"""

import random

import pytest
import torch

import ark_mpc_tpu as ref
import ark_mpc_tpu_torch as port
from ark_mpc_tpu.algebra.curve import CurvePoint as RPoint
from ark_mpc_tpu.algebra.point_share import PointShare as RPointShare
from ark_mpc_tpu_torch.algebra.curve import CurvePoint, ED_D, GEN_X, GEN_Y, P
from ark_mpc_tpu_torch.algebra.point_share import PointShare

torch.set_num_threads(1)

L = port.Scalar.spec.modulus
G = (GEN_X, GEN_Y)
rng = random.Random(23)


def ref_add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    t = ED_D * x1 * x2 % P * y1 % P * y2 % P
    return ((x1 * y2 + x2 * y1) * pow(1 + t, -1, P) % P,
            (y1 * y2 + x1 * x2) * pow(1 - t, -1, P) % P)


def ref_mul(k, pt):
    acc = (0, 1)
    while k:
        if k & 1:
            acc = ref_add(acc, pt)
        pt = ref_add(pt, pt)
        k >>= 1
    return acc


def is_port(fabric) -> bool:
    return isinstance(fabric, port.MpcFabric)


def points(fabric, aff):
    xs, ys = [a[0] for a in aff], [a[1] for a in aff]
    if is_port(fabric):
        return CurvePoint.from_affine_ints(xs, ys, device=fabric.device)
    return RPoint.from_affine_ints(xs, ys)


def scalars(fabric, vals):
    if is_port(fabric):
        return fabric.field.from_ints(vals, device=fabric.device)
    return fabric.field.from_ints(vals)


def affine(pt):
    x, y = pt.to_affine()
    return list(zip(x.to_ints(), y.to_ints()))


def share_pts(fabric, aff, sender):
    return fabric.share_points(points(fabric, aff) if fabric.party_id == sender
                               else None, sender=sender, n=len(aff))


def share_vals(fabric, vals, sender):
    return fabric.share_values(scalars(fabric, vals) if fabric.party_id == sender
                               else None, sender=sender, n=len(vals))


PA = [ref_mul(rng.randrange(1, L), G) for _ in range(2)]
QA = [ref_mul(rng.randrange(1, L), G) for _ in range(2)]
KS = [rng.randrange(L) for _ in range(2)]


def prog_linear_ops(fabric):
    sp, sq = share_pts(fabric, PA, 0), share_pts(fabric, QA, 1)
    return affine(fabric.open_authenticated_points(sp + sq))


def prog_beaver_scalar_point_mul(fabric):
    sp, sk = share_pts(fabric, PA, 0), share_vals(fabric, KS, 1)
    return affine(fabric.open_authenticated_points(fabric.mul_points(sk, sp)))


def prog_mul_generator(fabric):
    return affine(fabric.open_authenticated_points(
        fabric.mul_generator(share_vals(fabric, KS, 0))))


def prog_bad_point_mac(fabric):
    sp = share_pts(fabric, PA, 0)
    if fabric.party_id == 1:
        cls = PointShare if is_port(fabric) else RPointShare
        gen = (CurvePoint.generator((2,), device=fabric.device) if is_port(fabric)
               else RPoint.generator((2,)))
        sp = cls(sp.share, sp.mac + gen)
    return fabric.open_authenticated_points(sp)


PROGRAMS = {
    "linear_ops": (prog_linear_ops, [ref_add(a, b) for a, b in zip(PA, QA)]),
    "beaver_scalar_point_mul": (prog_beaver_scalar_point_mul,
                                [ref_mul(k, a) for k, a in zip(KS, PA)]),
    "mul_generator": (prog_mul_generator, [ref_mul(k, G) for k in KS]),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_matches_reference(name):
    prog, expected = PROGRAMS[name]
    got = port.execute_mock_mpc_dealer(prog, device="cpu")
    want = ref.execute_mock_mpc_dealer(prog)
    assert got[0] == got[1] == want[0] == want[1] == expected


def test_bad_point_mac_rejected_by_both():
    with pytest.raises(port.AuthenticationError):
        port.execute_mock_mpc_dealer(prog_bad_point_mac, device="cpu")
    with pytest.raises(ref.AuthenticationError):
        ref.execute_mock_mpc_dealer(prog_bad_point_mac)


def test_share_open_and_deferred_checks():
    """Share, open with and without the MAC check, public sharing, and
    deferred scalar and point checks verified in one call."""
    def prog(fabric):
        sp = share_pts(fabric, PA, 0)
        plain = affine(fabric.open_points(sp))
        pub = fabric.share_public_points(points(fabric, QA))
        both = fabric.open_authenticated_points(sp - pub, defer=True)
        x = fabric.open_authenticated(share_vals(fabric, KS, 1), defer=True)
        fabric.verify_deferred()
        assert not fabric._deferred_points and not fabric._deferred
        return plain, affine(both), x.to_ints()

    r0, r1 = port.execute_mock_mpc_dealer(prog, device="cpu")
    neg_q = [((-x) % P, y) for x, y in QA]
    assert r0 == r1 == (PA, [ref_add(a, b) for a, b in zip(PA, neg_q)], KS)


def test_authenticated_msm():
    n = 3
    aff = PA + QA[:1]
    ks = [rng.randrange(L) for _ in range(n)]
    want = (0, 1)
    for k, a in zip(ks, aff):
        want = ref_add(want, ref_mul(k, a))

    def prog(fabric):
        res = fabric.msm(share_vals(fabric, ks, 1), share_pts(fabric, aff, 0))
        return affine(fabric.open_authenticated_points(res.reshape(1)))

    r0, r1 = port.execute_mock_mpc_dealer(prog, device="cpu")
    assert r0 == r1 == [want]


def test_off_subgroup_input_aborts():
    """A point with an order-2 component, sent as an input, fails the
    receiver's subgroup check; a point off the curve fails its curve check."""
    mixed = [((-x) % P, (-y) % P) for x, y in PA]  # P + (0, -1)
    off_curve = [(x, (y + 1) % P) for x, y in PA]
    for bad in (mixed, off_curve):
        with pytest.raises(port.AuthenticationError, match="validation"):
            port.execute_mock_mpc_dealer(lambda f, b=bad: share_pts(f, b, 0),
                                         device="cpu")
