"""The online core at BN254 Fr, the port against the JAX package.

The eight cases of `tests/test_online_bn254.py` (local share algebra,
share/open, Beaver products, inversion, a bad-MAC abort, the folded
deferred check, and the G1 point protocols) run through both packages'
`execute_mock_mpc` (the port with `device="cpu"`) under
`TrustedDealerSource(field=Fr)` on the same seed: opened values, and where
a case returns them share and MAC limbs, must be identical and equal
Python-int arithmetic.  A received point off the curve must abort.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ark_mpc_tpu as ref
import ark_mpc_tpu_torch as port
from ark_mpc_tpu.algebra import bn254 as ref_bn254
from ark_mpc_tpu.fabric.simulator import execute_mock_mpc as ref_execute
from ark_mpc_tpu_torch.algebra import bn254
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.bn254 import BN254_Q, BN254_R
from ark_mpc_tpu_torch.fabric import points

torch.set_num_threads(1)

_rnd = random.Random(78)
XS = [_rnd.randrange(BN254_R) for _ in range(4)]
YS = [_rnd.randrange(BN254_R) for _ in range(4)]
INV_XS = [_rnd.randrange(1, BN254_R) for _ in range(3)]
SECRETS = [_rnd.randrange(1, BN254_R) for _ in range(2)]


def is_port(fabric) -> bool:
    return isinstance(fabric, port.MpcFabric)


def fr(fabric, vals):
    if is_port(fabric):
        return bn254.Fr.from_ints(vals, device=fabric.device)
    return ref_bn254.Fr.from_ints(vals)


def generator(fabric, n):
    if is_port(fabric):
        return bn254.G1.generator((n,), device=fabric.device)
    return ref_bn254.G1.generator((n,))


def limbs(x) -> np.ndarray:
    if isinstance(x.limbs, torch.Tensor):
        return x.limbs.cpu().numpy().astype(np.uint32)
    return np.asarray(x.limbs)


def share_in(fabric, vals, sender):
    return fabric.share_values(fr(fabric, vals) if fabric.party_id == sender else None,
                               sender=sender, n=len(vals))


def affine(pt):
    x, y = pt.normalize().to_affine()
    return [x.to_ints(), y.to_ints()]


def affine_mul(k: int):
    """k G on y^2 = x^3 + 3 by Python-int affine arithmetic (k != 0 mod r)."""
    q = BN254_Q

    def add(p1, p2):
        if p1 is None:
            return p2
        (x1, y1), (x2, y2) = p1, p2
        if p1 == p2:
            lam = 3 * x1 * x1 * pow(2 * y1, -1, q) % q
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, q) % q
        x3 = (lam * lam - x1 - x2) % q
        return x3, (lam * (x1 - x3) - y1) % q

    acc = None
    for bit in bin(k)[2:]:
        acc = add(acc, acc)
        if bit == "1":
            acc = add(acc, (1, 2))
    return acc


# -- the cases of tests/test_online_bn254.py ---------------------------------


def prog_share_open(fabric):
    assert fabric.field is (bn254.Fr if is_port(fabric) else ref_bn254.Fr)
    sx = share_in(fabric, XS, 0)
    v = fabric.open_authenticated(sx)
    return {"open": v.to_ints(), "share": limbs(sx.share), "mac": limbs(sx.mac)}


def prog_beaver_mul(fabric):
    sz = fabric.mul(share_in(fabric, XS[:3], 0), share_in(fabric, YS[:3], 1))
    z = fabric.open_authenticated(sz, defer=True)
    fabric.verify_deferred()
    return {"open": z.to_ints(), "share": limbs(sz.share), "mac": limbs(sz.mac),
            "rounds": fabric.n_rounds}


def prog_inverse(fabric):
    inv = fabric.inverse(share_in(fabric, INV_XS, 0))
    return {"open": fabric.open_authenticated(inv).to_ints(), "share": limbs(inv.share)}


def prog_folded_deferred_check(fabric):
    sz = fabric.mul(share_in(fabric, XS, 0), share_in(fabric, YS, 1))
    o = fabric.open_authenticated(sz, defer=True)
    fabric.verify_deferred(fold=True)
    return {"open": o.to_ints(), "rounds": fabric.n_rounds}


def prog_point_share_open(fabric):
    pts = (generator(fabric, 2).mul(fr(fabric, SECRETS)) if fabric.party_id == 0
           else None)
    ps = fabric.share_points(pts, sender=0, n=2)
    return {"open": affine(fabric.open_authenticated_points(ps)),
            "rounds": fabric.n_rounds}


def prog_point_beaver_mul(fabric):
    sx = share_in(fabric, SECRETS, 0)
    pg = fabric.mul_generator(share_in(fabric, YS[:2], 1))
    prod = fabric.mul_points(sx, pg)
    return {"open": affine(fabric.open_authenticated_points(prod)),
            "rounds": fabric.n_rounds}


def prog_bad_mac(fabric):
    sx = share_in(fabric, XS[:2], 0)
    if fabric.party_id == 1:
        cls = port.ScalarShare if is_port(fabric) else ref.ScalarShare
        sx = cls(sx.share, sx.mac + fr(fabric, [1, 1]))
    return fabric.open_authenticated(sx).to_ints()


R = BN254_R
PROGRAMS = {
    "share_open": (prog_share_open, XS),
    "beaver_mul": (prog_beaver_mul, [x * y % R for x, y in zip(XS[:3], YS[:3])]),
    "inverse": (prog_inverse, [pow(x, -1, R) for x in INV_XS]),
    "folded_deferred_check": (prog_folded_deferred_check,
                              [x * y % R for x, y in zip(XS, YS)]),
    "point_share_open": (prog_point_share_open,
                         [list(c) for c in zip(*(affine_mul(s) for s in SECRETS))]),
    "point_beaver_mul": (prog_point_beaver_mul,
                         [list(c) for c in zip(*(affine_mul(x * y % R)
                                                 for x, y in zip(SECRETS, YS[:2])))]),
}


def run(pkg, prog, seed=7):
    if pkg is port:
        return port.execute_mock_mpc(
            prog, offline_factory=lambda pid: port.TrustedDealerSource(
                pid, seed=seed, field=bn254.Fr, device="cpu"), device="cpu")
    return ref_execute(prog, offline_factory=lambda pid: ref.TrustedDealerSource(
        pid, seed=seed, field=ref_bn254.Fr))


def same(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_matches_reference(name):
    prog, expected = PROGRAMS[name]
    p0, p1 = run(port, prog)
    r0, r1 = run(ref, prog)
    same(p0, r0)
    same(p1, r1)
    assert p0["open"] == p1["open"]
    assert p0["open"] == expected


def test_share_algebra_local_matches_reference():
    """Linear ops act on share and MAC together; add_public moves party 0's
    share only."""
    def both(pkg, mod):
        def mk(v):
            return (mod.Fr.from_ints(v, device="cpu") if pkg is port
                    else mod.Fr.from_ints(v))
        a = pkg.ScalarShare(mk([5, 6]), mk([50, 60]))
        b = pkg.ScalarShare(mk([1, 2]), mk([10, 20]))
        k = mk(3)
        outs = [a + b, (a - b).mul_public(mk(2)),
                a.add_public(mk([7, 7]), k, party_id=0),
                a.add_public(mk([7, 7]), k, party_id=1)]
        return [(limbs(s.share), limbs(s.mac)) for s in outs], outs

    got, outs = both(port, bn254)
    want, _ = both(ref, ref_bn254)
    for (gs, gm), (ws, wm) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gm, wm)
    assert type(outs[0].share) is bn254.Fr
    assert [o.share.to_ints() for o in outs] == [[6, 8], [8, 8], [12, 13], [5, 6]]
    assert [o.mac.to_ints() for o in outs] == [[60, 80], [80, 80], [71, 81], [71, 81]]


def test_bad_mac_aborts_in_both_packages():
    with pytest.raises(port.AuthenticationError):
        run(port, prog_bad_mac)
    with pytest.raises(ref.AuthenticationError):
        run(ref, prog_bad_mac)


def prog_off_curve_input(fabric):
    """Party 0 sends the canonical affine pair (5, 7), which is not on
    y^2 = x^3 + 3, where `share_points` expects its masked point."""
    if fabric.party_id == 0:
        fabric.offline.next_local_input_mask_batch(1)
        fabric.send_arrays([lb.ints_to_limb_array([5]), lb.ints_to_limb_array([7])])
        return None
    return fabric.share_points(None, sender=0, n=1)


def test_off_curve_received_point_aborts():
    assert not bool(bn254.G1.from_wire_affine(
        *(torch.from_numpy(lb.ints_to_limb_array([v]).astype(np.int32)) for v in (5, 7))
    ).is_on_curve())
    with pytest.raises(port.AuthenticationError, match="curve"):
        run(port, prog_off_curve_input)
    # the identity's encoding (0, 0) and the generator (1, 2) are accepted
    xc, yc = lb.ints_to_limb_array([0, 1]), lb.ints_to_limb_array([0, 2])
    pt = points._point_from_wire_checked(SimpleNamespace(device=torch.device("cpu")),
                                         bn254.G1, xc, yc)
    assert pt.is_identity().tolist() == [True, False]
