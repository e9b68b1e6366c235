"""The port's Ed25519 curve layer against the JAX package and Python ints (CPU).

Points built from the same affine ints have identical limbs in both
packages, so one formula step (add, double, hash-to-curve) must agree bit
for bit.  Scalar multiplication and MSM run other algorithms in the two
packages on the CPU (the port's windowed kernel in its plain form, the
reference's XLA ladder), so those compare affine ints, exactly.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.algebra import curve as rc
from ark_mpc_tpu.algebra.scalar import BaseFelt as RBaseFelt
from ark_mpc_tpu.algebra.scalar import Scalar as RScalar
from ark_mpc_tpu.ops import curve_kernels as rk
from ark_mpc_tpu_torch.algebra import curve as pc
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.scalar import BaseFelt, Scalar
from ark_mpc_tpu_torch.ops import curve_kernels as ck

torch.set_num_threads(1)

P, D, L = pc.P, pc.ED_D, Scalar.spec.modulus
G = (pc.GEN_X, pc.GEN_Y)
rng = random.Random(41)


def ref_add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    t = D * x1 * x2 % P * y1 % P * y2 % P
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


def on_curve(x, y):
    return (-x * x + y * y) % P == (1 + D * x * x % P * y * y) % P


def affine(pt):
    x, y = pt.to_affine()
    return list(zip(x.to_ints(), y.to_ints()))


def limbs(pt) -> list:
    return [np.asarray(c.limbs.cpu() if isinstance(c.limbs, torch.Tensor)
                       else c.limbs).astype(np.uint32)
            for c in (pt.X, pt.Y, pt.Z, pt.T)]


def same_limbs(a, b):
    for u, v in zip(limbs(a), limbs(b)):
        np.testing.assert_array_equal(u, v)


AFF = [ref_mul(rng.randrange(1, L), G) for _ in range(6)]
AFF2 = [ref_mul(rng.randrange(1, L), G) for _ in range(6)]


def both(aff):
    xs, ys = [a[0] for a in aff], [a[1] for a in aff]
    return (pc.CurvePoint.from_affine_ints(xs, ys, device="cpu"),
            rc.CurvePoint.from_affine_ints(xs, ys))


def test_group_law_matches_reference_bit_for_bit():
    (pa, ra), (pb, rb) = both(AFF), both(AFF2)
    same_limbs(pa, ra)
    same_limbs(pa + pb, ra + rb)
    same_limbs(pa - pb, ra - rb)
    same_limbs(pa.double(), ra.double())
    same_limbs((pa + pb).double() + pa, (ra + rb).double() + ra)
    assert affine(pa + pb) == [ref_add(a, b) for a, b in zip(AFF, AFF2)]
    assert affine(pa.double()) == [ref_add(a, a) for a in AFF]
    ident = pa - pa
    assert bool(ident.is_identity().all())
    assert affine(ident) == [(0, 1)] * len(AFF)
    assert affine(pc.CurvePoint.identity((6,), device="cpu") + pa) == AFF


def test_kernel_formulas_match_reference_twins():
    """The plain primitives the CUDA kernels mirror (`_padd`, `_double`,
    `_double_no_t`, `_padd_cached`, the base-field product) against the
    reference kernels' own functions, bit for bit."""
    (pa, ra), (pb, rb) = both(AFF), both(AFF2)
    B = rk.BASE_FIELD
    pl, rl = [c.limbs for c in pa._coords()], [c.limbs for c in ra._coords()]
    ql, sl = [c.limbs for c in pb._coords()], [c.limbs for c in rb._coords()]
    d2 = jnp.broadcast_to(jnp.asarray(rk._ED_2D_LIMBS, jnp.uint32)[:, None], rl[0].shape)

    def check(port_out, ref_out):
        port_out = ck.to_canonical(*port_out)
        for u, v in zip(port_out, ref_out):
            np.testing.assert_array_equal(u.numpy().astype(np.uint32), np.asarray(v))

    check(ck._padd(*pl, *ql), rk._padd(B, *rl, *sl, d2))
    check(ck._double(*pl), rk._double(B, *rl))
    check(ck._double_no_t(*pl[:3]), rk._double_no_t(B, *rl[:3]))
    cached_p = ck.to_canonical(lb.lazy_sub25519(ql[1], ql[0]), lb.lazy_add25519(ql[1], ql[0]),
                               lb.lazy_mul25519(ql[3], ck._const(ck.ED_2D, ql[3])), ql[2])
    cached_r = (rk._sub_mod(B, sl[1], sl[0]), rk._add_mod(B, sl[1], sl[0]),
                rk._bmul(d2, sl[3]), sl[2])
    for u, v in zip(cached_p, cached_r):
        np.testing.assert_array_equal(u.numpy().astype(np.uint32), np.asarray(v))
    check(ck._padd_cached(*pl, *cached_p), rk._padd_cached(B, *rl, *cached_r))
    check([ck._bmul(pl[0], ql[1])], [rk._bmul(rl[0], sl[1])])


def test_is_on_curve():
    pa, ra = both(AFF)
    assert bool(pa.is_on_curve().all())
    bad_y = pc.CurvePoint.from_affine_ints([a[0] for a in AFF],
                                           [(a[1] + 1) % P for a in AFF], device="cpu")
    bad_t = pc.CurvePoint(pa.X, pa.Y, pa.Z, pa.X)
    for bad in (bad_y, bad_t):
        assert not bool(bad.is_on_curve().any())
    ref_bad = rc.CurvePoint.from_affine_ints([a[0] for a in AFF],
                                             [(a[1] + 1) % P for a in AFF])
    assert np.asarray(ref_bad.is_on_curve()).tolist() == bad_y.is_on_curve().tolist()


def test_scalar_mul_matches_reference():
    ks = [0, 1, L - 1, rng.randrange(L)]
    pa, ra = both(AFF[:4])
    got = pa.mul(Scalar.from_ints(ks, device="cpu"))
    want = ra.mul(RScalar.from_ints(ks))
    assert affine(got) == affine(want) == [ref_mul(k, a) for k, a in zip(ks, AFF)]
    # broadcasting: one point times many scalars, many points times one
    g = pc.CurvePoint.generator((), device="cpu")
    assert affine(g.mul(Scalar.from_ints(ks[:2], device="cpu"))) == [(0, 1), G]
    assert affine(pa.mul(Scalar.from_ints(2, device="cpu"))) == [ref_add(a, a) for a in AFF[:4]]


def _eight_torsion():
    """A point of order 8: l times a curve point outside the subgroup."""
    for x in range(2, 1000):
        y2 = (1 + x * x) * pow(1 - D * x * x, -1, P) % P
        y = pow(y2, (P + 3) // 8, P)
        if y * y % P != y2:
            y = y * pc.SQRT_M1 % P
        if y * y % P != y2:
            continue
        q = ref_mul(L, (x, y))
        if ref_mul(4, q) != (0, 1):
            return q
    raise AssertionError("no 8-torsion point found")


def test_prime_subgroup_check():
    pa, _ = both(AFF[:3])
    assert bool(pa.is_in_prime_subgroup().all())
    two_torsion = pc.CurvePoint.from_affine_ints([0], [P - 1], device="cpu")
    tx, ty = _eight_torsion()
    t8 = pc.CurvePoint.from_affine_ints([tx], [ty], device="cpu")
    mixed = pa + t8.broadcast_to((3,))
    for pt in (two_torsion, t8, mixed):
        assert bool(pt.is_on_curve().all())
        assert not bool(pt.is_in_prime_subgroup().any())


def test_compress_roundtrip_matches_reference():
    pa, ra = both(AFF[:4])
    data = pa.compress()
    assert data == ra.compress()
    back = pc.CurvePoint.decompress(data, device="cpu")
    assert affine(back) == AFF[:4]
    with pytest.raises(ValueError):
        pc.CurvePoint.decompress((P).to_bytes(32, "little"), device="cpu")


def test_hash_to_curve_matches_reference():
    got = pc.hash_to_curve(b"ark seed", 3, device="cpu")
    want = rc.hash_to_curve(b"ark seed", 3)
    same_limbs(got, want)
    for x, y in affine(got):
        assert on_curve(x, y)
    r1 = pc.CurvePoint.random(2, np.random.default_rng(9), device="cpu")
    r2 = rc.CurvePoint.random(2, np.random.default_rng(9))
    same_limbs(r1, r2)


@pytest.mark.parametrize("route", ["ladder", "bucket", "winsum"])
def test_msm_routes_match_reference(route, monkeypatch):
    n = 8
    ks = [rng.randrange(L) for _ in range(n)]
    ks[0], ks[1] = 0, L - 1
    aff = AFF + AFF2[:2]
    pts, rpts = both(aff)
    monkeypatch.setenv("ARK_MSM_FORCE", route)
    got = pc.CurvePoint.msm(Scalar.from_ints(ks, device="cpu"), pts)
    monkeypatch.delenv("ARK_MSM_FORCE")
    want = rc.CurvePoint.msm(RScalar.from_ints(ks), rpts)  # n < 128: ladder + tree
    expect = (0, 1)
    for k, a in zip(ks, aff):
        expect = ref_add(expect, ref_mul(k, a))
    assert got.shape == ()
    assert affine(got.reshape(1)) == affine(want.reshape(1)) == [expect]


def test_msm_force_rejects_unknown_values(monkeypatch):
    pts, _ = both(AFF[:2])
    monkeypatch.setenv("ARK_MSM_FORCE", "bogus")
    with pytest.raises(ValueError, match="ARK_MSM_FORCE"):
        pc.CurvePoint.msm(Scalar.from_ints([1, 2], device="cpu"), pts)


def test_base_field_ops_against_ints():
    """The few-op p = 2^255 - 19 arithmetic under the curve layer, on edge
    values and random ones, lazy chains included."""
    edge = [0, 1, 2, P - 1, P - 2, P - 19, (1 << 255) - 20, 0xFFFF,
            (1 << 240) - 1, 19, 38, 1 << 254]
    r = random.Random(3)
    xs = edge + [r.randrange(P) for _ in range(100)]
    ys = [r.choice(edge) if r.random() < 0.4 else r.randrange(P) for _ in xs]
    X = torch.from_numpy(lb.ints_to_limb_array(xs).astype(np.int32))
    Y = torch.from_numpy(lb.ints_to_limb_array(ys).astype(np.int32))
    for fn, op in ((lb.mul25519, lambda a, b: a * b), (lb.add25519, lambda a, b: a + b),
                   (lb.sub25519, lambda a, b: a - b)):
        assert lb.limb_array_to_ints(fn(X, Y).numpy()) == [op(a, b) % P for a, b in zip(xs, ys)]
    v, w = lb.lazy_mul25519(X, Y), [a * b % P for a, b in zip(xs, ys)]
    for _ in range(6):
        v = lb.lazy_sub25519(lb.lazy_mul25519(v, v), lb.lazy_add25519(v, X))
        w = [(a * a - (a + x)) % P for a, x in zip(w, xs)]
    assert lb.limb_array_to_ints(lb.canon25519(v).numpy()) == w
    zinv = ck.inverse25519(X)
    assert lb.limb_array_to_ints(zinv.numpy()) == [pow(a, P - 2, P) for a in xs]


def test_base_felt_matches_reference():
    xs = [0, 1, P - 1, 12345, 1 << 254]
    a, b = BaseFelt.from_ints(xs, device="cpu"), BaseFelt.from_ints(xs[::-1], device="cpu")
    ra, rb = RBaseFelt.from_ints(xs), RBaseFelt.from_ints(xs[::-1])
    for got, want in ((a * b, ra * rb), (a + b, ra + rb), (a - b, ra - rb), (-a, -ra)):
        np.testing.assert_array_equal(got.limbs.numpy().astype(np.uint32), np.asarray(want.limbs))
