"""BN254 in the port (`ark_mpc_tpu_torch/algebra/bn254.py`) against the JAX
package: Fq and Fr arithmetic and every G1 operation bit for bit
(Montgomery-form Jacobian limbs through `convert`), and `G1.mul` against
Python-int affine arithmetic."""

import random

import jax
import numpy as np
import pytest
import torch

from ark_mpc_tpu.algebra import bn254 as ref
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.algebra import bn254
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.bn254 import BN254_Q, BN254_R, G1, Fq, Fr

torch.set_num_threads(1)

Q, R = BN254_Q, BN254_R


def _affine_add(p1, p2):
    """Python-int affine group law on y^2 = x^3 + 3 (None = identity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2 and (y1 + y2) % Q == 0:
        return None
    if p1 == p2:
        lam = 3 * x1 * x1 * pow(2 * y1, -1, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return x3, (lam * (x1 - x3) - y1) % Q


def _affine_mul(p, k):
    acc = None
    for bit in bin(k)[2:]:
        acc = _affine_add(acc, acc)
        if bit == "1":
            acc = _affine_add(acc, p)
    return acc


def _affine_of(pt) -> list:
    """Port points -> [(x, y) or None] by Python ints."""
    x, y = pt.normalize().to_affine()
    ids = pt.is_identity().reshape(-1).tolist()
    return [None if i else (a, b) for a, b, i in zip(x.to_ints(), y.to_ints(), ids)]


def _jacobian(points, seed):
    """(3, 16, n) Montgomery limbs of the affine points (None = identity) in
    random Jacobian representatives (X, Y, Z) = (x z^2, y z^3, z)."""
    rnd = random.Random(seed)
    cols = []
    for p in points:
        if p is None:
            cols.append((1, 1, 0))
        else:
            z = rnd.randrange(1, Q)
            cols.append((p[0] * z * z % Q, p[1] * z ** 3 % Q, z))
    return np.stack([convert.from_field(Fq.from_ints([c[i] for c in cols], device="cpu"))
                     for i in range(3)])


def _both(arr):
    """The same limbs as a reference G1 and a port G1."""
    rpt = ref.G1(*(ref.Fq(jax.numpy.asarray(c)) for c in arr))
    return rpt, convert.to_point(arr, device="cpu", curve=G1)


def _same(rpt, pt):
    np.testing.assert_array_equal(convert.from_point(pt), convert.from_point(rpt))


# points: P_i = k_i G for a few k, the identity, and pairs that hit the
# equal-point and opposite-point selects of the addition
_KS = [1, 2, 3, 77362, 2**64 + 13, R - 1]
_PTS = [_affine_mul((1, 2), k) for k in _KS]
_NEG = [(p[0], (-p[1]) % Q) for p in _PTS]
LHS = _PTS + [None, _PTS[0], None, _PTS[2], _PTS[3]]
RHS = _PTS[1:] + _PTS[:1] + [_PTS[4], None, None, _PTS[2], _NEG[3]]


@pytest.mark.parametrize("cls, ref_cls", [(Fq, ref.Fq), (Fr, ref.Fr)],
                         ids=["Fq", "Fr"])
def test_field_ops_match_reference(cls, ref_cls):
    m = cls.spec.modulus
    edge = [0, 1, 2, m - 1, m - 2, (1 << 16) - 1, m // 2]
    rng = np.random.default_rng(70)
    a = cls.concatenate([cls.from_ints(edge, device="cpu"), cls.random(9, rng, device="cpu")])
    b = cls.concatenate([cls.from_ints(edge[::-1], device="cpu"),
                         cls.random(9, rng, device="cpu")])
    ra, rb = (ref_cls(jax.numpy.asarray(convert.from_field(x))) for x in (a, b))
    ai, bi = a.to_ints(), b.to_ints()
    cases = [(a + b, ra + rb), (a - b, ra - rb), (a * b, ra * rb), (-a, -ra),
             (a.square(), ra.square()), (a.inverse(), ra.inverse()),
             (a.pow(5), ra.pow(5))]
    for got, want in cases:
        np.testing.assert_array_equal(convert.from_field(got), convert.from_field(want))
    assert (a * b).to_ints() == [x * y % m for x, y in zip(ai, bi)]
    assert (a - b).to_ints() == [(x - y) % m for x, y in zip(ai, bi)]
    assert a.inverse().to_ints() == [pow(x, -1, m) if x else 0 for x in ai]
    assert a.equals(b).tolist() == np.asarray(ra.equals(rb)).tolist()
    assert a.is_zero().tolist() == np.asarray(ra.is_zero()).tolist()
    # the same generator state draws the same elements in both packages
    np.testing.assert_array_equal(
        convert.from_field(cls.random(5, np.random.default_rng(3), device="cpu")),
        convert.from_field(ref_cls.random(5, np.random.default_rng(3))))


def test_g1_group_ops_match_reference():
    """double, +, -, neg, equals, is_on_curve and normalize: Jacobian limbs
    equal the reference's, the identity, P + P and P + (-P) included.  (The
    reference's eager `-` is its `+` of the negation: one jitted addition
    serves both, each compile costing ~20 s on the CPU.)"""
    r1, p1 = _both(_jacobian(LHS, 71))
    r2, p2 = _both(_jacobian(RHS, 72))
    _same(r1.double(), p1.double())
    _same(r1 + r2, p1 + p2)
    _same(r1 + (-r2), p1 - p2)
    _same(-r1, -p1)
    _same(r1.normalize(), p1.normalize())
    for got, want in ((p1.equals(p2), r1.equals(r2)),
                      (p1.is_on_curve(), r1.is_on_curve()),
                      (p1.is_identity(), r1.is_identity())):
        assert got.tolist() == np.asarray(want).tolist()
    assert all(p1.equals(p1.double() - p1).tolist())
    want = [_affine_add(a, b) for a, b in zip(LHS, RHS)]
    assert _affine_of(p1 + p2) == want
    assert _affine_of(p1.double()) == [_affine_add(a, a) for a in LHS]
    assert want[-1] is None  # P + (-P)


def test_g1_curve_and_wire_checks_match_reference():
    """is_on_curve rejects a point off y^2 = x^3 + 3; from_wire_affine maps
    (0, 0) to the identity; the subgroup check is all true (cofactor 1)."""
    xs = [1, 0, 5, _PTS[3][0]]
    ys = [2, 0, 7, _PTS[3][1]]  # G, the identity's encoding, off-curve, 77362 G
    xc, yc = lb.ints_to_limb_array(xs), lb.ints_to_limb_array(ys)
    pt = G1.from_wire_affine(torch.from_numpy(xc.astype(np.int32)),
                             torch.from_numpy(yc.astype(np.int32)))
    rpt = ref.G1.from_wire_affine(jax.numpy.asarray(xc), jax.numpy.asarray(yc))
    _same(rpt, pt)
    assert pt.is_on_curve().tolist() == [True, True, False, True]
    assert pt.is_on_curve().tolist() == np.asarray(rpt.is_on_curve()).tolist()
    assert pt.is_identity().tolist() == [False, True, False, False]
    assert pt.is_in_prime_subgroup().tolist() == [True] * 4


def test_g1_mul_matches_reference_and_python_ints():
    """One reference `G1.mul` at batch 8, the port's limbs equal to it, and
    both equal Python-int affine arithmetic; scalars 0, 1 and r - 1 among
    them."""
    rnd = random.Random(73)
    ks = [0, 1, R - 1, 77362] + [rnd.randrange(R) for _ in range(4)]
    bases = [_affine_mul((1, 2), rnd.randrange(1, R)) for _ in range(8)]
    arr = _jacobian(bases, 74)
    rpt, pt = _both(arr)
    got = pt.mul(Fr.from_ints(ks, device="cpu"))
    want = rpt.mul(ref.Fr.from_ints(ks))
    _same(want, got)
    assert _affine_of(got) == [_affine_mul(b, k) for b, k in zip(bases, ks)]
    assert bool(got.is_on_curve().all())
    # every scalar zero: the identity at once
    zero = pt.mul(Fr.zeros(8, device="cpu"))
    _same(ref.G1.identity((8,)), zero)


def test_g1_linearity_and_generator():
    g = G1.generator(device="cpu")
    assert bool(g.is_on_curve())
    a, b = 0x1234567, 0x89ABCDE
    lhs = g.mul(Fr.from_ints(a + b, device="cpu"))
    rhs = g.mul(Fr.from_ints(a, device="cpu")) + g.mul(Fr.from_ints(b, device="cpu"))
    assert bool(lhs.equals(rhs))
    assert _affine_of(lhs.reshape(1)) == [_affine_mul((1, 2), a + b)]
    ident = G1.identity(device="cpu")
    assert bool((g + ident).equals(g)) and bool((ident + g).equals(g))
    assert bool((g + (-g)).is_identity())
    assert bool((g + g).equals(g.double()))


def test_g1_sum_matches_reference_projectively():
    """The tree sum over 3 points (the odd tail's concatenation included;
    every reference addition at one shape) and over an axis of 7 x 2."""
    pts = [_affine_mul((1, 2), 3), None, _PTS[4]]
    rpt, pt = _both(_jacobian(pts, 75))
    got = pt.sum()
    want = convert.to_point(convert.from_point(rpt.sum()), device="cpu", curve=G1)
    assert bool(got.equals(want))
    assert _affine_of(got.reshape(1)) == [_affine_add(pts[0], pts[2])]
    more = [_affine_mul((1, 2), k) for k in (3, 5, 7, 11, 13)] + [None, _PTS[1]]
    arr = _jacobian(more, 76)
    total = None
    for p in more:
        total = _affine_add(total, p)
    one = convert.to_point(arr, device="cpu", curve=G1).sum()
    assert _affine_of(one.reshape(1)) == [total]
    stacked = convert.to_point(np.stack([arr, arr], 3), device="cpu", curve=G1)
    assert stacked.shape == (7, 2)
    assert stacked.sum(axis=0).equals(one.broadcast_to((2,))).tolist() == [True, True]


def test_point_conversion_checks_the_coordinate_count():
    arr = _jacobian(_PTS[:2], 77)
    pt = convert.to_point(arr, device="cpu", curve=G1)
    np.testing.assert_array_equal(convert.from_point(pt), arr)
    with pytest.raises(ValueError, match=r"point arrays must be \(3, 16"):
        convert.to_point(np.zeros((4, 16, 1), np.uint32), device="cpu", curve=G1)
    assert bn254.Fr.curve is G1 and G1.scalar_field is Fr and G1.base_field is Fq


def test_entry_points_default_to_cuda():
    """Without a card, BN254 constructors that are not given a device raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for make in (lambda: Fq.from_ints([1]), lambda: Fr.random(2),
                 lambda: G1.generator(2), lambda: G1.identity()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
