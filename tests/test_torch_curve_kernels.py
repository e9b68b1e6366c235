"""The curve kernels' plain versions against the JAX package (CPU).

On CPU tensors each wrapper runs its plain version (the CUDA kernels are
held to those on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`).  Here the plain versions meet the reference:

  - `windowed_mul` with a few windows against the reference's
    `CurvePoint.mul` on small scalars, and `msm_windowsum` against
    `CurvePoint.mul(...).sum()` (the reference kernel has no test of its
    own): affine ints, exactly;
  - `window_sums` lane by lane against Python-int sums of the reference's
    digit multiples d * P_i (`CurvePoint.mul`), at the edges of its lane
    partition, and window by window (over all lanes, whatever the
    partition) against the reference's `CurvePoint.sum()` of them;
  - `bucket_reduce` with two buckets a window and 4-bit windows (the
    window-sum MSM's Horner) against Python ints;
  - `bucket_accumulate` against `bucket_accumulate_pallas` in interpret
    mode on the tiny grid of `tests/test_msm_bucket_fast.py`, with the
    port's sorted-index input built from the same points: projective
    equality (the reference also adds its identity padding).

`bucket_reduce` is held to the reference in `tests/test_torch_msm_kernels.py`.
`ladder_plain` is held to the reference's XLA ladder `_scalar_mul` (the
function of `ladder_pallas`, whose own test is `slow`) in affine ints, and
to `windowed_mul_plain` projectively.
"""

import functools
import random

import jax
import numpy as np
import pytest
import torch

from ark_mpc_tpu.algebra.curve import CurvePoint as RPoint
from ark_mpc_tpu.algebra.curve import _scalar_mul as ref_scalar_mul
from ark_mpc_tpu.algebra.scalar import Scalar as RScalar
from ark_mpc_tpu.ops.msm_kernels import bucket_accumulate_pallas
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.algebra.curve import CurvePoint
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.scalar import Scalar
from ark_mpc_tpu_torch.ops import curve_kernels as ck
from ark_mpc_tpu_torch.ops import msm_kernels as mk

torch.set_num_threads(1)

L = Scalar.spec.modulus
rng = random.Random(77)


def affine(pt):
    x, y = pt.to_affine()
    return list(zip(x.to_ints(), y.to_ints()))


def port_of(rpt) -> CurvePoint:
    return convert.to_point(convert.from_point(rpt), device="cpu")


def ref_points(n, seed):
    r = random.Random(seed)
    return RPoint.generator((n,)).mul(RScalar.from_ints([r.randrange(1, L) for _ in range(n)]))


def coords(pt):
    return [c.limbs for c in pt._coords()]


P25519 = (1 << 255) - 19
ED_D = (-121665 * pow(121666, -1, P25519)) % P25519
GEN = (15112221349535400772501151409588531511454012693041857206046113283949847762202,
       46316835694926478169428394003475163141307993866256225615783033603165251855960)


def ed_add(p1, p2):
    """Python-int Edwards addition in affine coordinates."""
    (x1, y1), (x2, y2) = p1, p2
    t = ED_D * x1 * x2 % P25519 * y1 % P25519 * y2 % P25519
    return ((x1 * y2 + x2 * y1) * pow(1 + t, -1, P25519) % P25519,
            (y1 * y2 + x1 * x2) * pow(1 - t, -1, P25519) % P25519)


def ed_mul(k: int, pt=GEN):
    acc = (0, 1)
    while k:
        if k & 1:
            acc = ed_add(acc, pt)
        pt = ed_add(pt, pt)
        k >>= 1
    return acc


def test_windowed_mul_few_windows_matches_reference():
    n, windows = 4, 8
    rp = ref_points(n, 1)
    ks = [0, 1, (1 << 32) - 1, rng.randrange(1 << 32)]
    canon = torch.from_numpy(lb.ints_to_limb_array(ks).astype(np.int32))
    got = ck.windowed_mul(canon, *coords(port_of(rp)), windows=windows)
    want = rp.mul(RScalar.from_ints(ks))
    assert affine(CurvePoint.from_coords(got, (n,))) == affine(want)
    # windows < 64 takes the low windows only
    big = [k + (5 << 32) for k in ks]
    canon_big = torch.from_numpy(lb.ints_to_limb_array(big).astype(np.int32))
    again = ck.windowed_mul(canon_big, *coords(port_of(rp)), windows=windows)
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="windows"):
        ck.windowed_mul(canon, *coords(port_of(rp)), windows=65)


@pytest.mark.parametrize("lanes", [None, 2])
def test_msm_windowsum_matches_reference(lanes, monkeypatch):
    if lanes:  # two points a lane: two lanes
        monkeypatch.setattr(ck, "WS_LANE_POINTS", 2)
    n = 4
    rp = ref_points(n, 1)
    ks = [rng.randrange(L) for _ in range(n)]
    ks[0] = L - 1
    got = ck.msm_windowsum(port_of(rp), Scalar.from_ints(ks, device="cpu"))
    want = rp.mul(RScalar.from_ints(ks)).sum()
    assert affine(got.reshape(1)) == affine(want.reshape(1))


# window_sums: lanes of WS_LANE_POINTS = 64 points below 64 * 256 points
N_WS = 136


@functools.lru_cache(maxsize=None)
def window_sums_case():
    """N_WS reference points P_i, scalars k_i (0 and l - 1 among them), and
    d * P_i for every digit d by the reference's `CurvePoint.mul` (one (16,
    N_WS) batch): the reference products, and their affine ints
    multiples[d][i]."""
    r = random.Random(81)
    rp = ref_points(N_WS, 8)
    ks = [r.randrange(L) for _ in range(N_WS)]
    ks[1], ks[2] = 0, L - 1
    digits = np.array([[d] * N_WS for d in range(16)], dtype=object)
    prods = rp.mul(RScalar.from_ints(digits))
    flat = affine(prods.reshape(16 * N_WS))
    multiples = [flat[d * N_WS:(d + 1) * N_WS] for d in range(16)]
    return rp, ks, prods, multiples


def digit(k: int, w: int) -> int:
    return (k >> (4 * w)) & 15


@pytest.mark.parametrize("windows", [1, 3, 64])
@pytest.mark.parametrize("n", [1, 63, 65, N_WS])
def test_window_sums_lanes(n, windows):
    """Lane j of window w sums digit_w(s_i) P_i over its own points
    i = j * per .. min((j + 1) * per, n) - 1: one lane at n = 1 and 63,
    a lane of 64 and one of 1 at 65, two of 64 and a ragged 8 at 136."""
    rp, ks, _, multiples = window_sums_case()
    ks = ks[:n]
    per, lanes = ck.lane_points(n), ck.default_lanes(n)
    assert (per, lanes) == {1: (64, 1), 63: (64, 1), 65: (64, 2), N_WS: (64, 3)}[n]
    canon = torch.from_numpy(lb.ints_to_limb_array(ks).astype(np.int32))
    sums = ck.window_sums(canon, *coords(port_of(rp[:n])), windows=windows)
    assert all(tuple(a.shape) == (windows, 16, lanes) for a in sums)
    got = affine(CurvePoint.from_coords([a.permute(1, 0, 2) for a in sums],
                                        (windows, lanes)).reshape(windows * lanes))
    want = []
    for w in range(windows):
        for j in range(lanes):
            acc = (0, 1)
            for i in range(j * per, min((j + 1) * per, n)):
                acc = ed_add(acc, multiples[digit(ks[i], w)][i])
            want.append(acc)
    assert got == want


@pytest.mark.parametrize("lane_points", [None, 7])
def test_window_sums_totals_match_reference(lane_points, monkeypatch):
    """Whatever the partition (3 lanes, or 20 lanes of 7 points), each
    window's lanes sum to the reference's sum over all points of
    digit_w(k_i) * P_i."""
    if lane_points:
        monkeypatch.setattr(ck, "WS_LANE_POINTS", lane_points)
    rp, ks, prods, _ = window_sums_case()
    canon = torch.from_numpy(lb.ints_to_limb_array(ks).astype(np.int32))
    sums = ck.window_sums(canon, *coords(port_of(rp)))
    lanes = sums[0].shape[2]
    assert lanes == (20 if lane_points else 3)
    got = CurvePoint.from_coords([a.permute(1, 0, 2) for a in sums],
                                 (ck.WINDOWS, lanes)).sum(axis=1)
    d = np.array([[digit(k, w) for k in ks] for w in range(ck.WINDOWS)])
    i = np.broadcast_to(np.arange(N_WS), d.shape)
    want = prods[d, i].sum(axis=1)  # (64,) reference sums
    assert affine(got) == affine(want)


@pytest.mark.parametrize("windows", [1, 5, 64])
def test_bucket_reduce_two_buckets_is_horner(windows):
    """The window-sum MSM's Horner: bucket_reduce over (16, W, 2) with
    bucket 1 = S_w and c_bits = 4 is sum_w 16^w S_w; bucket 0 (weight 0)
    is dropped whatever it holds."""
    r = random.Random(windows)
    s = [r.randrange(L) for _ in range(windows)]
    junk = [r.randrange(1, L) for _ in range(windows)]
    gen = CurvePoint.generator((windows,), device="cpu")
    S = gen.mul(Scalar.from_ints(s, device="cpu"))
    B0 = gen.mul(Scalar.from_ints(junk, device="cpu"))
    buckets = [torch.stack([b.limbs, c.limbs], 2) for b, c in zip(B0._coords(), S._coords())]
    got = CurvePoint.from_coords(mk.bucket_reduce(*buckets, c_bits=4), ())
    want = ed_mul(sum(16 ** w * v for w, v in enumerate(s)) % L)
    assert affine(got.reshape(1)) == [want]


def test_bucket_accumulate_matches_reference_kernel():
    """The tiny grid of tests/test_msm_bucket_fast.py: (R, W, nb) points."""
    R, W, nb = 2, 2, 8
    n = R * W * nb
    rp = RPoint.generator((n,)).mul(RScalar.from_ints([(5 * i + 2) for i in range(1, n + 1)]))
    grid_coords = [c.limbs.reshape(16, R, W, nb) for c in rp._coords()]
    bx, by, bz, bt = bucket_accumulate_pallas(*grid_coords)  # interpret mode
    want = RPoint(*(type(rp.X)(a) for a in (bx, by, bz, bt)))

    # the same function on sorted segments: bucket (w, d) holds the points
    # grid[r, w, d] for r = 0..R-1, in rank order
    flat = np.arange(n).reshape(R, W, nb)
    idx = np.zeros((W, n), np.int32)
    off = np.zeros((W, nb + 1), np.int32)
    for w in range(W):
        seg = flat[:, w, :].T.reshape(-1)  # bucket-major, rank order
        idx[w, :seg.size] = seg
        off[w] = np.arange(nb + 1) * R
    got = mk.bucket_accumulate(torch.from_numpy(idx), torch.from_numpy(off),
                               *coords(port_of(rp)))
    got_pt = CurvePoint.from_coords(got, (W, nb))
    assert bool(got_pt[:, 0].is_identity().all())  # bucket 0 has weight 0
    want_p = port_of(RPoint(*(type(rp.X)(c.limbs[:, :, 1:]) for c in want._coords())))
    assert bool(got_pt[:, 1:].equals(want_p).all())
    # a bucket fed identities only, and one fed a point then the identity
    ident = CurvePoint.identity((2,), device="cpu")
    pts = CurvePoint.concatenate([port_of(rp[:1]), ident[:1], ident[1:]])
    b = mk.bucket_accumulate(torch.tensor([[0, 1, 2]], dtype=torch.int32),
                             torch.tensor([[0, 0, 2, 3]], dtype=torch.int32), *coords(pts))
    b = CurvePoint.from_coords(b, (1, 3))
    assert bool(b[0, 1].equals(port_of(rp[0]))) and bool(b[0, 2].is_identity())


def test_bucket_prologue_segments():
    n = 6
    ks = [0, 255, 256, L - 1, 1 << 200, 7]
    canon = torch.from_numpy(lb.ints_to_limb_array(ks).astype(np.int32))
    idx, off = mk.bucket_prologue(canon)
    assert idx.shape == (32, n) and off.shape == (32, 257)
    for w in range(32):
        for d in range(256):
            members = sorted(idx[w, off[w, d]:off[w, d + 1]].tolist())
            assert members == [i for i, k in enumerate(ks) if (k >> (8 * w)) & 255 == d]


def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors never reach a kernel, so no launch is counted."""
    before = mk.launch_counts()
    rp = ref_points(2, 4)
    canon = torch.from_numpy(lb.ints_to_limb_array([3, 5]).astype(np.int32))
    ck.windowed_mul(canon, *coords(port_of(rp)), windows=1)
    ck.ladder(canon[:, :1], *(c[:, :1] for c in coords(port_of(rp))))
    assert mk.launch_counts() == before
    assert jax.default_backend() == "cpu"


def test_ladder_plain_matches_reference_ladder():
    """As `tests/test_fp_kernels.py::test_ladder_pallas_interpret`, with the
    zero scalar; n = 4 (not 3: the port has no block padding to exercise)
    shares the reference ladder's compile with the tests above."""
    r = np.random.default_rng(17)
    ks = [0] + [int(r.integers(1, 2**63)) ** 4 % L for _ in range(2)] + [L - 1]
    rp = RPoint.generator((4,)).mul(RScalar.from_ints([5, 9, 11, 13]))
    want = ref_scalar_mul(rp, RScalar.from_ints(ks))
    got = ck.scalar_mul(port_of(rp), Scalar.from_ints(ks, device="cpu"), kernel="ladder")
    assert affine(got) == affine(want)
    windowed = ck.scalar_mul(port_of(rp), Scalar.from_ints(ks, device="cpu"))
    assert bool(got.equals(windowed).all())
    canon = torch.from_numpy(lb.ints_to_limb_array(ks).astype(np.int32))
    for a, b in zip(ck.ladder(canon, *coords(port_of(rp))),
                    ck.ladder_plain(canon, *coords(port_of(rp)))):
        assert torch.equal(a, b)


def test_ladder_mul_by_order_and_kernel_names():
    pt = port_of(ref_points(2, 5))
    assert bool(ck.mul_by_order(pt, kernel="ladder").is_identity().all())
    k = Scalar.from_ints([1, 2], device="cpu")
    for bad in ("Ladder", "bucket", ""):
        with pytest.raises(ValueError, match="kernel"):
            ck.scalar_mul(pt, k, kernel=bad)
        with pytest.raises(ValueError, match="kernel"):
            ck.mul_by_order(pt, kernel=bad)


# ---------------------------------------------------------------------------
# The CUDA ladder's arithmetic in Python ints (the kernel runs on the card
# only): P's cached form made once, each step the full double, then the
# cached add, then the select, every value loose (below 2^256, congruent
# mod p) until the canonical store; products on PTX carry chains, modelled
# word by word with the carry flag.
# ---------------------------------------------------------------------------

M32 = (1 << 32) - 1
W256 = 1 << 256
ED_2D = 2 * ED_D % P25519


class Ptx:
    """PTX's 32-bit carry-chain instructions: `cin` reads the carry flag
    (madc, addc), `cout` sets it (.cc); a form without .cc must not carry
    out, since the hardware would drop the carry."""

    def __init__(self):
        self.cf = 0

    def _out(self, v, cout):
        if cout:
            self.cf = v >> 32
        else:
            assert v >> 32 == 0, "a carry leaves a chain's top word"
        return v & M32

    def mad_lo(self, a, b, c, cin, cout=True):
        return self._out((a * b & M32) + c + (self.cf if cin else 0), cout)

    def mad_hi(self, a, b, c, cin, cout=True):
        return self._out((a * b >> 32) + c + (self.cf if cin else 0), cout)

    def add(self, a, b, cin, cout=True):
        return self._out(a + b + (self.cf if cin else 0), cout)


def words(v, n=8):
    return [(v >> (32 * k)) & M32 for k in range(n)]


def from_words(ws):
    return sum(w << (32 * k) for k, w in enumerate(ws))


def fold38(r, c):
    """`fe_fold38`: r + c 2^256 (c <= 38) below 2^256; the second fold
    lands in word 0 without a carry."""
    assert r < W256 and c <= 38
    v = r + 38 * c
    c2, v = v >> 256, v % W256
    assert (v & M32) + 38 * c2 <= M32
    return v + 38 * c2


def chain_cc(x, acc, i, a, b, first, last, capture):
    """`chain_cc(acc + i, a, b, first, last, capture)`."""
    acc[i + first] = x.mad_lo(a[first], b, acc[i + first], cin=False)
    for j in range(first, last, 2):
        acc[i + j + 1] = x.mad_hi(a[j], b, acc[i + j + 1], cin=True)
        acc[i + j + 2] = x.mad_lo(a[j + 2], b, acc[i + j + 2], cin=True)
    acc[i + last + 1] = x.mad_hi(a[last], b, acc[i + last + 1], cin=True, cout=capture)
    if capture:
        assert acc[i + last + 2] == 0
        acc[i + last + 2] = x.add(0, 0, cin=True, cout=False)


def row_cc(x, e, o, a, b, i, first):
    """`row_cc`: the products a[j] b, j >= first, with i + j even into e,
    the others into o; an even row's e chain and an odd row's o chain
    capture their carry."""
    odd = i & 1
    fe, le = first + ((first ^ i) & 1), 7 if odd else 6
    fo, lo = first + ((first ^ i ^ 1) & 1), 6 if odd else 7
    if fe <= le:
        chain_cc(x, e, i, a, b, fe, le, not odd and i > 0)
    if fo <= lo:
        chain_cc(x, o, i, a, b, fo, lo, bool(odd))


def merge_cc(x, e, o):
    t = [e[0], x.add(e[1], o[1], cin=False)]
    t += [x.add(e[k], o[k], cin=True) for k in range(2, 15)]
    return t + [x.add(e[15], o[15], cin=True, cout=False)]


def reduce_cc(x, t):
    r = [x.mad_lo(t[8], 38, t[0], cin=False)]
    r += [x.mad_lo(t[8 + k], 38, t[k], cin=True) for k in range(1, 8)]
    top = x.add(0, 0, cin=True, cout=False)
    r[1] = x.mad_hi(t[8], 38, r[1], cin=False)
    for k in range(1, 7):
        r[k + 1] = x.mad_hi(t[8 + k], 38, r[k + 1], cin=True)
    top = x.mad_hi(t[15], 38, top, cin=True, cout=False)
    return fold38(from_words(r), top)


def fe_mul_cc(a, b):
    x, aw, bw = Ptx(), words(a), words(b)
    e, o = [0] * 16, [0] * 16
    for i in range(8):
        row_cc(x, e, o, aw, bw[i], i, 0)
    return reduce_cc(x, merge_cc(x, e, o))


def fe_sqr_cc(a):
    x, aw = Ptx(), words(a)
    e, o = [0] * 16, [0] * 16
    for i in range(7):
        row_cc(x, e, o, aw, aw[i], i, i + 1)
    cross = from_words(merge_cc(x, e, o))
    assert cross < 1 << 511
    t = words(cross << 1, 16)
    t[0] = x.mad_lo(aw[0], aw[0], t[0], cin=False)
    t[1] = x.mad_hi(aw[0], aw[0], t[1], cin=True)
    for i in range(1, 8):
        t[2 * i] = x.mad_lo(aw[i], aw[i], t[2 * i], cin=True)
        t[2 * i + 1] = x.mad_hi(aw[i], aw[i], t[2 * i + 1], cin=True, cout=i < 7)
    return reduce_cc(x, t)


def mul_loose(a, b):
    """The value both carry-chain products leave: the exact 512-bit t,
    then t_lo + 38 t_hi folded below 2^256."""
    assert a < W256 and b < W256
    t = a * b
    v = t % W256 + 38 * (t >> 256)
    return fold38(v % W256, v >> 256)


def add_loose(a, b):
    s = a + b
    return fold38(s % W256, s >> 256)


def sub_loose(a, b):
    """`fe_sub_loose`: a borrow adds 2^256 = 38 mod p, so 38 comes off,
    twice where the first wraps."""
    d = a - b
    if d < 0:
        d += W256 - 38
        if d < 0:
            d += W256
            assert d & M32 >= 38
            d -= 38
    return d


def ladder_model(k, pt, mul=mul_loose, sqr=lambda a: mul_loose(a, a)):
    """The kernel's step sequence on one point: canonical ints out."""
    X, Y, Z, T = pt
    q = (sub_loose(Y, X), add_loose(Y, X), mul(T, ED_2D), Z)
    acc = (0, 1, 1, 0)
    for i in reversed(range(256)):
        x, y, z, _ = acc
        a, b, zz, s = sqr(x), sqr(y), sqr(z), sqr(add_loose(x, y))
        h, g = add_loose(a, b), sub_loose(a, b)
        e, f = sub_loose(h, s), add_loose(add_loose(zz, zz), g)
        acc = (mul(e, f), mul(g, h), mul(f, g), mul(e, h))
        x, y, z, t = acc
        a, b = mul(sub_loose(y, x), q[0]), mul(add_loose(y, x), q[1])
        c, zz = mul(t, q[2]), mul(z, q[3])
        dd = add_loose(zz, zz)
        e, f, g, h = sub_loose(b, a), sub_loose(dd, c), add_loose(dd, c), add_loose(b, a)
        added = (mul(e, f), mul(g, h), mul(f, g), mul(e, h))
        if (k >> i) & 1:
            acc = added
        assert all(v < W256 for v in acc)
    return tuple(v % P25519 for v in acc)


EDGE_FE = [0, 1, 2, 19, 38, P25519 - 1, P25519, P25519 + 1, 2 * P25519 - 1, 2 * P25519,
           1 << 255, W256 - 1, W256 - 38, W256 - 39, (1 << 224) - 1, M32, W256 // 3]


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_carry_chain_products_word_model(op):
    """Every carry lands in a word (no chain's top word carries out) and
    the words leave `mul_loose`'s value: on values at 0, p, 2p, 2^255 and
    2^256 and random ones."""
    r = random.Random(90)
    vals = EDGE_FE + [r.randrange(W256) for _ in range(24)] + \
        [W256 - 1 - r.randrange(1 << 64) for _ in range(6)]
    for a in vals:
        for b in (vals if op == "mul" else [a]):
            got = fe_mul_cc(a, b) if op == "mul" else fe_sqr_cc(a)
            assert got == mul_loose(a, b) and got % P25519 == a * b % P25519


def ladder_limbs_to_ints(limbs):
    return [int(v) for v in lb.limb_array_to_ints(limbs.numpy())]


@pytest.mark.parametrize("scalars", ["edge", "random"])
def test_ladder_model_matches_ladder_plain(scalars):
    """The kernel's sequence (P cached once, double, cached add, select,
    loose values canonical at the end) gives `ladder_plain`'s limbs bit for
    bit: on 0, 1, 2, l - 1, 2^253 - 1 and l (`mul_by_order`'s scalar), and
    on random scalars; the carry-chain products in full on one point."""
    r = random.Random(91)
    ks = ([0, 1, 2, L - 1, (1 << 253) - 1, L] if scalars == "edge"
          else [r.randrange(L) for _ in range(4)])
    pts = CurvePoint.random(len(ks), np.random.default_rng(len(ks)), device="cpu")
    co = coords(pts)
    canon = torch.from_numpy(lb.ints_to_limb_array(ks).astype(np.int32))
    want = list(zip(*(ladder_limbs_to_ints(c) for c in ck.ladder_plain(canon, *co))))
    ints = list(zip(*(ladder_limbs_to_ints(c) for c in co)))
    for i, k in enumerate(ks):
        assert ladder_model(k, ints[i]) == want[i]
    if scalars == "random":
        assert ladder_model(ks[0], ints[0], fe_mul_cc, fe_sqr_cc) == want[0]


# ---------------------------------------------------------------------------
# The CUDA bucket_reduce's schedule in Python ints: the window kernel's
# suffix scan and lane tree with the complete add on loose values, S_w
# handed over in cached form (Y - X, Y + X, 2d T, Z), then the Horner as
# the quad's product stages (a double: 4 squares, then 4 products; a cached
# add: 4 products, then 4), canonical at the end.
# ---------------------------------------------------------------------------

IDENTITY = (0, 1, 1, 0)


def finish_stage(a, b, c, zz, mul):
    """The second stage of an add: e f, g h, f g, e h."""
    dd = add_loose(zz, zz)
    e, f, g, h = sub_loose(b, a), sub_loose(dd, c), add_loose(dd, c), add_loose(b, a)
    return (mul(e, f), mul(g, h), mul(f, g), mul(e, h))


def padd_loose(p, q, mul):
    """`pt_add_cc`: the complete add, 2d T1 T2 as (T1 T2) 2d."""
    (x1, y1, z1, t1), (x2, y2, z2, t2) = p, q
    a, b = mul(sub_loose(y1, x1), sub_loose(y2, x2)), mul(add_loose(y1, x1), add_loose(y2, x2))
    return finish_stage(a, b, mul(mul(t1, t2), ED_2D), mul(z1, z2), mul)


def quad_double_model(p, mul, sqr):
    x, y, z, _ = p
    a, b, zz, s = (sqr(v) for v in (x, y, z, add_loose(x, y)))  # lanes 0-3
    h, g = add_loose(a, b), sub_loose(a, b)
    e, f = sub_loose(h, s), add_loose(add_loose(zz, zz), g)
    return (mul(e, f), mul(g, h), mul(f, g), mul(e, h))


def quad_add_cached_model(p, cached, mul):
    x, y, z, t = p
    a, b, c, zz = (mul(u, v) for u, v in zip((sub_loose(y, x), add_loose(y, x), t, z),
                                             cached))
    return finish_stage(a, b, c, zz, mul)


def bucket_reduce_model(B, c_bits, mul=mul_loose, sqr=lambda a: mul_loose(a, a)):
    """B[w][d] = (X, Y, Z, T) ints -> the kernels' canonical result."""
    W, nb = len(B), len(B[0])
    S = []
    for row in B:
        v = [IDENTITY] + list(row[1:])  # bucket 0 has weight 0
        k = 1
        while k < nb:  # suffix scan, every lane from the step's old values
            v = [padd_loose(v[d], v[d + k] if d + k < nb else IDENTITY, mul)
                 for d in range(nb)]
            k *= 2
        v[0] = IDENTITY
        k = nb // 2
        while k >= 1:  # lane tree
            v = [padd_loose(v[d], v[d + k], mul) for d in range(k)] + v[k:]
            k //= 2
        S.append(v[0])
    cached = [(sub_loose(y, x), add_loose(y, x), mul(t, ED_2D), z) for x, y, z, t in S]
    acc = S[-1]
    for w in reversed(range(W - 1)):
        for _ in range(c_bits):  # c - 1 T-less doubles and one double
            acc = quad_double_model(acc, mul, sqr)
        acc = quad_add_cached_model(acc, cached[w], mul)
        assert all(v < W256 for v in acc)
    return tuple(v % P25519 for v in acc)


@pytest.mark.parametrize("products", ["loose", "words"])
@pytest.mark.parametrize("W,nb,c_bits", [(3, 4, 8), (5, 2, 4)])
def test_bucket_reduce_model_matches_plain(W, nb, c_bits, products):
    """The kernels' schedule gives `bucket_reduce_plain`'s limbs bit for bit
    at the bucket route's c = 8 (window 1's buckets all the identity) and
    at the winsum route's 2 buckets with c = 4, on loose products and on
    the carry chains' word model."""
    pts = CurvePoint.random(W * nb, np.random.default_rng(W), device="cpu")
    co = [c.reshape(16, W, nb).clone() for c in coords(pts)]
    if c_bits == 8:
        for c, i in zip(co, ck.identity_coords(co[0][:, 1, :1])):
            c[:, 1, :] = i
    want = tuple(ladder_limbs_to_ints(c.reshape(16, 1))[0]
                 for c in mk.bucket_reduce_plain(*co, c_bits=c_bits))
    ints = list(zip(*(ladder_limbs_to_ints(c.reshape(16, W * nb)) for c in co)))
    B = [ints[w * nb:(w + 1) * nb] for w in range(W)]
    args = (fe_mul_cc, fe_sqr_cc) if products == "words" else ()
    assert bucket_reduce_model(B, c_bits, *args) == want
