"""The curve kernels' plain versions against the JAX package (CPU).

On CPU tensors each wrapper runs its plain version (the CUDA kernels are
held to those on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`).  Here the plain versions meet the reference:

  - `windowed_mul` with a few windows against the reference's
    `CurvePoint.mul` on small scalars, and `msm_windowsum` against
    `CurvePoint.mul(...).sum()` (the reference kernel has no test of its
    own): affine ints, exactly;
  - `bucket_accumulate` against `bucket_accumulate_pallas` in interpret
    mode on the tiny grid of `tests/test_msm_bucket_fast.py`, with the
    port's sorted-index input built from the same points: projective
    equality (the reference also adds its identity padding).

`bucket_reduce` is held to the reference in `tests/test_torch_msm_kernels.py`.
`ladder_plain` is held to the reference's XLA ladder `_scalar_mul` (the
function of `ladder_pallas`, whose own test is `slow`) in affine ints, and
to `windowed_mul_plain` projectively.
"""

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
    if lanes:
        monkeypatch.setattr(ck, "WS_LANES", lanes)
    n = 4
    rp = ref_points(n, 1)
    ks = [rng.randrange(L) for _ in range(n)]
    ks[0] = L - 1
    got = ck.msm_windowsum(port_of(rp), Scalar.from_ints(ks, device="cpu"))
    want = rp.mul(RScalar.from_ints(ks)).sum()
    assert affine(got.reshape(1)) == affine(want.reshape(1))


def test_window_sums_lanes(monkeypatch):
    """Lane j of window w sums digit_w(s_i) P_i over i = j, j + L, ..."""
    n, lanes, windows = 5, 2, 3
    monkeypatch.setattr(ck, "WS_LANES", lanes)
    rp = ref_points(n, 3)
    pt = port_of(rp)
    ks = [rng.randrange(1 << 12) for _ in range(n)]
    canon = torch.from_numpy(lb.ints_to_limb_array(ks).astype(np.int32))
    sums = ck.window_sums(canon, *coords(pt), windows=windows)
    assert sums[0].shape == (windows, 16, lanes)
    S = CurvePoint.from_coords([a.permute(1, 0, 2) for a in sums], (windows, lanes))
    for w in range(windows):
        for j in range(lanes):
            idx = list(range(j, n, lanes))
            digits = [(ks[i] >> (4 * w)) & 15 for i in idx]
            want = pt[torch.tensor(idx)].mul(Scalar.from_ints(digits, device="cpu")).sum()
            assert affine(S[w, j:j + 1]) == affine(want.reshape(1))


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
