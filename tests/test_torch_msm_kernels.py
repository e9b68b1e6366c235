"""The bucket MSM kernels' plain versions on the CPU.

`bucket_accumulate_plain` sums each bucket in chunked passes (the order its
CUDA kernel adds in); here it is held projectively to the sequential sum of
each bucket from the identity (the first port's order, kept below as the
reference loop), over segment lengths around the chunk size, one bucket
holding every point and random digits, and a Python model of the kernel's
chunk search checks that its threads cover every segment once, in order.
`bucket_accumulate` against the JAX kernel is in
`tests/test_torch_curve_kernels.py`.

`bucket_reduce`: the reference's `_reduce_body` runs eagerly, as
`tests/test_msm_bucket_fast.py` runs it, on the same tiny bucket grid
(w_real == W, so no virtual rows): the port runs the same formula sequence
(suffix scan with identity shifted in, lane tree, Horner), so the result is
bit-identical.  The grid is small and c = 1 (no T-less doubles in the
Horner): each distinct shape costs the reference an XLA compile of its
jitted formulas, which dominates this file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.ops.msm_kernels import _reduce_body
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.curve import CurvePoint
from ark_mpc_tpu_torch.algebra.scalar import Scalar
from ark_mpc_tpu_torch.ops import curve_kernels as ck
from ark_mpc_tpu_torch.ops import msm_kernels as mk

torch.set_num_threads(1)


def test_bucket_reduce_matches_reference_body_bit_for_bit():
    W, nb, c = 2, 4, 1  # w_real == W: no virtual rows
    r = np.random.default_rng(9)
    base = CurvePoint.generator((W * nb,), device="cpu").mul(Scalar.from_ints(
        [int(x) for x in r.integers(1, 2**30, size=W * nb)], device="cpu"))
    coords = [a.reshape(16, W, nb) for a in convert.from_point(base)]
    rx, ry, rz, rt = _reduce_body(*(jnp.asarray(a) for a in coords), w_real=W,
                                  c_bits=c, static_horner=True)
    want = [np.asarray(a[:, 0, 0]) for a in (rx, ry, rz, rt)]
    got = mk.bucket_reduce(*(torch.from_numpy(a.astype(np.int32)) for a in coords),
                           c_bits=c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), w)
    # and the direct formula: sum_w 2^(c w) sum_d d B[w, d]
    pt = base.reshape(W, nb)
    acc = None
    for w in reversed(range(W)):
        s = pt[w].mul(Scalar.from_ints(list(range(nb)), device="cpu")).sum()
        acc = s if acc is None else acc.mul(Scalar.from_ints(1 << c, device="cpu")) + s
    assert bool(CurvePoint.from_coords(got, ()).equals(acc))


# ---------------------------------------------------------------------------
# bucket_accumulate_plain: chunked passes
# ---------------------------------------------------------------------------


def sequential_bucket_sums(idx, offsets, x, y, z, t):
    """Each bucket summed point by point from the identity, rank by rank
    over all buckets; bucket 0 stays the identity."""
    W, nb = offsets.shape[0], offsets.shape[1] - 1
    off = offsets.long()
    start = off[:, :-1]
    counts = off[:, 1:] - start
    counts[:, 0] = 0
    acc = [a.to(torch.int64).reshape(16, 1, 1).expand(16, W, nb).contiguous()
           for a in ck.identity_coords(x[:, :1])]
    for r in range(int(counts.max())):
        wi, di = (counts > r).nonzero(as_tuple=True)
        pidx = idx.long()[wi, start[wi, di] + r]
        new = ck._padd(*(a[:, wi, di] for a in acc), *(c[:, pidx] for c in (x, y, z, t)))
        for a, v in zip(acc, new):
            a[:, wi, di] = v
    return ck.to_canonical(*acc)


def distinct_points(n):
    """(i + 1) * G for i < n: four (16, n) coordinates."""
    gen = [c.limbs.expand(16, n).contiguous()
           for c in CurvePoint.generator((n,), device="cpu")._coords()]
    canon = torch.from_numpy(lb.ints_to_limb_array(list(range(1, n + 1))).astype(np.int32))
    return ck.windowed_mul_plain(canon, *gen, windows=3)


def segments_of(counts_per_window):
    """Buckets of the given sizes, points in order -> (idx (W, n), offsets)."""
    n = sum(counts_per_window[0])
    idx = torch.arange(n, dtype=torch.int32).repeat(len(counts_per_window), 1)
    off = torch.tensor([[0] + np.cumsum(c).tolist() for c in counts_per_window],
                       dtype=torch.int32)
    return idx, off


def layout(name, chunk):
    if name == "lengths":  # bucket 0 holds points too: weight 0
        sizes = [3, 0, 1, chunk - 1, chunk, chunk + 1, chunk ** 2, chunk ** 2 + 1, 2]
        return segments_of([sizes])
    if name == "one_bucket":
        n = chunk ** 2 + 1
        return segments_of([[0, 0, 0, n], [0, n, 0, 0]])
    r = np.random.default_rng(chunk)
    canon = torch.from_numpy(lb.ints_to_limb_array(
        [int(v) for v in r.integers(0, 2**62, 40)]).astype(np.int32))
    canon[14:] = torch.from_numpy(r.integers(0, 1 << 16, (2, 40)).astype(np.int32))
    return mk.bucket_prologue(canon)


@pytest.mark.parametrize("name", ["lengths", "one_bucket", "random"])
@pytest.mark.parametrize("chunk", [3, mk.CHUNK])
def test_bucket_accumulate_plain_equals_sequential_order(monkeypatch, chunk, name):
    """Segments of 0, 1, C - 1, C, C + 1, C^2 and C^2 + 1 points, every point
    in one bucket (C^2 + 1: three passes), random digits: projectively the
    sequential sums; bucket 0 the identity."""
    monkeypatch.setattr(mk, "CHUNK", chunk)
    idx, off = layout(name, chunk)
    W, nb = off.shape[0], off.shape[1] - 1
    pts = [c.contiguous() for c in distinct_points(idx.shape[1])]
    got = CurvePoint.from_coords(mk.bucket_accumulate(idx, off, *pts), (W, nb))
    want = CurvePoint.from_coords(sequential_bucket_sums(idx, off, *pts), (W, nb))
    assert bool(got.equals(want).all())
    assert bool(got[:, 0].is_identity().all())
    if name == "one_bucket":
        assert mk.bucket_passes(idx.shape[1]) == 3


@pytest.mark.parametrize("n,chunk,passes", [(0, 16, 1), (1, 16, 1), (16, 16, 1),
                                            (17, 16, 2), (256, 16, 2), (257, 16, 3),
                                            (1 << 16, 16, 4), (1 << 16, 32, 4),
                                            (4097, 8, 5)])
def test_bucket_passes(monkeypatch, n, chunk, passes):
    monkeypatch.setattr(mk, "CHUNK", chunk)
    assert mk.bucket_passes(n) == passes


def kernel_thread(t, begin, count, prefix, chunk):
    """The CUDA kernel's index math for thread t of a chunk pass: -> (bucket,
    first, end) or None for a spare thread."""
    buckets = len(begin)
    if t >= prefix[buckets]:
        return None
    lo, hi = 0, buckets
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if prefix[mid] <= t:
            lo = mid
        else:
            hi = mid
    first = begin[lo] + (t - prefix[lo]) * chunk
    return lo, first, min(first + chunk, begin[lo] + count[lo])


@pytest.mark.parametrize("chunk", [2, 3, 16])
def test_chunk_ranges_cover_each_segment_in_order(monkeypatch, chunk):
    """Skewed segments (empty, one point, C, C + 1, one deep bucket, bucket 0
    full): every chunk pass's threads cover each bucket's entries once, in
    order, at most C a thread, within the pass's thread bound; the last
    pass gets at most C entries a bucket."""
    monkeypatch.setattr(mk, "CHUNK", chunk)
    sizes = [[5, 0, 1, chunk, chunk + 1, 0, 3 * chunk ** 2 + 7, 2]]
    n = sum(sizes[0])
    sizes.append([0, n // 3, 0, 0, 0, 0, 0, n - n // 3])
    _, off = segments_of(sizes)
    plan = mk.bucket_plan(off, n)
    assert len(plan) == mk.bucket_passes(n)
    for begin, count, prefix, threads in plan[:-1]:
        begin, count, prefix = begin.tolist(), count.tolist(), prefix.tolist()
        assert prefix[-1] <= threads
        covered = {b: [] for b in range(len(begin))}
        for t in range(threads):
            got = kernel_thread(t, begin, count, prefix, chunk)
            if got is not None:
                b, first, end = got
                assert 0 < end - first <= chunk and prefix[b] <= t < prefix[b + 1]
                covered[b].extend(range(first, end))
        for b in covered:
            assert covered[b] == list(range(begin[b], begin[b] + count[b]))
    begin, count, prefix, threads = plan[-1]
    assert prefix is None and threads == off.numel() - 2
    assert int(count.max()) <= chunk
    assert count.view(2, -1)[:, 0].tolist() == [0, 0]  # bucket 0 never summed
