"""Bucketed Pippenger MSM: two hand-written CUDA kernels, their plain
versions and wrappers.

Counterpart of `ark_mpc_tpu/ops/msm_kernels.py`.  The prologue is plain
torch: 8-bit digits (W = 32 windows, 256 buckets), a stable sort of each
window's point indices by digit, and the bucket offsets.  Then

  `bucket_accumulate` replaces `bucket_accumulate_pallas`
  (ark_mpc_tpu/ops/msm_kernels.py:133).
    B[w, d] = sum of the points whose window-w digit is d, for d >= 1,
    added in sorted (stable, so index) order from the identity by the
    complete unified addition; B[w, 0] is the identity (weight 0).
    The TPU cannot scatter, so the reference lays indices out on a rank
    grid with virtual top rows; here a sorted index list per window and
    its offsets (a few MB) replace the grid, and one thread per
    (window, bucket) walks its segment.  Points are read point-major
    (256 contiguous bytes each, L2-resident at 2^16 points).
    Bound: operations (~9 products per point and window).  Load balance:
    l < 2^253 leaves the top window digits 0..16 only, so those buckets
    run ~16x deeper than the rest.

  `bucket_reduce` replaces `bucket_reduce_pallas` (:372).
    sum_w 2^(c w) sum_d d B[w, d]: one block per window runs the lane
    suffix scan (Hillis-Steele, identity shifted in) and the lane tree
    in shared memory; the last block to finish runs the Horner across
    windows (c - 1 T-less doubles, 1 double, 1 add each) on one thread.
    The reference's `_reduce_body` math with no virtual rows to fold.
    Bound: latency (a few thousand dependent point operations).
"""

from __future__ import annotations

import torch

from ..algebra import limbs as lb
from ..algebra.fields import SCALAR_FIELD
from ..algebra.limbs import NLIMBS
from . import curve_kernels as ck
from .curve_kernels import _double, _double_no_t, _flat_point, _lib, _padd, identity_coords, to_canonical
from .fp_kernels import _check, _flat, _ptrs, _stream

C_BITS = 8
N_BUCKETS = 1 << C_BITS
N_WINDOWS = 256 // C_BITS
MAX_REDUCE_BUCKETS = 256  # one block of threads, one bucket each


def scalar_digits(canon: torch.Tensor) -> torch.Tensor:
    """Canonical (16, n) limbs -> (32, n) 8-bit digits, least significant
    window first."""
    parts = torch.stack([canon & 0xFF, canon >> 8], 1)
    return parts.reshape(2 * NLIMBS, canon.shape[1])


def bucket_prologue(canon: torch.Tensor):
    """-> (idx (W, n) int32 point indices sorted by digit per window,
    offsets (W, 257) int32: bucket d of window w is idx[w, off[w, d]:
    off[w, d + 1]])."""
    digits = scalar_digits(canon)
    sorted_digits, idx = torch.sort(digits, dim=1, stable=True)
    bounds = torch.arange(N_BUCKETS + 1, dtype=sorted_digits.dtype,
                          device=canon.device).expand(N_WINDOWS, -1).contiguous()
    offsets = torch.searchsorted(sorted_digits.contiguous(), bounds)
    return idx.to(torch.int32), offsets.to(torch.int32)


def _segments(idx, offsets):
    W, nb = offsets.shape[0], offsets.shape[1] - 1
    if idx.dim() != 2 or idx.shape[0] != W:
        raise ValueError(f"idx must be ({W}, n), got {tuple(idx.shape)}")
    return W, nb


# ---------------------------------------------------------------------------
# bucket_accumulate
# ---------------------------------------------------------------------------


def bucket_accumulate_plain(idx, offsets, x, y, z, t):
    """Plain torch form of `bucket_accumulate`: rank by rank, every bucket
    that still has points adds its next one."""
    W, nb = _segments(idx, offsets)
    off = offsets.long()
    start = off[:, :-1]
    counts = off[:, 1:] - start
    counts[:, 0] = 0
    acc = [a.to(torch.int64).reshape(NLIMBS, 1, 1).expand(NLIMBS, W, nb).contiguous()
           for a in identity_coords(x[:, :1])]
    pts = (x, y, z, t)
    for r in range(int(counts.max().item()) if counts.numel() else 0):
        wi, di = (counts > r).nonzero(as_tuple=True)
        pidx = idx.long()[wi, start[wi, di] + r]
        new = _padd(*(a[:, wi, di] for a in acc), *(c[:, pidx] for c in pts))
        for a, v in zip(acc, new):
            a[:, wi, di] = v
    return to_canonical(*acc)


def bucket_accumulate(idx, offsets, x, y, z, t):
    """Bucket sums of the sorted segments: idx (W, n), offsets (W, nb + 1),
    points four (16, n) -> four (16, W, nb) with bucket 0 the identity."""
    if idx.device.type == "cpu":
        return bucket_accumulate_plain(idx, offsets, x, y, z, t)
    W, nb = _segments(idx, offsets)
    dev = idx.device
    coords = [_flat(c, dev) for c in (x, y, z, t)]
    n = coords[0].shape[1]
    if idx.shape[1] != n:
        raise ValueError("idx and points differ in batch size")
    pts = torch.stack(coords).permute(2, 0, 1).contiguous()  # (n, 4, 16)
    ix = idx.to(device=dev, dtype=torch.int32).contiguous()
    off = offsets.to(device=dev, dtype=torch.int32).contiguous()
    outs = [torch.empty((NLIMBS, W, nb), dtype=lb.LIMB_DTYPE, device=dev)
            for _ in range(4)]
    with torch.cuda.device(dev):
        rc = _lib().ark_bucket_accumulate(_ptrs([ix, off, pts] + outs), n, W,
                                          nb, _stream(dev))
    _check(rc, "bucket_accumulate")
    bucket_accumulate.launches += 1
    return tuple(outs)


bucket_accumulate.launches = 0


# ---------------------------------------------------------------------------
# bucket_reduce
# ---------------------------------------------------------------------------


def _identity64(like):
    return tuple(c.to(torch.int64) for c in identity_coords(like))


def _drop_lane0(X):
    ident = _identity64(X[0][..., :1])
    return tuple(torch.cat([i, a[..., 1:]], -1) for i, a in zip(ident, X))


def bucket_reduce_plain(bx, by, bz, bt, c_bits: int = C_BITS):
    """Plain torch form of `bucket_reduce`."""
    W, nb = bx.shape[1], bx.shape[2]
    X = _drop_lane0(tuple(a.to(torch.int64) for a in (bx, by, bz, bt)))
    k = 1
    while k < nb:  # lane d <- sum_{e >= d} B_e
        ident = _identity64(X[0][..., :k])
        X = _padd(*X, *(torch.cat([a[..., k:], i], -1) for a, i in zip(X, ident)))
        k *= 2
    X = _drop_lane0(X)
    k = nb // 2
    while k >= 1:  # lane 0 <- sum_{d >= 1} suffix_d = sum_d d * B_d
        X = _padd(*(a[..., :k] for a in X), *(a[..., k:2 * k] for a in X))
        k //= 2
    S = [a[..., 0] for a in X]  # (16, W)
    acc = tuple(a[:, W - 1] for a in S)
    for i in range(1, W):
        x, y, z = acc[:3]
        for _ in range(c_bits - 1):
            x, y, z = _double_no_t(x, y, z)
        acc = _padd(*_double(x, y, z), *(a[:, W - 1 - i] for a in S))
    return to_canonical(*acc)


def bucket_reduce(bx, by, bz, bt, c_bits: int = C_BITS):
    """sum_w 2^(c_bits w) sum_d d * B[w, d] over bucket sums (16, W, nb)
    -> the four (16,) coordinates of one point."""
    if bx.device.type == "cpu":
        return bucket_reduce_plain(bx, by, bz, bt, c_bits)
    dev = bx.device
    W, nb = bx.shape[1], bx.shape[2]
    if nb > MAX_REDUCE_BUCKETS or nb & (nb - 1):
        raise ValueError(f"bucket_reduce takes a power-of-two bucket count up "
                         f"to {MAX_REDUCE_BUCKETS}, got {nb}")
    ins = [_flat(a, dev) for a in (bx, by, bz, bt)]
    if any(a.shape[1] != W * nb for a in ins):
        raise ValueError("bucket coordinates differ in shape")
    scratch = torch.empty((W, 4 * NLIMBS), dtype=torch.int32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    outs = [torch.empty(NLIMBS, dtype=lb.LIMB_DTYPE, device=dev) for _ in range(4)]
    with torch.cuda.device(dev):
        rc = _lib().ark_bucket_reduce(_ptrs(ins + [scratch, ticket] + outs),
                                      W, nb, c_bits, _stream(dev))
    _check(rc, "bucket_reduce")
    bucket_reduce.launches += 1
    return tuple(outs)


bucket_reduce.launches = 0


def msm_bucket(points, scalars):
    """The bucket-route MSM of flat (n,) points and scalars -> one point."""
    from ..algebra.curve import CurvePoint

    n = scalars.size
    canon = lb.from_mont(SCALAR_FIELD, scalars.reshape(n).limbs)
    idx, offsets = bucket_prologue(canon)
    buckets = bucket_accumulate(idx, offsets,
                                *_flat_point(points.broadcast_to((n,)), n))
    return CurvePoint.from_coords(bucket_reduce(*buckets), ())


# The curve layer's five kernels (all in `csrc/curve_kernels.cu`).
KERNELS = {"windowed_mul": ck.windowed_mul, "ladder": ck.ladder,
           "window_sums": ck.window_sums,
           "bucket_accumulate": bucket_accumulate, "bucket_reduce": bucket_reduce}
PLAIN = {"windowed_mul": ck.windowed_mul_plain, "ladder": ck.ladder_plain,
         "window_sums": ck.window_sums_plain,
         "bucket_accumulate": bucket_accumulate_plain,
         "bucket_reduce": bucket_reduce_plain}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
