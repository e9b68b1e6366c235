"""Bucketed Pippenger MSM: two hand-written CUDA kernels, their plain
versions and wrappers.

Counterpart of `ark_mpc_tpu/ops/msm_kernels.py`.  The prologue is plain
torch: 8-bit digits (W = 32 windows, 256 buckets), a stable sort of each
window's point indices by digit, and the bucket offsets.  Then

  `bucket_accumulate` replaces `bucket_accumulate_pallas`
  (ark_mpc_tpu/ops/msm_kernels.py:133).
    B[w, d] = sum of the points whose window-w digit is d, for d >= 1, by
    the complete unified addition; B[w, 0] is the identity (weight 0).
    The TPU cannot scatter, so the reference lays indices out on a rank
    grid with virtual top rows; here a sorted index list per window and
    its offsets (a few MB) replace the grid.
    Bound: operations (~9 products per point and window).  Load balance:
    l < 2^253 leaves the top window digits 0..16 only, so at 2^16 points
    its 15 live buckets hold ~4,096 points each against ~256 elsewhere;
    one thread per bucket (the first port) left 8,192 threads on fewer
    than half the SMs, and 15 of them adding ~4,096 points in a row.
    Design: a segmented sum in passes of one kernel.  Each pass cuts every
    bucket's entries into chunks of CHUNK consecutive entries, one thread a
    chunk (~262k threads at 2^16), found by a binary search over the
    chunks' prefix sum; a chunk starts from its first point, so a bucket
    of c points costs c - 1 adds in all.  Pass 1 gathers points through
    `idx`; each later pass sums the previous pass's partials, contiguous
    per bucket, until the last pass (a thread a bucket, at most CHUNK
    entries) writes the (16, W, nb) limbs.  The pass count comes from n
    (`bucket_passes`: no host sync); a pass over finished buckets copies.
    Points and partials are (rows, 4, 8) words, a 128-byte line each (8
    MiB at 2^16, L2-resident).  The chunk prefix sums are plain torch on
    the (W, nb) counts (`bucket_plan`), shared with the plain version,
    which sums the same chunks in the same order.
  `bucket_reduce` replaces `bucket_reduce_pallas` (:372).
    sum_w 2^(c w) S_w, S_w = sum_d d B[w, d]: the reference's `_reduce_body`
    math with no virtual rows to fold.  Bound: latency.  The least work is
    a few microseconds of multiplies; the time is a chain of dependent
    point operations: the lane suffix scan and the lane tree (2 log2 nb
    adds), then the Horner across windows, c (W - 1) doublings and W - 1
    adds (279 point operations at (16, 32, 256), c = 8), whose order the
    plain version fixes.  The first port ran the Horner on one thread with
    canonical arithmetic and C++ products, 8-9 products in a row per point
    operation (~4-5 us each).  Design: two kernels on one stream, from one
    C call.  The window kernel keeps a block a window and a thread a
    bucket, with the adds on PTX carry chains and loose values, and writes
    each S_w in cached form (Y - X, Y + X, 2d T, Z), so the Horner's adds
    take 8 products with 2d T off the chain.  The Horner kernel is one warp
    on `windowed_mul`'s quad core with carry-chain products: lane k
    computes product k of each stage, so a point operation is 2 product
    stages in a row, and the cached S_w wait in shared memory.  `marks`
    times the two kernels apart.
"""

from __future__ import annotations

import ctypes
import functools

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
MAX_REDUCE_WINDOWS = 256  # the Horner's cached S_w in 32 KiB of shared memory
CHUNK = 8  # entries a thread sums in each pass of bucket_accumulate (by the probe)
NW = NLIMBS // 2  # 32-bit words per field element


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


def bucket_passes(n: int) -> int:
    """Passes of `bucket_accumulate` over n points: the fewest p >= 1 with
    CHUNK^p >= n, so that every bucket (at most n entries) comes to the
    last pass with at most CHUNK partials."""
    p = 1
    while CHUNK ** p < n:
        p += 1
    return p


def _pass_threads(entries: int, buckets: int, passes: int) -> list:
    """Threads of each pass, known without a host sync: a chunk pass's
    bound on its chunks, sum_b ceil(c_b / C) <= (sum_b c_b) // C + buckets;
    the last pass, a thread a bucket."""
    threads = []
    for _ in range(passes - 1):
        entries = entries // CHUNK + buckets
        threads.append(entries)
    return threads + [buckets]


@functools.lru_cache(maxsize=16)
def _plan_constants(W: int, n: int, passes: int, chunk: int, device):
    """(window starts w * n as (W, 1), chunk^k and chunk^k - 1 for k = 1 ..
    passes - 1 as (passes - 1, 1)): made once per shape, not on every call."""
    base = torch.arange(W, dtype=torch.int32, device=device)[:, None] * n
    div = torch.tensor([[chunk ** k] for k in range(1, passes)], dtype=torch.int32)
    return base, div.to(device), (div - 1).to(device)


def bucket_plan(offsets: torch.Tensor, n: int) -> list:
    """-> one (begin, count, prefix, threads) per pass, over the W * nb
    buckets flattened window-major (int32 tensors on offsets' device).

    Pass 1 reads entries begin[b] .. begin[b] + count[b] of the flattened
    idx (window w's row starts at w * n; bucket 0 counts 0).  A chunk pass
    cuts bucket b into ceil(count[b] / CHUNK) chunks, whose sums are rows
    prefix[b] .. prefix[b + 1] of its output; the next pass reads those
    rows as its entries, so pass k + 1 counts ceil(c_b / CHUNK^k) for all k
    at once.  The last pass has prefix None and sums each bucket's entries.
    `threads` is `_pass_threads`'s bound on a pass's rows."""
    W, nb = offsets.shape[0], offsets.shape[1] - 1
    buckets = W * nb
    if W * n >= 2**31:
        raise ValueError(f"bucket_accumulate takes fewer than 2^31 entries, got {W * n}")
    off = offsets.to(torch.int32)
    threads = _pass_threads(W * n, buckets, bucket_passes(n))
    base, div, div_m1 = _plan_constants(W, n, len(threads), CHUNK, off.device)
    begin = (off[:, :-1] + base).reshape(buckets)
    count = torch.diff(off, dim=1)
    count[:, 0] = 0
    count = count.reshape(buckets)
    if len(threads) == 1:
        return [(begin, count, None, threads[0])]
    chunks = (count + div_m1) // div  # (passes - 1, buckets)
    prefix = torch.nn.functional.pad(torch.cumsum(chunks, 1, dtype=torch.int32), (1, 0))
    begins = [begin] + list(prefix[:, :-1])
    counts = [count] + list(chunks)
    return ([(begins[k], counts[k], prefix[k], rows) for k, rows in enumerate(threads[:-1])]
            + [(begins[-1], counts[-1], None, threads[-1])])


def _pass_plain(src, rows, begin, count, prefix):
    """One pass in plain torch, rank by rank over all chunks.  src: (4, 16,
    m) coordinates; entry k is column rows[k] of src (column k where rows
    is None) -> (4, 16, chunks), or (4, 16, buckets) on the last pass."""
    if prefix is None:
        first, length = begin.long(), count.long()
    else:
        prefix = prefix.long()
        t = torch.arange(int(prefix[-1]), device=src.device)
        b = torch.searchsorted(prefix, t, right=True) - 1
        first = begin.long()[b] + (t - prefix[b]) * CHUNK
        length = (begin.long()[b] + count.long()[b] - first).clamp(max=CHUNK)

    cols = None if rows is None else rows.long()

    def entry(k):
        return src[:, :, k if cols is None else cols[k]]

    one = torch.zeros((NLIMBS, 1), dtype=lb.LIMB_DTYPE, device=src.device)
    ident = torch.stack(identity_coords(one)).to(torch.int64)
    acc = ident.expand(4, NLIMBS, first.numel()).clone()
    live = (length > 0).nonzero(as_tuple=True)[0]
    acc[:, :, live] = entry(first[live]).to(torch.int64)
    for r in range(1, int(length.max()) if length.numel() else 0):
        live = (length > r).nonzero(as_tuple=True)[0]
        acc[:, :, live] = torch.stack(_padd(*acc[:, :, live], *entry(first[live] + r)))
    return torch.stack(to_canonical(*acc))


def bucket_accumulate_plain(idx, offsets, x, y, z, t):
    """Plain torch form of `bucket_accumulate`: the same passes, chunks and
    order of additions."""
    W, nb = _segments(idx, offsets)
    n = x.shape[1]
    src, rows = torch.stack([x, y, z, t]), idx.reshape(-1)
    for begin, count, prefix, _ in bucket_plan(offsets, n):
        src, rows = _pass_plain(src, rows, begin, count, prefix), None
    return tuple(src.reshape(4, NLIMBS, W, nb))


def _point_words(coords) -> torch.Tensor:
    """Four (16, n) limb tensors -> (n, 4, 8) 32-bit words (int32): the
    limbs as little-endian 16-bit halves, in one copy."""
    limbs = torch.stack(coords).permute(2, 0, 1)
    halves = torch.empty(limbs.shape, dtype=torch.int16, device=limbs.device)
    return halves.copy_(limbs).view(torch.int32)


def _null_or_ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def bucket_accumulate(idx, offsets, x, y, z, t, marks=None):
    """Bucket sums of the sorted segments: idx (W, n), offsets (W, nb + 1),
    points four (16, n) -> four (16, W, nb) with bucket 0 the identity.
    `marks`: optional CUDA events, one more than the passes, recorded
    before each pass and after the last (to time the passes)."""
    if idx.device.type == "cpu":
        return bucket_accumulate_plain(idx, offsets, x, y, z, t)
    W, nb = _segments(idx, offsets)
    dev = idx.device
    coords = [_flat(c, dev) for c in (x, y, z, t)]
    n = coords[0].shape[1]
    if idx.shape[1] != n:
        raise ValueError("idx and points differ in batch size")
    plan = bucket_plan(offsets.to(dev), n)
    if marks is not None and len(marks) != len(plan) + 1:
        raise ValueError(f"marks takes {len(plan) + 1} events, got {len(marks)}")
    rows = idx.to(device=dev, dtype=torch.int32).contiguous().reshape(-1)
    src = _point_words(coords)
    outs = list(torch.empty((4, NLIMBS, W, nb), dtype=lb.LIMB_DTYPE, device=dev))
    # one scratch for every chunk pass's partials
    scratch = torch.empty((sum(p[3] for p in plan[:-1]), 4, NW), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        used = 0
        for k, (begin, count, prefix, threads) in enumerate(plan):
            dst = None if prefix is None else scratch[used:used + threads]
            used += threads if prefix is not None else 0
            ptrs = [src, rows, begin, count, prefix, dst] + outs
            if marks is not None:
                marks[k].record()
            rc = _lib().ark_bucket_chunk(
                (ctypes.c_void_p * len(ptrs))(*map(_null_or_ptr, ptrs)), threads,
                W * nb, CHUNK, stream)
            _check(rc, "bucket_accumulate")
            bucket_accumulate.launches += 1
            src, rows = dst, None
        if marks is not None:
            marks[-1].record()
    return tuple(outs)


def bucket_launch_config(n: int, device) -> dict:
    """`bucket_accumulate`'s launch at n points, W x nb buckets: chunk size,
    passes, threads a block, resident blocks and warps per SM, and each
    pass's grid (blocks)."""
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        _check(_lib().ark_bucket_accumulate_config(ctypes.byref(blocks),
                                                    ctypes.byref(threads)),
               "bucket_accumulate_config")
    grids = [-(-k // threads.value) for k in
             _pass_threads(N_WINDOWS * n, N_WINDOWS * N_BUCKETS, bucket_passes(n))]
    return {"chunk": CHUNK, "passes": len(grids), "threads": threads.value,
            "blocks_per_sm": blocks.value,
            "warps_per_sm": blocks.value * threads.value // 32, "grids": grids}


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


def _reduce_shape(bx, c_bits: int):
    W, nb = bx.shape[1], bx.shape[2]
    if c_bits < 1:
        raise ValueError(f"bucket_reduce takes c_bits >= 1, got {c_bits}")
    if nb > MAX_REDUCE_BUCKETS or nb < 1 or nb & (nb - 1):
        raise ValueError(f"bucket_reduce takes a power-of-two bucket count up "
                         f"to {MAX_REDUCE_BUCKETS}, got {nb}")
    if not 1 <= W <= MAX_REDUCE_WINDOWS:
        raise ValueError(f"bucket_reduce takes 1 to {MAX_REDUCE_WINDOWS} windows, got {W}")
    return W, nb


def bucket_reduce(bx, by, bz, bt, c_bits: int = C_BITS, marks=None):
    """sum_w 2^(c_bits w) sum_d d * B[w, d] over bucket sums (16, W, nb)
    -> the four (16,) coordinates of one point.  `marks`: optional three
    CUDA events, recorded before the window kernel, between it and the
    Horner kernel, and after the Horner (to time the two kernels)."""
    if bx.device.type == "cpu":
        return bucket_reduce_plain(bx, by, bz, bt, c_bits)
    dev = bx.device
    W, nb = _reduce_shape(bx, c_bits)
    if marks is not None and len(marks) != 3:
        raise ValueError(f"marks takes 3 events, got {len(marks)}")
    ins = [_flat(a, dev) for a in (bx, by, bz, bt)]
    if any(a.shape[1] != W * nb for a in ins):
        raise ValueError("bucket coordinates differ in shape")
    scratch = torch.empty((W + 1, 4 * NW), dtype=torch.int32, device=dev)
    outs = [torch.empty(NLIMBS, dtype=lb.LIMB_DTYPE, device=dev) for _ in range(4)]
    ptrs = _ptrs(ins + [scratch] + outs)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        if marks is None:  # both kernels from one C call: no host gap between them
            _check(_lib().ark_bucket_reduce(ptrs, W, nb, c_bits, 0, stream), "bucket_reduce")
        else:
            for part in (1, 2):
                marks[part - 1].record()
                _check(_lib().ark_bucket_reduce(ptrs, W, nb, c_bits, part, stream),
                       "bucket_reduce")
            marks[2].record()
    bucket_reduce.launches += 1
    return tuple(outs)


def reduce_launch_config(W: int, nb: int) -> dict:
    """`bucket_reduce`'s two launches over W windows of nb buckets: grid,
    threads a block and dynamic shared bytes of each kernel."""
    vals = (ctypes.c_longlong * 6)()
    _check(_lib().ark_bucket_reduce_config(W, nb, vals), "bucket_reduce_config")
    return {"window": dict(zip(("grid", "threads", "smem_bytes"), vals[:3])),
            "horner": dict(zip(("grid", "threads", "smem_bytes"), vals[3:]))}


def reduce_critical_path(W: int, nb: int, c_bits: int = C_BITS) -> dict:
    """`bucket_reduce`'s chain of dependent point operations: the scan and
    the tree (log2 nb adds each), then c (W - 1) doublings and W - 1 adds;
    and the Horner's product stages (a double or a cached add is 2 stages
    of 4 independent products on the quad core)."""
    scan = 2 * (nb.bit_length() - 1)
    doubles, adds = c_bits * (W - 1), W - 1
    return {"point_ops": scan + doubles + adds, "scan_adds": scan, "doublings": doubles,
            "horner_adds": adds, "horner_stages": 2 * (doubles + adds)}


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
