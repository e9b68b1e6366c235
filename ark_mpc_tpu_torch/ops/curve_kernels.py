"""Hand-written CUDA kernels for Ed25519 scalar multiplication and the
window-sum MSM, their plain versions and wrappers.

Counterpart of `ark_mpc_tpu/ops/curve_kernels.py`.  The kernels live in
`csrc/curve_kernels.cu` (CUDA C++ for sm_90a, built with nvcc at first use
and called through ctypes), with the two bucket-MSM kernels of
`ops/msm_kernels.py`.  Each wrapper:

  - runs its plain PyTorch version for CPU tensors, and only then;
  - for CUDA tensors launches the kernel on the current stream, or raises
    (no fallback), and adds one to its `launches` count per launch.

Points are four (16, n) int32 limb tensors (X, Y, Z, T: extended twisted
Edwards coordinates over p = 2^255 - 19, canonical limbs); scalars are
canonical (16, n) limbs.  Every base-field value is canonical, so a kernel
that runs the same formula sequence as its plain version is bit-identical
to it.

Source notes (bounds for one H100 SXM; see `chip_smoke.py` for the counts):

  `windowed_mul` replaces `windowed_mul_pallas`
  (ark_mpc_tpu/ops/curve_kernels.py:106).
    Bound: operations (~2,500 base-field products per point against 576
    bytes moved).  What held the first port back was memory, not the
    multiplies: one thread per point kept its 16-entry cached table (2 KiB)
    and the build's eight extended points in local memory, 4.9 KB of stack
    a thread at 12 warps per SM, ~1.9 MB an SM, so the table and the spills
    streamed from L2 and HBM.  Design: four lanes per point (a quad).  The
    formulas are 4-way parallel, so lane k computes product k of each
    stage (a window is 10 stages: 4 doubles and a cached add, 2 stages
    each) and the quad swaps the results through shared memory; every lane
    runs the sums and differences itself.  Lane k keeps coordinate k
    (Y-X, Y+X, 2dT or Z) of the 16 cached entries in shared memory, 512
    bytes a lane and 64 KiB a 128-thread block, 3 blocks (12 warps) an SM,
    with no local memory; the build recovers X, Y, Z of a half entry from
    the table instead of keeping extended points.  The entry is a masked
    scan over all 16 entries of the lane's quarter and the digit a shuffle
    from the lane holding that scalar word, so no address or branch depends
    on the digit (the scalar may be a MAC-key share).  Base-field products
    are 8x32-bit schoolbooks folded x38 (squares: 36 word products), kept
    loose below 2^256 and brought to canonical form once, at the store.
    What bounds it now is the integer pipes (the multiplies and their carry
    additions) at 12 warps per SM, which shared memory caps.

  `ladder` replaces `ladder_pallas` (ark_mpc_tpu/ops/curve_kernels.py:196).
    Bound: operations (16 base-field products per bit: a full double, 4 of
    them squares, and a cached add).  The first port ran one thread a point
    with canonical arithmetic at every product and sum, the complete add
    (9 products: 2d T every bit) and 168 registers: 3 blocks of 128 threads
    an SM, so the 512 blocks of 2^16 points took 1.29 waves, the second
    running 4 warps an SM.  Design: still one thread per point, no table:
    for bit 255 .. 0 of the canonical scalar, acc = 2 acc, then the sum
    acc + P is always computed and taken by a masked word select, so
    nothing branches on the scalar.  P's cached form (Y-X, Y+X, 2dT, Z) is
    made once and kept in the thread's column of shared memory (reread each
    step), so the add takes 8 products; values stay loose below 2^256 and
    are made canonical once, at the store; products and squares run on PTX
    carry chains (`fe_mul_cc`, `fe_sqr_cc`: a row's products split by the
    parity of their low word onto two chains of multiply-adds that carry
    through the flag, so each product's two words are one 64-bit
    multiply-add into an aligned register pair).  At most 128 registers
    (`__launch_bounds__(128, 4)`): 4 blocks, 16 warps, an SM, and 2^16
    points in one wave of 528 block slots.  What bounds it now is the
    integer multiply pipe, whose issue slots the loose sums, the selects
    and the carry captures share.
    Reached through `scalar_mul(..., kernel="ladder")` and
    `mul_by_order(..., kernel="ladder")`, as the reference reaches its
    kernel through `kernel=ladder_pallas`; `CurvePoint.mul`, the subgroup
    check and every MSM route take `windowed_mul`.

  `window_sums` replaces `window_sums_pallas` (:248).
    Bound: operations (~610 products per point: a table, then one cached
    add a window).  The TPU carried its 64 window accumulators through a
    sequential grid; CUDA blocks run in no order.  The first port made
    each of up to 16,384 threads a lane with its 64 accumulators in device
    memory (a read and a write of each per point, 268 MB of output at
    2^16) and the 16-entry table in local memory (5.5 KB of stack): 128
    blocks of 4 warps on 132 SMs, 27x its bound.  Design: the loops turned
    inside out, on `windowed_mul`'s quad core.  A lane is a block over a
    contiguous range of points (`lane_points(n)` points a lane, at least
    WS_LANE_POINTS, at most WS_MAX_LANES lanes: 256 lanes of 256 points at
    2^16, so the partition is a function of n alone and the plain version
    repeats it).  A quad (4 threads) is a window: 64 quads, 256 threads,
    each holding its window's accumulator in registers for the whole lane.
    The block walks its lane in tiles of 64 points: quad p builds point
    p's cached table in shared memory (2 KiB a point, 128 KiB a tile), the
    tile's scalars go to shared memory, and every quad adds its window's
    entry of each point's table in turn, the entry a masked scan over all
    16 (all quads read the same chunks: broadcasts) and the digit a shared
    word picked by the window index, so no address or branch depends on the
    digit.  Values stay loose and are made canonical at the store of the
    (windows, 16, L) outputs (4 MB at 2^16).  `msm_windowsum` sums the
    lanes (plain torch tree, batched over windows; ~8 levels) and runs the
    Horner sum_w 16^w S_w on the card as one `bucket_reduce` launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..algebra import limbs as lb
from ..algebra.fields import SCALAR_FIELD
from ..algebra.limbs import NLIMBS
from . import _build
from .fp_kernels import _check, _flat, _ptrs, _stream

P = (1 << 255) - 19
ED_D = (-121665 * pow(121666, -1, P)) % P
ED_2D = (2 * ED_D) % P

WINDOWS = 64            # 4-bit windows of a 256-bit scalar
WS_MAX_LANES = 256      # window_sums lanes (one block each) at most
WS_LANE_POINTS = 64     # window_sums points a lane at least
WM_LANES = 4            # windowed_mul lanes per point (a quad)
WM_THREADS = 128        # windowed_mul threads a block: 32 points
SOURCE = "curve_kernels"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ark_windowed_mul.argtypes = [vp, i64, i32, vp]
    lib.ark_windowed_mul_config.argtypes = [vp, vp]
    lib.ark_ladder.argtypes = [vp, i64, vp]
    lib.ark_ladder_config.argtypes = [vp, vp, vp]
    lib.ark_window_sums.argtypes = [vp, i64, i32, i64, i64, vp]
    lib.ark_window_sums_config.argtypes = [vp, vp, vp, vp]
    lib.ark_bucket_accumulate_config.argtypes = [vp, vp]
    lib.ark_bucket_chunk.argtypes = [vp, i64, i32, i32, vp]
    lib.ark_bucket_reduce.argtypes = [vp, i32, i32, i32, i32, vp]
    lib.ark_bucket_reduce_config.argtypes = [i32, i32, vp]
    for fn in (lib.ark_windowed_mul, lib.ark_windowed_mul_config, lib.ark_ladder,
               lib.ark_ladder_config, lib.ark_window_sums, lib.ark_window_sums_config,
               lib.ark_bucket_accumulate_config,
               lib.ark_bucket_chunk, lib.ark_bucket_reduce,
               lib.ark_bucket_reduce_config):
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# base-field helpers.  The plain versions keep values lazy (int64 limbs,
# congruent mod p; `limbs.lazy_*25519`) and canonicalize what they return.
# Independent products (sums, differences) of one formula step go through
# ONE batched call.
# ---------------------------------------------------------------------------


def _common_shape(tensors):
    """Broadcast shape of `tensors`; equal shapes, the common case, skip
    `torch.broadcast_shapes`, whose pure-Python cost dominates the plain
    formulas on small batches."""
    first = tensors[0].shape
    if all(t.shape == first for t in tensors):
        return first
    return torch.broadcast_shapes(*(t.shape for t in tensors))


def _batched(fn, pairs):
    if len(pairs) == 1:
        return [fn(*pairs[0])]
    shape = _common_shape([t for pair in pairs for t in pair])
    a = torch.stack([p[0].to(torch.int64).expand(shape) for p in pairs], 1)
    b = torch.stack([p[1].to(torch.int64).expand(shape) for p in pairs], 1)
    return list(fn(a, b).unbind(1))


def _mul(*pairs):
    return _batched(lb.lazy_mul25519, pairs)


def _lin(*terms):
    """[x + y or x - y for (x, op, y) in terms], op "+" or "-", in one call."""
    shape = _common_shape([t for x, _, y in terms for t in (x, y)])
    x = torch.stack([t[0].to(torch.int64).expand(shape) for t in terms], 1)
    y = torch.stack([t[2].to(torch.int64).expand(shape) for t in terms], 1)
    sub = _cached(("sub", tuple(t[1] == "-" for t in terms)), x.device)
    sub = sub.reshape((1, len(terms)) + (1,) * (x.dim() - 2))
    return list(lb.lazy_addsub25519(x, y, sub).unbind(1))


def to_canonical(*vals):
    """Lazy values -> canonical int32 limbs, in one batched call."""
    if len(vals) == 1:
        return (lb.canon25519(vals[0]),)
    shape = _common_shape(vals)
    return lb.canon25519(torch.stack([v.to(torch.int64).expand(shape)
                                      for v in vals], 1)).unbind(1)


def _bmul(x, y):
    """Base-field product, canonical limbs in and out."""
    return lb.mul25519(x, y)


_CACHE: dict = {}


def _cached(key, device) -> torch.Tensor:
    """A small constant tensor, made once per device: ("sub", flags) or
    ("limbs", value)."""
    full = (key, str(device))
    if full not in _CACHE:
        kind, data = key
        if kind == "sub":
            _CACHE[full] = torch.tensor(data, device=device)
        else:
            _CACHE[full] = torch.tensor(lb.int_to_limbs(data).astype("int32"),
                                        device=device)
    return _CACHE[full]


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    """The limbs of `value` broadcast to `like`'s shape (a view)."""
    c = _cached(("limbs", value), like.device)
    return c.reshape((NLIMBS,) + (1,) * (like.dim() - 1)).expand(like.shape)


_INV_BITS = tuple(((P - 2) >> i) & 1 for i in range((P - 2).bit_length()))


def inverse25519(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2) = z^-1 (0 -> 0), canonical out; least significant bit first,
    acc * base and base^2 of one step in one batched product."""
    acc, base = _const(1, z).to(torch.int64), z
    last = len(_INV_BITS) - 1
    for i, bit in enumerate(_INV_BITS):
        if bit and i < last:
            acc, base = _mul((acc, base), (base, base))
        elif bit:
            acc = lb.lazy_mul25519(acc, base)
        elif i < last:
            base = lb.lazy_mul25519(base, base)
    return lb.canon25519(acc)


def identity_coords(like: torch.Tensor):
    zero = torch.zeros_like(like)
    one = _const(1, like).contiguous()
    return zero, one, one.clone(), zero.clone()


# ---------------------------------------------------------------------------
# Edwards formulas (a = -1): the same sequence as the JAX kernels'
# `_double`, `_double_no_t`, `_padd` and `_padd_cached`; lazy in and out
# ---------------------------------------------------------------------------


def _double_parts(x, y, z):
    xy = lb.lazy_add25519(x, y)
    a, b, zz, s = _mul((x, x), (y, y), (z, z), (xy, xy))
    c, h, g = _lin((zz, "+", zz), (a, "+", b), (a, "-", b))
    e, f = _lin((h, "-", s), (c, "+", g))
    return e, f, g, h


def _double(x, y, z, t=None):
    e, f, g, h = _double_parts(x, y, z)
    return tuple(_mul((e, f), (g, h), (f, g), (e, h)))


def _double_no_t(x, y, z):
    """Doubling without the T output: only a double feeding an addition
    needs extended T."""
    e, f, g, h = _double_parts(x, y, z)
    return tuple(_mul((e, f), (g, h), (f, g)))


def _finish_add(a, b, c, zz):
    dd = lb.lazy_add25519(zz, zz)
    e, f, g, h = _lin((b, "-", a), (dd, "-", c), (dd, "+", c), (b, "+", a))
    return tuple(_mul((e, f), (g, h), (f, g), (e, h)))


def _padd(x1, y1, z1, t1, x2, y2, z2, t2):
    """Complete unified addition (RFC 8032 5.1.4)."""
    s1, s2, a1, a2 = _lin((y1, "-", x1), (y2, "-", x2), (y1, "+", x1), (y2, "+", x2))
    a, b, tt, zz = _mul((s1, s2), (a1, a2), (t1, t2), (z1, z2))
    c = lb.lazy_mul25519(tt, _const(ED_2D, tt))
    return _finish_add(a, b, c, zz)


def _padd_cached(x1, y1, z1, t1, cp, cq, cr, cz):
    """Extended + cached-form point (Y-X, Y+X, 2d*T, Z): 8 products."""
    s, ad = _lin((y1, "-", x1), (y1, "+", x1))
    a, b, c, zz = _mul((s, cp), (ad, cq), (t1, cr), (z1, cz))
    return _finish_add(a, b, c, zz)


def _table(x, y, z, t) -> torch.Tensor:
    """The 16 multiples 0..15 of P in cached form, (4, 16 limbs, 16, *batch)
    lazy: evens by doubling the half entry, odds by adding P."""
    pt = tuple(c.to(torch.int64) for c in (x, y, z, t))
    ext = [tuple(c.to(torch.int64) for c in identity_coords(x)), pt]
    for k in range(2, 16):
        ext.append(_double(*ext[k // 2]) if k % 2 == 0 else _padd(*ext[k - 1], *pt))
    X, Y, Z, T = (torch.stack([e[i] for e in ext], 1) for i in range(4))
    cp, cq = lb.lazy_sub25519(Y, X), lb.lazy_add25519(Y, X)
    cr = lb.lazy_mul25519(T, _const(ED_2D, T))
    return torch.stack([cp, cq, cr, Z])


def _select(tab: torch.Tensor, digits: torch.Tensor):
    """Plain table lookup: tab (4, 16, 16, m), digits (..., m) in [0, 16)
    -> four (16, ..., m) coordinates."""
    idx = digits.long().reshape(1, 1, -1, digits.shape[-1])
    idx = idx.expand(4, NLIMBS, idx.shape[2], idx.shape[3])
    sel = torch.gather(tab, 2, idx)
    return sel.reshape((4, NLIMBS) + tuple(digits.shape)).unbind(0)


def _nibbles(canon: torch.Tensor) -> torch.Tensor:
    """Canonical (16, n) limbs -> (64, n) 4-bit digits, least significant
    first."""
    parts = torch.stack([(canon >> (4 * k)) & 15 for k in range(4)], 1)
    return parts.reshape(4 * NLIMBS, canon.shape[1])


def _check_windows(windows: int) -> None:
    if not 1 <= windows <= WINDOWS:
        raise ValueError(f"windows must be in [1, {WINDOWS}], got {windows}")


def _coords(canon, x, y, z, t):
    dev = canon.device
    flat = [_flat(a, dev) for a in (canon, x, y, z, t)]
    n = flat[0].shape[1]
    if any(a.shape[1] != n for a in flat):
        raise ValueError("scalar and point coordinates differ in batch size")
    return dev, flat, n


# ---------------------------------------------------------------------------
# windowed_mul
# ---------------------------------------------------------------------------


def windowed_mul_plain(canon, x, y, z, t, windows: int = WINDOWS):
    """Plain torch form of `windowed_mul`."""
    tab = _table(x, y, z, t)
    digits = _nibbles(canon)
    acc = tuple(c.to(torch.int64) for c in identity_coords(x))
    for i in range(windows):
        ax, ay, az = acc[:3]
        for _ in range(3):
            ax, ay, az = _double_no_t(ax, ay, az)
        ax, ay, az, at = _double(ax, ay, az)
        sel = _select(tab, digits[windows - 1 - i])
        acc = _padd_cached(ax, ay, az, at, *sel)
    return to_canonical(*acc)


def windowed_mul(canon, x, y, z, t, windows: int = WINDOWS):
    """s*P over (16, n) canonical scalar limbs and point coordinates by
    4-bit fixed windows, most significant first.  `windows < 64` takes only
    the low `windows` windows: (s mod 2^(4*windows)) * P.  -> (X, Y, Z, T)."""
    _check_windows(windows)
    if canon.device.type == "cpu":
        return windowed_mul_plain(canon, x, y, z, t, windows)
    dev, flat, n = _coords(canon, x, y, z, t)
    outs = [torch.empty_like(flat[1]) for _ in range(4)]
    if n:
        with torch.cuda.device(dev):
            rc = _lib().ark_windowed_mul(_ptrs(flat + outs), n, windows,
                                         _stream(dev))
        _check(rc, "windowed_mul")
        windowed_mul.launches += 1
    return tuple(outs)


windowed_mul.launches = 0


@functools.lru_cache(maxsize=None)
def _windowed_occupancy(device_index: int) -> tuple[int, int]:
    """(resident blocks per SM, dynamic shared bytes per block) of
    `windowed_mul`."""
    blocks, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        rc = _lib().ark_windowed_mul_config(ctypes.byref(blocks), ctypes.byref(smem))
    _check(rc, "windowed_mul occupancy")
    return blocks.value, smem.value


def windowed_launch_config(n: int, device) -> dict:
    """The launch of `windowed_mul` over n points on a CUDA device: a quad
    of lanes per point, 32 points a block, one block per 32 points."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks, smem = _windowed_occupancy(index)
    points = WM_THREADS // WM_LANES
    return {"lanes_per_point": WM_LANES, "threads": WM_THREADS,
            "points_per_block": points, "grid": -(-n // points),
            "blocks_per_sm": blocks, "warps_per_sm": blocks * WM_THREADS // 32,
            "smem_bytes": smem}


# ---------------------------------------------------------------------------
# ladder
# ---------------------------------------------------------------------------


def ladder_plain(canon, x, y, z, t):
    """Plain torch form of `ladder`."""
    pt = tuple(c.to(torch.int64) for c in (x, y, z, t))
    acc = tuple(c.to(torch.int64) for c in identity_coords(x))
    for i in range(255, -1, -1):
        bit = ((canon[i >> 4] >> (i & 15)) & 1).bool()
        acc = _double(*acc)
        added = _padd(*acc, *pt)
        acc = tuple(torch.where(bit, a, d) for a, d in zip(added, acc))
    return to_canonical(*acc)


def ladder(canon, x, y, z, t):
    """s*P over (16, n) canonical scalar limbs and point coordinates by the
    256-step most-significant-first double-and-add ladder (the full double,
    then the complete add, taken where the bit is set).  -> (X, Y, Z, T)."""
    if canon.device.type == "cpu":
        return ladder_plain(canon, x, y, z, t)
    dev, flat, n = _coords(canon, x, y, z, t)
    outs = [torch.empty_like(flat[1]) for _ in range(4)]
    if n:
        with torch.cuda.device(dev):
            rc = _lib().ark_ladder(_ptrs(flat + outs), n, _stream(dev))
        _check(rc, "ladder")
        ladder.launches += 1
    return tuple(outs)


ladder.launches = 0


@functools.lru_cache(maxsize=None)
def _ladder_occupancy(device_index: int) -> tuple[int, int, int]:
    """(threads a block, points a block, resident blocks per SM) of
    `ladder`."""
    vals = [ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)]
    with torch.cuda.device(device_index):
        rc = _lib().ark_ladder_config(*map(ctypes.byref, vals))
    _check(rc, "ladder occupancy")
    return tuple(v.value for v in vals)


def ladder_launch_config(n: int, device) -> dict:
    """The launch of `ladder` over n points on a CUDA device: its grid,
    resident blocks and warps per SM, and the waves the grid takes."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    threads, points, blocks = _ladder_occupancy(index)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    grid = -(-n // points)
    return {"threads": threads, "points_per_block": points, "grid": grid,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "waves": grid / (blocks * sms)}

# scalar x point kernels by name (`scalar_mul` and `mul_by_order` take one)
SCALAR_MUL_KERNELS = {"windowed": windowed_mul, "ladder": ladder}


def _scalar_mul_kernel(kernel: str):
    if kernel not in SCALAR_MUL_KERNELS:
        raise ValueError(f"kernel={kernel!r}: expected one of "
                         f"{', '.join(repr(k) for k in SCALAR_MUL_KERNELS)}")
    return SCALAR_MUL_KERNELS[kernel]


def _flat_point(point, n):
    return [c.limbs.expand((NLIMBS,) + tuple(point.shape)).reshape(NLIMBS, n)
            for c in point._coords()]


def scalar_mul(point, scalar, kernel: str = "windowed"):
    """`CurvePoint.mul`: broadcast, flatten, run the named kernel
    (`windowed_mul` or `ladder`), reshape."""
    from ..algebra.curve import CurvePoint

    kern = _scalar_mul_kernel(kernel)
    shape = torch.broadcast_shapes(tuple(point.shape), tuple(scalar.shape))
    n = 1
    for s in shape:
        n *= s
    pt = point.broadcast_to(shape)
    canon = lb.from_mont(SCALAR_FIELD, scalar.broadcast_to(shape).limbs)
    out = kern(canon.reshape(NLIMBS, n), *_flat_point(pt, n))
    return CurvePoint.from_coords(out, shape)


def mul_by_order(point, kernel: str = "windowed"):
    """l * P (l the prime group order, which no `Scalar` can hold): the
    prime-subgroup check every received point takes (with `windowed_mul`)."""
    from ..algebra.curve import CurvePoint

    kern = _scalar_mul_kernel(kernel)
    shape = tuple(point.shape)
    n = 1
    for s in shape:
        n *= s
    coords = _flat_point(point, n)
    canon = _const(SCALAR_FIELD.modulus, coords[0]).contiguous()
    return CurvePoint.from_coords(kern(canon, *coords), shape)


# ---------------------------------------------------------------------------
# window_sums
# ---------------------------------------------------------------------------


def lane_points(n: int) -> int:
    """Points a `window_sums` lane takes at n points (the last lane the
    rest): at least WS_LANE_POINTS, and enough for at most WS_MAX_LANES
    lanes."""
    return max(WS_LANE_POINTS, -(-n // WS_MAX_LANES))


def default_lanes(n: int) -> int:
    """`window_sums` lanes at n points: every lane holds at least one."""
    return max(1, -(-n // lane_points(n)))


def window_sums_plain(canon, x, y, z, t, windows: int = WINDOWS):
    """Plain torch form of `window_sums`: step r adds point lo_j + r of
    every lane j that has one, all windows at once."""
    n = canon.shape[1]
    L, per = default_lanes(n), lane_points(n)
    tab = _table(x, y, z, t)
    digits = _nibbles(canon)[:windows]
    acc = [a.to(torch.int64).unsqueeze(1).expand(NLIMBS, windows, L).contiguous()
           for a in identity_coords(x[:, :1].expand(NLIMBS, L))]
    starts = torch.arange(L, device=canon.device) * per
    for r in range(min(per, n)):
        m = min(L, -(-(n - r) // per))  # lanes 0 .. m - 1 have a point r
        cols = starts[:m] + r
        sel = _select(tab[..., cols], digits[:, cols])
        new = _padd_cached(*(a[:, :, :m] for a in acc), *sel)
        for a, v in zip(acc, new):
            a[:, :, :m] = v
    return tuple(a.permute(1, 0, 2).contiguous() for a in to_canonical(*acc))


def window_sums(canon, x, y, z, t, windows: int = WINDOWS):
    """Per-window, per-lane partial MSM sums: lane j of window w holds the
    sum over its points i = j * per .. min((j + 1) * per, n) - 1 (in that
    order, from the identity) of digit_w(s_i) * P_i, by cached adds of
    table entries, with per = `lane_points(n)` and L = `default_lanes(n)`
    lanes.  `windows < 64` takes the low windows only.  -> four
    (windows, 16, L) tensors."""
    _check_windows(windows)
    if canon.device.type == "cpu":
        return window_sums_plain(canon, x, y, z, t, windows)
    dev, flat, n = _coords(canon, x, y, z, t)
    if n == 0:
        raise ValueError("window_sums needs at least one point")
    L = default_lanes(n)
    outs = [torch.empty((windows, NLIMBS, L), dtype=lb.LIMB_DTYPE, device=dev)
            for _ in range(4)]
    with torch.cuda.device(dev):
        rc = _lib().ark_window_sums(_ptrs(flat + outs), n, windows, L,
                                    lane_points(n), _stream(dev))
    _check(rc, "window_sums")
    window_sums.launches += 1
    return tuple(outs)


window_sums.launches = 0


@functools.lru_cache(maxsize=None)
def _window_sums_occupancy(device_index: int) -> tuple[int, int, int, int]:
    """(threads a block, tile points, resident blocks per SM, dynamic shared
    bytes per block) of `window_sums`."""
    vals = [ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)]
    with torch.cuda.device(device_index):
        rc = _lib().ark_window_sums_config(*map(ctypes.byref, vals))
    _check(rc, "window_sums occupancy")
    return tuple(v.value for v in vals)


def window_sums_launch_config(n: int, device) -> dict:
    """The launch of `window_sums` over n points on a CUDA device: a block
    a lane, a quad a window, tables built a tile at a time."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    threads, tile, blocks, smem = _window_sums_occupancy(index)
    return {"threads": threads, "tile": tile, "lanes": default_lanes(n),
            "lane_points": lane_points(n), "grid": default_lanes(n),
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "smem_bytes": smem}


def msm_windowsum(points, scalars, windows: int = WINDOWS, marks=None):
    """MSM through `window_sums`: the lane partials summed by a plain torch
    tree (batched over windows), then the Horner sum_w 16^w S_w on the card
    by one `bucket_reduce` launch over (16, windows, 2) buckets, bucket 1
    holding S_w (bucket 0 has weight 0).  `marks`: optional four CUDA
    events, recorded before the kernel, the tree and the Horner and after
    the Horner (to time the parts)."""
    from ..algebra.curve import CurvePoint
    from .msm_kernels import bucket_reduce

    if marks is not None and len(marks) != 4:
        raise ValueError(f"marks takes 4 events, got {len(marks)}")

    def record(k):
        if marks is not None:
            marks[k].record()

    n = scalars.size
    canon = lb.from_mont(SCALAR_FIELD, scalars.reshape(n).limbs)
    coords = _flat_point(points.broadcast_to((n,)), n)
    record(0)
    sums = window_sums(canon, *coords, windows=windows)
    record(1)
    S = CurvePoint.from_coords([a.permute(1, 0, 2) for a in sums],
                               (windows, sums[0].shape[2])).sum(axis=1)
    record(2)
    out = bucket_reduce(*(torch.stack([c.limbs, c.limbs], 2) for c in S._coords()),
                        c_bits=4)
    record(3)
    return CurvePoint.from_coords(out, ())
