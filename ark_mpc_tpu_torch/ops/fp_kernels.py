"""Hand-written CUDA kernels for the hot field ops, their plain versions and
wrappers.

Counterpart of `ark_mpc_tpu/ops/fp_kernels.py`.  The kernels live in
`csrc/fp_kernels.cu` (CUDA C++ for sm_90a, built with nvcc at first use and
called through ctypes).  Each wrapper:

  - runs its plain PyTorch version for CPU tensors, and only then;
  - for CUDA tensors launches the kernel on the current stream, or raises
    (no fallback), and adds one to its `launches` count per launch;
  - rejects pseudo-Mersenne field specs: the kernels compute Montgomery
    products.  (The reference's `mont_mul_pallas` given the Ed25519 base
    field also computes a Montgomery product, unlike `limbs.mont_mul`.)

Source notes (per kernel; bounds are for one H100 SXM):

  `mont_mul` replaces `mont_mul_pallas` (ark_mpc_tpu/ops/fp_kernels.py:63).
    Bound: bytes.  Per element it moves 192 bytes against one 256x256
    product and one REDC (128 32x32->64 products, ~264 32-bit multiplies),
    so device memory is the limit.  Design: one thread per element, limbs
    repacked to eight 32-bit words in registers (reads and writes stay one
    pass each), SOS product + 32-bit REDC, coalesced limb-row loads.

  `beaver_round` replaces `beaver_round_pallas` (:88).
    Bound: bytes (512 read and 128 written per element against 6 products
    and 4 reductions).  Design: one pass over the 8 operand arrays with
    every intermediate in registers; the MAC-key share is read as one (16,)
    vector instead of a broadcast (16, n) array (64 bytes per element
    fewer); two products feeding one output share a reduction
    (2m^2 < m*2^256).

  `beaver_chain` replaces `beaver_chain_pallas` (:132).
    Bound: operations (7 products + 5 reductions per round for the shares,
    3 fold products).  Design: both parties' running shares stay in
    registers for all K rounds; round-invariant operands are re-read from
    global memory (L1/L2 resident per block) each round; the MAC-check fold
    is an un-reduced 512-bit inner product summed per warp with redux.sync
    on 16-bit halves and per block in 64-bit shared accumulators, finished
    by a plain torch sum over blocks and one Montgomery reduction
    (`fold_reduce`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..algebra import limbs as lb
from ..algebra.limbs import NLIMBS, FieldSpec
from . import _build

THREADS = 256
# Per-launch round cap: the chain's shared accumulator takes 384 bytes per
# round, and 512 rounds (192 KiB) stay inside Hopper's 227 KiB per block.
CHAIN_MAX_ROUNDS = 512
# Blocks per SM for the chain's grid-stride loop (also sizes its partials).
CHAIN_BLOCKS_PER_SM = 4
FOLD_WORDS = 16


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fp_kernels")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ark_mont_mul.argtypes = [vp, vp, vp, i64, vp, vp]
    lib.ark_beaver_round.argtypes = [vp, i64, i32, vp, vp]
    lib.ark_beaver_chain.argtypes = [vp, i64, i32, i32, vp, vp]
    for fn in (lib.ark_mont_mul, lib.ark_beaver_round, lib.ark_beaver_chain):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _field_words(spec: FieldSpec):
    """Modulus as 8 little-endian 32-bit words, then n0' = -m^-1 mod 2^32."""
    words = [(spec.modulus >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    return (ctypes.c_uint32 * 9)(*words, spec.n0_32)


def _require_montgomery(spec: FieldSpec, name: str) -> None:
    if spec.pm_c:
        raise ValueError(
            f"{name}: {spec} is a pseudo-Mersenne field; the kernel computes "
            "Montgomery products only")


def _flat(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """(16, *batch) int32 CUDA tensor -> contiguous (16, n)."""
    if x.device != device:
        raise ValueError(f"tensor on {x.device}, expected {device}")
    if x.dtype != lb.LIMB_DTYPE:
        raise TypeError(f"limbs must be {lb.LIMB_DTYPE}, got {x.dtype}")
    if x.shape[0] != NLIMBS:
        raise ValueError(f"limb axis must be {NLIMBS}, got shape {tuple(x.shape)}")
    return x.reshape(NLIMBS, -1).contiguous()


def _vec(k: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A (16,) limb vector (MAC-key share) on `device`."""
    if tuple(k.shape) != (NLIMBS,):
        raise ValueError(f"key share must have shape ({NLIMBS},), got {tuple(k.shape)}")
    return _flat(k.reshape(NLIMBS, 1), device).reshape(NLIMBS)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _bcast_vec(k: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return k.reshape((NLIMBS,) + (1,) * (like.dim() - 1)).expand(like.shape)


# ---------------------------------------------------------------------------
# mont_mul
# ---------------------------------------------------------------------------


def mont_mul(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Montgomery product x*y*2^-256 mod m over (16, *batch) limb tensors."""
    _require_montgomery(spec, "mont_mul")
    if x.device.type == "cpu":
        return lb.mont_mul_plain(spec, x, y)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    dev = x.device
    xf, yf = _flat(x, dev), _flat(y, dev)
    out = torch.empty_like(xf)
    n = xf.shape[1]
    if n:
        with torch.cuda.device(dev):
            rc = _lib().ark_mont_mul(xf.data_ptr(), yf.data_ptr(), out.data_ptr(),
                                     n, _field_words(spec), _stream(dev))
        _check(rc, "mont_mul")
        mont_mul.launches += 1
    return out.reshape(x.shape)


mont_mul.launches = 0


# ---------------------------------------------------------------------------
# beaver_round
# ---------------------------------------------------------------------------


def beaver_round_plain(spec, party_id, a_s, a_m, b_s, b_m, c_s, c_m, d, e, key):
    """Plain torch form of `beaver_round`."""
    mm = functools.partial(lb.mont_mul_plain, spec)
    add = functools.partial(lb.add, spec)
    de = mm(d, e)
    share = add(add(mm(d, b_s), mm(e, a_s)), c_s)
    if party_id == 0:
        share = add(share, de)
    mac = add(add(add(mm(d, b_m), mm(e, a_m)), c_m), mm(_bcast_vec(key, de), de))
    return share, mac


def beaver_round(spec: FieldSpec, party_id: int, a_s, a_m, b_s, b_m, c_s, c_m,
                 d, e, key):
    """One party's fused Beaver combine over (16, *batch) limb tensors:
      share = d*e*(party==0) + d*b_s + e*a_s + c_s
      mac   = key*d*e + d*b_m + e*a_m + c_m
    with `key` the party's (16,) MAC-key share.  -> (share, mac)."""
    _require_montgomery(spec, "beaver_round")
    if party_id not in (0, 1):
        raise ValueError(f"party_id must be 0 or 1, got {party_id}")
    if d.device.type == "cpu":
        return beaver_round_plain(spec, party_id, a_s, a_m, b_s, b_m, c_s, c_m,
                                  d, e, key)
    dev = d.device
    ops = [_flat(t, dev) for t in (a_s, a_m, b_s, b_m, c_s, c_m, d, e)]
    n = ops[-1].shape[1]
    if any(t.shape[1] != n for t in ops):
        raise ValueError("beaver_round operands differ in batch size")
    out_s, out_m = torch.empty_like(ops[0]), torch.empty_like(ops[0])
    if n:
        ptrs = _ptrs(ops + [_vec(key, dev), out_s, out_m])
        with torch.cuda.device(dev):
            rc = _lib().ark_beaver_round(ptrs, n, party_id, _field_words(spec),
                                         _stream(dev))
        _check(rc, "beaver_round")
        beaver_round.launches += 1
    return out_s.reshape(d.shape), out_m.reshape(d.shape)


beaver_round.launches = 0


# ---------------------------------------------------------------------------
# beaver_chain
# ---------------------------------------------------------------------------


def beaver_chain_plain(spec, rounds, x0, x1, e, a0, a1, b0, b1, bm0, bm1,
                       c0, c1, cm0, cm1, ea0, ea1, eam0, eam1, k0, k1, cf):
    """Plain torch form of `beaver_chain`: the same rounds one op at a time,
    the fold as modular sums of Montgomery products."""
    mm = functools.partial(lb.mont_mul_plain, spec)
    add = functools.partial(lb.add, spec)
    sub = functools.partial(lb.sub, spec)
    kb0, kb1 = _bcast_vec(k0, x0), _bcast_vec(k1, x0)
    folds = []
    for _ in range(rounds):
        d = add(sub(x0, a0), sub(x1, a1))
        de = mm(d, e)
        s0 = add(add(add(mm(d, b0), ea0), c0), de)
        s1 = add(add(mm(d, b1), ea1), c1)
        m0 = add(add(add(mm(d, bm0), mm(kb0, de)), eam0), cm0)
        m1 = add(add(add(mm(d, bm1), mm(kb1, de)), eam1), cm1)
        v = add(s0, s1)
        folds.append(torch.stack(
            [lb.tree_sum(spec, mm(cf, t)) for t in (v, m0, m1)], dim=-1))
        x0, x1 = s0, s1
    return x0, x1, torch.stack(folds, dim=1)


def fold_reduce(spec: FieldSpec, word_sums: torch.Tensor) -> torch.Tensor:
    """(K, 3, 16) int64 sums of the 32-bit words of 512-bit products
    cf_mont * t_mont -> (16, K, 3) Montgomery limbs of sum_i cf_i * t_i.

    The integer S = sum(cf * t) * R^2 (split into 16-bit columns) is reduced
    by a 24-iteration REDC (divides by 2^384; S < m * 2^384) and corrected by
    W = 2^384 mod m: mont_mul(redc24(S), W) = S * R^-1 = sum(cf * t) * R."""
    w = word_sums.permute(2, 0, 1)  # (16, K, 3); word k weighs 2^(32k)
    cols = w.new_zeros((2 * FOLD_WORDS + 2,) + tuple(w.shape[1:]))
    for q in range(4):  # 16-bit piece q of word k lands in column 2k + q
        cols[q:q + 2 * FOLD_WORDS:2] += (w >> (16 * q)) & lb.LIMB_MASK
    y = lb._redc(spec, cols, iters=24)
    corr = lb.int_to_limbs((1 << 384) % spec.modulus)
    return lb.mont_mul(spec, y, lb.const_like(corr, y))


def beaver_chain(spec: FieldSpec, rounds: int, x0, x1, e, a0, a1, b0, b1,
                 bm0, bm1, c0, c1, cm0, cm1, ea0, ea1, eam0, eam1, k0, k1, cf):
    """K dependent two-party Beaver rounds x <- x*y with the MAC-check fold.

    Operands are (16, n) Montgomery limb tensors (e, e*a_p and e*a_mac_p
    hoisted by the caller), k0/k1 the parties' (16,) MAC-key shares and cf
    the fold coefficients.  Returns (x0_K, x1_K, fold) with fold (16, K, 3)
    the Montgomery values <cf, v_r>, <cf, mac0_r>, <cf, mac1_r> per round."""
    _require_montgomery(spec, "beaver_chain")
    if rounds < 1:
        raise ValueError(f"beaver_chain needs at least one round, got {rounds}")
    args = (x0, x1, e, a0, a1, b0, b1, bm0, bm1, c0, c1, cm0, cm1,
            ea0, ea1, eam0, eam1)
    if x0.device.type == "cpu":
        return beaver_chain_plain(spec, rounds, *args, k0, k1, cf)
    dev = x0.device
    ops = [_flat(t, dev) for t in args]
    cf_f = _flat(cf, dev)
    n = ops[0].shape[1]
    if n == 0 or any(t.shape[1] != n for t in ops + [cf_f]):
        raise ValueError("beaver_chain operands must share one non-empty batch")
    keys = [_vec(k0, dev), _vec(k1, dev)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = min(-(-n // THREADS), sms * CHAIN_BLOCKS_PER_SM)
    word_sums = torch.empty((rounds, 3, FOLD_WORDS), dtype=torch.int64, device=dev)
    cx0, cx1 = ops[0], ops[1]
    for start in range(0, rounds, CHAIN_MAX_ROUNDS):
        k = min(CHAIN_MAX_ROUNDS, rounds - start)
        out0, out1 = torch.empty_like(cx0), torch.empty_like(cx1)
        partial = torch.empty((grid, k, 3, FOLD_WORDS), dtype=torch.int64,
                              device=dev)
        ptrs = _ptrs([cx0, cx1] + ops[2:] + keys + [cf_f, out0, out1, partial])
        with torch.cuda.device(dev):
            rc = _lib().ark_beaver_chain(ptrs, n, k, grid, _field_words(spec),
                                         _stream(dev))
        _check(rc, "beaver_chain")
        beaver_chain.launches += 1
        word_sums[start:start + k] = partial.sum(dim=0)
        cx0, cx1 = out0, out1
    return cx0, cx1, fold_reduce(spec, word_sums)


beaver_chain.launches = 0

KERNELS = {"mont_mul": mont_mul, "beaver_round": beaver_round,
           "beaver_chain": beaver_chain}
PLAIN = {"mont_mul": lb.mont_mul_plain, "beaver_round": beaver_round_plain,
         "beaver_chain": beaver_chain_plain}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def build() -> dict[str, str]:
    """Compile the kernels now (one nvcc per source, in parallel) and load
    them; -> {source: compiler log}."""
    logs = _build.build(["fp_kernels"])
    _lib()
    return logs

