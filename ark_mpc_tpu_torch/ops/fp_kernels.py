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
    Bound: operations.  By linearity a round needs 2 Montgomery products
    (2 reductions) and 3 un-reduced wide products, 912 32-bit multiplies
    an element, plus 4 products, 4 reductions and 2 wide products once per
    element for the invariants.  Identities, with every value canonical:
      s_p   = d*B_p + C_p,  B0 = b0 + e, B1 = b1, C_p = e*a_p + c_p;
      mac_p = d*M_p + CM_p, M_p = bmac_p + k_p*e, CM_p = e*amac_p + cmac_p;
      <cf, mac_p> = sum d*G_p + K_p, G_p = cf*M_p, K_p = sum cf*CM_p,
    so the shares stay bit-identical and the MACs, never output, reach the
    fold through G_p and the round-invariant K_p.  Design: persistent
    blocks of 256 threads (grid = resident blocks x SMs, from the
    occupancy API); per tile each raw input is read once and the
    invariants a0 a1 B0 B1 C0 C1 G0 G1 cf go to shared memory word-major
    (72 KiB a block, conflict-free); the K rounds keep x0, x1 in registers
    and read only shared memory; `__launch_bounds__(256, 2)` caps the
    kernel at 128 registers so 16 warps stay resident per SM.  The fold's
    512-bit products are summed per warp through a padded shared scratch
    (conflict-free column writes and row reads, one shuffle, one 16-lane
    atomic) and per block in 64-bit shared accumulators, one extra row
    holding K_0, K_1; `chain_word_sums` adds that row to every round and
    `fold_reduce` reduces once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..algebra import limbs as lb
from ..algebra.limbs import NLIMBS, FieldSpec
from . import _build

THREADS = 256
# Per-launch round cap: a chain block holds 72 KiB of invariants, 16.5 KiB
# of fold scratch and 384 bytes of accumulators per round (plus one row for
# K_p); at 64 rounds (112.9 KiB) two blocks still fit an SM's 228 KiB.
CHAIN_MAX_ROUNDS = 64
FOLD_WORDS = 16
# The chain's word sums reach n * 2^33, exact in int64 below this batch.
CHAIN_MAX_N = 1 << 30


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fp_kernels")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ark_mont_mul.argtypes = [vp, vp, vp, i64, vp, vp]
    lib.ark_beaver_round.argtypes = [vp, i64, i32, vp, vp]
    lib.ark_beaver_chain.argtypes = [vp, i64, i32, i32, vp, vp]
    lib.ark_beaver_chain_config.argtypes = [i32, vp, vp]
    for fn in (lib.ark_mont_mul, lib.ark_beaver_round, lib.ark_beaver_chain,
               lib.ark_beaver_chain_config):
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


def _count(kernel, spec: FieldSpec) -> None:
    """One launch of `kernel`, in its total and in its count for the field."""
    kernel.launches += 1
    kernel.launches_by_field[spec.name] = kernel.launches_by_field.get(spec.name, 0) + 1


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
        _count(mont_mul, spec)
    return out.reshape(x.shape)


mont_mul.launches = 0
mont_mul.launches_by_field = {}


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
        _count(beaver_round, spec)
    return out_s.reshape(d.shape), out_m.reshape(d.shape)


beaver_round.launches = 0
beaver_round.launches_by_field = {}


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


def chain_word_sums(acc: torch.Tensor) -> torch.Tensor:
    """(K + 1, 3, 16) block-summed chain accumulators -> (K, 3, 16) word sums.

    Rows 0..K-1 hold each round's sums of cf*v, d*G_0, d*G_1; row K holds
    [0, K_0, K_1], the MAC folds' round-invariant part, which every round's
    MAC sums take."""
    sums = acc[:-1].clone()
    sums[:, 1:] += acc[-1, 1:]
    return sums


@functools.lru_cache(maxsize=None)
def _chain_occupancy(device_index: int, rounds: int) -> tuple[int, int]:
    """(resident blocks per SM, dynamic shared bytes per block) of the chain
    kernel at `rounds` rounds a launch."""
    blocks, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        rc = _lib().ark_beaver_chain_config(rounds, ctypes.byref(blocks),
                                            ctypes.byref(smem))
    _check(rc, "beaver_chain occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"beaver_chain: a block of {smem.value} shared bytes "
                           "does not fit an SM")
    return blocks.value, smem.value


def chain_launch_config(n: int, rounds: int, device) -> dict:
    """The persistent grid of one chain launch of `rounds` rounds over n
    elements on a CUDA device: resident blocks per SM x SMs, capped by the
    number of 256-element tiles."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks, smem = _chain_occupancy(index, rounds)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return {"grid": min(-(-n // THREADS), blocks * sms), "threads": THREADS,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * THREADS // 32,
            "smem_bytes": smem}


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
    if n >= CHAIN_MAX_N:
        raise ValueError(f"beaver_chain takes fewer than {CHAIN_MAX_N} elements "
                         f"(its int64 word sums), got {n}")
    keys = [_vec(k0, dev), _vec(k1, dev)]
    word_sums = torch.empty((rounds, 3, FOLD_WORDS), dtype=torch.int64, device=dev)
    cx0, cx1 = ops[0], ops[1]
    for start in range(0, rounds, CHAIN_MAX_ROUNDS):
        k = min(CHAIN_MAX_ROUNDS, rounds - start)
        grid = chain_launch_config(n, k, dev)["grid"]
        out0, out1 = torch.empty_like(cx0), torch.empty_like(cx1)
        partial = torch.empty((grid, k + 1, 3, FOLD_WORDS), dtype=torch.int64,
                              device=dev)
        ptrs = _ptrs([cx0, cx1] + ops[2:] + keys + [cf_f, out0, out1, partial])
        with torch.cuda.device(dev):
            rc = _lib().ark_beaver_chain(ptrs, n, k, grid, _field_words(spec),
                                         _stream(dev))
        _check(rc, "beaver_chain")
        _count(beaver_chain, spec)
        word_sums[start:start + k] = chain_word_sums(partial.sum(dim=0))
        cx0, cx1 = out0, out1
    return cx0, cx1, fold_reduce(spec, word_sums)


beaver_chain.launches = 0
beaver_chain.launches_by_field = {}

KERNELS = {"mont_mul": mont_mul, "beaver_round": beaver_round,
           "beaver_chain": beaver_chain}
PLAIN = {"mont_mul": lb.mont_mul_plain, "beaver_round": beaver_round_plain,
         "beaver_chain": beaver_chain_plain}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.launches_by_field = {}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def field_launch_counts() -> dict[str, dict[str, int]]:
    """{kernel: {field name: launches}} since the last reset."""
    return {name: dict(fn.launches_by_field) for name, fn in KERNELS.items()}


def build() -> dict[str, str]:
    """Compile the kernels now (one nvcc per source, in parallel) and load
    them; -> {source: compiler log}."""
    logs = _build.build(["fp_kernels"])
    _lib()
    return logs

