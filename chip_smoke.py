#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
  1. build    compile the hand-written kernels with nvcc (sm_90a) and print
              the card's name and power limit;
  2. kernels  each kernel against its plain PyTorch version at n = 2^16
              (chain: 2 rounds) and at an odd n, bit for bit;
  3. readme   the README product through `execute_mock_mpc` on the card
              (= [6]), and a corrupted-MAC run that must abort;
  4. fabric   `MpcFabric.mul` + deferred authenticated opens + one folded
              MAC check at n = 2^20 under the trusted dealer;
  5. chain    the headline: n = 2^22 elements, 64 dependent rounds, one MAC
              check, timed with CUDA events over 5 runs after a warm-up;
  6. report   every kernel timed at its main-path shape beside its plain
              version on the same inputs, its bound and its launch count,
              and the chain's launch: its persistent grid, resident blocks
              and warps per SM and shared memory per block;
  7. curve    `windowed_mul` and `window_sums` against their plain versions
              at the tail sizes n = 1, 3, 33 (`window_sums` 1, 31, 33); the
              five curve kernels against their plain versions at n = 2^12
              and n = 1000 (64 windows), and `bucket_reduce` at the
              window-sum MSM's Horner shape (16, 64, 2) with 4-bit windows,
              bit for bit;
  8. points   the point protocols through `execute_mock_mpc_dealer` at
              n = 10,000 points: `share_points`, a Beaver scalar x point
              product, an authenticated MSM, deferred authenticated opens and
              one `verify_deferred`, spot-checked against Python ints; then a
              corrupted point MAC and an order-2 input point must abort;
  9. msm      the public MSM at n = 2^16 through each route (windowed + tree,
              bucket, winsum): routes agree with each other and with Python
              ints; median of 5 CUDA-event timings after a warm-up; the
              ladder kernel's column (`scalar_mul(kernel="ladder").sum()`)
              by parts (CUDA events) beside the host's enqueue time; the
              winsum route's parts (the `window_sums` kernel, the plain lane
              tree, the `bucket_reduce` Horner) by CUDA events, median of 5;
 10. report   the curve kernels as in phase 6, with `windowed_mul`'s launch
              (lanes per point, threads and points a block, resident blocks
              and warps per SM, shared memory per block) and its time at
              n = 1000 beside the one at 2^16, `window_sums`' launch
              (threads, tile, lanes, grid, resident blocks and warps per SM,
              shared memory per block, ptxas of its kernel), `ladder`'s
              launch (threads and points a block, grid, resident blocks and
              warps per SM, waves at 2^16, ptxas of its kernel), and
              `bucket_accumulate`'s passes (chunk size, pass count, grids,
              resident warps per SM, ptxas of its kernel, the time of each
              pass), and `bucket_reduce`'s two launches (grid, threads and
              shared memory of the window kernel and of the Horner, ptxas of
              both, the time of each by CUDA events) with its critical path
              (dependent point operations, the Horner's product stages and
              its time a stage);
 11. traced   traced circuits (`fabric.tracer()`): the README example; gate
              throughput of 100,000 add gates under `NoRecvTransport`; a
              circuit at n = 2^20 under the trusted dealer (x*y + x at 2^20;
              bit_xor, inverse, a reused mid-circuit open, pow 5 and a sum on
              a 2^16 slice) whose rounds must equal its communication depth;
              a traced prefix product at 2^16 and a traced scalar x point
              circuit at n = 10,000, all spot-checked against Python ints;
              then a corrupted MAC that must abort at `verify_deferred`;
 12. matmul   `shared_matmul` at 512 x 512 x 512 under the trusted dealer
              (MAC-checked, spot entries against Python ints), `mont_matmul`
              alone at 512^3, shared `poly_mul` of two degree-255
              polynomials with `poly_eval` and `poly_div`, and an
              `EvaluationDomain(132)` FFT/IFFT round trip of shares;
 13. bn254    at BN254's scalar field Fr under `TrustedDealerSource(field=
              Fr)`: phase 4's fabric batch at n = 2^20 (spot products
              against Python ints mod r) and a corrupted MAC that must
              abort; the G1 point protocols at n = 10,000 (share and open,
              `mul_generator`, `beaver_mul_points`, deferred opens, one
              `verify_deferred`), spot points against Python-int affine
              arithmetic, then a corrupted point MAC and a received point
              off the curve that must abort; one `G1.mul` at n = 10,000
              timed alone with its `mont_mul` launches; `mont_mul` at Fq
              and Fr at (16, 2^22) and `beaver_round` at Fr at (16, 2^20)
              against their plain versions, bit for bit, timed beside
              phase 6's l-field times;
 14. tcp      two party processes on this card over localhost TCP
              (plaintext, the native IO library): `python -m
              ark_mpc_tpu_torch.integration` runs every registry case in
              both, which must all be "ok" and agree; then the
              wire-inclusive batch of `benchmarks/online_wire.py` at its
              full size (n = 2^20, 4 chained `fabric.mul` rounds drawing
              their triples inside the clock, one authenticated open, one
              folded deferred check where that file's is unfolded, and
              plaintext where it uses TLS; this script run as
              `--wire-port P --party p`): mults/s over the slower
              party's wall time, bytes sent per mult, set-up seconds, the
              IO path (must be native) and each party's `beaver_round`
              launches (must be > 0).

Each phase logs its seconds.  The launch counts of the field kernels are
those of phases 3-5, those of the curve kernels those of phases 8-9 (each
path's counts are set to 0 just before it and read just after;
`bucket_accumulate` counts one launch a pass, and `bucket_reduce` launches
on the bucket and the winsum routes); phases
11-12 are a third path, whose kernels (`mont_matmul`'s and the fabric's)
must each launch there too, and phase 13's fabric batch and point
protocols a fourth, which must launch `mont_mul` at Fq and at Fr and
`beaver_round` at Fr (counted by field).  The last line is `{"ok": true,
"device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ark_mpc_tpu_torch import (
    G1,
    AuthenticationError,
    CurvePoint,
    Fr,
    MpcFabric,
    PartyIDBeaverSource,
    PointShare,
    Scalar,
    ScalarShare,
    TcpTransport,
    TrustedDealerSource,
    execute_mock_mpc,
    execute_mock_mpc_dealer,
)
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra import poly
from ark_mpc_tpu_torch.algebra.bn254 import BN254_BASE, BN254_Q, BN254_R, BN254_SCALAR
from ark_mpc_tpu_torch.algebra.domain import EvaluationDomain
from ark_mpc_tpu_torch.algebra.fields import SCALAR_FIELD as SPEC
from ark_mpc_tpu_torch.algebra.limbs import NLIMBS
from ark_mpc_tpu_torch.device import resolve_device
from ark_mpc_tpu_torch.fabric import commitment
from ark_mpc_tpu_torch.fabric.transport import NoRecvTransport
from ark_mpc_tpu_torch.gadgets import bit_xor, prefix_product
from ark_mpc_tpu_torch.models.circuits import shared_matmul
from ark_mpc_tpu_torch.ops import _build
from ark_mpc_tpu_torch.ops import curve_kernels as ck
from ark_mpc_tpu_torch.ops import fp_kernels as fk
from ark_mpc_tpu_torch.ops import matmul
from ark_mpc_tpu_torch.ops import msm_kernels as mk
from ark_mpc_tpu_torch.utils.stats import FabricStats

L = SPEC.modulus
SOURCE = "ark_mpc_tpu_torch/ops/csrc/fp_kernels.cu"
CURVE_SOURCE = "ark_mpc_tpu_torch/ops/csrc/curve_kernels.cu"
REPLACES = {
    "mont_mul": "ark_mpc_tpu/ops/fp_kernels.py:63",
    "beaver_round": "ark_mpc_tpu/ops/fp_kernels.py:88",
    "beaver_chain": "ark_mpc_tpu/ops/fp_kernels.py:132",
    "windowed_mul": "ark_mpc_tpu/ops/curve_kernels.py:106",
    "ladder": "ark_mpc_tpu/ops/curve_kernels.py:196",
    "window_sums": "ark_mpc_tpu/ops/curve_kernels.py:248",
    "bucket_accumulate": "ark_mpc_tpu/ops/msm_kernels.py:133",
    "bucket_reduce": "ark_mpc_tpu/ops/msm_kernels.py:372",
}
# Device-memory rates by card (NVIDIA data sheets); SXM is the default.
MEM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
INT32_LANES_PER_SM = 64  # 32-bit integer multiplies per clock per SM (sm_90)

N_CMP, K_CMP, N_ODD = 1 << 16, 2, 1000
N_FABRIC = 1 << 20
N_CHAIN, K_CHAIN = 1 << 22, 64
CHAIN_RUNS = 5  # timed runs of the headline after its warm-up
N_CURVE_CMP = 1 << 12
WM_TAILS = (1, 3, 33)
WS_TAILS = (1, 31, 33)     # a lone point; 31 and 33 either side of a tile of 32
N_POINTS = 10_000          # circuit_msm_throughput.rs top size
N_MSM = 1 << 16            # native_msm.rs top size
MSM_RUNS = 5
MSM_ROUTES = ("ladder", "bucket", "winsum")
N_GATES = 100_000          # benchmarks/online_suite.py top size
N_TRACED = 1 << 20         # the fabric's full width
N_SLICE = 1 << 16          # the other gates of the traced circuit
N_TRACED_POINTS = 10_000
N_MATMUL = 512             # benchmarks/shared_matmul_512.py
POLY_DEG = 255
MATMUL_RUNS = 5
# 32-bit multiply instructions per base-field product: 64 32x32->64
# products (lo and hi) and the x38 fold of 8 high words; a square needs 36
# word products (8 * 9 / 2)
MUL_OPS = 2 * 64 + 2 * 8
SQR_OPS = 2 * 36 + 2 * 8
# (products, squares) of each Edwards formula, as the kernels run them
DBL, DBL_NO_T, PADD, PADD_CACHED, PRODUCT = (4, 4), (3, 4), (9, 0), (8, 0), (1, 0)
# the cached table of 0..15 * P: 7 doubles, 7 adds and 2d * T of entries 1..15
TABLE = ((7, DBL), (7, PADD), (15, PRODUCT))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call by CUDA events (after `warmup` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_diff(a, b) -> int:
    """Largest limb difference between two results (tensor or tuple)."""
    if isinstance(a, tuple):
        return max(max_diff(x, y) for x, y in zip(a, b))
    check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


class Operands:
    """Random Montgomery operands for every kernel at one batch size."""

    def __init__(self, n: int, seed: int, dev):
        rng = np.random.default_rng(seed)
        self.arr = [Scalar.random(n, rng, device=dev).limbs for _ in range(18)]
        self.keys = [Scalar.random((), rng, device=dev).limbs for _ in range(2)]

    def mont_mul(self):
        return (SPEC, self.arr[0], self.arr[1])

    def beaver_round(self, party: int = 0):
        return (SPEC, party, *self.arr[:8], self.keys[0])

    def beaver_chain(self, rounds: int):
        return (SPEC, rounds, *self.arr[:17], *self.keys, self.arr[17])


def compare_kernels(ops: Operands, rounds: int) -> dict:
    """Each kernel against its plain version on the same inputs; -> max diff."""
    diffs = {
        "mont_mul": max_diff(fk.mont_mul(*ops.mont_mul()),
                             lb.mont_mul_plain(*ops.mont_mul())),
        "beaver_round": max(
            max_diff(fk.beaver_round(*ops.beaver_round(p)),
                     fk.beaver_round_plain(*ops.beaver_round(p)))
            for p in (0, 1)),
        "beaver_chain": max_diff(fk.beaver_chain(*ops.beaver_chain(rounds)),
                                 fk.beaver_chain_plain(*ops.beaver_chain(rounds))),
    }
    torch.cuda.synchronize()
    return diffs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> tuple[str, dict]:
    t0 = time.time()
    logs = _build.build(["fp_kernels", ck.SOURCE])  # one nvcc each, in parallel
    fk._lib()
    ck._lib()
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    card = smi("name,power.limit")
    log(f"[1 build] kernels built in {time.time() - t0:.1f} s")
    log(f"card: {card}")
    return card, logs


def ptxas_of(log_text: str, kernel: str) -> str:
    """ptxas's registers, stack frame and spills for one kernel."""
    lines = log_text.splitlines()
    at = next((i for i, line in enumerate(lines)
               if "Compiling entry" in line and kernel in line), None)
    if at is None:
        return "no ptxas log (a build from before logs were kept)"
    return " | ".join(line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                      if "stack frame" in line or "registers" in line)


def phase_kernels(dev) -> dict:
    ops = Operands(N_CMP, 11, dev)
    diffs = compare_kernels(ops, K_CMP)
    odd = compare_kernels(Operands(N_ODD, 12, dev), K_CMP)
    log(f"[2 kernels] max limb difference kernel vs plain at n=2^16 (chain "
        f"K={K_CMP}): {diffs}; at n={N_ODD}: {odd}")
    check(all(v == 0 for v in diffs.values()), "kernels differ from plain at 2^16")
    check(all(v == 0 for v in odd.values()), f"kernels differ from plain at n={N_ODD}")
    times = {}
    for name in fk.KERNELS:
        args = (ops.beaver_chain(K_CMP) if name == "beaver_chain"
                else getattr(ops, name)())
        times[name] = {
            "kernel_ms": cuda_ms(lambda: fk.KERNELS[name](*args), reps=10),
            "plain_ms": cuda_ms(lambda: fk.PLAIN[name](*args), reps=3),
        }
    return times


def readme_program(fabric):
    dev = fabric.device
    a = fabric.share_values(
        Scalar.from_ints([2], device=dev) if fabric.party_id == 0 else None,
        sender=0, n=1)
    b = fabric.share_values(
        Scalar.from_ints([3], device=dev) if fabric.party_id == 1 else None,
        sender=1, n=1)
    return fabric.open_authenticated(fabric.mul(a, b)).to_ints()


def corrupt_mac_program(fabric):
    dev, field = fabric.device, fabric.field
    sx = fabric.share_values(
        field.from_ints([5], device=dev) if fabric.party_id == 0 else None,
        sender=0, n=1)
    if fabric.party_id == 1:
        sx = ScalarShare(sx.share, sx.mac + field.from_ints(1, device=dev))
    return fabric.open_authenticated(sx).to_ints()


def phase_readme(dev) -> None:
    r0, r1 = execute_mock_mpc(readme_program, device=dev)
    log(f"[3 readme] product on {dev}: {r0} / {r1}")
    check(r0 == r1 == [6], "README product is not [6]")
    try:
        execute_mock_mpc_dealer(corrupt_mac_program, device=dev)
    except AuthenticationError as err:
        log(f"[3 readme] corrupted MAC aborted: AuthenticationError({err})")
    else:
        raise RuntimeError("check failed: corrupted MAC was not detected")


def fabric_program(fabric):
    n = N_FABRIC
    x = fabric.random_shared_scalars(n)
    y = fabric.random_shared_scalars(n)
    z = fabric.mul(x, y)
    opened = [fabric.open_authenticated(v, defer=True) for v in (x, y, z)]
    fabric.verify_deferred(fold=True)
    idx = torch.tensor([0, 1, n // 3, n // 2, n - 1], device=fabric.device)
    return [v[idx].to_ints() for v in opened], fabric.n_rounds


def phase_fabric(dev) -> None:
    torch.cuda.synchronize()
    t0 = time.time()
    (vals0, rounds0), (vals1, _) = execute_mock_mpc_dealer(fabric_program,
                                                           seed=3, device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    xs, ys, zs = vals0
    check(vals0 == vals1, "parties opened different values")
    check(zs == [x * y % L for x, y in zip(xs, ys)], "opened products are wrong")
    log(f"[4 fabric] n=2^20 mul + 3 deferred opens + folded MAC check OK in "
        f"{secs:.2f} s host time ({rounds0} rounds); spot checks {len(zs)}/{len(zs)}")


class Chain:
    """The headline chain's dealer material (left out of the timing) and
    its online work: pre-products, K rounds, fold, MAC-check values."""

    def __init__(self, n: int, rounds: int, dev):
        self.n, self.rounds = n, rounds
        rng = np.random.default_rng(0)
        dealer = TrustedDealerSource(0, seed=42, device=dev)
        self.key0 = dealer.get_mac_key_share()
        self.key1 = dealer._mac_key_shares[1]
        self.x = Scalar.random(n, rng, device=dev)
        self.y = Scalar.random(n, rng, device=dev)
        self.x0, self.x1 = dealer._deal(self.x)
        self.y0, self.y1 = dealer._deal(self.y)
        av = Scalar.random(n, rng, device=dev)
        bv = Scalar.random(n, rng, device=dev)
        self.a0, self.a1 = dealer._deal(av)
        self.b0, self.b1 = dealer._deal(bv)
        self.c0, self.c1 = dealer._deal(av * bv)
        self.cf = Scalar.random(n, rng, device=dev)
        self.rho = Scalar.random(rounds, np.random.default_rng(7), device=dev)
        self.blinder_rng = np.random.default_rng(8)

    def chain_args(self, e, pre):
        return (SPEC, self.rounds, self.x0.share.limbs, self.x1.share.limbs,
                e.limbs, self.a0.share.limbs, self.a1.share.limbs,
                self.b0.share.limbs, self.b1.share.limbs,
                self.b0.mac.limbs, self.b1.mac.limbs,
                self.c0.share.limbs, self.c1.share.limbs,
                self.c0.mac.limbs, self.c1.mac.limbs, *pre,
                self.key0.limbs, self.key1.limbs, self.cf.limbs)

    def pre_products(self):
        e = (self.y0 - self.b0).share + (self.y1 - self.b1).share
        pre = [fk.mont_mul(SPEC, e.limbs, t.limbs)
               for t in (self.a0.share, self.a1.share, self.a0.mac, self.a1.mac)]
        return e, pre

    def online(self, marks=None):
        """-> (x0_K, x1_K, acc0, acc1): final shares and each party's folded
        MAC-check value sum_r rho_r (k_p <cf, v_r> - <cf, mac_p,r>).  `marks`:
        three CUDA events, recorded before the pre-products, before the
        chain and after the check values."""
        if marks:
            marks[0].record()
        e, pre = self.pre_products()
        if marks:
            marks[1].record()
        xf0, xf1, fold = fk.beaver_chain(*self.chain_args(e, pre))
        v, m0, m1 = (Scalar(fold[:, :, i]) for i in range(3))
        acc0 = ((self.key0 * v - m0) * self.rho).sum()
        acc1 = ((self.key1 * v - m1) * self.rho).sum()
        if marks:
            marks[2].record()
        return xf0, xf1, acc0, acc1

    def mac_check(self, acc0, acc1) -> None:
        """Commit-reveal zero test of the two parties' folded values."""
        for acc in (acc0, acc1):
            blinder = Scalar.random((), self.blinder_rng, device=acc.device)
            comm = commitment.commit(acc.reshape(1), blinder)
            check(commitment.verify(acc.reshape(1), blinder, comm),
                  "fold commitment does not open")
        check(bool((acc0 + acc1).is_zero()), "MAC check failed on the chain")


def phase_chain(dev, card: str) -> tuple[Chain, dict]:
    t0 = time.time()
    ch = Chain(N_CHAIN, K_CHAIN, dev)
    torch.cuda.synchronize()
    log(f"[5 chain] dealer material n=2^22 ready in {time.time() - t0:.1f} s "
        "(untimed)")
    xf0, xf1, acc0, acc1 = ch.online()  # warm-up, checked too
    ch.mac_check(acc0, acc1)
    idx = [0, 7, N_CHAIN // 3, N_CHAIN - 1]
    got = (Scalar(xf0) + Scalar(xf1))[torch.tensor(idx, device=dev)].to_ints()
    xs = ch.x[torch.tensor(idx, device=dev)].to_ints()
    ys = ch.y[torch.tensor(idx, device=dev)].to_ints()
    check(got == [x * pow(y, K_CHAIN, L) % L for x, y in zip(xs, ys)],
          "chain output is not x * y^K")

    chain_ms, total_ms = [], []
    for _ in range(CHAIN_RUNS):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        _, _, acc0, acc1 = ch.online(marks)
        torch.cuda.synchronize()
        ch.mac_check(acc0, acc1)
        chain_ms.append(marks[1].elapsed_time(marks[2]))
        total_ms.append(marks[0].elapsed_time(marks[2]))
    mults = N_CHAIN * K_CHAIN
    med_chain, med_total = float(np.median(chain_ms)), float(np.median(total_ms))
    headline = {
        "metric": "authenticated_beaver_mults_per_sec",
        "value": mults / (med_chain / 1e3),
        "value_with_pre_products": mults / (med_total / 1e3),
        "n": N_CHAIN, "rounds": K_CHAIN, "mac_check": "passed",
        "runs": CHAIN_RUNS, "chain_and_check_ms": chain_ms,
        "with_pre_products_ms": total_ms, "card": card,
    }
    log(f"[5 chain] MAC check over {mults} mults passed in each of "
        f"{CHAIN_RUNS} timed runs; median {headline['value']:.4e} mults/s "
        f"(chain + fold check, {med_chain:.2f} ms; runs {min(chain_ms):.2f}-"
        f"{max(chain_ms):.2f} ms), {headline['value_with_pre_products']:.4e} "
        f"with pre-products; card {card}")
    return ch, headline


def device_rates(dev) -> tuple[float, float]:
    """(device-memory bytes/s, 32-bit integer multiplies/s) of this card."""
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    name = torch.cuda.get_device_name(0)
    mem_rate = next((r for k, r in MEM_BYTES_PER_S.items() if k in name), 3.35e12)
    int_rate = props.multi_processor_count * INT32_LANES_PER_SM * clock_mhz * 1e6
    log(f"[report] bounds from {mem_rate / 1e12:.2f} TB/s and "
        f"{props.multi_processor_count} SMs x {INT32_LANES_PER_SM} int32 "
        f"multiplies/clock x {clock_mhz:.0f} MHz = {int_rate:.4e} /s")
    return mem_rate, int_rate


def mul_ops(products: int, reductions: int) -> int:
    """Work per element, in 32-bit multiply instructions: a 32x32->64 product
    is two (lo and hi), a REDC quotient word one; 64 products per 256-bit
    product or reduction, 8 quotient words per reduction."""
    return 2 * 64 * (products + reductions) + 8 * reductions


def phase_report(dev, ch: Chain, launches: dict) -> list:
    props = torch.cuda.get_device_properties(dev)
    mem_rate, int_rate = device_rates(dev)
    ops = mul_ops

    e, pre = ch.pre_products()
    chain_args = ch.chain_args(e, pre)
    rnd = Operands(N_FABRIC, 13, dev)
    n, k = N_CHAIN, K_CHAIN
    cfg = fk.chain_launch_config(n, k, dev)
    log(f"[6 report] beaver_chain launch at n=2^22 x {k} rounds: grid {cfg['grid']} "
        f"({cfg['blocks_per_sm']} resident blocks per SM x {props.multi_processor_count} "
        f"SMs), {cfg['threads']} threads a block, {cfg['warps_per_sm']} resident "
        f"warps per SM, {cfg['smem_bytes']} bytes of shared memory per block")
    cases = {
        # name: (args, reps, bytes, ops)
        "mont_mul": ((SPEC, e.limbs, ch.a0.share.limbs), 20,
                     3 * 64 * n, ops(1, 1) * n),
        "beaver_round": (rnd.beaver_round(0), 20,
                         (8 * 64 + 2 * 64) * N_FABRIC + 64,
                         ops(6, 4) * N_FABRIC),
        # least work: 2 products + 2 reductions + 3 wide fold products a
        # round; once per element k_p*e, cf*M_p (4 + 4) and cf*CM_p (2)
        "beaver_chain": (chain_args, 3,
                         (18 * 64 + 2 * 64) * n + 128 + k * 3 * 64,
                         ops(5, 2) * n * k + ops(6, 4) * n),
    }
    word_sums = torch.randint(0, 1 << 54, (k, 3, fk.FOLD_WORDS), device=dev)
    fold_ms = cuda_ms(lambda: fk.fold_reduce(SPEC, word_sums), reps=10)
    log(f"[6 report] fold_reduce (plain torch, inside the beaver_chain call) "
        f"at K={k}: {fold_ms:.3f} ms")
    rows = []
    for name, (args, reps, nbytes, nops) in cases.items():
        ms = cuda_ms(lambda: fk.KERNELS[name](*args), reps=reps)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        want = fk.KERNELS[name](*args)
        t0.record()
        plain = fk.PLAIN[name](*args)
        t1.record()
        torch.cuda.synchronize()
        err = max_diff(want, plain)
        check(err == 0, f"{name} differs from its plain version at the "
                        f"main-path shape (max {err})")
        t_bytes, t_ops = nbytes / mem_rate, nops / int_rate
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": t0.elapsed_time(t1),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None,
        })
        log(f"[6 report] {name}: {ms:.4f} ms/launch, plain {rows[-1]['plain_ms']:.2f}"
            f" ms, bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}); "
            f"max limb difference vs plain {err} (tolerance 0: exact integers)")
    return rows


# ---------------------------------------------------------------------------
# the curve layer
# ---------------------------------------------------------------------------

P25519 = (1 << 255) - 19
ED_D = (-121665 * pow(121666, -1, P25519)) % P25519
GEN = (15112221349535400772501151409588531511454012693041857206046113283949847762202,
       46316835694926478169428394003475163141307993866256225615783033603165251855960)


def ed_add(p1, p2):
    """Python-int Edwards addition (the reference for the checks)."""
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


def affine(pt, idx=None) -> list:
    if idx is not None:
        pt = pt[torch.tensor(idx, device=pt.device)]
    x, y = pt.to_affine()
    return list(zip(x.to_ints(), y.to_ints()))


class CurveOperands:
    """Random points P_i = g_i * G (known g_i) and scalars at one size."""

    def __init__(self, n: int, seed: int, dev):
        rng = np.random.default_rng(seed)
        self.n = n
        self.g = Scalar.random(n, rng, device=dev)
        self.k = Scalar.random(n, rng, device=dev)
        self.points = CurvePoint.generator((n,), device=dev).mul(self.g)
        self.canon = self.k.canonical_limbs().contiguous()
        self.coords = [c.limbs.contiguous() for c in self.points._coords()]
        self.idx, self.off = mk.bucket_prologue(self.canon)
        self.lanes = ck.default_lanes(n)

    def args(self, name: str, buckets=None):
        if name in ("windowed_mul", "ladder"):
            return (self.canon, *self.coords)
        if name == "window_sums":
            return (self.canon, *self.coords)
        if name == "bucket_accumulate":
            return (self.idx, self.off, *self.coords)
        return tuple(buckets)


def compare_curve_kernels(ops: CurveOperands) -> dict:
    diffs = {}
    for name in ("windowed_mul", "ladder", "window_sums", "bucket_accumulate"):
        diffs[name] = max_diff(mk.KERNELS[name](*ops.args(name)),
                               mk.PLAIN[name](*ops.args(name)))
    buckets = mk.bucket_accumulate(*ops.args("bucket_accumulate"))
    diffs["bucket_reduce"] = max_diff(mk.bucket_reduce(*buckets),
                                      mk.bucket_reduce_plain(*buckets))
    torch.cuda.synchronize()
    return diffs


def phase_curve_kernels(dev) -> None:
    for n in WM_TAILS:  # a lone quad, a part-filled warp, a part-filled block
        ops = CurveOperands(n, 20 + n, dev)
        args = ops.args("windowed_mul")
        check(max_diff(ck.windowed_mul(*args), ck.windowed_mul_plain(*args)) == 0,
              f"windowed_mul differs from plain at n={n}")
    log(f"[7 curve] windowed_mul equals plain at n={', '.join(map(str, WM_TAILS))}")
    for n in WS_TAILS:
        ops = CurveOperands(n, 30 + n, dev)
        args = ops.args("window_sums")
        check(max_diff(ck.window_sums(*args), ck.window_sums_plain(*args)) == 0,
              f"window_sums differs from plain at n={n}")
    log(f"[7 curve] window_sums equals plain at n={', '.join(map(str, WS_TAILS))}")
    horner = [c.reshape(NLIMBS, ck.WINDOWS, 2)
              for c in CurveOperands(2 * ck.WINDOWS, 29, dev).coords]
    check(max_diff(mk.bucket_reduce(*horner, c_bits=4),
                   mk.bucket_reduce_plain(*horner, c_bits=4)) == 0,
          "bucket_reduce differs from plain at (16, 64, 2), c_bits=4")
    log("[7 curve] bucket_reduce equals plain at the winsum Horner's (16, 64, 2), "
        "c_bits=4")
    for n, seed in ((N_CURVE_CMP, 21), (N_ODD, 22)):
        ops = CurveOperands(n, seed, dev)
        diffs = compare_curve_kernels(ops)
        log(f"[7 curve] max limb difference kernel vs plain at n={n} "
            f"(64 windows): {diffs}")
        check(all(v == 0 for v in diffs.values()),
              f"curve kernels differ from plain at n={n}")
        if n == N_CURVE_CMP:
            lad = CurvePoint.from_coords(ck.ladder(*ops.args("ladder")), (n,))
            win = CurvePoint.from_coords(ck.windowed_mul(*ops.args("windowed_mul")), (n,))
            check(bool(lad.equals(win).all()), "ladder and windowed_mul disagree")
            check(bool(ck.mul_by_order(ops.points, kernel="ladder").is_identity().all()),
                  "mul_by_order(kernel='ladder') is not the identity on subgroup points")
            log(f"[7 curve] n={n}: ladder equals windowed_mul projectively; "
                "mul_by_order(kernel='ladder') is the identity on subgroup points")


def points_program(gs, ks, check_idx):
    """Share points P_i = g_i G, multiply by shared k_i (Beaver), an
    authenticated MSM, deferred authenticated opens, one verify_deferred."""
    def prog(fabric):
        dev, n = fabric.device, len(gs)
        marks = {}
        torch.cuda.synchronize()
        t0 = time.time()
        pts = (CurvePoint.generator((n,), device=dev).mul(Scalar.from_ints(gs, device=dev))
               if fabric.party_id == 0 else None)
        sp = fabric.share_points(pts, sender=0, n=n)
        sk = fabric.share_values(Scalar.from_ints(ks, device=dev)
                                 if fabric.party_id == 1 else None, sender=1, n=n)
        torch.cuda.synchronize()
        marks["share"] = time.time() - t0
        prod = fabric.mul_points(sk, sp)
        torch.cuda.synchronize()
        marks["beaver"] = time.time() - t0 - sum(marks.values())
        msm = fabric.msm(sk, sp)
        torch.cuda.synchronize()
        marks["msm"] = time.time() - t0 - sum(marks.values())
        opened = fabric.open_authenticated_points(prod, defer=True)
        opened_msm = fabric.open_authenticated_points(msm.reshape(1), defer=True)
        fabric.verify_deferred()
        torch.cuda.synchronize()
        marks["open+verify"] = time.time() - t0 - sum(marks.values())
        return affine(opened, check_idx), affine(opened_msm), marks, fabric.n_rounds
    return prog


def corrupt_point_mac_program(fabric):
    n, dev = 16, fabric.device
    pts = CurvePoint.generator((n,), device=dev) if fabric.party_id == 0 else None
    sp = fabric.share_points(pts, sender=0, n=n)
    if fabric.party_id == 1:
        sp = PointShare(sp.share, sp.mac + CurvePoint.generator((n,), device=dev))
    return fabric.open_authenticated_points(sp)


def order2_input_program(fabric):
    """Party 0 inputs the order-2 point (0, -1): the receiver's subgroup
    check must reject the masked point."""
    dev = fabric.device
    pts = (CurvePoint.from_affine_ints([0], [P25519 - 1], device=dev)
           if fabric.party_id == 0 else None)
    return fabric.share_points(pts, sender=0, n=1)


def phase_points(dev) -> dict:
    rnd = random.Random(31)
    gs = [rnd.randrange(1, L) for _ in range(N_POINTS)]
    ks = [rnd.randrange(L) for _ in range(N_POINTS)]
    idx = [0, 1, N_POINTS // 3, N_POINTS // 2, N_POINTS - 1]
    torch.cuda.synchronize()
    t0 = time.time()
    (o0, m0, marks, rounds), (o1, m1, _, _) = execute_mock_mpc_dealer(
        points_program(gs, ks, idx), seed=5, device=dev)
    secs = time.time() - t0
    check(o0 == o1 and m0 == m1, "parties opened different points")
    check(o0 == [ed_mul(ks[i] * gs[i] % L) for i in idx],
          "opened Beaver products differ from Python ints")
    check(m0 == [ed_mul(sum(k * g for k, g in zip(ks, gs)) % L)],
          "authenticated MSM differs from Python ints")
    log(f"[8 points] n={N_POINTS}: share + Beaver k*P + authenticated MSM + "
        f"deferred opens + verify_deferred OK in {secs:.2f} s host time "
        f"({rounds} rounds); party 0 steps (s): "
        f"{ {k: round(v, 3) for k, v in marks.items()} }; spot checks 5/5 and "
        "the MSM equal Python ints")
    for prog, what in ((corrupt_point_mac_program, "corrupted point MAC"),
                       (order2_input_program, "order-2 input point")):
        try:
            execute_mock_mpc_dealer(prog, seed=6, device=dev)
        except AuthenticationError as err:
            log(f"[8 points] {what} aborted: AuthenticationError({err})")
        else:
            raise RuntimeError(f"check failed: {what} was not detected")
    return {"host_s": secs, "steps_party0_s": marks, "rounds": rounds}


def phase_msm(dev) -> tuple[CurveOperands, dict]:
    ops = CurveOperands(N_MSM, 41, dev)
    torch.cuda.synchronize()
    gs, ks = ops.g.to_ints(), ops.k.to_ints()
    want = ed_mul(sum(k * g for k, g in zip(ks, gs)) % L)
    results, times = {}, {}
    for route in MSM_ROUTES:
        os.environ["ARK_MSM_FORCE"] = route
        try:
            results[route] = CurvePoint.msm(ops.k, ops.points)  # warm-up
            runs = []
            for _ in range(MSM_RUNS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                CurvePoint.msm(ops.k, ops.points)
                b.record()
                torch.cuda.synchronize()
                runs.append(a.elapsed_time(b))
        finally:
            del os.environ["ARK_MSM_FORCE"]
        times[route] = {"median_ms": float(np.median(runs)), "runs_ms": runs}
        check(affine(results[route].reshape(1)) == [want],
              f"MSM route {route} differs from Python ints")
    # the ladder kernel's column (not an ARK_MSM_FORCE route, as in the
    # reference: benchmarks/msm.py's pallas_ladder_ms); its parts by CUDA
    # events (scalar_mul with the kernel, then the plain tree sum) and the
    # host's time to enqueue the whole column
    def ladder_msm(mark=None):
        prod = ck.scalar_mul(ops.points, ops.k, kernel="ladder")
        if mark is not None:
            mark.record()
        return prod.sum()

    results["ladder_kernel"] = ladder_msm()  # warm-up
    runs, parts = [], {"scalar_mul": [], "tree_sum": [], "host_enqueue": []}
    for _ in range(MSM_RUNS):
        a, m, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        ladder_msm(m)
        b.record()
        parts["host_enqueue"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b))
        parts["scalar_mul"].append(a.elapsed_time(m))
        parts["tree_sum"].append(m.elapsed_time(b))
    times["ladder_kernel"] = {"median_ms": float(np.median(runs)), "runs_ms": runs,
                              **{f"{k}_median_ms": float(np.median(v))
                                 for k, v in parts.items()}}
    check(affine(results["ladder_kernel"].reshape(1)) == [want],
          "MSM by the ladder kernel differs from Python ints")
    for route in MSM_ROUTES[1:] + ("ladder_kernel",):
        check(bool(results[route].equals(results["ladder"])),
              f"MSM routes ladder and {route} disagree")
    log(f"[9 msm] n={N_MSM}: routes agree with each other and with Python ints "
        "(route 'ladder' runs windowed_mul; 'ladder_kernel' is "
        "scalar_mul(kernel='ladder').sum()); "
        + "; ".join(f"{r} median {t['median_ms']:.2f} ms "
                    f"({min(t['runs_ms']):.2f}-{max(t['runs_ms']):.2f})"
                    for r, t in times.items()))
    lk = times["ladder_kernel"]
    log(f"[9 msm] ladder_kernel column parts, median of {MSM_RUNS}: scalar_mul "
        f"(the ladder kernel) {lk['scalar_mul_median_ms']:.4f} ms, then the plain "
        f"tree sum {lk['tree_sum_median_ms']:.4f} ms (CUDA events); the host "
        f"enqueued the column in {lk['host_enqueue_median_ms']:.4f} ms")
    times["winsum_parts_ms"] = winsum_parts(ops, results["ladder"])
    return ops, times


def winsum_parts(ops: CurveOperands, want) -> dict:
    """The winsum route's kernel, lane tree and Horner by CUDA events
    (median of MSM_RUNS calls)."""
    parts = {"window_sums": [], "lane_tree": [], "bucket_reduce_horner": []}
    for _ in range(MSM_RUNS):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        got = ck.msm_windowsum(ops.points, ops.k, marks=marks)
        torch.cuda.synchronize()
        for k, name in enumerate(parts):
            parts[name].append(marks[k].elapsed_time(marks[k + 1]))
        check(bool(got.equals(want)), "msm_windowsum differs from the ladder route")
    medians = {name: float(np.median(v)) for name, v in parts.items()}
    log(f"[9 msm] winsum route parts at n={ops.n} ({ck.default_lanes(ops.n)} lanes), "
        "median of 5: " + "; ".join(f"{k} {v:.4f} ms" for k, v in medians.items()))
    return medians


def fe_ops(*terms) -> int:
    """32-bit multiplies of (count, formula) terms."""
    return sum(k * (f[0] * MUL_OPS + f[1] * SQR_OPS) for k, f in terms)


def curve_work(ops: CurveOperands) -> dict:
    """-> {kernel: (bytes, 32-bit multiplies)}: the least work each kernel's
    function needs on this run's inputs (no work on the identity, a square
    at 36 word products, the bucket sums weighted by a running sum)."""
    n, lanes, W, nb = ops.n, ops.lanes, mk.N_WINDOWS, mk.N_BUCKETS
    counts = (ops.off[:, 1:] - ops.off[:, :-1]).long()[:, 1:]  # digits >= 1
    # a bucket of c points needs c - 1 adds
    bucket_adds = int((counts - 1).clamp(min=0).sum())
    # sum_d d * B_d from the top nonempty digit D down: a running suffix sum
    # (an add per nonempty bucket below D) and an add of it per digit
    nonempty = counts > 0
    digits = torch.arange(1, nb, device=counts.device)
    top = (nonempty * digits).max(dim=1).values
    below = (nonempty & (digits < top[:, None])).sum(dim=1)
    reduce_adds = int((below + (top - 1).clamp(min=0)).sum())
    window = ((3, DBL_NO_T), (1, DBL), (1, PADD_CACHED))
    # the ladder: one double and one cached add per bit below each scalar's
    # top set bit (the steps above it act on the identity), and P's cached
    # form (2d T) once a point
    ladder_steps = sum(max(0, v.bit_length() - 1) for v in ops.k.to_ints())
    return {
        "ladder": (9 * 64 * n, fe_ops((ladder_steps, DBL), (ladder_steps, PADD_CACHED),
                                      (n, PRODUCT))),
        # constant time: every window but the top one (a select into the
        # identity) doubles four times and adds its entry
        "windowed_mul": (9 * 64 * n,
                         n * fe_ops(*TABLE, *((63 * k, f) for k, f in window))),
        # a lane's first point in each window is a select, not an add
        "window_sums": (5 * 64 * n + 4 * 64 * ck.WINDOWS * lanes,
                        n * fe_ops(*TABLE)
                        + fe_ops((ck.WINDOWS * (n - lanes), PADD_CACHED))),
        "bucket_accumulate": (4 * W * n + 4 * W * (nb + 1) + 256 * n
                              + 4 * 64 * W * nb, fe_ops((bucket_adds, PADD))),
        # the suffix sums, then Horner over windows: c - 1 T-less doubles,
        # 1 double, 1 add per step
        "bucket_reduce": (4 * 64 * W * nb + 4 * 64,
                          fe_ops((reduce_adds, PADD), ((mk.C_BITS - 1) * (W - 1), DBL_NO_T),
                                 (W - 1, DBL), (W - 1, PADD))),
    }


def bucket_report(dev, ops: CurveOperands, ptxas_log: str) -> None:
    """`bucket_accumulate`'s launch at the main-path shape: chunk size,
    passes, grids, resident warps, ptxas of its one kernel (every pass
    runs it) and the time of each pass (mean of 5 calls)."""
    cfg = mk.bucket_launch_config(ops.n, dev)
    args = ops.args("bucket_accumulate")
    mk.bucket_accumulate(*args)  # warm-up
    pass_ms = [0.0] * cfg["passes"]
    for _ in range(5):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(cfg["passes"] + 1)]
        mk.bucket_accumulate(*args, marks=marks)
        torch.cuda.synchronize()
        for k in range(cfg["passes"]):
            pass_ms[k] += marks[k].elapsed_time(marks[k + 1]) / 5
    log(f"[10 report] bucket_accumulate launch at n={ops.n} x {mk.N_WINDOWS} windows "
        f"x {mk.N_BUCKETS} buckets: chunk C={cfg['chunk']}, {cfg['passes']} passes "
        f"of bucket_chunk_kernel, grids {cfg['grids']} blocks of {cfg['threads']} "
        f"threads, {cfg['blocks_per_sm']} resident blocks ({cfg['warps_per_sm']} "
        f"warps) per SM; ptxas bucket_chunk_kernel: "
        f"{ptxas_of(ptxas_log, 'bucket_chunk_kernel')}; ms a pass "
        f"{[round(v, 4) for v in pass_ms]} (sum {sum(pass_ms):.4f})")


def reduce_report(buckets, ptxas_log: str) -> dict:
    """`bucket_reduce`'s two launches at the bucket route's shape: grid,
    threads and shared memory of each kernel, ptxas of both, the time of
    each (CUDA events between them, mean of 5 calls) and the critical path:
    the dependent point operations and the Horner's product stages
    (returned)."""
    W, nb = mk.N_WINDOWS, mk.N_BUCKETS
    cfg = mk.reduce_launch_config(W, nb)
    mk.bucket_reduce(*buckets)  # warm-up
    part_ms = [0.0, 0.0]
    for _ in range(5):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        mk.bucket_reduce(*buckets, marks=marks)
        torch.cuda.synchronize()
        for k in range(2):
            part_ms[k] += marks[k].elapsed_time(marks[k + 1]) / 5
    path = mk.reduce_critical_path(W, nb)
    win, hor = cfg["window"], cfg["horner"]
    log(f"[10 report] bucket_reduce launches at ({NLIMBS}, {W}, {nb}), c={mk.C_BITS}: "
        f"window kernel grid {win['grid']} x {win['threads']} threads, "
        f"{win['smem_bytes']} bytes of shared memory a block, ptxas "
        f"bucket_window_kernel: {ptxas_of(ptxas_log, 'bucket_window_kernel')}; "
        f"Horner grid {hor['grid']} x {hor['threads']} threads (a quad's chain), "
        f"{hor['smem_bytes']} bytes of shared memory, ptxas bucket_horner_kernel: "
        f"{ptxas_of(ptxas_log, 'bucket_horner_kernel')}; ms window {part_ms[0]:.4f}, "
        f"Horner {part_ms[1]:.4f}")
    per_stage = 1e3 * part_ms[1] / path["horner_stages"]
    log(f"[10 report] bucket_reduce critical path: {path['point_ops']} dependent point "
        f"operations ({path['scan_adds']} scan and tree adds, {path['doublings']} "
        f"doublings, {path['horner_adds']} Horner adds); the Horner's "
        f"{path['horner_stages']} product stages at {per_stage:.4f} us a stage")
    return path


def phase_curve_report(dev, ops: CurveOperands, launches: dict, ptxas_log: str) -> list:
    mem_rate, int_rate = device_rates(dev)
    cfg = ck.windowed_launch_config(ops.n, dev)
    log(f"[10 report] windowed_mul launch at n={ops.n}: {cfg['lanes_per_point']} "
        f"lanes per point, {cfg['threads']} threads and {cfg['points_per_block']} "
        f"points a block, grid {cfg['grid']}, {cfg['blocks_per_sm']} resident "
        f"blocks ({cfg['warps_per_sm']} warps) per SM, {cfg['smem_bytes']} bytes "
        "of shared memory per block")
    check(cfg["warps_per_sm"] >= 12, "windowed_mul keeps fewer than 12 warps per SM")
    small = CurveOperands(N_ODD, 43, dev)
    small_ms = cuda_ms(lambda: ck.windowed_mul(*small.args("windowed_mul")), reps=20)
    log(f"[10 report] windowed_mul at n={N_ODD}: {small_ms:.4f} ms/launch")
    ws = ck.window_sums_launch_config(ops.n, dev)
    log(f"[10 report] window_sums launch at n={ops.n} x {ck.WINDOWS} windows: "
        f"{ws['threads']} threads (a quad a window), tile T={ws['tile']} points, "
        f"L={ws['lanes']} lanes of {ws['lane_points']} points, grid {ws['grid']}, "
        f"{ws['blocks_per_sm']} resident blocks ({ws['warps_per_sm']} warps) per SM, "
        f"{ws['smem_bytes']} bytes of shared memory per block; ptxas "
        f"window_sums_kernel: {ptxas_of(ptxas_log, 'window_sums_kernel')}")
    check(ws["grid"] == ops.lanes, "window_sums launches a grid other than its lanes")
    lad = ck.ladder_launch_config(ops.n, dev)
    log(f"[10 report] ladder launch at n={ops.n}: {lad['threads']} threads and "
        f"{lad['points_per_block']} points a block, grid {lad['grid']}, "
        f"{lad['blocks_per_sm']} resident blocks ({lad['warps_per_sm']} warps) per SM, "
        f"{lad['waves']:.4f} waves; ptxas ladder_kernel: "
        f"{ptxas_of(ptxas_log, 'ladder_kernel')}")
    check(lad["warps_per_sm"] >= 16, "ladder keeps fewer than 16 warps per SM")
    bucket_report(dev, ops, ptxas_log)
    buckets = mk.bucket_accumulate(*ops.args("bucket_accumulate"))
    path = reduce_report(buckets, ptxas_log)
    work = curve_work(ops)
    rows = []
    for name in mk.KERNELS:
        args = ops.args(name, buckets)
        ms = cuda_ms(lambda: mk.KERNELS[name](*args), reps=5)
        want = mk.KERNELS[name](*args)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        plain = mk.PLAIN[name](*args)
        t1.record()
        torch.cuda.synchronize()
        err = max_diff(want, plain)
        check(err == 0, f"{name} differs from its plain version at the main-path "
                        f"shape (max {err})")
        nbytes, nops = work[name]
        t_bytes, t_ops = nbytes / mem_rate, nops / int_rate
        rows.append({
            "name": name, "route": "cuda", "source": CURVE_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": t0.elapsed_time(t1),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None,
        })
        beside = (f", critical path {path['point_ops']} dependent point operations"
                  if name == "bucket_reduce" else "")
        log(f"[10 report] {name}: {ms:.4f} ms a call at n={ops.n}, plain "
            f"{rows[-1]['plain_ms']:.2f} ms, bound {rows[-1]['bound_ms']:.4f} ms "
            f"({rows[-1]['bound_by']}{beside}); max limb difference vs plain {err}")
    return rows



# ---------------------------------------------------------------------------
# traced circuits, shared matmul and polynomials
# ---------------------------------------------------------------------------


def spot(x: Scalar, idx) -> list:
    return x[torch.tensor(idx, device=x.device)].to_ints()


def readme_traced_program(fabric):
    dev = fabric.device
    sx = fabric.share_values(Scalar.from_ints([2, 5], device=dev)
                             if fabric.party_id == 0 else None, sender=0, n=2)
    sy = fabric.share_values(Scalar.from_ints([3, 7], device=dev)
                             if fabric.party_id == 1 else None, sender=1, n=2)
    tr = fabric.tracer()
    x, y = tr.wrap(sx), tr.wrap(sy)
    z = (x * y + x).sum()
    out = z.open()
    tr.run()            # fused rounds + one deferred MAC check
    return out.value.to_ints()


def gate_throughput(dev) -> float:
    """`benchmarks/online_suite.py`'s gate throughput: an add-gate chain
    through the tracer with no peer; -> gates/s (host clock)."""
    fabric = MpcFabric(0, NoRecvTransport(), PartyIDBeaverSource(0, device=dev),
                       device=dev)
    x_sh = fabric.share_public(Scalar.from_ints([1], device=dev))
    torch.cuda.synchronize()
    t0 = time.time()
    tr = fabric.tracer()
    x = tr.wrap(x_sh)
    v = x
    for _ in range(N_GATES):
        v = v + x
    (out,) = tr.run(outputs=[v])
    torch.cuda.synchronize()
    secs = time.time() - t0
    check(out.share.to_ints() == [N_GATES + 1], "gate chain result is wrong")
    return N_GATES / secs


# Exchanges of the traced circuit below, level by level, as
# tests/test_scheduler.py counts them.  Level 1: one Beaver round for x*y,
# x*y on the slice, the bit_xor product and the pow's first square, and the
# batched inverse (its masking product and its masked open: 2).  Level 2:
# the mid-circuit open of the slice's x*y, then one Beaver round for the
# pow's second square and x^-1 * x.  Level 3: the pow's last product.  Then
# the terminal open flush and the 3 exchanges of the one deferred MAC check.
TRACED_ROUNDS = (1 + 2) + (1 + 1) + 1 + 1 + 3
# the traced prefix product: two blinding products, the blinded open, the
# unblinding product, the terminal flush and the MAC check
PREFIX_ROUNDS = 1 + 1 + 1 + 1 + 1 + 3


def traced_program(xs: Scalar, ys: Scalar, corrupt: bool = False):
    """x*y + x at the full width; bit_xor of shared bits, an inverse, a
    mid-circuit open reused with as_public(), pow 5 and a sum on the first
    N_SLICE elements; terminal opens and ONE deferred MAC check."""
    def prog(fabric):
        dev, n = fabric.device, xs.size
        sx = fabric.share_values(xs if fabric.party_id == 0 else None,
                                 sender=0, n=n)
        sy = fabric.share_values(ys if fabric.party_id == 1 else None,
                                 sender=1, n=n)
        m = min(n, N_SLICE)
        bits_a, bits_b = fabric.random_shared_bits(m), fabric.random_shared_bits(m)
        if corrupt and fabric.party_id == 1:
            sx = ScalarShare(sx.share, sx.mac + Scalar.from_ints(1, device=dev))
        torch.cuda.synchronize()
        base, t0 = fabric.n_rounds, time.time()
        tr = fabric.tracer()
        x, y = tr.wrap(sx), tr.wrap(sy)
        xm, ym = tr.wrap(sx[:m]), tr.wrap(sy[:m])
        a, b = tr.wrap(bits_a), tr.wrap(bits_b)
        z = x * y + x
        inv = xm.inverse()
        p = (xm * ym).open()
        q = ym * p.as_public() + xm
        handles = {"z": z.open(), "xor": bit_xor(fabric, a, b).open(),
                   "a": a.open(), "b": b.open(), "inv": inv.open(), "p": p,
                   "q": q.open(), "pow5": xm.pow(5).open(),
                   "sum": (inv * xm).sum().open()}
        tr.run()
        torch.cuda.synchronize()
        secs = time.time() - t0
        idx = [0, 1, m // 2, m - 1]
        out = {k: (h.value.to_ints() if k == "sum" else spot(h.value, idx))
               for k, h in handles.items()}
        out["z_top"] = spot(handles["z"].value, [n // 2, n - 1])
        return out, fabric.n_rounds - base, secs
    return prog


def prefix_program(xs: Scalar):
    def prog(fabric):
        dev, n = fabric.device, xs.size
        sx = fabric.share_values(xs if fabric.party_id == 0 else None,
                                 sender=0, n=n)
        torch.cuda.synchronize()
        base, t0 = fabric.n_rounds, time.time()
        tr = fabric.tracer()
        h = prefix_product(fabric, tr.wrap(sx)).open()
        tr.run()
        torch.cuda.synchronize()
        return spot(h.value, [0, 1, n // 2, n - 1]), fabric.n_rounds - base, time.time() - t0
    return prog


def traced_points_program(gs, ks, idx):
    def prog(fabric):
        dev, n = fabric.device, len(gs)
        pts = (CurvePoint.generator((n,), device=dev).mul(Scalar.from_ints(gs, device=dev))
               if fabric.party_id == 0 else None)
        sp = fabric.share_points(pts, sender=0, n=n)
        sk = fabric.share_values(Scalar.from_ints(ks, device=dev)
                                 if fabric.party_id == 1 else None, sender=1, n=n)
        torch.cuda.synchronize()
        base, t0 = fabric.n_rounds, time.time()
        tr = fabric.tracer()
        p = tr.wrap_points(sp)
        h = (p.mul(tr.wrap(sk)) + p).open()
        tr.run()
        torch.cuda.synchronize()
        return affine(h.value, idx), fabric.n_rounds - base, time.time() - t0
    return prog


def phase_traced(dev) -> dict:
    r0, r1 = execute_mock_mpc(readme_traced_program, device=dev)
    check(r0 == r1 == [2 * 3 + 2 + 5 * 7 + 5], "README traced example is wrong")
    log(f"[11 traced] README example on {dev}: {r0} / {r1}")
    gates_per_s = gate_throughput(dev)
    log(f"[11 traced] gate throughput: {N_GATES} add gates through "
        f"tr.run(outputs=[v]) under NoRecvTransport: {gates_per_s:.1f} gates/s")

    rng = np.random.default_rng(61)
    xs = Scalar.random(N_TRACED, rng, device=dev)
    ys = Scalar.random(N_TRACED, rng, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    (o0, rounds, secs), (o1, _, _) = execute_mock_mpc_dealer(
        traced_program(xs, ys), seed=8, device=dev)
    total = time.time() - t0
    check(o0 == o1, "parties opened different values")
    m = N_SLICE
    idx = [0, 1, m // 2, m - 1]
    xv, yv = spot(xs, idx), spot(ys, idx)
    pv = [x * y % L for x, y in zip(xv, yv)]
    check(o0["z"] == [(x * y + x) % L for x, y in zip(xv, yv)], "x*y + x is wrong")
    top = [N_TRACED // 2, N_TRACED - 1]
    check(o0["z_top"] == [(x * y + x) % L for x, y in zip(spot(xs, top), spot(ys, top))],
          "x*y + x is wrong past the slice")
    check(o0["xor"] == [a ^ b for a, b in zip(o0["a"], o0["b"])], "bit_xor is wrong")
    check(all(bit in (0, 1) for bit in o0["a"] + o0["b"]), "shared bits are not bits")
    check(o0["inv"] == [pow(x, -1, L) for x in xv], "inverse is wrong")
    check(o0["p"] == pv, "mid-circuit open is wrong")
    check(o0["q"] == [(y * p + x) % L for x, y, p in zip(xv, yv, pv)],
          "the reused open is wrong")
    check(o0["pow5"] == [pow(x, 5, L) for x in xv], "pow 5 is wrong")
    check(o0["sum"] == [m], "sum of x^-1 * x is not the slice width")
    check(rounds == TRACED_ROUNDS, f"{rounds} rounds, the circuit's depth gives "
                                   f"{TRACED_ROUNDS}")
    log(f"[11 traced] circuit at n=2^20 (other gates on a 2^{m.bit_length() - 1} "
        f"slice): {rounds} rounds (= its communication depth), run {secs:.2f} s and "
        f"{total:.2f} s with inputs and dealer host time; spot checks equal Python ints")

    (p0, prounds, psecs), (p1, _, _) = execute_mock_mpc_dealer(
        prefix_program(xs[:m]), seed=9, device=dev)
    want, acc = [], 1
    for i, x in enumerate(xs[:m].to_ints()):
        acc = acc * x % L
        if i in (0, 1, m // 2, m - 1):
            want.append(acc)
    check(p0 == p1 == want, "traced prefix product is wrong")
    check(prounds == PREFIX_ROUNDS, f"prefix product took {prounds} rounds, "
                                    f"its depth gives {PREFIX_ROUNDS}")
    log(f"[11 traced] prefix_product at n=2^16: {prounds} rounds, {psecs:.2f} s; "
        "spot checks equal Python ints")

    rnd = random.Random(71)
    gs = [rnd.randrange(1, L) for _ in range(N_TRACED_POINTS)]
    ks = [rnd.randrange(L) for _ in range(N_TRACED_POINTS)]
    pidx = [0, N_TRACED_POINTS // 2, N_TRACED_POINTS - 1]
    (q0, qrounds, qsecs), (q1, _, _) = execute_mock_mpc_dealer(
        traced_points_program(gs, ks, pidx), seed=10, device=dev)
    check(q0 == q1 == [ed_mul((ks[i] + 1) * gs[i] % L) for i in pidx],
          "traced point circuit is wrong")
    log(f"[11 traced] point circuit (k*P + P) at n={N_TRACED_POINTS}: {qrounds} "
        f"rounds, {qsecs:.2f} s; spot checks equal Python ints")

    small = Scalar.random(16, rng, device=dev)
    try:
        execute_mock_mpc_dealer(traced_program(small, small, corrupt=True),
                                seed=11, device=dev)
    except AuthenticationError as err:
        log(f"[11 traced] corrupted MAC aborted at verify_deferred: "
            f"AuthenticationError({err})")
    else:
        raise RuntimeError("check failed: corrupted MAC was not detected")
    return {"gates_per_s": gates_per_s, "circuit_2^20_rounds": rounds,
            "circuit_2^20_run_s": secs, "circuit_2^20_host_s": total,
            "prefix_2^16_s": psecs, "points_10000_s": qsecs}


def matmul_program(a: Scalar, b: Scalar, idx):
    def prog(fabric):
        dev, (m, k), n = fabric.device, a.shape, b.shape[1]
        sa = fabric.share_values(a.reshape(m * k) if fabric.party_id == 0
                                 else None, sender=0, n=m * k).reshape(m, k)
        sb = fabric.share_values(b.reshape(k * n) if fabric.party_id == 1
                                 else None, sender=1, n=k * n).reshape(k, n)
        torch.cuda.synchronize()
        t0 = time.time()
        sc = shared_matmul(fabric, sa, sb)
        torch.cuda.synchronize()
        secs = time.time() - t0
        opened = fabric.open_authenticated(sc.reshape(m * n))  # MAC-checked
        return spot(opened, [i * n + j for i, j in idx]), secs
    return prog


def poly_program(f_ints, g_ints, h_ints, x_eval, dom: EvaluationDomain):
    def prog(fabric):
        dev = fabric.device
        sf = poly.AuthenticatedDensePoly(fabric.share_values(
            Scalar.from_ints(f_ints, device=dev) if fabric.party_id == 0 else None,
            sender=0, n=len(f_ints)))
        sg = poly.AuthenticatedDensePoly(fabric.share_values(
            Scalar.from_ints(g_ints, device=dev) if fabric.party_id == 1 else None,
            sender=1, n=len(g_ints)))
        torch.cuda.synchronize()
        t0 = time.time()
        prod = poly.poly_mul(fabric, sf, sg)
        ev = prod.eval(Scalar.from_ints(x_eval, device=dev))
        q = poly.poly_div(fabric, sf, poly.DensePoly.from_ints(h_ints, device=dev))
        rt = dom.fft_shares(dom.fft_shares(sf.truncate(dom.n).coeffs), forward=False)
        out = {"prod": poly.poly_open(fabric, prod, defer=True).to_ints(),
               "eval": fabric.open_authenticated(ev, defer=True).to_ints(),
               "div": poly.poly_open(fabric, q, defer=True).to_ints(),
               "fft_round_trip": fabric.open_authenticated(rt, defer=True).to_ints()}
        fabric.verify_deferred()
        torch.cuda.synchronize()
        return out, time.time() - t0
    return prog


def poly_ref_mul(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] += x * y
    return [v % L for v in out]


def phase_matmul(dev) -> dict:
    rng = np.random.default_rng(81)
    n = N_MATMUL
    a = Scalar.random((n, n), rng, device=dev)
    b = Scalar.random((n, n), rng, device=dev)
    idx = [(0, 0), (3, 5), (n - 1, n - 1), (100 % n, 200 % n)]
    (e0, secs0), (e1, _) = execute_mock_mpc_dealer(matmul_program(a, b, idx), seed=12,
                                                   device=dev)
    want = [sum(u * v for u, v in zip(a[i].to_ints(), b[:, j].to_ints())) % L
            for i, j in idx]
    check(e0 == e1 == want, "shared matmul spot entries differ from Python ints")
    runs = []
    for _ in range(MATMUL_RUNS + 1):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        matmul.mont_matmul(SPEC, a.limbs, b.limbs)
        e.record()
        torch.cuda.synchronize()
        runs.append(s.elapsed_time(e))
    mm_ms = float(np.median(runs[1:]))  # the first call is the warm-up
    log(f"[12 matmul] shared_matmul {n}^3 under the dealer: MAC check passed, "
        f"entries {idx} equal Python ints; party 0's shared_matmul call "
        f"{secs0 * 1e3:.2f} ms host time (dealer triple included); mont_matmul "
        f"{n}^3 alone median {mm_ms:.3f} ms ({min(runs[1:]):.3f}-{max(runs[1:]):.3f}), "
        f"route {matmul.ROUTE}")

    r = random.Random(91)
    f = [r.randrange(L) for _ in range(POLY_DEG + 1)]
    g = [r.randrange(L) for _ in range(POLY_DEG + 1)]
    h = [r.randrange(1, L) for _ in range(18)]
    x_eval = r.randrange(L)
    dom = EvaluationDomain(132, device=dev)
    (p0, psecs), (p1, _) = execute_mock_mpc_dealer(poly_program(f, g, h, x_eval, dom),
                                                   seed=13, device=dev)
    check(p0 == p1, "parties opened different polynomials")
    prod = poly_ref_mul(f, g)
    check(p0["prod"] == prod, "shared poly_mul differs from Python ints")
    check(p0["eval"] == [sum(c * pow(x_eval, i, L) for i, c in enumerate(prod)) % L],
          "poly_eval differs from Python ints")
    rem = [(u - v) % L for u, v in zip(f, poly_ref_mul(p0["div"], h) + [0] * len(f))]
    check(len(p0["div"]) == len(f) - len(h) + 1 and not any(rem[len(h) - 1:]),
          "poly_div leaves a remainder of too high a degree")
    check(p0["fft_round_trip"] == f[:132], "FFT/IFFT round trip of shares failed")
    log(f"[12 matmul] degree-{POLY_DEG} shared poly_mul, poly_eval, poly_div and an "
        f"EvaluationDomain(132) FFT/IFFT share round trip equal Python ints "
        f"({psecs:.2f} s host time)")
    return {"shared_matmul_512_party0_ms": secs0 * 1e3, "mont_matmul_512_ms": mm_ms,
            "mont_matmul_runs_ms": runs[1:], "route": matmul.ROUTE,
            "poly_s": psecs}


# ---------------------------------------------------------------------------
# BN254 (Fq, Fr, G1) and two party processes over TCP
# ---------------------------------------------------------------------------

BN254_KERNELS = (  # (kernel, field, elements): mont_mul at 2^22, beaver_round at 2^20
    ("mont_mul", BN254_BASE, 1 << 22),
    ("mont_mul", BN254_SCALAR, 1 << 22),
    ("beaver_round", BN254_SCALAR, 1 << 20),
)
N_G1 = N_POINTS
# benchmarks/online_wire.py:44-46: n = 2^20, 4 chained rounds, dealer seed
WIRE_N, WIRE_ROUNDS, WIRE_SEED = 1 << 20, 4, 1234
REGISTRY_TIMEOUT = 600


def g1_add(p1, p2):
    """Python-int affine addition on y^2 = x^3 + 3 over F_q (None = identity)."""
    q = BN254_Q
    if p1 is None or p2 is None:
        return p2 if p1 is None else p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2 and (y1 + y2) % q == 0:
        return None
    if p1 == p2:
        lam = 3 * x1 * x1 * pow(2 * y1, -1, q) % q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, q) % q
    x3 = (lam * lam - x1 - x2) % q
    return x3, (lam * (x1 - x3) - y1) % q


def g1_mul(k: int, pt=(1, 2)):
    acc = None
    for bit in bin(k % BN254_R)[2:]:
        acc = g1_add(acc, acc)
        if bit == "1":
            acc = g1_add(acc, pt)
    return acc


def g1_spots(pt: G1, idx) -> list:
    """Affine Python ints of the points at `idx` (None for the identity)."""
    pt = pt[torch.tensor(idx, device=pt.device)]
    x, y = pt.to_affine()
    ids = pt.is_identity().tolist()
    return [None if i else (a, b) for a, b, i in zip(x.to_ints(), y.to_ints(), ids)]


def rand_below(spec, n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """(16, n) limbs of random values below the modulus, made on the card:
    every limb uniform, the top one below the modulus' top limb."""
    limbs = torch.randint(0, 1 << 16, (NLIMBS, n), generator=gen, device=dev,
                          dtype=torch.int32)
    limbs[-1] = torch.randint(0, int(spec.mod_limbs[-1]), (n,), generator=gen,
                              device=dev, dtype=torch.int32)
    return limbs


def bn254_dealer(seed: int, dev):
    return lambda pid: TrustedDealerSource(pid, seed=seed, field=Fr, device=dev)


def g1_points_program(gs, ks, idx):
    """Party 0 shares P_i = g_i G and both open them; party 1 shares k_i;
    [k] G by `mul_generator`, [k P] by `beaver_mul_points`; deferred
    authenticated opens and one `verify_deferred`."""
    def prog(fabric):
        dev, n = fabric.device, len(gs)
        steps = {}

        def mark(name):
            torch.cuda.synchronize()
            steps[name] = time.time() - t0 - sum(steps.values())

        t0 = time.time()
        pts = (G1.generator((n,), device=dev).mul(Fr.from_ints(gs, device=dev))
               if fabric.party_id == 0 else None)
        sp = fabric.share_points(pts, sender=0, n=n)
        opened = fabric.open_authenticated_points(sp, defer=True)
        mark("share+open")
        sk = fabric.share_values(Fr.from_ints(ks, device=dev) if fabric.party_id == 1
                                 else None, sender=1, n=n)
        kg = fabric.mul_generator(sk)
        mark("mul_generator")
        prod = fabric.mul_points(sk, sp)
        mark("beaver_mul_points")
        o_kg = fabric.open_authenticated_points(kg, defer=True)
        o_prod = fabric.open_authenticated_points(prod, defer=True)
        fabric.verify_deferred()
        mark("open+verify")
        return ([g1_spots(v, idx) for v in (opened, o_kg, o_prod)], steps,
                fabric.n_rounds)
    return prog


def g1_corrupt_mac_program(fabric):
    n, dev = 16, fabric.device
    pts = G1.generator((n,), device=dev) if fabric.party_id == 0 else None
    sp = fabric.share_points(pts, sender=0, n=n)
    if fabric.party_id == 1:
        sp = PointShare(sp.share, sp.mac + G1.generator((n,), device=dev))
    return fabric.open_authenticated_points(sp)


def g1_off_curve_program(fabric):
    """Party 0 sends the canonical affine pair (5, 7), not on y^2 = x^3 + 3,
    where `share_points` expects its masked point."""
    if fabric.party_id == 0:
        fabric.offline.next_local_input_mask_batch(1)
        fabric.send_arrays([lb.ints_to_limb_array([5]), lb.ints_to_limb_array([7])])
        return None
    return fabric.share_points(None, sender=0, n=1)


def expect_abort(prog, what: str, label: str, dev) -> None:
    try:
        execute_mock_mpc(prog, offline_factory=bn254_dealer(6, dev), device=dev)
    except AuthenticationError as err:
        log(f"[{label}] {what} aborted: AuthenticationError({err})")
    else:
        raise RuntimeError(f"check failed: {what} was not detected")


def phase_bn254(dev) -> dict:
    """The Fr fabric batch and the G1 point protocols (the path whose
    launches are counted), then one `G1.mul` timed alone."""
    r = BN254_R
    torch.cuda.synchronize()
    t0 = time.time()
    (vals0, rounds0), (vals1, _) = execute_mock_mpc(
        fabric_program, offline_factory=bn254_dealer(3, dev), device=dev)
    torch.cuda.synchronize()
    fabric_s = time.time() - t0
    xs, ys, zs = vals0
    check(vals0 == vals1, "parties opened different Fr values")
    check(zs == [x * y % r for x, y in zip(xs, ys)], "opened Fr products are wrong")
    log(f"[13 bn254] Fr fabric: n=2^20 mul + 3 deferred opens + folded MAC check OK "
        f"in {fabric_s:.2f} s host time ({rounds0} rounds); spot checks "
        f"{len(zs)}/{len(zs)} equal Python ints mod r")
    expect_abort(corrupt_mac_program, "corrupted Fr MAC", "13 bn254", dev)

    rnd = random.Random(37)
    gs = [rnd.randrange(1, r) for _ in range(N_G1)]
    ks = [rnd.randrange(1, r) for _ in range(N_G1)]
    idx = [0, 1, N_G1 // 3, N_G1 // 2, N_G1 - 1]
    torch.cuda.synchronize()
    t0 = time.time()
    (spots0, steps, rounds), (spots1, _, _) = execute_mock_mpc(
        g1_points_program(gs, ks, idx), offline_factory=bn254_dealer(5, dev), device=dev)
    points_s = time.time() - t0
    check(spots0 == spots1, "parties opened different G1 points")
    opened, o_kg, o_prod = spots0
    check(opened == [g1_mul(gs[i]) for i in idx], "opened G1 points differ from Python ints")
    check(o_kg == [g1_mul(ks[i]) for i in idx], "[k] G differs from Python ints")
    check(o_prod == [g1_mul(ks[i] * gs[i]) for i in idx],
          "Beaver k * P differs from Python ints")
    log(f"[13 bn254] G1 points n={N_G1}: share + open, mul_generator, "
        f"beaver_mul_points, deferred opens + verify_deferred OK in {points_s:.2f} s "
        f"host time ({rounds} rounds); party 0 steps (s): "
        f"{ {k: round(v, 3) for k, v in steps.items()} }; 15/15 spot points equal "
        "Python ints")
    expect_abort(g1_corrupt_mac_program, "corrupted G1 point MAC", "13 bn254", dev)
    expect_abort(g1_off_curve_program, "received point off the curve", "13 bn254", dev)
    return {"fabric_host_s": fabric_s, "fabric_rounds": rounds0,
            "points_host_s": points_s, "points_rounds": rounds,
            "points_steps_party0_s": steps}


def g1_mul_alone(dev) -> dict:
    """One `G1.mul` at n = 10,000 random scalars: seconds and launches."""
    rng = np.random.default_rng(38)
    g = G1.generator((N_G1,), device=dev)
    k = Fr.random(N_G1, rng, device=dev)
    torch.cuda.synchronize()
    before, t0 = fk.mont_mul.launches, time.time()
    out = g.mul(k)
    torch.cuda.synchronize()
    secs, launches = time.time() - t0, fk.mont_mul.launches - before
    check(g1_spots(out, [0, N_G1 - 1]) == [g1_mul(v) for v in k[torch.tensor(
        [0, N_G1 - 1], device=dev)].to_ints()], "G1.mul differs from Python ints")
    log(f"[13 bn254] one G1.mul at n={N_G1}: {secs:.2f} s host time, {launches} "
        "mont_mul launches (plain torch ladder, 2 spot points equal Python ints)")
    return {"g1_mul_s": secs, "g1_mul_mont_mul_launches": launches}


def bn254_kernel_rows(dev, launches: dict, l_rows: list) -> list:
    """mont_mul at Fq and Fr, beaver_round at Fr: bit for bit against their
    plain versions, timed by CUDA events beside the l-field rows."""
    mem_rate, int_rate = device_rates(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(52)
    l_ms = {row["name"]: row["ms"] for row in l_rows}
    rows = []
    for name, spec, n in BN254_KERNELS:
        if name == "mont_mul":
            args = (spec, rand_below(spec, n, gen, dev), rand_below(spec, n, gen, dev))
            nbytes, nops = 3 * 64 * n, mul_ops(1, 1) * n
        else:
            ops = [rand_below(spec, n, gen, dev) for _ in range(8)]
            key = rand_below(spec, 1, gen, dev).reshape(NLIMBS)
            args = (spec, 0, *ops, key)
            nbytes, nops = (8 * 64 + 2 * 64) * n + 64, mul_ops(6, 4) * n
        got = fk.KERNELS[name](*args)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        plain = fk.PLAIN[name](*args)
        t1.record()
        torch.cuda.synchronize()
        err = max_diff(got, plain)
        check(err == 0, f"{name} at {spec.name} differs from its plain version (max {err})")
        ms = cuda_ms(lambda: fk.KERNELS[name](*args), reps=20)
        t_bytes, t_ops = nbytes / mem_rate, nops / int_rate
        label = f"{name}[{spec.name}]"
        rows.append({
            "name": label, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name].get(spec.name, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": t0.elapsed_time(t1),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None,
        })
        log(f"[13 bn254] {label} at (16, 2^{n.bit_length() - 1}): {ms:.4f} ms/launch "
            f"(l field, phase 6: {l_ms[name]:.4f} ms), plain {rows[-1]['plain_ms']:.2f} ms, "
            f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}); max limb "
            f"difference vs plain {err} (tolerance 0: exact integers)")
    return rows


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_parties(cmd: list, timeout: float) -> list:
    """Run `cmd + ["--party", p]` for p = 1 (the listener) and 0 at once;
    -> each party's last stdout line as JSON.  Stops both on any failure."""
    procs = {p: subprocess.Popen(cmd + ["--party", str(p)], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for p in (1, 0)}
    try:
        outs = {p: proc.communicate(timeout=timeout) for p, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    results = []
    for p in (0, 1):
        out, err = outs[p]
        check(procs[p].returncode == 0,
              f"party {p} exited {procs[p].returncode}:\n{out[-2000:]}\n{err[-4000:]}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def phase_tcp(dev) -> dict:
    """Two party processes on this card over localhost TCP (plaintext: the
    card host has no `cryptography` for TLS): the integration registry, then
    the wire-inclusive batch."""
    from ark_mpc_tpu_torch.fabric import native_net

    _, lib_path = native_net.library()  # load or build it once, before the children
    t0 = time.time()
    r0, r1 = run_parties([sys.executable, "-m", "ark_mpc_tpu_torch.integration",
                          "--port", str(free_port()), "--no-tls", "--quiet",
                          "--timeout", str(REGISTRY_TIMEOUT)], REGISTRY_TIMEOUT)
    registry_s = time.time() - t0
    check(r0 == r1, "the parties' registry results differ")
    bad = {k: v for k, v in r0.items() if v != "ok"}
    check(not bad, f"registry cases failed: {bad}")
    log(f"[14 tcp] integration registry over TCP (no TLS, native IO from "
        f"{lib_path}): {len(r0)}/{len(r0)} cases ok in both parties, "
        f"{registry_s:.1f} s wall")

    w0, w1 = run_parties([sys.executable, os.path.abspath(__file__), "--wire-port",
                          str(free_port())], REGISTRY_TIMEOUT)
    check(w0["spots"] == w1["spots"], "the wire parties opened different values")
    xs, ys, zs = w0["spots"]
    check(zs == [x * pow(y, WIRE_ROUNDS, L) % L for x, y in zip(xs, ys)],
          f"the wire batch's output is not x * y^{WIRE_ROUNDS}")
    for w in (w0, w1):
        check(w["io"] == "native", f"party {w['party']} IO path is {w['io']}, not native")
        check(w["beaver_round_launches"] > 0,
              f"party {w['party']} launched no beaver_round")
    elapsed = max(w0["elapsed_s"], w1["elapsed_s"])
    mults = WIRE_N * WIRE_ROUNDS
    out = {"mults_per_sec": mults / elapsed, "elapsed_s_max_of_parties": elapsed,
           "bytes_sent_per_mult": [w["bytes_sent"] / mults for w in (w0, w1)],
           "setup_s": [w["setup_s"] for w in (w0, w1)], "io": w0["io"],
           "beaver_round_launches": [w["beaver_round_launches"] for w in (w0, w1)],
           "parties": [w0, w1], "registry_s": registry_s, "registry_cases": len(r0)}
    log(f"[14 tcp] wire-inclusive batch n=2^20 x {WIRE_ROUNDS} chained muls + 1 "
        f"authenticated open + 1 folded deferred check (triples drawn inside the "
        f"clock; plaintext TCP), two processes on one card: "
        f"{out['mults_per_sec']:.4e} mults/s (max of the parties' {w0['elapsed_s']:.3f} / "
        f"{w1['elapsed_s']:.3f} s), bytes sent per mult "
        f"{out['bytes_sent_per_mult'][0]:.2f} / {out['bytes_sent_per_mult'][1]:.2f}, "
        f"set-up {w0['setup_s']:.1f} / {w1['setup_s']:.1f} s, IO {w0['io']}, "
        f"beaver_round launches {out['beaver_round_launches']}; spot values equal "
        "Python ints")
    for w in (w0, w1):
        log(f"[14 tcp] party {w['party']} timed steps (s, host clock; `in_exchange` "
            f"spans sending and waiting for the peer): "
            f"{ {k: round(v, 3) for k, v in w['steps_s'].items()} }")
    return out


def wire_party(party: int, port: int) -> dict:
    """One party of the wire-inclusive batch (run by phase 14 as a child).
    The timed window is `benchmarks/online_wire.py`'s: each `fabric.mul`
    draws its triples from the dealer inside it.  It differs from that file
    in two ways: plaintext TCP (the card host has no `cryptography`) and the
    folded MAC check (`verify_deferred(fold=True)`; the reference's runs
    unfolded without a mesh)."""
    dev = resolve_device(None)
    t0 = time.time()
    dealer = TrustedDealerSource(party, seed=WIRE_SEED, device=dev)
    transport = TcpTransport(party, "127.0.0.1", port, timeout=REGISTRY_TIMEOUT, tls=False)
    blocked = [0.0]  # seconds inside transport.exchange: sending, and waiting for the peer
    exchange = transport.exchange

    def timed_exchange(data):
        t = time.time()
        try:
            return exchange(data)
        finally:
            blocked[0] += time.time() - t

    transport.exchange = timed_exchange
    try:
        fabric = MpcFabric(party, transport, dealer, device=dev, collect_stats=True)
        fk.reset_launches()
        x = dealer.next_shared_value_batch(WIRE_N)
        y = dealer.next_shared_value_batch(WIRE_N)
        z = fabric.mul(x, y)  # warm-up round, outside the clock
        fabric.open_authenticated(z, defer=True)
        fabric.verify_deferred(fold=True)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        stats = transport.stats
        base = (stats.bytes_sent, stats.msgs_sent)
        transport.exchange(b"go")
        fabric.stats = FabricStats()
        blocked[0] = 0.0
        t1 = time.time()
        z = x
        for _ in range(WIRE_ROUNDS):
            z = fabric.mul(z, y)
        opened = fabric.open_authenticated(z, defer=True)
        fabric.verify_deferred(fold=True)
        torch.cuda.synchronize()
        elapsed = time.time() - t1
        steps = {op: v["seconds"] for op, v in fabric.stats.snapshot()["ops"].items()}
        steps["in_exchange"] = blocked[0]
        sent = (stats.bytes_sent - base[0], stats.msgs_sent - base[1])
        idx = torch.tensor([0, 7, WIRE_N // 3, WIRE_N - 1], device=dev)
        ox = fabric.open_authenticated(x[idx], defer=True)
        oy = fabric.open_authenticated(y[idx], defer=True)
        fabric.verify_deferred(fold=True)
        return {"party": party, "n": WIRE_N, "rounds": WIRE_ROUNDS, "elapsed_s": elapsed,
                "setup_s": setup_s, "steps_s": steps, "bytes_sent": sent[0],
                "msgs_sent": sent[1],
                "io": transport.io, "tls": transport.tls,
                "beaver_round_launches": fk.beaver_round.launches,
                "spots": [ox.to_ints(), oy.to_ints(), opened[idx].to_ints()],
                "device": torch.cuda.get_device_name(dev)}
    finally:
        transport.close()


def timed(label: str, fn, *args):
    """Run one phase; log its seconds (host clock, after a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn(*args)
    torch.cuda.synchronize()
    log(f"[{label}] phase took {time.time() - t0:.1f} s")
    return out


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    if argv:  # one party of phase 14's wire-inclusive batch
        ap = argparse.ArgumentParser()
        ap.add_argument("--wire-port", type=int, required=True)
        ap.add_argument("--party", type=int, required=True, choices=[0, 1])
        args = ap.parse_args(argv)
        print(json.dumps(wire_party(args.party, args.wire_port)), flush=True)
        return 0
    dev = torch.device("cuda")
    t_start = time.time()
    card, build_logs = phase_build()
    plain_2_16 = timed("2 kernels", phase_kernels, dev)

    fk.reset_launches()
    timed("3 readme", phase_readme, dev)
    timed("4 fabric", phase_fabric, dev)
    ch, headline = timed("5 chain", phase_chain, dev, card)
    launches = fk.launch_counts()
    log(f"main-path launches: {launches}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")

    rows = timed("6 report", phase_report, dev, ch, launches)
    timed("7 curve", phase_curve_kernels, dev)

    mk.reset_launches()
    points = timed("8 points", phase_points, dev)
    msm_ops, msm_times = timed("9 msm", phase_msm, dev)
    curve_launches = mk.launch_counts()
    log(f"curve-path launches: {curve_launches}")
    check(all(v > 0 for v in curve_launches.values()),
          "a kernel of the curve path was never launched")
    rows += timed("10 report", phase_curve_report, dev, msm_ops, curve_launches,
                  build_logs[ck.SOURCE])

    fk.reset_launches()
    mk.reset_launches()
    traced = timed("11 traced", phase_traced, dev)
    mats = timed("12 matmul", phase_matmul, dev)
    circuit_launches = {**fk.launch_counts(), **mk.launch_counts()}
    log(f"circuit-path launches: {circuit_launches}")
    check(all(circuit_launches[k] > 0 for k in ("mont_mul", "beaver_round", "windowed_mul")),
          "a kernel of the circuit path was never launched")

    fk.reset_launches()
    bn254 = timed("13 bn254", phase_bn254, dev)
    bn254_launches = fk.field_launch_counts()
    log(f"bn254-path launches: {bn254_launches}")
    check(all(bn254_launches[k].get(f, 0) > 0 for k, f in (
        ("mont_mul", "bn254-fq"), ("mont_mul", "bn254-fr"), ("beaver_round", "bn254-fr"))),
        "a kernel of the BN254 path was never launched at its field")
    bn254.update(timed("13 bn254", g1_mul_alone, dev))
    rows += timed("13 bn254", bn254_kernel_rows, dev, bn254_launches, rows)
    tcp = timed("14 tcp", phase_tcp, dev)

    log(json.dumps({"headline": headline}))
    log(json.dumps({"points_n_10000": points}))
    log(json.dumps({"msm_n_2^16": msm_times}))
    log(json.dumps({"times_at_n_2^16": plain_2_16}))
    log(json.dumps({"traced": traced, "matmul_poly": mats}))
    log(json.dumps({"bn254": bn254, "tcp": tcp}))
    log(f"total {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
