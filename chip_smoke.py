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
              both, the slow dealer-free `lowgear_dealer_free_e2e` (BGV
              key exchange, LowGear at m = 132, an online product) named
              with them, which must all be "ok" and agree; then the
              wire-inclusive batch of `benchmarks/online_wire.py` at its
              full size (n = 2^20, 4 chained `fabric.mul` rounds drawing
              their triples inside the clock, one authenticated open, one
              folded deferred check where that file's is unfolded, and
              plaintext where it uses TLS; this script run as
              `--wire-port P --party p`): mults/s over the slower
              party's wall time, bytes sent per mult, set-up seconds, the
              IO path (must be native) and each party's `beaver_round`
              launches (must be > 0);
 15. bgv      BGV over l at the production ring m = 118965 (phi = 48960,
              24,480 GF(l^2) slots): the ring's host build time; keygen,
              then encode -> encrypt(x) -> ct x pt(y) -> ct + pt(z) ->
              rerandomize (drowning at sec 128) -> decrypt -> decode, every
              slot equal to x*y + z mod l by Python ints; ct x ct with
              relinearization at the medium ring (m = 1155); the ZK proof
              with U = 2, V = 128 at sec = ring.zk_sec: accepted, a tampered
              response digit rejected, the wire round trip accepted; then
              the median of 5 CUDA-event runs of each op, each op's
              `mont_mul` launches, prove and verify seconds and the peak
              device memory, and `mont_mul` at (16, 48960) against its plain
              version;
 16. lowgear  the dealer-free offline phase (`bench_offline.py:54-109`),
              both parties on this card through `execute_mock_mpc`: at the
              medium ring (m = 1155, 240 slots) bgv-mode `LowGear` with
              fixed numpy seeds, the key exchange, a warm-up call and a timed
              call of `generate_triples(2 x 240)` (each makes 64 slot
              batches), the rest of the inventory (randomness, triples,
              inverse tuples, bits, input masks), an online product over the
              prep against Python ints, and a corrupted candidate triple
              that must raise `SacrificeError` in both parties; then at the
              production ring (m = 118965, 29 primes, 24,480 slots, uncut)
              the secure default ring's key exchange with its two proofs, a
              warm-up and a timed call of `generate_triples(2 x 24480)`
              (4 slot batches, 97,920 sacrificed triples a call), input
              masks and an online product of 2^10 elements over the prep;
              sacrificed triples/s over the timed call's wall clock, the key
              exchange's seconds, each party's stage record (seconds by
              stage, the proof's and the sacrifice's included), the phase's
              peak device memory, and its `mont_mul` and `beaver_round`
              launches;
 17. mesh     the scale-out path over torch.distributed: a mesh of
              `torch.cuda.device_count()` ranks over NCCL (one rank a card;
              one rank, in this process, on a one-card host, more ranks
              spawned with `parallel.launch`), its two party groups NCCL
              too; `sharded_mul_mac_step` at n = 2^22, bit for bit equal to
              the unsharded `beaver_mul_step` + `mac_check_fold`, each timed
              by CUDA events (median of 5 after a warm-up) beside the fold's
              `all_reduce` alone; the mesh-attached fabric at n = 2^20
              (phase 4's program with the default folded check through
              `sharded_rlc_fold`): spot values equal Python ints and phase
              4's, both parties agree, host seconds beside phase 4's, and a
              corrupted MAC aborts both parties; then the sharded ct x pt
              at the production ring, U = `stack_chunk` = 4 ciphertexts
              split over the ranks, every decoded slot equal to Python ints;
              then the operations that reduce over the batch axis or hold
              values whole (replicated): `ScalarShare.sum` and
              `inner_product` at 2^20, a traced circuit at 2^16 whose levels
              open a sum beside a sharded product, `shared_matmul` at 512^3
              (row-sharded), phase 12's degree-255 polynomials with
              `poly_eval`, and Ed25519 `share_points` + `mul_generator` +
              `msm_authenticated` at 2^16, each against Python ints, with
              its host seconds beside the unsharded phase's (the points
              beside the same program on the unsharded fabric, whose shares
              mul_generator's equal bit for bit and the MSM's
              projectively); a corrupted point MAC on one rank pair aborts
              both parties, and `prefix_product` still raises; and the
              path's `mont_mul`, `beaver_round` and `windowed_mul` launches;
 18. proto    the t-generic prototype BGV stack at `test_params()` (N = 1024,
              t a 29-bit prime, 6 x 30-bit q): both parties' key exchange
              (`offline/lowgear/setup.run_key_exchange`) and a triple pair
              (`triplets_bgv.generate_triple_pairs`: the enc(a) exchange
              gated on its V = 32 proof, the homomorphic cross products,
              the MACs) through `execute_mock_mpc`, c = a b, c' = a b' and
              every MAC against Python ints in all 1024 slots; a tampered
              proof must raise `KeyExchangeError`; the seconds of the key
              exchange, the pair, and the enc(a) proof's prove and verify
              alone; one `poly_mul_mod` batch (64 x 6 x 1024) on the card
              (CUDA events) against the same batch on the host CPU, equal.

Each phase logs its seconds.  The launch counts of the field kernels are
those of phases 3-5, those of the curve kernels those of phases 8-9 (each
path's counts are set to 0 just before it and read just after;
`bucket_accumulate` counts one launch a pass, and `bucket_reduce` launches
on the bucket and the winsum routes); phases
11-12 are a third path, whose kernels (`mont_matmul`'s and the fabric's)
must each launch there too, and phase 13's fabric batch and point
protocols a fourth, which must launch `mont_mul` at Fq and at Fr and
`beaver_round` at Fr (counted by field), phase 15 a fifth, which must
launch `mont_mul` at l, and phase 16 a sixth, which must launch `mont_mul`
and `beaver_round`, phase 17 a seventh (counted on each rank and added),
which must launch both and `windowed_mul`; phase 18's path reaches none of
the kernels (the reference's prototype has no Pallas kernel), and its
counts are logged.  The last line is `{"ok": true, "device":
{...}}`.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ark_mpc_tpu_torch import (
    G1,
    AuthenticationError,
    CurvePoint,
    Fr,
    LowGear,
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
from ark_mpc_tpu_torch.fabric import commitment, messages
from ark_mpc_tpu_torch.fabric.transport import NoRecvTransport
from ark_mpc_tpu_torch.gadgets import bit_xor, prefix_product
from ark_mpc_tpu_torch.integration import REGISTRY
from ark_mpc_tpu_torch.integration import cases as _cases  # noqa: F401  (fills REGISTRY)
from ark_mpc_tpu_torch.models.circuits import inner_product, poly_eval, shared_matmul
from ark_mpc_tpu_torch.offline import bgv
from ark_mpc_tpu_torch.offline.bgv import bgv as proto_bgv
from ark_mpc_tpu_torch.offline.bgv import params as proto_params
from ark_mpc_tpu_torch.offline.bgv import zkpok as proto_zk
from ark_mpc_tpu_torch.offline.bgv import zkpok_words
from ark_mpc_tpu_torch.offline.errors import KeyExchangeError, SacrificeError
from ark_mpc_tpu_torch.offline.lowgear import resolve_bgv_ring
from ark_mpc_tpu_torch.offline.lowgear import setup as proto_setup
from ark_mpc_tpu_torch.offline.lowgear import triplets_bgv as proto_triples
from ark_mpc_tpu_torch.offline.lowgear.triplets_l import stack_chunk
from ark_mpc_tpu_torch.ops import _build
from ark_mpc_tpu_torch.ops import curve_kernels as ck
from ark_mpc_tpu_torch.ops import fp_kernels as fk
from ark_mpc_tpu_torch.ops import matmul
from ark_mpc_tpu_torch.ops import msm_kernels as mk
from ark_mpc_tpu_torch.ops import ntt
from ark_mpc_tpu_torch.parallel import launch
from ark_mpc_tpu_torch.parallel.dryrun import sharded_ct_x_pt
from ark_mpc_tpu_torch.parallel.launch import run_rank
from ark_mpc_tpu_torch.parallel.step import (
    beaver_mul_step,
    gather,
    mac_check_fold,
    shard,
    shard_share,
    sharded_mul_mac_step,
)
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


def phase_fabric(dev) -> tuple[float, list]:
    """-> (host seconds, party 0's spot values), for phase 17."""
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
    return secs, vals0


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


def whole(x, fabric):
    """x gathered over the party's ranks of a mesh fabric (else as it is)."""
    return x if fabric.mesh is None else gather(x, fabric.mesh)


def matmul_program(a: Scalar, b: Scalar, idx):
    """Shared matmul of the global a and b; on a mesh each rank holds its
    rows of both (its shard of the flat batch), and of the product."""
    def prog(fabric):
        dev, (m, k), n = fabric.device, a.shape, b.shape[1]
        sa = fabric.share_values(a.reshape(m * k) if fabric.party_id == 0
                                 else None, sender=0, n=m * k).reshape(-1, k)
        sb = fabric.share_values(b.reshape(k * n) if fabric.party_id == 1
                                 else None, sender=1, n=k * n).reshape(-1, n)
        torch.cuda.synchronize()
        t0 = time.time()
        sc = shared_matmul(fabric, sa, sb)
        torch.cuda.synchronize()
        secs = time.time() - t0
        opened = fabric.open_authenticated(sc.reshape(sc.size))  # MAC-checked
        return spot(whole(opened, fabric), [i * n + j for i, j in idx]), secs
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


def poly_inputs() -> tuple:
    r = random.Random(91)
    f = [r.randrange(L) for _ in range(POLY_DEG + 1)]
    g = [r.randrange(L) for _ in range(POLY_DEG + 1)]
    h = [r.randrange(1, L) for _ in range(18)]
    return f, g, h, r.randrange(L)


def check_poly(p0, p1, f, g, h, x_eval) -> None:
    """`poly_program`'s opens against Python ints; both parties agree."""
    check(p0 == p1, "parties opened different polynomials")
    prod = poly_ref_mul(f, g)
    check(p0["prod"] == prod, "shared poly_mul differs from Python ints")
    check(p0["eval"] == [sum(c * pow(x_eval, i, L) for i, c in enumerate(prod)) % L],
          "poly_eval differs from Python ints")
    rem = [(u - v) % L for u, v in zip(f, poly_ref_mul(p0["div"], h) + [0] * len(f))]
    check(len(p0["div"]) == len(f) - len(h) + 1 and not any(rem[len(h) - 1:]),
          "poly_div leaves a remainder of too high a degree")
    check(p0["fft_round_trip"] == f[:132], "FFT/IFFT round trip of shares failed")


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

    f, g, h, x_eval = poly_inputs()
    dom = EvaluationDomain(132, device=dev)
    (p0, psecs), (p1, _) = execute_mock_mpc_dealer(poly_program(f, g, h, x_eval, dom),
                                                   seed=13, device=dev)
    check_poly(p0, p1, f, g, h, x_eval)
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
    names = ",".join(sorted(REGISTRY))      # the slow LowGear case runs only when named
    t0 = time.time()
    r0, r1 = run_parties([sys.executable, "-m", "ark_mpc_tpu_torch.integration",
                          "--port", str(free_port()), "--no-tls", "--quiet", "--tests", names,
                          "--timeout", str(REGISTRY_TIMEOUT)], REGISTRY_TIMEOUT)
    registry_s = time.time() - t0
    check(r0 == r1, "the parties' registry results differ")
    check(sorted(r0) == sorted(REGISTRY), "the registry run left cases out")
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

# -- phase 15: BGV over l at the production ring --------------------------

BGV_RUNS = 5               # CUDA-event runs of each op; the median is kept
ZK_V, ZK_U = 128, 2        # triplets_l.ZK_ROWS challenge rows; two plaintexts


def slot_ints(rng: np.random.Generator, n: int) -> list:
    """n uniform elements of F_l as Python ints (320 random bits each)."""
    raw = rng.bytes(40 * n)
    return [int.from_bytes(raw[40 * i:40 * i + 40], "little") % L for i in range(n)]


def median_event_ms(fn, runs: int = BGV_RUNS) -> float:
    """Median of `runs` single calls, each timed by CUDA events."""
    times = []
    for _ in range(runs):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def bgv_pipeline(ring, dev) -> tuple[dict, dict]:
    """Key, then encode -> encrypt(x) -> ct x pt(y) -> ct + pt(z) -> drown ->
    decrypt -> decode on every slot, each op once with its mont_mul launches;
    every slot must equal x y + z mod l.  -> (launches by op, the ops as
    closures for timing, the keypair)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(60)
    kp = bgv.keygen_l(ring, gen)
    rng = np.random.default_rng(61)
    x, y, z = (slot_ints(rng, ring.slots) for _ in range(3))
    sx, sy, sz = (Scalar.from_ints(v, device=dev) for v in (x, y, z))
    launches, state = {}, {}
    ops = {
        "encode": lambda: bgv.encode_slots_l(ring, sx),
        "encrypt": lambda: bgv.encrypt_l(ring, kp.pk_a, kp.pk_b, state["encode"], gen),
        "ct_x_pt": lambda: bgv.mul_pt_l(ring, state["encrypt"], state["pt_y"]),
        "ct_plus_pt": lambda: bgv.add_pt_l(ring, state["ct_x_pt"], state["pt_z"]),
        "rerandomize": lambda: bgv.rerandomize_l(ring, kp.pk_a, kp.pk_b, state["ct_plus_pt"], gen),
        "decrypt": lambda: bgv.decrypt_l(ring, kp.sk, state["rerandomize"]),
        "decode": lambda: bgv.decode_slots_l(ring, state["decrypt"]),
    }
    state["pt_y"] = bgv.encode_slots_l(ring, sy)
    state["pt_z"] = bgv.encode_slots_l(ring, sz)
    for name, fn in ops.items():
        before = fk.mont_mul.launches
        state[name] = fn()
        torch.cuda.synchronize()
        launches[name] = fk.mont_mul.launches - before
    got = state["decode"].to_ints()
    want = [(a * b + c) % L for a, b, c in zip(x, y, z)]
    check(len(got) == ring.slots, f"decoded {len(got)} slots")
    bad = sum(g != w for g, w in zip(got, want))
    check(bad == 0, f"{bad} of {ring.slots} slots differ from x*y + z mod l")
    log(f"[15 bgv] encode -> encrypt -> ct x pt -> ct + pt -> rerandomize (drown "
        f"{ring.drown_bits} bits) -> decrypt -> decode: {ring.slots}/{ring.slots} slots "
        "equal x*y + z mod l (Python ints)")
    return launches, ops, kp


def bgv_ct_x_ct(dev) -> None:
    """ct x ct with relinearization at the medium ring (m = 1155)."""
    ring = bgv.medium_ring(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(62)
    kp = bgv.keygen_l(ring, gen)
    rlk = bgv.gen_relin_key_l(ring, kp.sk, gen)
    rng = np.random.default_rng(63)
    a, b = (slot_ints(rng, ring.slots) for _ in range(2))
    ca, cb = (bgv.encrypt_l(ring, kp.pk_a, kp.pk_b,
                            bgv.encode_slots_l(ring, Scalar.from_ints(v, device=dev)), gen)
              for v in (a, b))
    got = bgv.decode_slots_l(ring, bgv.decrypt_l(ring, kp.sk, bgv.mul_ct_l(ring, rlk, ca, cb)))
    check(got.to_ints() == [u * v % L for u, v in zip(a, b)], "medium-ring ct x ct is wrong")
    log(f"[15 bgv] medium ring m={ring.m} (phi={ring.phi}, {len(ring.q_primes)} primes): "
        f"mul_ct_l with relinearization decodes to x*y mod l on {ring.slots}/{ring.slots} slots")


def bgv_zk(ring, kp, dev) -> dict:
    """encrypt_and_prove_batch with U = 2, V = 128 at sec = ring.zk_sec;
    verify, a tampered response digit, a wire round trip."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(64)
    rng = np.random.default_rng(65)
    slots = [slot_ints(rng, ring.slots) for _ in range(ZK_U)]
    pts = [bgv.encode_slots_l(ring, Scalar.from_ints(v, device=dev)) for v in slots]
    torch.cuda.synchronize()
    t0 = time.time()
    proof = bgv.encrypt_and_prove_batch(ring, kp.pk_a, kp.pk_b, pts, gen, v=ZK_V,
                                        sec=ring.zk_sec)
    torch.cuda.synchronize()
    prove_s = time.time() - t0
    t0 = time.time()
    ok = bgv.verify_proof(ring, kp.pk_a, kp.pk_b, proof, sec=ring.zk_sec, v=ZK_V,
                          expected_u=ZK_U)
    torch.cuda.synchronize()
    verify_s = time.time() - t0
    check(ok, "the production-ring proof was rejected")
    got = bgv.decode_slots_l(ring, bgv.decrypt_l(ring, kp.sk, proof.cts)).to_ints()
    check(got == slots[0] + slots[1], "the proven ciphertexts decrypt wrong")
    items = bgv.proof_to_arrays(proof)
    bad = [np.array(a, copy=True) for a in items]
    bad[4][3, 5, 0] += 1   # one digit of the plaintext response z
    check(not bgv.verify_proof(ring, kp.pk_a, kp.pk_b, bgv.proof_from_arrays(bad, device=dev),
                               sec=ring.zk_sec, v=ZK_V, expected_u=ZK_U),
          "a tampered response digit was accepted")
    check(bgv.verify_proof(ring, kp.pk_a, kp.pk_b, bgv.proof_from_arrays(items, device=dev),
                           sec=ring.zk_sec, v=ZK_V, expected_u=ZK_U),
          "the wire round trip of the proof was rejected")
    wire = sum(a.nbytes for a in items)
    log(f"[15 bgv] ZK proof U={ZK_U}, V={ZK_V}, sec={ring.zk_sec} (V-chunk "
        f"{zkpok_words._v_chunk(ring, ZK_V)}): prove {prove_s:.2f} s, verify {verify_s:.2f} s "
        f"(host clock); accepted, decrypts to its plaintexts, a tampered digit rejected, "
        f"the wire round trip ({wire / 2**20:.1f} MiB) accepted")
    return {"prove_s": prove_s, "verify_s": verify_s, "wire_bytes": wire}


def phase_bgv(dev, card: str) -> tuple[dict, dict]:
    """BGV over l at the production ring m = 118965: ring build, the slot
    pipeline, ct x ct at the medium ring and the V = 128 ZK proof (the path,
    its mont_mul launches counted), then each op's median time."""
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)   # tensors earlier phases still hold
    t0 = time.time()
    ring = bgv.production_ring(device=dev)
    build_s = time.time() - t0
    t0 = time.time()
    ring._build_slot_maps()
    slot_maps_s = time.time() - t0
    check((ring.phi, ring.slots) == (48960, 24480), "production ring shape")
    log(f"[15 bgv] production ring m={ring.m}: phi={ring.phi}, {ring.slots} GF(l^2) slots, "
        f"{len(ring.q_primes)} primes (log2 q = {ring.log2_q}, budget ok {ring.budget_ok}, "
        f"RLWE-128 {bgv.rlwe_secure_128(ring)}); built in {build_s:.2f} s + slot maps "
        f"{slot_maps_s:.2f} s (host)")
    before = fk.mont_mul.launches
    launches, ops, kp = bgv_pipeline(ring, dev)
    bgv_ct_x_ct(dev)
    zk = bgv_zk(ring, kp, dev)
    path_launches = fk.mont_mul.launches - before
    log(f"[15 bgv] mont_mul launches by op: {launches}; whole path {path_launches}")
    times = {name: median_event_ms(fn) for name, fn in ops.items()}
    peak = torch.cuda.max_memory_allocated(dev) - held
    log(f"[15 bgv] median of {BGV_RUNS} CUDA-event runs (ms): "
        f"{ {k: round(v, 3) for k, v in times.items()} } on {card}")
    log(f"[15 bgv] peak device memory of the phase {peak / 2**30:.2f} GiB (above the "
        f"{held / 2**30:.2f} GiB earlier phases still hold)")
    return {"ring_build_s": build_s, "slot_maps_s": slot_maps_s, "op_ms": times,
            "op_mont_mul_launches": launches, "path_mont_mul_launches": path_launches,
            "peak_device_bytes": peak, "held_before_bytes": held, **zk}, {"mont_mul": path_launches}


def bgv_kernel_row(dev, launches: int) -> dict:
    """mont_mul at the RNS -> F_l conversion's shape (16, phi) against its
    plain version, timed by CUDA events."""
    mem_rate, int_rate = device_rates(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(66)
    n = 48960
    args = (SPEC, rand_below(SPEC, n, gen, dev), rand_below(SPEC, n, gen, dev))
    got = fk.mont_mul(*args)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    plain = lb.mont_mul_plain(*args)
    t1.record()
    torch.cuda.synchronize()
    err = max_diff(got, plain)
    check(err == 0, f"mont_mul at (16, {n}) differs from its plain version (max {err})")
    ms = cuda_ms(lambda: fk.mont_mul(*args), reps=50)
    t_bytes, t_ops = 3 * 64 * n / mem_rate, mul_ops(1, 1) * n / int_rate
    row = {"name": "mont_mul[bgv]", "route": "cuda", "source": SOURCE,
           "replaces": REPLACES["mont_mul"], "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": t0.elapsed_time(t1), "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes > t_ops else "operations", "library_ms": None}
    log(f"[15 bgv] mont_mul at (16, {n}): {ms:.4f} ms/launch, plain {row['plain_ms']:.2f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); max limb difference vs plain "
        f"{err} (tolerance 0: exact integers)")
    return row


# -- phase 16: the dealer-free LowGear offline phase -----------------------

LG_SEED = 300              # numpy seeds 300 + party, as bench_offline.py
LG_BATCHES = 2             # slot batches asked of each call (bench_offline.py's BATCHES)
N_LG_ONLINE = 1 << 10      # the online product over the production prep


def lowgear_program(ring, allow_insecure: bool, rest: bool, n_online: int):
    """One party of bench_offline.py's flow (`bench_offline.py:54-109`):
    key exchange, a warm-up call and a timed call of `generate_triples(2
    slot batches)` (each rounds up to `stack_chunk(ring)` batches), with
    `rest` the remaining inventory, then an online product over the prep
    and, with `rest`, a corrupted candidate triple.  -> host-clock spans
    (start, end) by step, the timed call's stage record, counts and spot
    values."""
    def prog(fabric):
        pid, dev = fabric.party_id, fabric.device
        spans = {}

        def span(label, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            spans[label] = (t0, time.perf_counter())
            return out

        gen = torch.Generator(device=dev)
        gen.manual_seed(LG_SEED + 10 + pid)
        lg = span("key_exchange", lambda: LowGear(
            pid, fabric.transport, mode="bgv", ring=ring, allow_insecure_ring=allow_insecure,
            rng=np.random.default_rng(LG_SEED + pid), gen=gen, device=dev))
        kx_stages = dict(lg.timing)
        n = ring.slots * LG_BATCHES
        span("warmup", lambda: lg.generate_triples(n))
        warm = len(lg.prep.triples)
        lg.timing.clear()
        span("timed", lambda: lg.generate_triples(n))
        out = {"spans": spans, "stages": dict(lg.timing), "key_exchange_stages": kx_stages,
               "warm_triples": warm, "timed_triples": len(lg.prep.triples) - warm}
        if rest:
            n_inv = n_bits = ring.slots

            def stock():
                lg.generate_shared_randomness(2 * n_inv + n_bits)
                lg.generate_triples(n_inv + n_bits)
                lg.generate_inverse_tuples(n_inv)
                lg.generate_shared_bits(n_bits)
            span("rest", stock)
        span("input_masks", lambda: lg.generate_input_masks(max(n_online, min(ring.slots, 64))))
        prep = lg.get_offline_result()
        out["stores"] = {name: len(store) for name, store in prep._stores().items()}

        rnd = random.Random(LG_SEED)
        xs = [rnd.randrange(L) for _ in range(n_online)]
        ys = [rnd.randrange(L) for _ in range(n_online)]
        online = MpcFabric(pid, fabric.transport, prep, device=dev,
                           rng=np.random.default_rng(LG_SEED + 20 + pid))

        def product():
            sx = online.share_values(Scalar.from_ints(xs, device=dev) if pid == 0 else None,
                                     sender=0, n=n_online)
            sy = online.share_values(Scalar.from_ints(ys, device=dev) if pid == 1 else None,
                                     sender=1, n=n_online)
            z = online.open_authenticated(online.mul(sx, sy), defer=True)
            online.verify_deferred(fold=True)
            return z
        z = span("online", product)
        idx = [0, 1, n_online // 2, n_online - 1]
        out["spots"] = (z[torch.tensor(idx, device=dev)].to_ints(),
                        [xs[i] * ys[i] % L for i in idx])
        if rest:
            a, b, c, b2, c2 = lg._raw_triple_pairs(ring.slots)
            c = c.add_public(Scalar.from_ints(1, device=dev), lg.fabric.mac_key, pid)
            lg._raw_triple_pairs = lambda _n: (a, b, c, b2, c2)
            try:
                lg.generate_triples(ring.slots)
                out["corrupted"] = "accepted"
            except SacrificeError:
                out["corrupted"] = "SacrificeError"
        return out

    return prog


def lowgear_run(label: str, ring, allow_insecure: bool, rest: bool, n_online: int,
                dev, card: str) -> dict:
    r0, r1 = execute_mock_mpc(lowgear_program(ring, allow_insecure, rest, n_online), device=dev)

    def wall(step):  # both parties run in lockstep: from the first start to the last end
        return (max(r["spans"][step][1] for r in (r0, r1))
                - min(r["spans"][step][0] for r in (r0, r1)))

    for r in (r0, r1):
        got, want = r["spots"]
        check(got == want, f"{label}: the online product over the prep is wrong")
        check(r["timed_triples"] == r0["timed_triples"] > 0, f"{label}: no triples made")
    made = r0["timed_triples"]
    out = {"m": ring.m, "slots": ring.slots, "primes": len(ring.q_primes),
           "slot_batches_a_call": made // ring.slots, "triples_a_call": made,
           "key_exchange_s": wall("key_exchange"), "warmup_s": wall("warmup"),
           "timed_s": wall("timed"), "triples_per_s": made / wall("timed"),
           "input_masks_s": wall("input_masks"), "online_s": wall("online"),
           "stages_s": [r0["stages"], r1["stages"]],
           "key_exchange_stages_s": [r0["key_exchange_stages"], r1["key_exchange_stages"]],
           "stores": r0["stores"]}
    if rest:
        out["rest_s"] = wall("rest")
        check(r0["corrupted"] == r1["corrupted"] == "SacrificeError",
              f"{label}: a corrupted triple passed the sacrifice "
              f"({r0['corrupted']} / {r1['corrupted']})")
    log(f"[16 lowgear] {label} m={ring.m} ({len(ring.q_primes)} primes, {ring.slots} slots): "
        f"key exchange {out['key_exchange_s']:.2f} s; warm-up call {out['warmup_s']:.2f} s; "
        f"timed call {made} sacrificed triples ({made // ring.slots} slot batches) in "
        f"{out['timed_s']:.3f} s = {out['triples_per_s']:.1f} triples/s on {card}")
    for pid, r in enumerate((r0, r1)):
        log(f"[16 lowgear] {label} party {pid} stages of the timed call (s, host clock; "
            f"lockstep: `exchange` spans waiting for the peer): "
            f"{ {k: round(v, 3) for k, v in r['stages'].items()} }")
    log(f"[16 lowgear] {label} input masks {out['input_masks_s']:.2f} s"
        + (f", the rest (randomness, triples, inverse tuples, bits) {out['rest_s']:.2f} s"
           if rest else "")
        + f"; online product of {n_online} elements {out['online_s']:.2f} s equals Python "
        f"ints at spot indices; stores {out['stores']}"
        + ("; a corrupted candidate triple raised SacrificeError in both parties"
           if rest else ""))
    return out


def phase_lowgear(dev, card: str) -> dict:
    """bench_offline.py's flow, both parties on this card through
    `execute_mock_mpc`: the medium ring with the rest of the inventory and
    a corrupted triple, then the production ring uncut."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)   # tensors earlier phases still hold
    medium = lowgear_run("medium", bgv.medium_ring(device=dev), True, True, 64, dev, card)
    t0 = time.time()
    ring = resolve_bgv_ring(None, allow_insecure_ring=False, device=dev)
    ring._build_slot_maps()
    ring_s = time.time() - t0
    prod = lowgear_run("production", ring, False, False, N_LG_ONLINE, dev, card)
    peak = torch.cuda.max_memory_allocated(dev) - held
    log(f"[16 lowgear] production ring built in {ring_s:.2f} s (host, with slot maps); "
        f"peak device memory of the phase {peak / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB earlier phases hold (two parties on one card)")
    return {"medium": medium, "production": prod, "production_ring_build_s": ring_s,
            "peak_device_bytes": peak, "held_before_bytes": held}


# ---------------------------------------------------------------------------
# phase 17: the mesh
# ---------------------------------------------------------------------------

N_MESH_STEP = 1 << 22      # the headline's width
MESH_RUNS = 5              # CUDA-event runs of each timing after a warm-up; the median is kept
MESH_TIMEOUT = 600         # seconds a collective may wait before it raises


def warm_median_ms(fn) -> float:
    fn()
    return median_event_ms(fn, MESH_RUNS)


def mesh_step(mesh, n: int) -> dict:
    """The sharded step at n on the rank's shard against the unsharded step
    on the same global inputs (random field elements made on the card from
    one seed on every rank), bit for bit; both timed, and the fold's
    `all_reduce` alone."""
    dev = mesh.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(170)
    whole = [Scalar(rand_below(SPEC, n, gen, dev)) for _ in range(13)]
    key = Scalar(rand_below(SPEC, 1, gen, dev).reshape(NLIMBS))
    x, y, a, b, c = (ScalarShare(whole[2 * i], whole[2 * i + 1]) for i in range(5))
    d, e, cf = whole[10:]
    local = ([shard_share(s, mesh) for s in (x, y, a, b, c)]
             + [shard(v, mesh) for v in (d, e)] + [key, shard(cf, mesh)])

    def sharded():
        return sharded_mul_mac_step(mesh, 0, *local)

    def unsharded():
        z = beaver_mul_step(0, x, y, a, b, c, d, e, key)
        return z, mac_check_fold(key, z.share, z.mac, cf)

    (z, fold), (zu, fu) = sharded(), unsharded()
    zg = gather(z, mesh)
    check(torch.equal(zg.share.limbs, zu.share.limbs) and torch.equal(zg.mac.limbs, zu.mac.limbs)
          and torch.equal(fold.limbs, fu.limbs),
          "the sharded step differs from the unsharded one")
    cols = torch.ones((NLIMBS, 1), dtype=torch.int64, device=dev)
    out = {"n": n, "sharded_ms": warm_median_ms(sharded),
           "unsharded_ms": warm_median_ms(unsharded),
           "all_reduce_ms": warm_median_ms(lambda: dist.all_reduce(cols, group=mesh.group))}
    return out


def mesh_fabric_program(fabric):
    """Phase 4's program on a mesh: the check folds by default; the opens
    are gathered for the spot values."""
    n = N_FABRIC
    x = fabric.random_shared_scalars(n)
    y = fabric.random_shared_scalars(n)
    z = fabric.mul(x, y)
    opened = [fabric.open_authenticated(v, defer=True) for v in (x, y, z)]
    fabric.verify_deferred()
    idx = torch.tensor([0, 1, n // 3, n // 2, n - 1], device=fabric.device)
    return [gather(v, fabric.mesh)[idx].to_ints() for v in opened], fabric.n_rounds


def mesh_corrupt_program(fabric):
    x = fabric.random_shared_scalars(N_FABRIC)
    if fabric.party_id == 1:
        x = ScalarShare(x.share, x.mac + Scalar.ones(x.shape, device=fabric.device))
    try:
        fabric.open_authenticated(x, defer=True)
        fabric.verify_deferred()
    except AuthenticationError:
        return "abort"
    return "pass"


def mesh_fabric(mesh, phase4_vals) -> dict:
    torch.cuda.synchronize()
    t0 = time.time()
    (vals0, rounds), (vals1, _) = execute_mock_mpc_dealer(mesh_fabric_program, seed=3,
                                                          mesh=mesh)
    torch.cuda.synchronize()
    secs = time.time() - t0
    xs, ys, zs = vals0
    check(vals0 == vals1, "mesh parties opened different values")
    check(zs == [x * y % L for x, y in zip(xs, ys)], "mesh products are wrong")
    check(vals0 == phase4_vals, "the mesh fabric's spot values differ from phase 4's")
    t0 = time.time()
    aborts = execute_mock_mpc_dealer(mesh_corrupt_program, seed=4, mesh=mesh)
    check(aborts == ("abort", "abort"), f"a corrupted MAC on the mesh gave {aborts}")
    return {"n": N_FABRIC, "host_s": secs, "rounds": rounds,
            "abort_host_s": time.time() - t0}


def mesh_ct(mesh) -> dict:
    t0 = time.time()
    ring = bgv.production_ring(device=mesh.device)
    ring_s = time.time() - t0
    u = stack_chunk(ring)
    torch.cuda.synchronize()
    t0 = time.time()
    held = sharded_ct_x_pt(mesh, ring, u, seed=171)
    torch.cuda.synchronize()
    return {"m": ring.m, "slots": ring.slots, "u": u, "held": held,
            "ring_build_s": ring_s, "host_s": time.time() - t0}


def synced_s(t0: float) -> float:
    torch.cuda.synchronize()
    return time.time() - t0


def mesh_sum_program(fabric):
    """`ScalarShare.sum` and `inner_product` at phase 4's 2^20 on the mesh,
    each timed; x and y are opened too, for party 0's Python-int check."""
    n, mesh = N_FABRIC, fabric.mesh
    x = fabric.random_shared_scalars(n)
    y = fabric.random_shared_scalars(n)
    secs = {}
    t0 = time.time()
    total = x.sum()
    secs["sum"] = synced_s(t0)
    t0 = time.time()
    ip = inner_product(fabric, x, y)
    secs["inner_product"] = synced_s(t0)
    s_open, ip_open, xs, ys = (gather(fabric.open_authenticated(v, defer=True), mesh)
                               for v in (total, ip, x, y))
    fabric.verify_deferred()
    ok = None
    if fabric.party_id == 0:
        xs, ys = xs.to_ints(), ys.to_ints()
        ok = (s_open.to_ints() == [sum(xs) % L]
              and ip_open.to_ints() == [sum(a * b for a, b in zip(xs, ys)) % L])
    return s_open.to_ints(), ip_open.to_ints(), ok, secs


def mesh_traced_program(fabric):
    """A traced circuit at 2^16 whose level opens a sum beside a sharded
    product (mid-circuit and in the terminal flush)."""
    n, mesh = N_SLICE, fabric.mesh
    x = fabric.random_shared_scalars(n)
    y = fabric.random_shared_scalars(n)
    t0 = time.time()
    tr = fabric.tracer()
    tx, ty = tr.wrap(x), tr.wrap(y)
    prod = tx * ty
    tsum = prod.sum()
    w = tx * prod.open().as_public() + tsum.open().as_public()
    handles = [tsum.open(), w.open(), tx.open(), ty.open()]
    before = fabric.n_rounds
    tr.run()
    secs = synced_s(t0)
    total, ws, xs, ys = (gather(h.value, mesh).to_ints() for h in handles)
    ok = None
    if fabric.party_id == 0:
        ps = [a * b % L for a, b in zip(xs, ys)]
        ok = total == [sum(ps) % L] and ws == [(a * p + total[0]) % L for a, p in zip(xs, ps)]
    return total, ok, secs, fabric.n_rounds - before


def mesh_poly_eval_program(f, x_eval):
    """`poly_eval` of phase 12's degree-255 f, its coefficients shared as
    the ranks' shards."""
    def prog(fabric):
        dev = fabric.device
        sf = fabric.share_values(Scalar.from_ints(f, device=dev) if fabric.party_id == 0
                                 else None, sender=0, n=len(f))
        t0 = time.time()
        ev = poly_eval(fabric, sf, Scalar.from_ints(x_eval, device=dev))
        secs = synced_s(t0)
        return fabric.open_authenticated(ev).to_ints(), secs
    return prog


def mesh_points_program(gs, ks, idx):
    """share_points + mul_generator + the authenticated MSM at phases 8-9's
    MSM size, with or without a mesh: -> the spot points of mul_generator
    and the MSM (affine ints, gathered), each step's host seconds, and the
    shares to compare with the unsharded run (the MSM's PointShare, the
    gathered mul_generator share coordinates)."""
    def prog(fabric):
        dev, n = fabric.device, len(gs)
        pts = (CurvePoint.generator((n,), device=dev).mul(Scalar.from_ints(gs, device=dev))
               if fabric.party_id == 0 else None)
        secs = {}
        t0 = time.time()
        sp = fabric.share_points(pts, sender=0, n=n)
        secs["share_points"] = synced_s(t0)
        sk = fabric.share_values(Scalar.from_ints(ks, device=dev)
                                 if fabric.party_id == 1 else None, sender=1, n=n)
        t0 = time.time()
        mg = fabric.mul_generator(sk)
        secs["mul_generator"] = synced_s(t0)
        t0 = time.time()
        msm = fabric.msm(sk, sp)
        secs["msm_authenticated"] = synced_s(t0)
        o_mg = fabric.open_authenticated_points(mg, defer=True)
        o_msm = fabric.open_authenticated_points(msm.reshape(1), defer=True)
        fabric.verify_deferred()
        mg = whole(mg, fabric)
        return (affine(whole(o_mg, fabric), idx), affine(o_msm), secs, msm,
                [c.limbs for c in mg.share._coords() + mg.mac._coords()])
    return prog


def mesh_corrupt_point_program(fabric):
    """Party 1 of the last rank adds G to its point MAC shares."""
    n, dev = 16 * fabric.mesh.size, fabric.device
    gen = CurvePoint.generator((n,), device=dev)
    sp = fabric.share_points(gen if fabric.party_id == 0 else None, sender=0, n=n)
    if fabric.party_id == 1 and fabric.mesh.rank == fabric.mesh.size - 1:
        sp = PointShare(sp.share, sp.mac + gen[:sp.size])
    try:
        fabric.open_authenticated_points(sp)
    except AuthenticationError:
        return "abort"
    return "pass"


def mesh_prefix_program(fabric):
    x = fabric.random_shared_scalars(2 * fabric.mesh.size)
    try:
        prefix_product(fabric, x)
    except NotImplementedError as err:
        return str(err)
    return "no error"


def mesh_ops(mesh) -> tuple[dict, tuple]:
    """The operations slice G gave the mesh, at the unsharded phases'
    sizes, each against Python ints; -> their numbers, and the point
    program's results for `mesh_points_vs_unsharded`."""
    out = {}
    (s0, ip0, ok, secs), (s1, ip1, _, _) = execute_mock_mpc_dealer(
        mesh_sum_program, seed=172, mesh=mesh)
    check(ok and (s0, ip0) == (s1, ip1),
          "mesh sum or inner product differs from Python ints or between the parties")
    out["sum_inner_product_2^20_s"] = secs
    (t0, ok, secs, rounds), (t1, _, _, _) = execute_mock_mpc_dealer(
        mesh_traced_program, seed=173, mesh=mesh)
    check(ok and t0 == t1, "the traced mesh circuit differs from Python ints")
    out["traced_2^16"] = {"s": secs, "rounds": rounds}

    rng = np.random.default_rng(81)  # phase 12's inputs
    n = N_MATMUL
    a = Scalar.random((n, n), rng, device=mesh.device)
    b = Scalar.random((n, n), rng, device=mesh.device)
    idx = [(0, 0), (3, 5), (n - 1, n - 1), (100 % n, 200 % n)]
    (e0, secs), (e1, _) = execute_mock_mpc_dealer(matmul_program(a, b, idx), seed=12, mesh=mesh)
    want = [sum(u * v for u, v in zip(a[i].to_ints(), b[:, j].to_ints())) % L for i, j in idx]
    check(e0 == e1 == want, "mesh shared matmul spot entries differ from Python ints")
    out["shared_matmul_512_party0_s"] = secs
    f, g, h, x_eval = poly_inputs()
    dom = EvaluationDomain(132, device=mesh.device)
    (p0, secs), (p1, _) = execute_mock_mpc_dealer(poly_program(f, g, h, x_eval, dom),
                                                  seed=13, mesh=mesh)
    check_poly(p0, p1, f, g, h, x_eval)
    out["poly_s"] = secs
    (v0, secs), (v1, _) = execute_mock_mpc_dealer(mesh_poly_eval_program(f, x_eval),
                                                  seed=14, mesh=mesh)
    check(v0 == v1 == [sum(c * pow(x_eval, i, L) for i, c in enumerate(f)) % L],
          "mesh poly_eval differs from Python ints")
    out["poly_eval_s"] = secs

    rng = np.random.default_rng(41)  # phase 9's discrete logs and scalars
    gs, ks = (Scalar.random(N_MSM, rng, device=mesh.device).to_ints() for _ in range(2))
    pidx = [0, 1, N_MSM // 3, N_MSM // 2, N_MSM - 1]
    prog = mesh_points_program(gs, ks, pidx)
    res = execute_mock_mpc_dealer(prog, seed=15, mesh=mesh)
    for r in res:
        check(r[0] == [ed_mul(ks[i]) for i in pidx], "mesh mul_generator differs from Python ints")
        check(r[1] == [ed_mul(sum(k * g for k, g in zip(ks, gs)) % L)],
              "mesh authenticated MSM differs from Python ints")
    out["points_2^16_party0_s"] = res[0][2]
    aborts = execute_mock_mpc_dealer(mesh_corrupt_point_program, seed=16, mesh=mesh)
    check(aborts == ("abort", "abort"),
          f"a corrupted point MAC on one rank pair of the mesh gave {aborts}")
    msg = execute_mock_mpc_dealer(mesh_prefix_program, seed=17, mesh=mesh)[0]
    check("ark_mpc_tpu/gadgets/products.py:52" in msg, f"prefix_product on the mesh: {msg}")
    return out, (prog, res)


def mesh_points_vs_unsharded(dev, prog, mesh_res) -> dict:
    """The point program on the unsharded fabric on this card: mul_generator's
    gathered shares bit for bit, the MSM's share and MAC projectively, the
    opened points equal; -> party 0's step seconds there."""
    plain = execute_mock_mpc_dealer(prog, seed=15, device=dev)
    for got, want in zip(mesh_res, plain):
        check(got[:2] == want[:2], "mesh points differ from the unsharded fabric's")
        check(all(torch.equal(u, v) for u, v in zip(got[4], want[4])),
              "mesh mul_generator shares differ from the unsharded fabric's")
        check(bool(got[3].share.equals(want[3].share)) and bool(got[3].mac.equals(want[3].mac)),
              "the mesh MSM's shares differ projectively from the unsharded fabric's")
    return plain[0][2]


def mesh_rank(mesh, phase4_vals) -> dict:
    """Phase 17 on one rank; every rank of the mesh runs it.  -> its
    numbers and the launches of its path (counted from 0 here; rank 0's
    comparison with the unsharded point program runs after the count)."""
    backends = {name: dist.get_backend(m.group)
                for name, m in (("mesh", mesh), ("party0", mesh.party(0)),
                                ("party1", mesh.party(1)))}
    check(set(backends.values()) == {"nccl"}, f"mesh groups are not NCCL: {backends}")
    torch.cuda.synchronize()
    fk.reset_launches()
    mk.reset_launches()
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
           "backends": backends, "step": mesh_step(mesh, N_MESH_STEP),
           "fabric": mesh_fabric(mesh, phase4_vals), "ct_x_pt": mesh_ct(mesh)}
    out["ops"], (prog, points) = mesh_ops(mesh)
    torch.cuda.synchronize()
    out["launches"] = {**fk.launch_counts(), **mk.launch_counts()}
    if mesh.rank == 0:
        out["ops"]["points_2^16_unsharded_party0_s"] = mesh_points_vs_unsharded(
            mesh.device, prog, points)
    return out


def phase_mesh(dev, fabric_ref, mats: dict) -> dict:
    """A mesh of every card of this host: one rank in this process on a
    one-card host (NCCL takes one rank a card), else one spawned rank a
    card.  -> rank 0's numbers with the launches of all ranks added."""
    phase4_s, phase4_vals = fabric_ref
    n_ranks = torch.cuda.device_count()
    if n_ranks == 1:
        with tempfile.TemporaryDirectory(prefix="ark-mesh-") as tmp:
            ranks = [run_rank(mesh_rank, 0, 1, os.path.join(tmp, "store"), "cuda",
                              (phase4_vals,), MESH_TIMEOUT)]
    else:
        ranks = launch(mesh_rank, n_ranks, phase4_vals, timeout=2 * MESH_TIMEOUT)
    out = ranks[0]
    out["launches"] = {k: sum(r["launches"][k] for r in ranks) for k in out["launches"]}
    step, fab, ct = out["step"], out["fabric"], out["ct_x_pt"]
    check(sum(r["ct_x_pt"]["held"] for r in ranks) == ct["u"],
          "the ciphertexts were not split over the ranks")
    log(f"[17 mesh] {n_ranks} rank(s) over NCCL ({out['backends']}), rank 0 on {out['device']}")
    log(f"[17 mesh] sharded_mul_mac_step n=2^22 == beaver_mul_step + mac_check_fold (bit for "
        f"bit): sharded {step['sharded_ms']:.3f} ms, unsharded {step['unsharded_ms']:.3f} ms, "
        f"the fold's all_reduce alone {step['all_reduce_ms']:.4f} ms (CUDA events, median "
        f"of {MESH_RUNS})")
    log(f"[17 mesh] fabric n=2^20 mul + 3 deferred opens + default folded check OK in "
        f"{fab['host_s']:.2f} s host time (phase 4: {phase4_s:.2f} s; {fab['rounds']} rounds); "
        f"spot values equal Python ints and phase 4's; corrupted MAC aborted both parties "
        f"({fab['abort_host_s']:.2f} s)")
    log(f"[17 mesh] ct x pt at m = {ct['m']}: {ct['u']} ciphertexts x {ct['slots']} slots split "
        f"over {n_ranks} rank(s), every slot equal to Python ints; ring built in "
        f"{ct['ring_build_s']:.2f} s, pipeline {ct['host_s']:.2f} s host time")
    ops = out["ops"]
    sip, tr, pts = ops["sum_inner_product_2^20_s"], ops["traced_2^16"], ops["points_2^16_party0_s"]
    log(f"[17 mesh] ScalarShare.sum and inner_product at n=2^20 (replicated results) equal "
        f"Python ints, both parties agree: sum {sip['sum']:.3f} s, inner_product "
        f"{sip['inner_product']:.3f} s host time, party 0 (phase 4's 2^20 program: "
        f"{phase4_s:.2f} s)")
    log(f"[17 mesh] traced circuit at n=2^16 opening a sum beside a sharded product (mid-circuit "
        f"and terminal): equal to Python ints, {tr['rounds']} rounds, {tr['s']:.2f} s")
    log(f"[17 mesh] shared_matmul 512^3 (row-sharded, E all-gathered): MAC check passed, spot "
        f"entries equal Python ints; party 0's call {ops['shared_matmul_512_party0_s'] * 1e3:.2f} "
        f"ms host time (phase 12: {mats['shared_matmul_512_party0_ms']:.2f} ms)")
    log(f"[17 mesh] degree-{POLY_DEG} poly_mul, eval, poly_div and the FFT round trip on "
        f"replicated polynomials equal Python ints ({ops['poly_s']:.2f} s; phase 12: "
        f"{mats['poly_s']:.2f} s); poly_eval of sharded coefficients "
        f"{ops['poly_eval_s'] * 1e3:.2f} ms, equal to Python ints")
    log(f"[17 mesh] Ed25519 share_points + mul_generator + msm_authenticated at n=2^16: spot "
        f"points and the MSM equal Python ints; mul_generator's shares equal the unsharded "
        f"fabric's bit for bit and the MSM's projectively; party 0 steps (s): "
        f"{ {k: round(v, 3) for k, v in pts.items()} }, unsharded "
        f"{ {k: round(v, 3) for k, v in ops['points_2^16_unsharded_party0_s'].items()} }; "
        f"a corrupted point MAC on one rank pair aborted both parties; prefix_product still "
        f"raises NotImplementedError")
    return out


# ---------------------------------------------------------------------------
# phase 18: the t-generic prototype BGV stack
# ---------------------------------------------------------------------------

PROTO_KEYS = (12345, 12444)  # the parties' MAC key shares (slot values)
PROTO_BATCH = 64             # polynomials in the timed poly_mul_mod batch


class TamperProof:
    """Party 1's transport: its enc(a) proof (the third frame, after the key
    exchange's two) leaves with one ternary response raised by 1."""

    def __init__(self, inner):
        self.inner, self.count = inner, 0

    def exchange(self, data: bytes) -> bytes:
        self.count += 1
        if self.count == 3:
            items = messages.decode_arrays(data)
            items[5] = items[5].copy()
            items[5][0, 0] += 1
            data = messages.encode_arrays(items)
        return self.inner.exchange(data)


def proto_program(params, tamper: bool = False):
    """Both parties: the prototype key exchange, then a triple pair; ->
    the slot vectors as Python ints and the host seconds of each step."""

    def prog(fabric):
        pid, dev = fabric.party_id, params.device
        transport = TamperProof(fabric.transport) if tamper and pid == 1 else fabric.transport
        gen = torch.Generator(device=dev).manual_seed(1800 + pid)
        key_slots = np.full(params.n, PROTO_KEYS[pid], dtype=np.uint32)
        t0 = time.time()
        st = proto_setup.run_key_exchange(transport, params, key_slots, gen)
        torch.cuda.synchronize()
        t1 = time.time()
        trip, pair = proto_triples.generate_triple_pairs(
            transport, st, PROTO_KEYS[pid], gen)
        torch.cuda.synchronize()
        t2 = time.time()
        # the enc(a) proof alone, at the protocol's size (U = 1, V = 32)
        coeffs = proto_bgv.encode_slots(params, trip.a)[None]
        proof = proto_zk.encrypt_and_prove_batch(params, st.keypair.pk_a, st.keypair.pk_b,
                                                 coeffs, gen, v=proto_triples.ZK_V)
        torch.cuda.synchronize()
        t3 = time.time()
        ok = proto_zk.verify_proof(params, st.keypair.pk_a, st.keypair.pk_b, proof)
        t4 = time.time()
        vals = {name: {k: getattr(t, k).tolist() for k in
                       ("a", "b", "c", "a_mac", "b_mac", "c_mac")}
                for name, t in (("trip", trip), ("pair", pair))}
        return vals, ok, {"key_exchange_s": t1 - t0, "triple_pair_s": t2 - t1,
                          "prove_s": t3 - t2, "verify_s": t4 - t3}

    return prog


def check_proto_triples(r0, r1, t: int) -> None:
    key = sum(PROTO_KEYS) % t
    for name in ("trip", "pair"):
        x0, x1 = r0[name], r1[name]
        a, b, c = ([(u + v) % t for u, v in zip(x0[k], x1[k])] for k in "abc")
        check(c == [u * v % t for u, v in zip(a, b)], f"prototype {name}: c != a b mod t")
        for k, vals in (("a", a), ("b", b), ("c", c)):
            macs = [(u + v) % t for u, v in zip(x0[f"{k}_mac"], x1[f"{k}_mac"])]
            check(macs == [v * key % t for v in vals], f"prototype {name}: mac({k}) != key {k}")
    check(r0["trip"]["a"] == r0["pair"]["a"] and r1["trip"]["a"] == r1["pair"]["a"],
          "the prototype pair does not share a")


def phase_proto_bgv(dev) -> dict:
    """The prototype BGV stack at `test_params()` (N = 1024, 6 x 30-bit q):
    both parties' key exchange and triple pair through `execute_mock_mpc`,
    every slot against Python ints; a tampered proof aborts; the enc(a)
    proof's prove and verify alone; one `poly_mul_mod` batch on the card
    against the same batch on the host CPU (equal, and each timed)."""
    t0 = time.time()
    params = proto_params.test_params(device=dev)
    setup_s = time.time() - t0
    (r0, ok0, s0), (r1, ok1, s1) = execute_mock_mpc(proto_program(params), device=dev)
    check_proto_triples(r0, r1, params.t)
    check(ok0 and ok1, "a prototype enc(a) proof did not verify")
    try:
        execute_mock_mpc(proto_program(params, tamper=True), device=dev)
        check(False, "a tampered prototype proof was accepted")
    except KeyExchangeError as err:
        check("proof of knowledge failed" in str(err), f"tampered proof: {err}")

    cpu = proto_params.test_params(device="cpu")
    rng = np.random.default_rng(1820)
    shape = (PROTO_BATCH, len(cpu.q_primes), cpu.n)
    a, b = (torch.from_numpy(np.stack([rng.integers(0, q, size=(PROTO_BATCH, cpu.n))
                                       for q in cpu.q_primes], axis=1)) for _ in range(2))
    want = ntt.poly_mul_mod(cpu.q_ntt, a, b)
    t0 = time.perf_counter()
    for _ in range(BGV_RUNS):
        ntt.poly_mul_mod(cpu.q_ntt, a, b)
    cpu_ms = (time.perf_counter() - t0) * 1e3 / BGV_RUNS
    ad, bd = a.to(dev), b.to(dev)
    got = ntt.poly_mul_mod(params.q_ntt, ad, bd)
    check(torch.equal(got.cpu(), want), "poly_mul_mod on the card differs from the CPU's")
    card_ms = median_event_ms(lambda: ntt.poly_mul_mod(params.q_ntt, ad, bd))
    out = {"n": params.n, "t": params.t, "q_primes": params.q_primes, "params_s": setup_s,
           "party0": s0, "party1": s1, "poly_mul_mod_shape": list(shape),
           "poly_mul_mod_card_ms": card_ms, "poly_mul_mod_host_cpu_ms": cpu_ms}
    log(f"[18 proto] test_params(): N = {params.n}, t = {params.t}, {len(params.q_primes)} x "
        f"30-bit q (plans built in {setup_s:.3f} s)")
    for pid, st in ((0, s0), (1, s1)):
        log(f"[18 proto] party {pid}: key exchange {st['key_exchange_s']:.3f} s, triple pair "
            f"(enc(a) proof exchange, 7 cross products) {st['triple_pair_s']:.3f} s; the enc(a) "
            f"proof alone: prove {st['prove_s']:.3f} s, verify {st['verify_s']:.3f} s "
            f"(host clock)")
    log(f"[18 proto] c = a b, c' = a b' and every MAC equal Python ints in all {params.n} "
        f"slots; a tampered proof raised KeyExchangeError")
    log(f"[18 proto] poly_mul_mod {shape}: card {card_ms:.3f} ms (CUDA events, median of "
        f"{BGV_RUNS}), host CPU {cpu_ms:.1f} ms (mean of {BGV_RUNS}), equal")
    return out


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
    fabric_ref = timed("4 fabric", phase_fabric, dev)
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

    fk.reset_launches()
    bgv_out, bgv_launches = timed("15 bgv", phase_bgv, dev, card)
    log(f"bgv-path launches: {bgv_launches}")
    check(bgv_launches["mont_mul"] > 0, "mont_mul was never launched on the BGV path")
    rows.append(timed("15 bgv", bgv_kernel_row, dev, bgv_launches["mont_mul"]))

    fk.reset_launches()
    lowgear = timed("16 lowgear", phase_lowgear, dev, card)
    lowgear_launches = fk.launch_counts()
    log(f"lowgear-path launches: {lowgear_launches}")
    check(lowgear_launches["mont_mul"] > 0 and lowgear_launches["beaver_round"] > 0,
          "mont_mul or beaver_round was never launched on the LowGear path")
    lowgear["launches"] = lowgear_launches

    mesh = timed("17 mesh", phase_mesh, dev, fabric_ref, mats)
    log(f"mesh-path launches: {mesh['launches']}")
    check(all(mesh["launches"][k] > 0 for k in ("mont_mul", "beaver_round", "windowed_mul")),
          "mont_mul, beaver_round or windowed_mul was never launched on the mesh path")

    fk.reset_launches()
    mk.reset_launches()
    proto = timed("18 proto", phase_proto_bgv, dev)
    proto["launches"] = {**fk.launch_counts(), **mk.launch_counts()}
    fk.reset_launches()
    execute_mock_mpc(lambda fabric: None, device=dev)  # the mock fabrics' own set-up
    proto["launches_of_an_empty_mock_mpc"] = fk.launch_counts()
    log(f"proto-bgv-path launches: {proto['launches']}; an empty execute_mock_mpc launches "
        f"{proto['launches_of_an_empty_mock_mpc']} (phase 18 runs it twice; the prototype "
        f"itself reaches no hand kernel, as the reference computes it in XLA)")

    log(json.dumps({"headline": headline}))
    log(json.dumps({"points_n_10000": points}))
    log(json.dumps({"msm_n_2^16": msm_times}))
    log(json.dumps({"times_at_n_2^16": plain_2_16}))
    log(json.dumps({"traced": traced, "matmul_poly": mats}))
    log(json.dumps({"bn254": bn254, "tcp": tcp}))
    log(json.dumps({"bgv_production": bgv_out}))
    log(json.dumps({"lowgear": lowgear}))
    log(json.dumps({"mesh": mesh}))
    log(json.dumps({"proto_bgv": proto}))
    log(f"total {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
