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
              version on the same inputs, its bound and its launch count.

The launch counts are those of phases 3-5 (the main path).  The last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ark_mpc_tpu_torch import (
    AuthenticationError,
    Scalar,
    ScalarShare,
    TrustedDealerSource,
    execute_mock_mpc,
    execute_mock_mpc_dealer,
)
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.fields import SCALAR_FIELD as SPEC
from ark_mpc_tpu_torch.fabric import commitment
from ark_mpc_tpu_torch.ops import fp_kernels as fk

L = SPEC.modulus
SOURCE = "ark_mpc_tpu_torch/ops/csrc/fp_kernels.cu"
REPLACES = {
    "mont_mul": "ark_mpc_tpu/ops/fp_kernels.py:63",
    "beaver_round": "ark_mpc_tpu/ops/fp_kernels.py:88",
    "beaver_chain": "ark_mpc_tpu/ops/fp_kernels.py:132",
}
# Device-memory rates by card (NVIDIA data sheets); SXM is the default.
MEM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
INT32_LANES_PER_SM = 64  # 32-bit integer multiplies per clock per SM (sm_90)

N_CMP, K_CMP, N_ODD = 1 << 16, 2, 1000
N_FABRIC = 1 << 20
N_CHAIN, K_CHAIN = 1 << 22, 64
CHAIN_RUNS = 5  # timed runs of the headline after its warm-up


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


def phase_build() -> str:
    t0 = time.time()
    logs = fk.build()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    card = smi("name,power.limit")
    log(f"[1 build] kernels built in {time.time() - t0:.1f} s")
    log(f"card: {card}")
    return card


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
    dev = fabric.device
    sx = fabric.share_values(
        Scalar.from_ints([5], device=dev) if fabric.party_id == 0 else None,
        sender=0, n=1)
    if fabric.party_id == 1:
        sx = ScalarShare(sx.share, sx.mac + Scalar.from_ints(1, device=dev))
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


def phase_report(dev, ch: Chain, launches: dict) -> list:
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    name = torch.cuda.get_device_name(0)
    mem_rate = next((r for k, r in MEM_BYTES_PER_S.items() if k in name), 3.35e12)
    int_rate = props.multi_processor_count * INT32_LANES_PER_SM * clock_mhz * 1e6
    log(f"[6 report] bounds from {mem_rate / 1e12:.2f} TB/s and "
        f"{props.multi_processor_count} SMs x {INT32_LANES_PER_SM} int32 "
        f"multiplies/clock x {clock_mhz:.0f} MHz = {int_rate:.4e} /s")

    # Work per element, in 32-bit multiply instructions: a 32x32->64 product
    # is two (lo and hi), a REDC quotient word one; 64 products per 256-bit
    # product or reduction, 8 quotient words per reduction.
    def ops(products: int, reductions: int) -> int:
        return 2 * 64 * (products + reductions) + 8 * reductions

    e, pre = ch.pre_products()
    chain_args = ch.chain_args(e, pre)
    rnd = Operands(N_FABRIC, 13, dev)
    n, k = N_CHAIN, K_CHAIN
    sms = props.multi_processor_count
    grid = min(-(-n // fk.THREADS), sms * fk.CHAIN_BLOCKS_PER_SM)
    cases = {
        # name: (args, reps, bytes, ops)
        "mont_mul": ((SPEC, e.limbs, ch.a0.share.limbs), 20,
                     3 * 64 * n, ops(1, 1) * n),
        "beaver_round": (rnd.beaver_round(0), 20,
                         (8 * 64 + 2 * 64) * N_FABRIC + 64,
                         ops(6, 4) * N_FABRIC),
        "beaver_chain": (chain_args, 3,
                         (18 * 64 + 2 * 64) * n + 128 + grid * k * 48 * 8,
                         ops(7 + 3, 5) * n * k),
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.time()
    card = phase_build()
    plain_2_16 = phase_kernels(dev)

    fk.reset_launches()
    phase_readme(dev)
    phase_fabric(dev)
    ch, headline = phase_chain(dev, card)
    torch.cuda.synchronize()
    launches = fk.launch_counts()
    log(f"main-path launches: {launches}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")

    rows = phase_report(dev, ch, launches)
    log(json.dumps({"headline": headline}))
    log(json.dumps({"times_at_n_2^16": plain_2_16}))
    log(f"total {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
