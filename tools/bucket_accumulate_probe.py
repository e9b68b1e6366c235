#!/usr/bin/env python3
"""Check `bucket_accumulate` against its plain version and time it against
older builds and at other chunk sizes on one card.

    python3 tools/bucket_accumulate_probe.py [--baseline DIR/curve_kernels.cu ...]
                                             [--chunks 8 16 32]

Builds `ark_mpc_tpu_torch/ops/csrc/curve_kernels.cu` ("current") and any
other versions of the same file (each named by its directory, e.g. the
parent commit's, unpacked with `git archive`, or variants of the current
one) with nvcc in parallel, and prints each build's ptxas registers, stack
frame and spills for its bucket kernel.  The current build must equal
`bucket_accumulate_plain` bit for bit at n = 1, 17, 4097 under four digit
layouts (random scalars, a top window of digits 1..15, every scalar equal,
segments of exactly C and C + 1 points) and at n = 2^16 (random).  A build
with the chunked passes' entry point runs through the current wrapper and
must equal the plain version at n = 4097 too; an older build (one thread
per bucket, its own summation order) must equal the current one
projectively at n = 1000.  Then at n = 2^16, 32 windows x 256 buckets,
each build is timed with CUDA events (30 calls after a warm-up) in turns
forward and back (current, A, B, B, A, current), and the current build at
each chunk size of `--chunks` (forward and back), with the time of each
pass and the host's time to enqueue a call.  Prints the launch (from
`bucket_launch_config`), the card and one JSON line.  Needs a CUDA card and
nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ark_mpc_tpu_torch.algebra.curve import CurvePoint  # noqa: E402
from ark_mpc_tpu_torch.algebra.scalar import Scalar  # noqa: E402
from ark_mpc_tpu_torch.ops import _build  # noqa: E402
from ark_mpc_tpu_torch.ops import curve_kernels as ck  # noqa: E402
from ark_mpc_tpu_torch.ops import msm_kernels as mk  # noqa: E402
from ark_mpc_tpu_torch.ops.fp_kernels import _ptrs, _stream  # noqa: E402

TAILS = (1, 17, 4097)
LAYOUTS = ("random", "top", "cluster", "chunk_and_one_more")
N = 1 << 16
REPS = 30
KERNEL_NAMES = ("bucket_chunk_kernel", "bucket_accumulate_kernel")


def build(name: str, text: str):
    """nvcc one variant; -> (Popen, library path)."""
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"curve_{name}.cu"
    src.write_text(text)
    lib = out / f"libcurve_{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def ptxas_line(log: str) -> str:
    lines = log.splitlines()
    at = next(i for i, line in enumerate(lines) if "Compiling entry" in line
              and any(k in line for k in KERNEL_NAMES))
    return " | ".join(line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                      if "stack frame" in line or "registers" in line)


def old_accumulate(lib):
    """The one-launch interface of builds before the chunked passes: points
    (n, 4, 16) limbs, one thread per (window, bucket)."""
    def run(idx, off, *coords):
        W, nb = off.shape[0], off.shape[1] - 1
        n = coords[0].shape[1]
        pts = torch.stack(coords).permute(2, 0, 1).contiguous()
        outs = [torch.empty((16, W, nb), dtype=torch.int32, device=idx.device)
                for _ in range(4)]
        rc = lib.ark_bucket_accumulate(_ptrs([idx.contiguous(), off.contiguous(), pts] + outs),
                                       n, W, nb, _stream(idx.device))
        if rc != 0:
            raise RuntimeError(f"bucket_accumulate launch failed: CUDA error {rc}")
        return tuple(outs)
    return run


def chunked(lib):
    """The current wrapper over another build of the chunked kernel."""
    def run(*args):
        saved = mk._lib
        mk._lib = lambda: lib
        try:
            return mk.bucket_accumulate(*args)
        finally:
            mk._lib = saved
    return run


def digits_canon(digits: np.ndarray, dev) -> torch.Tensor:
    """(32, n) 8-bit digits -> (16, n) canonical limbs."""
    d = digits.astype(np.int64)
    return torch.from_numpy((d[0::2] | (d[1::2] << 8)).astype(np.int32)).to(dev)


def operands(n: int, layout: str, seed: int, dev):
    rng = np.random.default_rng(seed)
    pts = CurvePoint.generator((n,), device=dev).mul(Scalar.random(n, rng, device=dev))
    if layout == "random":
        canon = Scalar.random(n, rng, device=dev).canonical_limbs().contiguous()
    elif layout == "top":
        dg = rng.integers(0, 256, (32, n))
        dg[31] = rng.integers(1, 16, n)
        canon = digits_canon(dg, dev)
    elif layout == "cluster":
        canon = digits_canon(np.repeat(rng.integers(0, 256, (32, 1)), n, 1), dev)
    else:  # buckets of exactly C and C + 1 points
        seq = np.concatenate([np.full(mk.CHUNK + (d & 1), d) for d in range(1, 256)])
        canon = digits_canon(np.stack([rng.permutation(np.resize(seq, n))
                                       for _ in range(32)]), dev)
    idx, off = mk.bucket_prologue(canon)
    return (idx, off, *[c.limbs.contiguous() for c in pts._coords()])


def same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def time_ms(fn, args) -> float:
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def host_ms(fn, args) -> float:
    """Host milliseconds to enqueue one call (REPS calls from an idle card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn(*args)
    ms = (time.perf_counter() - t0) * 1e3 / REPS
    torch.cuda.synchronize()
    return ms


def pass_ms(args) -> list:
    """Mean ms of each pass over REPS calls."""
    passes = mk.bucket_passes(args[2].shape[1])
    total = [0.0] * passes
    for _ in range(REPS):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(passes + 1)]
        mk.bucket_accumulate(*args, marks=marks)
        torch.cuda.synchronize()
        for k in range(passes):
            total[k] += marks[k].elapsed_time(marks[k + 1]) / REPS
    return total


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", type=Path, nargs="*", default=[],
                        help="older versions of curve_kernels.cu, each named by "
                             "its directory")
    parser.add_argument("--chunks", type=int, nargs="*", default=[8, 16, 32],
                        help="chunk sizes to time the current build at")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("bucket_accumulate_probe: needs a CUDA card", file=sys.stderr)
        return 1
    jobs = {path.parent.name: build(path.parent.name, path.read_text())
            for path in opts.baseline}
    logs = {"current": _build.build([ck.SOURCE])[ck.SOURCE]}
    runs = {"current": mk.bucket_accumulate}
    for name, (proc, path) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            print(logs[name], file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(path))
        if hasattr(lib, "ark_bucket_chunk"):
            lib.ark_bucket_chunk.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.ark_bucket_chunk.restype = ctypes.c_int
            runs[name] = chunked(lib)
        else:
            lib.ark_bucket_accumulate.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.ark_bucket_accumulate.restype = ctypes.c_int
            runs[name] = old_accumulate(lib)
    ptxas = {name: ptxas_line(log) for name, log in logs.items()}
    for name, line in ptxas.items():
        print(f"[{name}] ptxas: {line}", flush=True)

    dev = torch.device("cuda")
    cfg = mk.bucket_launch_config(N, dev)
    print(f"[current] launch at n={N}: {cfg}", flush=True)
    for n in TAILS:
        for layout in LAYOUTS:
            args = operands(n, layout, n, dev)
            if not same(mk.bucket_accumulate(*args), mk.bucket_accumulate_plain(*args)):
                print(f"[current] differs from plain at n={n}, {layout}", file=sys.stderr)
                return 1
    timed = operands(N, "random", 7, dev)
    if not same(mk.bucket_accumulate(*timed), mk.bucket_accumulate_plain(*timed)):
        print(f"[current] differs from plain at n={N}", file=sys.stderr)
        return 1
    print(f"[current] equals bucket_accumulate_plain at n={TAILS} x {LAYOUTS} "
          f"and n={N} (random), chunk {mk.CHUNK}", flush=True)
    check = operands(1000, "random", 3, dev)
    want = CurvePoint.from_coords(mk.bucket_accumulate(*check), (32, 256))
    tail = operands(4097, "top", 4097, dev)
    for name in list(runs)[1:]:
        if runs[name].__qualname__.startswith("chunked"):
            if not same(runs[name](*tail), mk.bucket_accumulate_plain(*tail)):
                print(f"[{name}] differs from plain at n=4097", file=sys.stderr)
                return 1
            print(f"[{name}] equals bucket_accumulate_plain at n=4097", flush=True)
        got = CurvePoint.from_coords(runs[name](*check), (32, 256))
        if not bool(got.equals(want).all()):
            print(f"[{name}] differs from the current build projectively", file=sys.stderr)
            return 1
        print(f"[{name}] equals the current build projectively at n=1000", flush=True)

    for _ in range(3 * REPS):  # clocks up before the first turn
        mk.bucket_accumulate(*timed)
    torch.cuda.synchronize()
    times = {name: [] for name in runs}
    host = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name].append(time_ms(runs[name], timed))
        host[name].append(host_ms(runs[name], timed))
        print(f"[{name}] {times[name][-1]:.4f} ms a call at n={N} (host enqueue "
              f"{host[name][-1]:.4f} ms)", flush=True)
    chosen = mk.CHUNK
    by_chunk = {c: {"ms": [], "pass_ms": None, "passes": None} for c in opts.chunks}
    try:
        for c in opts.chunks + opts.chunks[::-1]:
            mk.CHUNK = c
            if by_chunk[c]["pass_ms"] is None:
                args = operands(4097, "top", c, dev)
                if not same(mk.bucket_accumulate(*args), mk.bucket_accumulate_plain(*args)):
                    print(f"[current, chunk {c}] differs from plain at n=4097", file=sys.stderr)
                    return 1
            by_chunk[c]["ms"].append(time_ms(mk.bucket_accumulate, timed))
            if by_chunk[c]["pass_ms"] is None:
                by_chunk[c]["pass_ms"] = pass_ms(timed)
                by_chunk[c]["passes"] = mk.bucket_passes(N)
            print(f"[current, chunk {c}] {by_chunk[c]['ms'][-1]:.4f} ms a call, "
                  f"passes (ms): {[round(v, 4) for v in by_chunk[c]['pass_ms']]}",
                  flush=True)
    finally:
        mk.CHUNK = chosen
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"bucket_accumulate_ms": times, "host_enqueue_ms": host,
                      "by_chunk": by_chunk,
                      "ptxas": ptxas, "launch": cfg, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
