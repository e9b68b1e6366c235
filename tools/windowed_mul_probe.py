#!/usr/bin/env python3
"""Check `windowed_mul` at its tail sizes and time it against an older build
on one card.

    python3 tools/windowed_mul_probe.py [--baseline DIR/curve_kernels.cu ...]

Builds `ark_mpc_tpu_torch/ops/csrc/curve_kernels.cu` ("current") and any
other versions of the same file (each named by its directory, e.g. the
parent commit's, unpacked with `git archive`) with nvcc in parallel, and
prints each build's ptxas registers, stack frame and spills for
`windowed_mul_kernel` (with `--sass`, also the opcode counts of its SASS
from `cuobjdump`).  The current build must equal `windowed_mul_plain`
bit for bit at n = 1, 3, 33, 1000, 4097 with 1, 17 and 64 windows, the
others at n = 1000.  Then each build is timed at n = 2^16 and n = 1000, 64
windows, with CUDA events (10 calls after a warm-up), in turns forward and
back (current, A, B, B, A, current).  Prints the current launch (from
`windowed_launch_config`), the card and one JSON line.  Needs a CUDA card
and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ark_mpc_tpu_torch.algebra.curve import CurvePoint  # noqa: E402
from ark_mpc_tpu_torch.algebra.scalar import Scalar  # noqa: E402
from ark_mpc_tpu_torch.ops import _build  # noqa: E402
from ark_mpc_tpu_torch.ops import curve_kernels as ck  # noqa: E402

TAILS = (1, 3, 33, 1000, 4097)
WINDOWS = (1, 17, 64)
SIZES = (1 << 16, 1000)
REPS = 10


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
    at = next(i for i, line in enumerate(lines)
              if "Compiling entry" in line and "windowed_mul_kernel" in line)
    return " | ".join(line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                      if "stack frame" in line or "registers" in line)


def sass_mix(lib: Path) -> dict:
    """Opcode counts of `windowed_mul_kernel`'s SASS (cuobjdump beside
    nvcc), most frequent first."""
    out = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
                          str(lib)], capture_output=True, text=True, check=True).stdout
    out = next(part for part in out.split("Function : ")[1:]
               if "windowed_mul_kernel" in part.split("\n", 1)[0])
    ops = collections.Counter(
        m.group(1).split(".")[0]
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", out))
    return dict(ops.most_common())


def operands(n: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    pts = CurvePoint.generator((n,), device=dev).mul(Scalar.random(n, rng, device=dev))
    canon = Scalar.random(n, rng, device=dev).canonical_limbs().contiguous()
    return (canon, *[c.limbs.contiguous() for c in pts._coords()])


def same(args, windows: int) -> bool:
    got = ck.windowed_mul(*args, windows=windows)
    want = ck.windowed_mul_plain(*args, windows=windows)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def time_ms(args) -> float:
    ck.windowed_mul(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        ck.windowed_mul(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", type=Path, nargs="*", default=[],
                        help="other versions of curve_kernels.cu, each named by "
                             "its directory")
    parser.add_argument("--sass", action="store_true",
                        help="print each build's SASS opcode counts")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("windowed_mul_probe: needs a CUDA card", file=sys.stderr)
        return 1
    jobs = {path.parent.name: build(path.parent.name, path.read_text())
            for path in opts.baseline}
    # the current source through the package's own build, in parallel
    logs = {"current": _build.build([ck.SOURCE])[ck.SOURCE]}
    libs = {"current": ck._lib()}
    paths = {"current": _build.library_path(ck.SOURCE)}
    for name, (proc, path) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            print(logs[name], file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(path))
        lib.ark_windowed_mul.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_void_p]
        lib.ark_windowed_mul.restype = ctypes.c_int
        libs[name] = lib
        paths[name] = path
    ptxas = {name: ptxas_line(log) for name, log in logs.items()}
    for name, line in ptxas.items():
        print(f"[{name}] ptxas windowed_mul_kernel: {line}", flush=True)
    mix = {name: sass_mix(path) for name, path in paths.items()} if opts.sass else {}
    for name, ops in mix.items():
        print(f"[{name}] SASS opcodes ({sum(ops.values())}): {ops}", flush=True)

    dev = torch.device("cuda")
    cfg = ck.windowed_launch_config(SIZES[0], dev)
    print(f"[current] launch at n={SIZES[0]}: {cfg}", flush=True)
    tails = {n: operands(n, n, dev) for n in TAILS}
    for name, lib in libs.items():
        ck._lib = lambda lib=lib: lib
        cases = ([(n, w) for n in TAILS for w in WINDOWS] if name == "current"
                 else [(1000, 64)])
        bad = [c for c in cases if not same(tails[c[0]], c[1])]
        if bad:
            print(f"[{name}] differs from windowed_mul_plain at (n, windows) {bad}",
                  file=sys.stderr)
            return 1
        print(f"[{name}] equals windowed_mul_plain at (n, windows) {cases}", flush=True)

    timed = {n: operands(n, 7 + n, dev) for n in SIZES}
    order = list(libs) + list(libs)[::-1]
    times = {name: {str(n): [] for n in SIZES} for name in libs}
    for name in order:
        ck._lib = lambda lib=libs[name]: lib
        for n in SIZES:
            times[name][str(n)].append(time_ms(timed[n]))
        print(f"[{name}] ms a call, 64 windows: "
              + ", ".join(f"n={n} {times[name][str(n)][-1]:.4f}" for n in SIZES),
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"windowed_mul_ms": times, "ptxas": ptxas, "launch": cfg,
                      "sass_opcodes": mix, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
