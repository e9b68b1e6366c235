#!/usr/bin/env python3
"""Check `window_sums` against its plain version and time its block shapes
and lane counts against an older build on one card.

    python3 tools/window_sums_probe.py [--baseline DIR/curve_kernels.cu ...]
        [--shapes NAME=THREADS,TILE,MIN_BLOCKS ...] [--max-lanes 256 264 ...]

Builds `ark_mpc_tpu_torch/ops/csrc/curve_kernels.cu` ("current"), copies of
it with other block shapes (WS_THREADS threads a block, so WS_THREADS / 4
quads and 64 / quads windows a quad; WS_TILE points a tile of tables in
shared memory; `__launch_bounds__` minimum of WS_MIN_BLOCKS blocks an SM)
and any older versions of the file (each named by its directory, e.g. the
parent commit's, unpacked with `git archive`) with nvcc in parallel, and
prints each build's ptxas registers, stack frame and spills for
`window_sums_kernel`, and each shape's resident blocks and warps per SM.
The current build must equal `window_sums_plain` bit for bit at n = 1, 31,
33, 1000 and 4097 with 1, 17 and 64 windows, each other shape at n = 33,
1000 and 4097 with 64 windows, and at n = 4097 under each lane cap of
`--max-lanes`; an older build (one thread a lane, up to 16,384 lanes, its
own partition) must give the same window totals over its lanes,
projectively, at n = 1000.  Then at n = 2^16, 64 windows, each build is
timed with CUDA events (20 calls after a warm-up) in turns forward and back
(current, A, B, B, A, current), the new shapes at each lane cap.  Prints
the card and one JSON line.  Needs a CUDA card and nvcc; exits non-zero
without them.
"""

from __future__ import annotations

import argparse
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
from ark_mpc_tpu_torch.ops.fp_kernels import _ptrs, _stream  # noqa: E402

TAILS = (1, 31, 33, 1000, 4097)
WINDOWS = (1, 17, 64)
N = 1 << 16
REPS = 20
DEFAULT_SHAPES = ("b=256,32,2", "c=128,32,3")  # beside the current (256, 64, 1)
OLD_LANES = 16384  # the one-thread-per-lane build's lane cap


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


def with_shape(text: str, threads: int, tile: int, min_blocks: int) -> str:
    """The current source with another block shape."""
    for name, value in (("WS_THREADS", threads), ("WS_TILE", tile),
                        ("WS_MIN_BLOCKS", min_blocks)):
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if count != 1:
            raise ValueError(f"{name} is not defined once in {ck.SOURCE}.cu")
    return text


def ptxas_line(log: str) -> str:
    lines = log.splitlines()
    at = next(i for i, line in enumerate(lines)
              if "Compiling entry" in line and "window_sums_kernel" in line)
    return " | ".join(line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                      if "stack frame" in line or "registers" in line)


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if hasattr(lib, "ark_window_sums_config"):
        lib.ark_window_sums.argtypes = [vp, i64, i32, i64, i64, vp]
        lib.ark_window_sums_config.argtypes = [vp, vp, vp, vp]
        lib.ark_window_sums_config.restype = ctypes.c_int
    else:
        lib.ark_window_sums.argtypes = [vp, i64, i32, i64, vp]
    lib.ark_window_sums.restype = ctypes.c_int
    return lib


def shape_of(lib) -> dict:
    vals = [ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)]
    rc = lib.ark_window_sums_config(*map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"window_sums_config failed: CUDA error {rc}")
    threads, tile, blocks, smem = (v.value for v in vals)
    return {"threads": threads, "tile": tile, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32, "smem_bytes": smem}


def current_wrapper(lib):
    """`ck.window_sums` over another build with the current interface."""
    def run(*args, **kw):
        saved = ck._lib
        ck._lib = lambda: lib
        try:
            return ck.window_sums(*args, **kw)
        finally:
            ck._lib = saved
    return run


def old_wrapper(lib):
    """The one-thread-per-lane interface: lane j sums points j, j + L, ...
    with L = min(n, 16384)."""
    def run(canon, x, y, z, t, windows: int = ck.WINDOWS):
        n = canon.shape[1]
        lanes = min(n, OLD_LANES)
        outs = [torch.empty((windows, 16, lanes), dtype=torch.int32, device=canon.device)
                for _ in range(4)]
        rc = lib.ark_window_sums(_ptrs([canon, x, y, z, t] + outs), n, windows, lanes,
                                 _stream(canon.device))
        if rc != 0:
            raise RuntimeError(f"window_sums launch failed: CUDA error {rc}")
        return tuple(outs)
    return run


def operands(n: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    pts = CurvePoint.generator((n,), device=dev).mul(Scalar.random(n, rng, device=dev))
    canon = Scalar.random(n, rng, device=dev).canonical_limbs().contiguous()
    return (canon, *[c.limbs.contiguous() for c in pts._coords()])


def same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def totals(sums) -> CurvePoint:
    windows, lanes = sums[0].shape[0], sums[0].shape[2]
    return CurvePoint.from_coords([a.permute(1, 0, 2) for a in sums],
                                  (windows, lanes)).sum(axis=1)


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


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", type=Path, nargs="*", default=[],
                        help="older versions of curve_kernels.cu, each named by "
                             "its directory")
    parser.add_argument("--shapes", nargs="*", default=list(DEFAULT_SHAPES),
                        help="NAME=THREADS,TILE,MIN_BLOCKS block shapes to build")
    parser.add_argument("--max-lanes", type=int, nargs="*", default=[ck.WS_MAX_LANES],
                        help="lane caps (WS_MAX_LANES) to time the new shapes at")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("window_sums_probe: needs a CUDA card", file=sys.stderr)
        return 1
    text = (_build.SRC_DIR / f"{ck.SOURCE}.cu").read_text()
    jobs = {}
    for spec in opts.shapes:
        name, dims = spec.split("=")
        jobs[name] = build(name, with_shape(text, *map(int, dims.split(","))))
    for path in opts.baseline:
        jobs[path.parent.name] = build(path.parent.name, path.read_text())
    logs = {"current": _build.build([ck.SOURCE])[ck.SOURCE]}
    libs = {"current": ck._lib()}
    for name, (proc, path) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            print(logs[name], file=sys.stderr)
            return 1
        libs[name] = load(path)
    ptxas = {name: ptxas_line(log) for name, log in logs.items()}
    shapes = {name: shape_of(lib) for name, lib in libs.items()
              if hasattr(lib, "ark_window_sums_config")}
    for name in libs:
        print(f"[{name}] ptxas window_sums_kernel: {ptxas[name]}; "
              f"{shapes.get(name, 'one thread a lane')}", flush=True)
    runs = {name: (current_wrapper(lib) if name in shapes else old_wrapper(lib))
            for name, lib in libs.items()}

    dev = torch.device("cuda")
    tails = {n: operands(n, n, dev) for n in TAILS}
    for name, run in runs.items():
        if name not in shapes:
            continue
        cases = ([(n, w) for n in TAILS for w in WINDOWS] if name == "current"
                 else [(n, 64) for n in TAILS[2:]])
        bad = [c for c in cases if not same(run(*tails[c[0]], windows=c[1]),
                                            ck.window_sums_plain(*tails[c[0]], windows=c[1]))]
        cap = ck.WS_MAX_LANES
        try:
            for lanes in opts.max_lanes:
                ck.WS_MAX_LANES = lanes
                if not same(run(*tails[4097]), ck.window_sums_plain(*tails[4097])):
                    bad.append((4097, 64, f"max lanes {lanes}"))
        finally:
            ck.WS_MAX_LANES = cap
        if bad:
            print(f"[{name}] differs from window_sums_plain at {bad}", file=sys.stderr)
            return 1
        print(f"[{name}] equals window_sums_plain at (n, windows) {cases} and at "
              f"n=4097 under max lanes {opts.max_lanes}", flush=True)
    want = totals(ck.window_sums(*tails[1000]))
    for name, run in runs.items():
        if name not in shapes:
            if not bool(totals(run(*tails[1000])).equals(want).all()):
                print(f"[{name}] window totals differ from the current build", file=sys.stderr)
                return 1
            print(f"[{name}] window totals equal the current build's projectively "
                  "at n=1000", flush=True)

    timed = operands(N, 7, dev)
    for _ in range(3):  # clocks up before the first turn
        ck.window_sums(*timed)
    torch.cuda.synchronize()
    times: dict = {}
    cap = ck.WS_MAX_LANES
    try:
        for name in list(runs) + list(runs)[::-1]:
            for lanes in (opts.max_lanes if name in shapes else [OLD_LANES]):
                ck.WS_MAX_LANES = lanes
                key = f"{name}@{lanes}"
                times.setdefault(key, []).append(time_ms(runs[name], timed))
                print(f"[{key}] {times[key][-1]:.4f} ms a call at n={N}, 64 windows, "
                      f"{min(N, lanes) if name not in shapes else ck.default_lanes(N)} "
                      "lanes", flush=True)
    finally:
        ck.WS_MAX_LANES = cap
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"window_sums_ms": times, "ptxas": ptxas, "shapes": shapes,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
