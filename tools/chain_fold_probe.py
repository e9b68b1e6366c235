#!/usr/bin/env python3
"""Time the `beaver_chain` kernel's two ways of summing the fold on one card.

    python3 tools/chain_fold_probe.py

The kernel sums each round's 512-bit fold products over a warp before it
adds them into its block's accumulators.  This script builds
`ark_mpc_tpu_torch/ops/csrc/fp_kernels.cu` twice with nvcc:

  scratch  as committed: the words go through a padded shared scratch,
           one shuffle and one 16-lane atomic per product;
  redux    the same source with the fold of the first CUDA chain kernel:
           `redux.sync` over each word's 16-bit halves (32 per product) and
           a single-lane 64-bit atomic per word.

It prints each build's ptxas registers and spills, checks both against
`beaver_chain_plain` (n = 100,003, 3 rounds, bit for bit), times each at
(16, 2^22) x 64 rounds with CUDA events (3 calls after a warm-up, in turns
scratch, redux, redux, scratch), and prints one JSON line.  Needs a CUDA card
and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ark_mpc_tpu_torch.algebra.fields import SCALAR_FIELD as SPEC  # noqa: E402
from ark_mpc_tpu_torch.algebra.scalar import Scalar  # noqa: E402
from ark_mpc_tpu_torch.ops import _build  # noqa: E402
from ark_mpc_tpu_torch.ops import fp_kernels as fk  # noqa: E402

REDUX_FOLD = """__device__ __forceinline__ void fold_add(unsigned long long* acc,
                                         uint32_t* scratch,
                                         const uint32_t a[NW],
                                         const uint32_t b[NW], int lane) {
  uint32_t p[FOLD_WORDS];
  mul_wide(a, b, p);
#pragma unroll
  for (int k = 0; k < FOLD_WORDS; ++k) {
    const uint32_t lo = __reduce_add_sync(0xffffffffu, p[k] & 0xFFFFu);
    const uint32_t hi = __reduce_add_sync(0xffffffffu, p[k] >> 16);
    if (lane == k) {
      atomicAdd(acc + k, static_cast<unsigned long long>(lo) +
                             (static_cast<unsigned long long>(hi) << 16));
    }
  }
}
"""


def sources() -> dict[str, str]:
    src = (_build.SRC_DIR / "fp_kernels.cu").read_text()
    start = src.index("__device__ __forceinline__ void fold_add(")
    end = src.index("\n}\n", start) + 3
    return {"scratch": src, "redux": src[:start] + REDUX_FOLD + src[end:]}


def build(name: str, text: str):
    """nvcc one variant; -> (Popen, library path)."""
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"fold_{name}.cu"
    src.write_text(text)
    lib = out / f"libfold_{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ark_mont_mul.argtypes = [vp, vp, vp, i64, vp, vp]
    lib.ark_beaver_chain.argtypes = [vp, i64, i32, i32, vp, vp]
    lib.ark_beaver_chain_config.argtypes = [i32, vp, vp]
    for fn in (lib.ark_mont_mul, lib.ark_beaver_chain, lib.ark_beaver_chain_config):
        fn.restype = ctypes.c_int
    return lib


def use(lib: ctypes.CDLL) -> None:
    """Route the wrapper's launches through `lib`."""
    fk._lib = lambda: lib
    fk._chain_occupancy.cache_clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_fold_probe: needs a CUDA card", file=sys.stderr)
        return 1
    jobs = {name: build(name, text) for name, text in sources().items()}
    libs, ptxas = {}, {}
    for name, (proc, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and "beaver_chain_kernel" in line)
        ptxas[name] = " | ".join(line.split(":", 1)[-1].strip()
                                 for line in lines[at + 1:at + 3])
        libs[name] = load(path)
        print(f"[{name}] ptxas: {ptxas[name]}", flush=True)

    dev = torch.device("cuda")
    n, k = 1 << 22, 64
    rng = np.random.default_rng(0)
    arr = [Scalar.random(n, rng, device=dev).limbs for _ in range(18)]
    keys = [Scalar.random((), rng, device=dev).limbs for _ in range(2)]
    args = (SPEC, k, *arr[:17], *keys, arr[17])
    m = 100_003
    small = (SPEC, 3, *[a[:, :m].contiguous() for a in arr[:17]], *keys,
             arr[17][:, :m].contiguous())
    want = fk.beaver_chain_plain(*small)
    times = {name: [] for name in libs}
    for name in ("scratch", "redux", "redux", "scratch"):
        use(libs[name])
        if not times[name]:
            got = fk.beaver_chain(*small)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                print(f"[{name}] differs from beaver_chain_plain", file=sys.stderr)
                return 1
        fk.beaver_chain(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fk.beaver_chain(*args)
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / 3)
        print(f"[{name}] {times[name][-1]:.3f} ms a call at n=2^22 x {k} rounds",
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"chain_fold_ms": times, "ptxas": ptxas, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
