#!/usr/bin/env python3
"""Compare shapes of the `ladder` kernel on one card, with older builds.

    python3 tools/ladder_probe.py [--sass] [--baseline DIR/curve_kernels.cu ...]

Builds `ark_mpc_tpu_torch/ops/csrc/curve_kernels.cu` ("current": one
thread a point, P's cached form in shared memory, products on PTX carry
chains), text variants of it, and any `--baseline` versions of the file
(each named by its directory, e.g. the parent commit's, unpacked with `git
archive`), all with nvcc in parallel:

  regs_cc     P's cached form in registers instead of shared memory;
  smem_cxx    the C++ products (`fe_mul_loose`, `fe_sqr_loose`: 64-bit
              sums) instead of the carry chains;
  regs_cxx    both of the above;
  quad_cxx    four threads a point on `windowed_mul`'s quad core
              (`quad_double`, `quad_add_cached`, lane k holding coordinate k
              of P's cached form; the bit a shuffle from the lane that holds
              its scalar word), 32 points a block;
  quad_cc     the quad with every product on the carry chains.

Every build goes through the same C entry point (`ark_ladder`) and the
current wrapper.  Prints each build's ptxas registers, stack frame and
spills for `ladder_kernel` (with `--sass`, also its SASS opcode counts from
`cuobjdump`, and which of the file's other kernels compile to other SASS
than in the current build) and its launch (resident blocks and warps per
SM, waves at 2^16) where the build reports one.  Every build must equal `ladder_plain`
bit for bit at n = 1, 31, 33, 127, 129, 4097 (the current one's failure
exits non-zero; another's drops it from the timing).  Then each build is
timed at n = 2^16 and n = 1000 with CUDA events (10 calls after a warm-up)
in turns forward and back (current, A, B, ..., B, A, current).  Prints the
card and one JSON line.  Needs a CUDA card and nvcc; exits non-zero
without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ark_mpc_tpu_torch.algebra import limbs as lb  # noqa: E402
from ark_mpc_tpu_torch.algebra.curve import CurvePoint  # noqa: E402
from ark_mpc_tpu_torch.algebra.fields import SCALAR_FIELD  # noqa: E402
from ark_mpc_tpu_torch.algebra.scalar import Scalar  # noqa: E402
from ark_mpc_tpu_torch.ops import _build  # noqa: E402
from ark_mpc_tpu_torch.ops import curve_kernels as ck  # noqa: E402
from probe_builds import build, first_difference, replace, sass, sass_mix  # noqa: E402

TAILS = (1, 31, 33, 127, 129, 4097)
SIZES = (1 << 16, 1000)
REPS = 10
L = SCALAR_FIELD.modulus
EDGE = [0, 1, 2, L - 1, (1 << 253) - 1, L]

LADDER_HEAD = "// ladder: out = s * P"
NEXT_HEAD = "// window_sums: block j is lane j"
KERNEL_HEAD = "__global__ void __launch_bounds__(LADDER_THREADS, LADDER_MIN_BLOCKS)\nladder_kernel("

QUAD_KERNEL = r"""__global__ void __launch_bounds__(LADDER_THREADS, LADDER_MIN_BLOCKS)
ladder_kernel(const int32_t* __restrict__ canon, Coords p, OutCoords o,
              int64_t n) {
  __shared__ __align__(16) uint32_t xch[(LADDER_THREADS / 32) * XCH_WARP_WORDS];
  const int t = threadIdx.x;
  const Quad Q{xch + (t >> 5) * XCH_WARP_WORDS, (t & 31) >> 2, t & (QUAD - 1)};
  const int64_t point = static_cast<int64_t>(blockIdx.x) * LADDER_POINTS + (t >> 2);
  const int64_t j = point < n ? point : n - 1;
  // lane k holds scalar words 2k, 2k + 1: bits 64k .. 64k + 63
  const uint32_t s0 = static_cast<uint32_t>(__ldg(canon + (4 * Q.k) * n + j)) |
                      (static_cast<uint32_t>(__ldg(canon + (4 * Q.k + 1) * n + j)) << 16);
  const uint32_t s1 = static_cast<uint32_t>(__ldg(canon + (4 * Q.k + 2) * n + j)) |
                      (static_cast<uint32_t>(__ldg(canon + (4 * Q.k + 3) * n + j)) << 16);
  const Pt P = pt_load(p, n, j);
  const Fe mine = fe_pick(Q.k, fe_sub_loose(P.y, P.x), fe_add_loose(P.y, P.x),
                          fe_mul_loose(P.t, fe_d2()), P.z);
  const int src = (t & 31) & ~(QUAD - 1);
  Pt acc = pt_identity();
#pragma unroll 1
  for (int i = 255; i >= 0; --i) {
    quad_double(Q, acc);
    Pt sum = acc;
    quad_add_cached(Q, sum, mine);
    const uint32_t word = ((i >> 5) & 1) ? s1 : s0;
    const uint32_t m =
        0u - __shfl_sync(0xFFFFFFFFu, (word >> (i & 31)) & 1u, src + (i >> 6));
    acc = Pt{fe_select(sum.x, acc.x, m), fe_select(sum.y, acc.y, m),
             fe_select(sum.z, acc.z, m), fe_select(sum.t, acc.t, m)};
  }
  if (point < n) {
    int32_t* dst = Q.k == 0 ? o.c[0] : Q.k == 1 ? o.c[1] : Q.k == 2 ? o.c[2] : o.c[3];
    fe_store(dst, n, j, fe_canon(fe_pick(Q.k, acc.x, acc.y, acc.z, acc.t)));
  }
}
"""


def ladder_span(text: str) -> tuple[int, int]:
    return text.index(LADDER_HEAD), text.index(NEXT_HEAD)


def in_registers(text: str) -> str:
    """P's cached form kept in registers."""
    lo, hi = ladder_span(text)
    for old, new in (
            ("  __shared__ uint4 cache[NW * LADDER_THREADS];\n", ""),
            ("  column_store(cache + threadIdx.x, Pt{", "  const Pt q = Pt{"),
            ("fe_mul_cc(P.t, fe_d2()), P.z});", "fe_mul_cc(P.t, fe_d2()), P.z};"),
            ("  const uint32_t col = static_cast<uint32_t>(__cvta_generic_to_shared("
             "cache + threadIdx.x));\n", ""),
            ("column_load(col)", "q")):
        text = replace(text, old, new, lo, hi)
        lo, hi = ladder_span(text)
    return text


def cxx_products(text: str) -> str:
    """The ladder's products on the C++ 64-bit sums."""
    lo, hi = ladder_span(text)
    text = replace(text, "fe_mul_cc(", "fe_mul_loose(", lo, hi)
    lo, hi = ladder_span(text)
    return replace(text, "fe_sqr_cc(", "fe_sqr_loose(", lo, hi)


def quad(text: str) -> str:
    """The quad-core ladder: 4 threads a point."""
    text = replace(text, "constexpr int LADDER_POINTS = LADDER_THREADS;",
                   "constexpr int LADDER_POINTS = LADDER_THREADS / QUAD;")
    start = text.index(KERNEL_HEAD)
    end = text.index("\n}\n", start) + 3
    return text[:start] + QUAD_KERNEL + text[end:]


def cc_everywhere(text: str) -> str:
    """Every product after the Edwards formulas' header on the carry chains
    (the quad helpers' by their default product)."""
    lo = text.index("// Edwards formulas")
    text = replace(text, "fe_mul_loose(", "fe_mul_cc(", lo)
    return replace(text, "template <class Prod = CxxProducts>",
                   "template <class Prod = CcProducts>", lo)


VARIANTS = {
    "regs_cc": in_registers,
    "smem_cxx": cxx_products,
    "regs_cxx": lambda t: cxx_products(in_registers(t)),
    "quad_cxx": quad,
    "quad_cc": lambda t: cc_everywhere(quad(t)),
}


def ptxas_line(log: str) -> str:
    lines = log.splitlines()
    at = next(i for i, line in enumerate(lines)
              if "Compiling entry" in line and "ladder_kernel" in line)
    return " | ".join(line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                      if "stack frame" in line or "registers" in line)


OTHER_KERNELS = ("windowed_mul_kernel", "window_sums_kernel", "bucket_chunk_kernel",
                 "bucket_window_kernel", "bucket_horner_kernel")


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.ark_ladder.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.ark_ladder.restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, n: int) -> dict | None:
    """The build's `ladder_launch_config` at n points, where it reports
    one."""
    if not hasattr(lib, "ark_ladder_config"):
        return None
    ck._lib = lambda: lib
    ck._ladder_occupancy.cache_clear()
    return ck.ladder_launch_config(n, "cuda")


def operands(n: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    pts = CurvePoint.generator((n,), device=dev).mul(Scalar.random(n, rng, device=dev))
    canon = Scalar.random(n, rng, device=dev).canonical_limbs().contiguous()
    if n >= len(EDGE):  # the edge scalars at the front
        edge = torch.from_numpy(lb.ints_to_limb_array(EDGE).astype(np.int32)).to(dev)
        canon[:, :len(EDGE)] = edge
    return (canon, *[c.limbs.contiguous() for c in pts._coords()])


def time_ms(args) -> float:
    ck.ladder(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        ck.ladder(*args)
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
        print("ladder_probe: needs a CUDA card", file=sys.stderr)
        return 1
    current = (_build.SRC_DIR / f"{ck.SOURCE}.cu").read_text()
    texts = {name: patch(current) for name, patch in VARIANTS.items()}
    texts.update({path.parent.name: path.read_text() for path in opts.baseline})
    jobs = {name: build(f"ladder_{name}", text) for name, text in texts.items()}
    # the current source through the package's own build, in parallel
    logs = {"current": _build.build([ck.SOURCE])[ck.SOURCE]}
    paths = {"current": _build.library_path(ck.SOURCE)}
    for name, (proc, path) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            print(logs[name], file=sys.stderr)
            return 1
        paths[name] = path
    libs = {name: load(path) for name, path in paths.items()}
    ptxas = {name: ptxas_line(log) for name, log in logs.items()}
    for name, line in ptxas.items():
        print(f"[{name}] ptxas ladder_kernel: {line}", flush=True)
    code = ({name: sass(path, ("ladder_kernel", *OTHER_KERNELS))
             for name, path in paths.items()} if opts.sass else {})
    mix = {name: sass_mix(funcs["ladder_kernel"]) for name, funcs in code.items()}
    for name, ops in mix.items():
        print(f"[{name}] SASS opcodes ({sum(ops.values())}): {ops}", flush=True)
    other = {name: {k: first_difference(code["current"][k], funcs[k])
                    for k in OTHER_KERNELS if funcs[k] != code["current"][k]}
             for name, funcs in code.items() if name != "current"}
    for name, differ in other.items():
        print(f"[{name}] other kernels' SASS: "
              + (f"differs from current: {differ}" if differ else
                 f"identical to current ({', '.join(OTHER_KERNELS)})"), flush=True)
    launches = {name: launch(lib, SIZES[0]) for name, lib in libs.items()}
    for name, cfg in launches.items():
        print(f"[{name}] launch at n={SIZES[0]}: {cfg}", flush=True)

    dev = torch.device("cuda")
    tails = {n: operands(n, n, dev) for n in TAILS}
    wants = {n: ck.ladder_plain(*args) for n, args in tails.items()}
    bad = {}
    for name, lib in libs.items():
        ck._lib = lambda lib=lib: lib
        bad[name] = [n for n in TAILS
                     if not all(torch.equal(g, w)
                                for g, w in zip(ck.ladder(*tails[n]), wants[n]))]
        print(f"[{name}] " + (f"DIFFERS from ladder_plain at n = {bad[name]}" if bad[name]
                              else f"equals ladder_plain at n = {list(TAILS)}"), flush=True)
    if bad["current"]:
        return 1

    good = [name for name in libs if not bad[name]]
    timed = {n: operands(n, 7 + n, dev) for n in SIZES}
    times = {name: {str(n): [] for n in SIZES} for name in good}
    for name in good + good[::-1]:
        ck._lib = lambda lib=libs[name]: lib
        for n in SIZES:
            times[name][str(n)].append(time_ms(timed[n]))
        print(f"[{name}] ms a call: "
              + ", ".join(f"n={n} {times[name][str(n)][-1]:.4f}" for n in SIZES),
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"ladder_ms": times, "ptxas": ptxas, "launch": launches,
                      "differs_at": bad, "sass_opcodes": mix,
                      "other_kernels_sass_differ": other, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
