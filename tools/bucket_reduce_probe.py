#!/usr/bin/env python3
"""Compare shapes of the `bucket_reduce` kernels on one card, with older
builds.

    python3 tools/bucket_reduce_probe.py [--sass] [--baseline DIR/curve_kernels.cu ...]

Builds `ark_mpc_tpu_torch/ops/csrc/curve_kernels.cu` ("current": a window
kernel with its adds on PTX carry chains, then the Horner on one quad of
lanes with carry-chain products, S_w handed over in cached form), text
variants of it, and any `--baseline` versions of the file (each named by
its directory, e.g. the parent commit's, unpacked with `git archive`; a
build without `ark_bucket_reduce_config` runs through the old one-launch
entry point: a ticket, the Horner on one thread), all with nvcc in
parallel:

  thread_cc   the Horner on one thread (`ladder_double`, `ladder_add`:
              carry chains, loose values), the window kernel as current;
  quad_cxx    the current kernels with the C++ products (`fe_mul_loose`,
              `fe_sqr_loose`) instead of the carry chains;
  fused       the current arithmetic in one launch: the window blocks take a
              ticket, and the last one's first warp runs the Horner (the
              split's launch gap against this).

Prints each build's ptxas registers, stack frame and spills for its reduce
kernels (with `--sass`, their SASS opcode counts from `cuobjdump`, and
whether the file's other curve kernels compile to the same SASS as in each
baseline build).  Every build must equal `bucket_reduce_plain` bit for bit
at (16, 32, 256) with c = 8, (16, 64, 2) with c = 4 (bucket 0 = bucket 1,
as the winsum route hands them over) and at a few edge shapes (the
current one's failure exits non-zero; another's drops it from the timing).
Then each build is timed at the two caller shapes with CUDA events (20
calls after a warm-up) in turns forward and back (current, A, B, ..., B,
A, current); a build with the two-kernel entry point also times each
kernel alone (the Horner over ready cached S_w), and the Horner's time
over its product stages (`reduce_critical_path`) gives the time of one
stage on the chain.  Prints the card and one JSON line.  Needs a CUDA card
and nvcc; exits non-zero without them.
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

from ark_mpc_tpu_torch.algebra.curve import CurvePoint  # noqa: E402
from ark_mpc_tpu_torch.algebra.limbs import NLIMBS  # noqa: E402
from ark_mpc_tpu_torch.algebra.scalar import Scalar  # noqa: E402
from ark_mpc_tpu_torch.ops import _build  # noqa: E402
from ark_mpc_tpu_torch.ops import curve_kernels as ck  # noqa: E402
from ark_mpc_tpu_torch.ops import msm_kernels as mk  # noqa: E402
from ark_mpc_tpu_torch.ops.fp_kernels import _ptrs, _stream  # noqa: E402
from probe_builds import build, first_difference, replace, sass, sass_mix  # noqa: E402

# (windows, buckets, c_bits, the winsum route's bucket 0 = bucket 1)
CALLERS = ((32, 256, 8, False), (64, 2, 4, True))
EDGES = ((1, 256, 8, False), (2, 1, 8, False), (31, 4, 1, False), (64, 256, 8, False))
REPS = 20
REDUCE_KERNELS = ("bucket_window_kernel", "bucket_horner_kernel", "bucket_reduce_kernel")
OTHER_KERNELS = ("windowed_mul_kernel", "ladder_kernel", "window_sums_kernel",
                 "bucket_chunk_kernel")

SECTION = "// bucket_reduce: sum_w 2^(c w) S_w"
HORNER_HEAD = "__global__ void __launch_bounds__(HORNER_THREADS)\nbucket_horner_kernel("
WINDOW_HEAD = "__global__ void __launch_bounds__(MAX_REDUCE_BUCKETS)\nbucket_window_kernel("

THREAD_HORNER = r"""__global__ void __launch_bounds__(HORNER_THREADS)
bucket_horner_kernel(const uint32_t* __restrict__ scratch, OutCoords out, int windows,
                     int c_bits) {
  if (threadIdx.x != 0) return;
  Pt acc = pt_load_words(scratch, windows);
  for (int w = windows - 2; w >= 0; --w) {
    for (int b = 0; b < c_bits; ++b) ladder_double(acc);
    ladder_add(acc, pt_load_words(scratch, w), 0xFFFFFFFFu);
  }
  pt_store(out, 0, 1, 0, Pt{fe_canon(acc.x), fe_canon(acc.y), fe_canon(acc.z), fe_canon(acc.t)});
}
"""

FUSED_KERNEL = r"""__device__ int g_ticket = 0;  // window blocks done; the last resets it

__device__ __forceinline__ Pt pt_load_words_cg(const uint32_t* src, int64_t row) {
  const uint4* p = reinterpret_cast<const uint4*>(src + row * (4 * NW));
  Pt a;
  uint32_t* aw = reinterpret_cast<uint32_t*>(&a);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint4 v = __ldcg(p + i);
    aw[4 * i] = v.x;
    aw[4 * i + 1] = v.y;
    aw[4 * i + 2] = v.z;
    aw[4 * i + 3] = v.w;
  }
  return a;
}

// max(nb, 32) threads: threads at or past nb hold the identity and add
// nothing the first nb read.
__global__ void __launch_bounds__(MAX_REDUCE_BUCKETS)
bucket_window_kernel(Coords in, uint32_t* scratch, int windows, int nb, OutCoords out,
                     int c_bits) {
  extern __shared__ __align__(16) uint32_t fs[];
  __shared__ int last;
  const int w = blockIdx.x;
  const int d = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(windows) * nb;
  Pt v = (d == 0 || d >= nb) ? pt_identity()
                             : pt_load(in, stride, static_cast<int64_t>(w) * nb + d);
  for (int k = 1; k < nb; k *= 2) {
    pt_to_smem(fs + 32 * d, v);
    __syncthreads();
    const Pt u = (d + k < nb) ? pt_from_smem(fs + 32 * (d + k)) : pt_identity();
    __syncthreads();
    v = pt_add_cc(v, u);
  }
  if (d == 0) v = pt_identity();
  for (int k = nb / 2; k >= 1; k /= 2) {
    pt_to_smem(fs + 32 * d, v);
    __syncthreads();
    if (d < k) v = pt_add_cc(v, pt_from_smem(fs + 32 * (d + k)));
    __syncthreads();
  }
  if (d == 0) {
    pt_store_words(scratch, w, Pt{fe_sub_loose(v.y, v.x), fe_add_loose(v.y, v.x),
                                  fe_mul_cc(v.t, fe_d2()), v.z});
    if (w == windows - 1) pt_store_words(scratch, windows, v);
    __threadfence();
    last = atomicAdd(&g_ticket, 1) == windows - 1;
  }
  __syncthreads();
  if (!last || d >= HORNER_THREADS) return;
  __threadfence();
  if (d == 0) g_ticket = 0;
  uint4* rows = reinterpret_cast<uint4*>(fs + XCH_WARP_WORDS);
  const Quad Q{fs, d >> 2, d & (QUAD - 1)};
  const uint4* src = reinterpret_cast<const uint4*>(scratch);
  for (int i = d; i < (windows - 1) * 2 * QUAD; i += HORNER_THREADS) rows[i] = __ldcg(src + i);
  Pt acc = pt_load_words_cg(scratch, windows);
  __syncwarp();
  for (int ww = windows - 2; ww >= 0; --ww) {
    for (int b = 0; b < c_bits; ++b) quad_double<CcProducts>(Q, acc);
    const uint4 lo = rows[(ww * QUAD + Q.k) * 2];
    const uint4 hi = rows[(ww * QUAD + Q.k) * 2 + 1];
    quad_add_cached<CcProducts>(Q, acc, Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}});
  }
  if (d < QUAD) {
    int32_t* dst = Q.k == 0 ? out.c[0] : Q.k == 1 ? out.c[1] : Q.k == 2 ? out.c[2] : out.c[3];
    fe_store(dst, 1, 0, fe_canon(fe_pick(Q.k, acc.x, acc.y, acc.z, acc.t)));
  }
}
"""

FUSED_ENTRY = r"""  uint32_t* scratch = static_cast<uint32_t*>(ptrs[4]);
  const int threads = nb > HORNER_THREADS ? nb : HORNER_THREADS;
  size_t smem = static_cast<size_t>(threads) * 4 * NW * 4;
  if (horner_smem(windows) > smem) smem = horner_smem(windows);
  (void)part;
  bucket_window_kernel<<<windows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      coords_of(ptrs), scratch, windows, nb, out_coords_of(ptrs + 5), c_bits);
  return static_cast<int>(cudaGetLastError());
}
"""


def kernel_span(text: str, head: str) -> tuple[int, int]:
    start = text.index(head)
    return start, text.index("\n}\n", start) + 3


def thread_horner(text: str) -> str:
    """The Horner on one thread, on the ladder's carry-chain formulas."""
    lo, hi = kernel_span(text, HORNER_HEAD)
    return text[:lo] + THREAD_HORNER + text[hi:]


def cxx_products(text: str) -> str:
    """The reduce kernels on the C++ 64-bit products."""
    lo = text.index(SECTION)
    text = replace(text, "CcProducts", "CxxProducts", lo)
    return replace(text, "fe_mul_cc(", "fe_mul_loose(", lo)


def fused(text: str) -> str:
    """One launch: the window kernel with a ticket, the Horner in its last
    block."""
    lo, hi = kernel_span(text, WINDOW_HEAD)
    text = text[:lo] + FUSED_KERNEL + text[hi:]
    lo, hi = kernel_span(text, HORNER_HEAD)
    text = text[:lo] + text[hi:]
    start = text.index("int ark_bucket_reduce(void* const* ptrs")
    body = text.index("{\n", start) + 2
    end = text.index("\n}\n", body) + 3
    return text[:body] + FUSED_ENTRY + text[end:]


VARIANTS = {"thread_cc": thread_horner, "quad_cxx": cxx_products, "fused": fused}


def ptxas_lines(log: str) -> dict:
    """{reduce kernel: ptxas's registers, stack frame and spills}."""
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        name = next((k for k in REDUCE_KERNELS if "Compiling entry" in line and k in line),
                    None)
        if name:
            out[name] = " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                                   if "stack frame" in x or "registers" in x)
    return out


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "ark_bucket_reduce_config"):
        lib.ark_bucket_reduce.argtypes = [vp, i32, i32, i32, i32, vp]
        lib.ark_bucket_reduce_config.argtypes = [i32, i32, vp]
    else:  # the one-launch entry point: scratch (W, 4, 16) limbs and a ticket
        lib.ark_bucket_reduce.argtypes = [vp, i32, i32, i32, vp]
    lib.ark_bucket_reduce.restype = ctypes.c_int
    return lib


def split(lib: ctypes.CDLL) -> bool:
    return hasattr(lib, "ark_bucket_reduce_config")


def old_reduce(lib, buckets, c_bits):
    """The one-launch build through its own entry point."""
    W, nb = buckets[0].shape[1], buckets[0].shape[2]
    dev = buckets[0].device
    ins = [b.reshape(NLIMBS, W * nb).contiguous() for b in buckets]
    scratch = torch.empty((W, 4 * NLIMBS), dtype=torch.int32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    outs = [torch.empty(NLIMBS, dtype=torch.int32, device=dev) for _ in range(4)]
    rc = lib.ark_bucket_reduce(_ptrs(ins + [scratch, ticket] + outs), W, nb, c_bits,
                               _stream(dev))
    if rc != 0:
        raise RuntimeError(f"bucket_reduce launch failed: {rc}")
    return tuple(outs)


def reduce_with(lib):
    """-> f(buckets, c_bits): the build's bucket_reduce call."""
    if split(lib):
        def f(buckets, c_bits):
            mk._lib = lambda: lib
            return mk.bucket_reduce(*buckets, c_bits=c_bits)
        return f
    return lambda buckets, c_bits: old_reduce(lib, buckets, c_bits)


def buckets_of(W: int, nb: int, same: bool, seed: int, dev) -> list:
    """Bucket sums (16, W, nb) of random points (bucket 0 = bucket 1 for
    the winsum route's shape)."""
    rng = np.random.default_rng(seed)
    m = W * (1 if same else nb)
    pts = CurvePoint.generator((m,), device=dev).mul(Scalar.random(m, rng, device=dev))
    coords = [c.limbs.contiguous() for c in pts._coords()]
    if same:
        return [torch.stack([c, c], 2).contiguous() for c in coords]
    return [c.reshape(NLIMBS, W, nb).contiguous() for c in coords]


def mean_ms(fn, reps: int = REPS) -> float:
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


def part_ms(lib, buckets, c_bits: int) -> dict:
    """Each kernel of a two-kernel build alone: the window kernel, then the
    Horner over the cached S_w it left (the scratch is reused)."""
    W, nb = buckets[0].shape[1], buckets[0].shape[2]
    dev = buckets[0].device
    ins = [b.reshape(NLIMBS, W * nb).contiguous() for b in buckets]
    scratch = torch.empty((W + 1, 4 * mk.NW), dtype=torch.int32, device=dev)
    outs = [torch.empty(NLIMBS, dtype=torch.int32, device=dev) for _ in range(4)]
    ptrs, stream = _ptrs(ins + [scratch] + outs), _stream(dev)

    def part(k):
        def run():
            if lib.ark_bucket_reduce(ptrs, W, nb, c_bits, k, stream) != 0:
                raise RuntimeError("bucket_reduce launch failed")
        return run

    return {"window_ms": mean_ms(part(1)), "horner_ms": mean_ms(part(2))}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", type=Path, nargs="*", default=[],
                        help="other versions of curve_kernels.cu, each named by "
                             "its directory")
    parser.add_argument("--sass", action="store_true",
                        help="print SASS opcode counts and compare the other kernels' SASS")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("bucket_reduce_probe: needs a CUDA card", file=sys.stderr)
        return 1
    current = (_build.SRC_DIR / f"{ck.SOURCE}.cu").read_text()
    texts = {name: patch(current) for name, patch in VARIANTS.items()}
    baselines = [path.parent.name for path in opts.baseline]
    texts.update({path.parent.name: path.read_text() for path in opts.baseline})
    jobs = {name: build(f"reduce_{name}", text) for name, text in texts.items()}
    logs = {"current": _build.build([ck.SOURCE])[ck.SOURCE]}
    paths = {"current": _build.library_path(ck.SOURCE)}
    for name, (proc, path) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            print(logs[name], file=sys.stderr)
            return 1
        paths[name] = path
    libs = {name: load(path) for name, path in paths.items()}
    ptxas = {name: ptxas_lines(log) for name, log in logs.items()}
    for name, lines in ptxas.items():
        for kernel, line in lines.items():
            print(f"[{name}] ptxas {kernel}: {line}", flush=True)
    mix, other = {}, {}
    if opts.sass:
        code = {name: sass(path, REDUCE_KERNELS + OTHER_KERNELS)
                for name, path in paths.items()}
        mix = {name: {k: sass_mix(funcs[k]) for k in REDUCE_KERNELS if k in funcs}
               for name, funcs in code.items()}
        for name, kernels in mix.items():
            for k, ops in kernels.items():
                print(f"[{name}] SASS {k} ({sum(ops.values())}): {ops}", flush=True)
        # the other curve kernels must compile as in each baseline (the parent)
        other = {base: {k: first_difference(code[base][k], code["current"][k])
                        for k in OTHER_KERNELS if code[base][k] != code["current"][k]}
                 for base in baselines}
        for base, differ in other.items():
            print(f"[current vs {base}] other kernels' SASS: "
                  + (f"DIFFERS: {differ}" if differ else
                     f"identical ({', '.join(OTHER_KERNELS)})"), flush=True)

    dev = torch.device("cuda")
    launch = {f"{W}x{nb}": mk.reduce_launch_config(W, nb) for W, nb, _, _ in CALLERS}
    print(f"[current] launch: {launch}", flush=True)
    cases = {(W, nb, c, same): buckets_of(W, nb, same, 7 * W + nb, dev)
             for W, nb, c, same in CALLERS + EDGES}
    wants = {key: mk.bucket_reduce_plain(*b, c_bits=key[2]) for key, b in cases.items()}
    bad = {}
    for name, lib in libs.items():
        f = reduce_with(lib)
        bad[name] = [f"{W}x{nb} c={c}" for (W, nb, c, same), b in cases.items()
                     if not all(torch.equal(g, w) for g, w in
                                zip(f(b, c), wants[(W, nb, c, same)]))]
        print(f"[{name}] " + (f"DIFFERS from bucket_reduce_plain at {bad[name]}" if bad[name]
                              else f"equals bucket_reduce_plain at {len(cases)} shapes"),
              flush=True)
    if bad["current"]:
        return 1

    good = [name for name in libs if not bad[name]]
    times = {name: {f"{W}x{nb}": [] for W, nb, _, _ in CALLERS} for name in good}
    for name in good + good[::-1]:
        f = reduce_with(libs[name])
        for W, nb, c, same in CALLERS:
            b = cases[(W, nb, c, same)]
            times[name][f"{W}x{nb}"].append(mean_ms(lambda: f(b, c)))
        print(f"[{name}] ms a call: " + ", ".join(f"{k} {v[-1]:.4f}"
                                                  for k, v in times[name].items()),
              flush=True)
    parts = {}
    for name in good:
        lib = libs[name]
        if not split(lib) or name == "fused":
            continue
        parts[name] = {}
        for W, nb, c, same in CALLERS:
            p = part_ms(lib, cases[(W, nb, c, same)], c)
            stages = mk.reduce_critical_path(W, nb, c)["horner_stages"]
            p["horner_us_per_stage"] = 1e3 * p["horner_ms"] / stages
            parts[name][f"{W}x{nb}"] = p
            print(f"[{name}] parts at {W}x{nb} c={c}: window {p['window_ms']:.4f} ms, "
                  f"Horner {p['horner_ms']:.4f} ms over {stages} product stages = "
                  f"{p['horner_us_per_stage']:.4f} us a stage", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"bucket_reduce_ms": times, "parts": parts, "ptxas": ptxas,
                      "launch": launch, "differs_at": bad, "sass_opcodes": mix,
                      "other_kernels_sass_differ": other, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
