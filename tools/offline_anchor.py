#!/usr/bin/env python3
"""Build and run the native CPU anchor of the offline phase.

    python3 tools/offline_anchor.py

Compiles `native/offline_anchor.cpp` with g++ (-O3 -march=native, all
cores) into `ark_mpc_tpu_torch/ops/_build/`, then runs it at the medium-ring
class (N = 512, 29 primes, 240 slots) and the production-ring class
(N = 65536, 27 primes, 24,480 slots, 4 reps), the configurations
`BASELINE.md` reports.  Prints the host CPU's model name and core count,
then each run's JSON line (`cpu_anchor_offline_triples_per_sec`).  The
anchor counts the homomorphic work of a triple pair with no proof and no
wire, so it is an upper bound for a CPU.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = ROOT / "native" / "offline_anchor.cpp"
BUILD = ROOT / "ark_mpc_tpu_torch" / "ops" / "_build"
RUNS = (("medium", ["512", "29", "240"]), ("production", ["65536", "27", "24480", "4"]))


def cpu_name() -> str:
    """The CPU model name as `lscpu` gives it; where the host masks it,
    the vendor, family and model numbers instead."""
    text = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    fields = {}
    for line in text.splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip().lower(), value.strip())
    name = fields.get("model name", "unknown")
    if name and name != "unknown":
        return name
    return (f"model name unknown ({fields.get('vendor id', '?')} family "
            f"{fields.get('cpu family', '?')} model {fields.get('model', '?')})")


def main() -> int:
    BUILD.mkdir(parents=True, exist_ok=True)
    exe = BUILD / "offline_anchor"
    subprocess.run(["g++", "-O3", "-march=native", "-funroll-loops", "-o", str(exe),
                    str(SOURCE), "-pthread"], check=True)
    print(f"host CPU: {cpu_name()}, {os.cpu_count()} cores", flush=True)
    for label, args in RUNS:
        out = subprocess.run([str(exe), *args], capture_output=True, text=True, check=True,
                             timeout=900)
        print(f"{label}: {out.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
