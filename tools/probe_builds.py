"""What the kernel probes share: text variants of a CUDA source, their nvcc
builds beside the package's own, and the SASS read back from a build.

Imported by `tools/ladder_probe.py` and `tools/bucket_reduce_probe.py`;
nothing runs on import.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ark_mpc_tpu_torch.ops import _build  # noqa: E402


def replace(text: str, old: str, new: str, lo: int = 0, hi: int | None = None) -> str:
    """`old` -> `new` inside text[lo:hi]; `old` must occur there."""
    hi = len(text) if hi is None else hi
    part = text[lo:hi]
    if old not in part:
        raise RuntimeError(f"variant patch does not apply: {old[:60]!r}")
    return text[:lo] + part.replace(old, new) + text[hi:]


def build(name: str, text: str):
    """Start nvcc on one variant's text; -> (Popen, library path)."""
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"curve_{name}.cu"
    src.write_text(text)
    lib = out / f"libcurve_{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def sass(lib: Path, kernels) -> dict:
    """{kernel: its SASS instructions} for the named kernels of the library
    (cuobjdump beside nvcc), without addresses and encodings."""
    out = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
                          str(lib)], capture_output=True, text=True, check=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        head, body = part.split("\n", 1)
        name = next((k for k in kernels if k in head), None)
        if name:
            # branch labels are numbered across the file: renumber them
            labels: dict = {}
            body = re.sub(r"\.L_x_\d+",
                          lambda m: labels.setdefault(m.group(0), f".L{len(labels)}"),
                          re.sub(r"/\*[^*]*\*/", "", body))
            funcs[name] = [line.strip() for line in body.splitlines() if line.strip()]
    return funcs


def first_difference(a: list, b: list) -> str:
    """The first instruction where two kernels' SASS differ."""
    at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return (f"line {at}: {a[at] if at < len(a) else '(end)'!r} vs "
            f"{b[at] if at < len(b) else '(end)'!r}")


def sass_mix(body: list) -> dict:
    """Opcode counts of one kernel's SASS, most frequent first, with the
    carry forms (IMAD.X, IADD3.X) apart."""
    ops = collections.Counter()
    for line in body:
        m = re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not m:
            continue
        parts = m.group(1).split(".")
        ops[parts[0] + (".X" if "X" in parts[1:] else "")] += 1
    return dict(ops.most_common())
