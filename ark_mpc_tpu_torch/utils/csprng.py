"""Cryptographically secure host-side randomness.

The reference samples all protocol secrets (blinders, masks, coin
contributions, offline secrets) from `rand::thread_rng()` — a CSPRNG.  The
round-1 build used numpy PCG64 (state-recoverable from outputs) with small
seeds; this module replaces it everywhere secrets are drawn.

`CSPRNG` implements the subset of the `numpy.random.Generator` API the
codebase uses (`integers`, `bytes`), backed by a SHAKE-256 output stream:

  - unseeded (the secure default): keyed from 32 bytes of OS entropy;
  - seeded (tests only): deterministic stream from the given seed.

Sampling bias: `integers` draws 128 bits per element and reduces mod the
range, so bias is < range / 2^128 — negligible for every range used here.
Power-of-two ranges take an exact mask fast path (vectorized; this is the
`Scalar.random` hot path).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

_BLOCK = 1 << 20  # SHAKE stream block size


class CSPRNG:
    """SHAKE-256-stream generator, numpy-Generator-compatible subset."""

    def __init__(self, seed: int | bytes | None = None):
        if seed is None:
            key = os.urandom(32)
        elif isinstance(seed, int):
            key = seed.to_bytes((seed.bit_length() + 7) // 8 + 1, "little",
                                signed=seed < 0)
        else:
            key = bytes(seed)
        self._key = key
        self._ctr = 0
        self._buf = b""

    def bytes(self, n: int) -> bytes:
        # Blocks are gathered in a list and joined once, so a draw of many
        # blocks costs linear time; the stream is unchanged.
        chunks, have = [self._buf], len(self._buf)
        while have < n:
            h = hashlib.shake_256(
                self._key + self._ctr.to_bytes(8, "little"))
            self._ctr += 1
            chunks.append(h.digest(_BLOCK))
            have += _BLOCK
        buf = b"".join(chunks)
        out, self._buf = buf[:n], buf[n:]
        return out

    def integers(self, low, high=None, size=None, dtype=np.int64,
                 endpoint: bool = False):
        """Uniform integers in [low, high) (numpy half-open convention)."""
        if high is None:
            low, high = 0, low
        low, high = int(low), int(high)
        if endpoint:
            high += 1
        span = high - low
        assert span > 0
        shape = () if size is None else (
            (size,) if isinstance(size, int) else tuple(size))
        n = int(np.prod(shape)) if shape else 1

        if span & (span - 1) == 0 and span.bit_length() <= 64:
            # power-of-two fast path: exact masking of a raw 64-bit stream
            raw = np.frombuffer(self.bytes(8 * n), dtype=np.uint64)
            vals = (raw & np.uint64(span - 1)).astype(np.int64) + low
        else:
            # 128 bits per draw -> bias < span / 2^128
            raw = self.bytes(16 * n)
            vals = np.fromiter(
                (int.from_bytes(raw[16 * i: 16 * i + 16], "little") % span
                 + low for i in range(n)),
                dtype=object if high.bit_length() >= 63 else np.int64,
                count=n,
            )
        out = vals.reshape(shape)
        if dtype is not None and out.dtype != np.dtype(object):
            out = out.astype(dtype)
        return out if shape else out[()]


def default_crypto_rng() -> CSPRNG:
    """Fresh OS-entropy-keyed CSPRNG (the secure default for secrets)."""
    return CSPRNG()
