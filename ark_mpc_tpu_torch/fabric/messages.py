"""Binary wire codec for MPC messages.

Replaces the reference's `NetworkOutbound { result_id, payload }` with
serde_json frames (`network.rs:33-60`, `network/quic.rs:292-310` — JSON field
elements being a known perf sin we deliberately avoid): here a message is a
deterministic *round* of flat arrays, encoded as a compact binary frame.
Limb arrays travel as packed uint16 (32 bytes per 256-bit element, same
density as canonical encoding) — both parties use identical Montgomery
representation so no conversion is needed on either end.

Frame layout (little-endian):
    u32 n_arrays
    per array: u8 kind (0=raw bytes, 1=u16-packed-limbs, 2=uint32, 3=uint8)
               u8 ndim, u32 shape[ndim], payload
"""

from __future__ import annotations

import struct

import numpy as np

KIND_BYTES = 0
KIND_LIMB16 = 1
KIND_U32 = 2
KIND_U8 = 3
KIND_I64 = 4


def encode_arrays(items) -> bytes:
    """items: list of numpy arrays or bytes."""
    out = [struct.pack("<I", len(items))]
    for it in items:
        if isinstance(it, (bytes, bytearray)):
            out.append(struct.pack("<BB I", KIND_BYTES, 1, len(it)))
            out.append(bytes(it))
            continue
        arr = np.asarray(it)
        if arr.dtype == np.uint32 and arr.size and arr.max(initial=0) <= 0xFFFF:
            kind, payload = KIND_LIMB16, arr.astype("<u2").tobytes()
        elif arr.dtype == np.uint32:
            kind, payload = KIND_U32, arr.astype("<u4").tobytes()
        elif arr.dtype == np.uint8:
            kind, payload = KIND_U8, arr.tobytes()
        elif arr.dtype == np.int64:
            kind, payload = KIND_I64, arr.astype("<i8").tobytes()
        else:
            raise TypeError(f"unsupported dtype {arr.dtype}")
        out.append(struct.pack("<BB", kind, arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        out.append(payload)
    return b"".join(out)


def decode_arrays(data: bytes):
    (n,) = struct.unpack_from("<I", data, 0)
    off = 4
    items = []
    for _ in range(n):
        kind, ndim = struct.unpack_from("<BB", data, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}I", data, off)
        off += 4 * ndim
        if kind == KIND_BYTES:
            size = shape[0]
            items.append(data[off : off + size])
            off += size
            continue
        count = int(np.prod(shape)) if shape else 1
        if kind == KIND_LIMB16:
            arr = np.frombuffer(data, "<u2", count, off).astype(np.uint32)
            off += 2 * count
        elif kind == KIND_U32:
            arr = np.frombuffer(data, "<u4", count, off).astype(np.uint32)
            off += 4 * count
        elif kind == KIND_U8:
            arr = np.frombuffer(data, np.uint8, count, off).copy()
            off += count
        elif kind == KIND_I64:
            arr = np.frombuffer(data, "<i8", count, off).astype(np.int64)
            off += 8 * count
        else:
            raise ValueError(f"bad kind {kind}")
        items.append(arr.reshape(shape))
    return items
