"""ctypes binding for the native framed TCP transport (`native/net.cpp`).

Counterpart of `ark_mpc_tpu/fabric/native_net.py`: `TcpTransport`'s
plaintext path sends and receives through this library, whose IO runs
outside the interpreter lock.  It loads the committed
`native/libarkmpcnet.so`; where that does not load, it builds
`native/net.cpp` with `g++ -O2 -shared -fPIC` into `ops/_build/` (listed in
`.gitignore`) and loads that.  Nothing is loaded or built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import socket
import subprocess
from pathlib import Path

from ..ops import _build

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCE = NATIVE_DIR / "net.cpp"
COMMITTED = NATIVE_DIR / "libarkmpcnet.so"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mpcnet_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_double]
    lib.mpcnet_connect.restype = ctypes.c_int
    lib.mpcnet_send.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64]
    lib.mpcnet_send.restype = ctypes.c_int
    lib.mpcnet_recv_len.argtypes = [ctypes.c_int]
    lib.mpcnet_recv_len.restype = ctypes.c_int64
    lib.mpcnet_recv.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64]
    lib.mpcnet_recv.restype = ctypes.c_int
    lib.mpcnet_close.argtypes = [ctypes.c_int]
    lib.mpcnet_close.restype = None
    return lib


def built_path() -> Path:
    """Where `native/net.cpp` is built when the committed library does not
    load (named by a hash of the source and flags)."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return _build.BUILD_DIR / f"libarkmpcnet-{tag.hexdigest()[:16]}.so"


def _build_library() -> Path:
    out = built_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)  # atomic: two parties may build at once
    return out


@functools.lru_cache(maxsize=None)
def library() -> tuple[ctypes.CDLL, str]:
    """-> (the loaded library, the path it came from)."""
    try:
        return _declare(ctypes.CDLL(str(COMMITTED))), str(COMMITTED)
    except OSError:
        path = _build_library()
        return _declare(ctypes.CDLL(str(path))), str(path)


class NativeConn:
    """One framed duplex connection (party 0 dials, party 1 listens)."""

    def __init__(self, party_id: int, host: str, port: int, timeout: float):
        self._lib, _ = library()
        ip = socket.gethostbyname(host)
        fd = self._lib.mpcnet_connect(ip.encode(), port, 1 if party_id == 1 else 0,
                                      float(timeout))
        if fd < 0:
            raise ConnectionError(f"native connect failed (party {party_id}, {ip}:{port})")
        self.fd = fd

    def send(self, data: bytes) -> None:
        if self._lib.mpcnet_send(self.fd, data, len(data)) != 0:
            raise ConnectionError("native send failed")

    def recv(self) -> bytes:
        n = self._lib.mpcnet_recv_len(self.fd)
        if n < 0:
            raise ConnectionError("native recv failed")
        buf = ctypes.create_string_buffer(int(n))
        if self._lib.mpcnet_recv(self.fd, buf, int(n)) != 0:
            raise ConnectionError("native recv failed")
        return buf.raw

    def close(self) -> None:
        self._lib.mpcnet_close(self.fd)
