"""TLS and plaintext TCP in the port (`fabric/tls.py`, `TcpTransport`): the
cases of `tests/test_tls.py` on free ports, and which IO path each mode
takes."""

import socket
import threading

import pytest

from ark_mpc_tpu_torch.fabric import native_net
from ark_mpc_tpu_torch.fabric import tls as tlsmod
from ark_mpc_tpu_torch.fabric.transport import TcpTransport


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_self_signed_cert_roundtrip():
    cert_pem, key_pem = tlsmod.generate_self_signed()
    assert b"BEGIN CERTIFICATE" in cert_pem
    assert b"BEGIN PRIVATE KEY" in key_pem
    # contexts build from the generated material
    tlsmod.server_context(cert_pem, key_pem)
    tlsmod.client_context()
    tlsmod.client_context(pinned_cert_pem=cert_pem)


def _pair(tls, listener_body, timeout=30):
    """Party 1 runs `listener_body(transport)` on a thread; -> party 0's
    transport and the thread."""
    port = _free_port()

    def listener():
        t1 = TcpTransport(1, "127.0.0.1", port, timeout=timeout, tls=tls)
        try:
            listener_body(t1)
        finally:
            t1.close()

    th = threading.Thread(target=listener, daemon=True)
    th.start()
    return TcpTransport(0, "127.0.0.1", port, timeout=timeout, tls=tls), th


@pytest.mark.parametrize("tls", [True, False])
def test_tcp_exchange(tls):
    """Loopback exchange in both TLS and plaintext modes; party 0 dials.
    Plaintext goes through the native IO library, TLS through Python."""
    result = {}

    def body(t1):
        result[1] = t1.exchange(b"from-party-1" * 100)
        result["io1"] = t1.io
        result["stats1"] = (t1.stats.msgs_sent, t1.stats.bytes_recv)

    t0, th = _pair(tls, body)
    result[0] = t0.exchange(b"from-party-0" * 100)
    th.join(timeout=30)
    t0.close()
    assert not th.is_alive()
    assert result[0] == b"from-party-1" * 100
    assert result[1] == b"from-party-0" * 100
    want_io = "python" if tls else "native"
    assert t0.io == result["io1"] == want_io
    assert (t0.stats.msgs_sent, t0.stats.bytes_sent) == (1, 1200)
    assert result["stats1"] == (1, 1200)


def test_tls13_negotiated_and_frames_decrypt():
    """The channel negotiates TLS 1.3 and framed payloads survive it."""
    secret = b"SUPER-SECRET-SHARE-BYTES" * 8
    got = {}

    def body(t1):
        got["version"] = t1.sock.version()
        got["payload"] = t1.recv()

    t0, th = _pair(True, body)
    assert t0.sock.version() == "TLSv1.3"
    t0.send(secret)
    th.join(timeout=30)
    t0.close()
    assert got["version"] == "TLSv1.3"
    assert got["payload"] == secret


def test_native_library_loads_or_builds():
    """The committed `native/libarkmpcnet.so` loads here; where it does not,
    `native/net.cpp` is built into the port's build directory."""
    lib, path = native_net.library()
    assert path.endswith(".so") and lib.mpcnet_send is not None
    assert native_net.built_path().parent.name == "_build"
