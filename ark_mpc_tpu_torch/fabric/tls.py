"""TLS channel security for the TCP transport.

A copy of `ark_mpc_tpu/fabric/tls.py`.  As ark-mpc runs its party traffic
over QUIC with TLS (`network/quic.rs:42-73`), each party makes an
ephemeral self-signed certificate when it connects and the peer accepts it
with a permissive verifier (`network/config.rs:14-73`): the channel is
private and intact against the network, and the MPC protocol's MACs bind
the parties.  On top of TCP:

  - `generate_self_signed()`: an ephemeral ECDSA P-256 key and self-signed
    X.509 certificate (imports `cryptography` when called);
  - `server_context()` / `client_context()`: TLS 1.3 contexts; the client
    verifies nothing (`CERT_NONE`) unless a pinned peer certificate is
    given.

Plaintext TCP stays available as `TcpTransport(..., tls=False)`.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
import tempfile


def generate_self_signed(common_name: str = "ark-mpc-tpu"):
    """Ephemeral ECDSA P-256 self-signed certificate.

    Returns `(cert_pem, key_pem)` bytes.  Mirrors the reference's
    per-connection rcgen self-signed cert (`network/config.rs:14-40`).
    """
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=7))
        .add_extension(
            x509.SubjectAlternativeName(
                [
                    x509.DNSName("localhost"),
                    x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
                ]
            ),
            critical=False,
        )
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


def server_context(cert_pem: bytes | None = None,
                   key_pem: bytes | None = None) -> ssl.SSLContext:
    """TLS 1.3 server context with an ephemeral (or supplied) cert."""
    if cert_pem is None:
        cert_pem, key_pem = generate_self_signed()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    # stdlib ssl loads cert chains from paths only; stage via a temp file
    # that is unlinked immediately after load.
    fd, path = tempfile.mkstemp(suffix=".pem")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(cert_pem + b"\n" + key_pem)
        ctx.load_cert_chain(path)
    finally:
        os.unlink(path)
    return ctx


def client_context(pinned_cert_pem: bytes | None = None) -> ssl.SSLContext:
    """TLS 1.3 client context.

    Default: permissive verifier (`SkipServerVerification`,
    `network/config.rs:42-73`) — encrypts the channel, skips PKI.  Pass
    `pinned_cert_pem` to additionally pin the peer's certificate.
    """
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    if pinned_cert_pem is None:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    else:
        ctx.check_hostname = False
        fd, path = tempfile.mkstemp(suffix=".pem")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(pinned_cert_pem)
            ctx.load_verify_locations(path)
        finally:
            os.unlink(path)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx
