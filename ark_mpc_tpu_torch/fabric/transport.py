"""Two-party transports.

Copied from `ark_mpc_tpu/fabric/transport.py`: the `Transport` interface,
the `LocalTransport` queue pair, the lockstep pair the mock simulator uses,
`NoRecvTransport` for single-party gate-throughput runs, and `TcpTransport`
between two processes or hosts (u64 little-endian length-prefixed frames,
TLS 1.3 by default, the native IO library on the plaintext path).

Party 0 always sends first in an exchange, so framing order is
deterministic and deadlock-free.
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import subprocess
import threading
import time

PARTY0 = 0
PARTY1 = 1


class NetworkStats:
    """Byte/message counters."""

    def __init__(self):
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.msgs_sent = 0
        self.msgs_recv = 0

    def __repr__(self):
        return (
            f"NetworkStats(sent={self.msgs_sent} msgs/{self.bytes_sent} B, "
            f"recv={self.msgs_recv} msgs/{self.bytes_recv} B)"
        )


class Transport:
    """Ordered, reliable two-party byte-frame transport."""

    def __init__(self, party_id: int):
        assert party_id in (PARTY0, PARTY1)
        self.party_id = party_id
        self.stats = NetworkStats()

    def send(self, data: bytes) -> None:
        self.stats.msgs_sent += 1
        self.stats.bytes_sent += len(data)
        self._send(data)

    def recv(self) -> bytes:
        data = self._recv()
        self.stats.msgs_recv += 1
        self.stats.bytes_recv += len(data)
        return data

    def exchange(self, data: bytes) -> bytes:
        """Send our frame, receive theirs; party 0 sends first."""
        if self.party_id == PARTY0:
            self.send(data)
            return self.recv()
        other = self.recv()
        self.send(data)
        return other

    def close(self):
        pass

    # -- implemented by subclasses
    def _send(self, data: bytes) -> None:
        raise NotImplementedError

    def _recv(self) -> bytes:
        raise NotImplementedError


class LocalTransport(Transport):
    """In-process duplex queue pair (MockNetwork analog)."""

    def __init__(self, party_id, inbox: queue.Queue, outbox: queue.Queue):
        super().__init__(party_id)
        self._inbox = inbox
        self._outbox = outbox

    @classmethod
    def pair(cls):
        q01, q10 = queue.Queue(), queue.Queue()
        return cls(PARTY0, q10, q01), cls(PARTY1, q01, q10)

    def _send(self, data):
        self._outbox.put(data)

    def _recv(self):
        data = self._inbox.get(timeout=120)
        if data is None:
            raise ConnectionError("peer closed")
        return data

    def close(self):
        self._outbox.put(None)


class LockstepScheduler:
    """Baton scheduler serializing two in-process parties.

    Exactly one party thread executes at a time, yielding the baton only
    when it blocks on an empty inbox (or finishes).  This makes mock runs
    deterministic.
    """

    def __init__(self):
        self.cond = threading.Condition()
        self.turn = 0  # party currently allowed to run
        self.done = [False, False]
        self.failed = [False, False]
        # deadlock fail-fast state: a protocol-order bug must surface
        # immediately, not after the timeout
        self.waiting = [False, False]
        self.inboxes: list = [None, None]
        self.deadlock = False

    def acquire(self, pid: int):
        with self.cond:
            self.cond.wait_for(lambda: self.turn == pid, timeout=600)

    def finish(self, pid: int, failed: bool = False):
        with self.cond:
            self.done[pid] = True
            self.failed[pid] = failed
            self.turn = 1 - pid
            self.cond.notify_all()


class LockstepTransport(Transport):
    """In-process transport with baton-serialized execution (see scheduler).

    Sends never block; recv on an empty inbox hands the baton to the peer
    and waits until a message arrives and the baton returns.
    """

    def __init__(self, party_id, inbox: list, outbox: list,
                 sched: LockstepScheduler):
        super().__init__(party_id)
        self._inbox = inbox
        self._outbox = outbox
        self._sched = sched

    @classmethod
    def pair(cls):
        sched = LockstepScheduler()
        q01, q10 = [], []
        sched.inboxes = [q10, q01]
        return (
            cls(PARTY0, q10, q01, sched),
            cls(PARTY1, q01, q10, sched),
        )

    def _send(self, data):
        self._outbox.append(data)

    def _recv(self):
        sched = self._sched
        pid, peer = self.party_id, 1 - self.party_id
        if not self._inbox:
            with sched.cond:
                # hand the baton to the peer and mark ourselves blocked
                sched.turn = peer
                sched.waiting[pid] = True
                sched.cond.notify_all()

                def ready():
                    if sched.deadlock or sched.done[peer]:
                        return True
                    if sched.turn == pid and self._inbox:
                        return True
                    # both parties blocked on recv with nothing in flight:
                    # a protocol-order bug — fail NOW, not at the timeout
                    if (sched.waiting[peer] and not self._inbox
                            and not sched.inboxes[peer]):
                        sched.deadlock = True
                        sched.cond.notify_all()
                        return True
                    return False

                timeout = float(os.environ.get("ARK_MPC_MOCK_TIMEOUT", "600"))
                ok = sched.cond.wait_for(ready, timeout=timeout)
                sched.waiting[pid] = False
            if sched.deadlock:
                raise ConnectionError(
                    "lockstep deadlock: both parties blocked on recv with "
                    "empty inboxes (protocol order mismatch)")
            if not ok:
                raise ConnectionError("lockstep recv timed out")
            if not self._inbox:
                raise ConnectionError("peer finished without sending (peer error or protocol mismatch)")
        return self._inbox.pop(0)

    def close(self):
        pass


class NoRecvTransport(Transport):
    """Sends are dropped and a receive raises: one party alone, for
    gate-throughput runs of circuits that need no peer."""

    def __init__(self, party_id=PARTY0):
        super().__init__(party_id)

    def _send(self, data):
        pass

    def _recv(self):
        raise RuntimeError("NoRecvTransport cannot receive")


class TcpTransport(Transport):
    """Frames over one TCP stream between two processes or hosts: u64
    little-endian length prefix, then the payload.

    Party 1 listens and party 0 dials, retrying until `timeout` (seconds,
    also the limit on each blocking accept or receive), with TCP_NODELAY.
    TLS 1.3 is on by default (`fabric/tls.py`: an ephemeral self-signed
    certificate, a client that verifies nothing); `tls=False` sends
    plaintext through the native IO library (`fabric/native_net.py`).  Only
    where that library neither loads nor builds does plaintext go through
    Python sockets.  `io` says which path runs: "native" or "python"."""

    HEADER = struct.Struct("<Q")

    def __init__(self, party_id: int, host: str, port: int,
                 timeout: float = 60.0, tls: bool = True):
        super().__init__(party_id)
        self.tls = tls
        self._native = None
        if not tls:
            from . import native_net

            try:
                native_net.library()
            except (OSError, subprocess.CalledProcessError):
                pass
            else:
                self._native = native_net.NativeConn(party_id, host, port, timeout)
                self.io = "native"
                return
        self.io = "python"
        if party_id == PARTY1:
            with socket.create_server((host, port)) as srv:
                srv.settimeout(timeout)
                self.sock, _ = srv.accept()
        else:
            deadline = time.monotonic() + timeout
            while True:
                try:
                    self.sock = socket.create_connection((host, port), timeout=timeout)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.25)
        self.sock.settimeout(timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if tls:
            from . import tls as tlsmod

            # the listener presents the ephemeral certificate
            if party_id == PARTY1:
                self.sock = tlsmod.server_context().wrap_socket(self.sock,
                                                                server_side=True)
            else:
                self.sock = tlsmod.client_context().wrap_socket(self.sock)

    def _send(self, data):
        if self._native is not None:
            self._native.send(data)
        else:
            self.sock.sendall(self.HEADER.pack(len(data)) + data)

    def _recv(self):
        if self._native is not None:
            return self._native.recv()
        (size,) = self.HEADER.unpack(self._recv_exact(self.HEADER.size))
        return self._recv_exact(size)

    def _recv_exact(self, size: int) -> bytes:
        buf = bytearray(size)
        view = memoryview(buf)
        got = 0
        while got < size:
            n = self.sock.recv_into(view[got:], size - got)
            if n == 0:
                raise ConnectionError("peer closed")
            got += n
        return bytes(buf)

    def close(self):
        if self._native is not None:
            self._native.close()
        else:
            self.sock.close()
