"""Two-party in-process transports.

Copied from `ark_mpc_tpu/fabric/transport.py` (stdlib only): the `Transport`
interface, the `LocalTransport` queue pair, and the lockstep pair the mock
simulator uses.  TCP and TLS transports come in a later slice of the port.

Party 0 always sends first in an exchange, so framing order is
deterministic and deadlock-free.
"""

from __future__ import annotations

import os
import queue
import threading

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
