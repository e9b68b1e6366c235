"""Runtime observability: round, element and timing counters.

Copied from `ark_mpc_tpu/utils/stats.py` (stdlib only).  The interesting
quantities are per round, not per gate: the round count (the circuit depth
in network hops), the calls and elements of each protocol step, and their
wall time.  `FabricStats.dump()` is the shutdown-time stats dump.

The wall times are host-clock times around asynchronous device work: a step
that ends without a device-to-host copy may return before the card is done.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class FabricStats:
    """Attached to an `MpcFabric` made with `collect_stats=True`; protocol
    methods record into it."""

    op_counts: dict = field(default_factory=lambda: defaultdict(int))
    op_elements: dict = field(default_factory=lambda: defaultdict(int))
    op_seconds: dict = field(default_factory=lambda: defaultdict(float))
    rounds: int = 0
    started: float = field(default_factory=time.time)

    @contextmanager
    def timed(self, op: str, n_elements: int = 0):
        t0 = time.time()
        try:
            yield
        finally:
            self.op_counts[op] += 1
            self.op_elements[op] += n_elements
            self.op_seconds[op] += time.time() - t0

    def snapshot(self, transport_stats=None) -> dict:
        out = {
            "wall_seconds": time.time() - self.started,
            "rounds": self.rounds,
            "ops": {
                op: {
                    "calls": self.op_counts[op],
                    "elements": self.op_elements[op],
                    "seconds": round(self.op_seconds[op], 6),
                }
                for op in sorted(self.op_counts)
            },
        }
        if transport_stats is not None:
            out["network"] = {
                "bytes_sent": transport_stats.bytes_sent,
                "bytes_recv": transport_stats.bytes_recv,
                "msgs_sent": transport_stats.msgs_sent,
                "msgs_recv": transport_stats.msgs_recv,
            }
        return out

    def dump(self, transport_stats=None) -> str:
        """Shutdown-time stats dump."""
        return json.dumps(self.snapshot(transport_stats), indent=2)
