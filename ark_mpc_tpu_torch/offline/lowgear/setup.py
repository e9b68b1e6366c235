"""LowGear setup helpers: numpy frames over the transport.

Counterpart of the frame helpers of `ark_mpc_tpu/offline/lowgear/setup.py`
(`_send_arrays`, `_exchange`).  The reference's t-generic prototype key
exchange (`SetupState`, `run_key_exchange`) is not ported; the production
key exchange is `triplets_l.key_exchange_l`.

The callers pass numpy arrays (residues as uint32, the reference's frames
byte for byte) and get numpy back, to check and place themselves.
"""

from __future__ import annotations

from ...fabric import messages
from ...fabric.transport import Transport


def _send_arrays(transport: Transport, *arrays):
    transport.send(messages.encode_arrays(list(arrays)))


def _exchange(transport: Transport, *arrays) -> list:
    """One frame each way (party 0 sends first) -> the peer's numpy arrays."""
    return messages.decode_arrays(transport.exchange(messages.encode_arrays(list(arrays))))
