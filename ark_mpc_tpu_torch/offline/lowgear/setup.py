"""LowGear setup: the prototype BGV key exchange and numpy frames over the
transport.

Counterpart of `ark_mpc_tpu/offline/lowgear/setup.py` (`setup.rs:13-32`):
the parties exchange BGV public keys, then encryptions of their MAC key
shares, which `triplets_bgv.authenticate_vec` multiplies homomorphically
by the counterparty's shares.  This is the t-generic PROTOTYPE exchange
(no proof gate on the MAC-share ciphertexts) over the small test
parameter sets (`offline/bgv/params.py`); the production key exchange is
`triplets_l.key_exchange_l`, ZK-gated at 2^-128.

Two deliberate differences from the reference:
  - the peer's public keys and ciphertext residues are checked (shape,
    dtype, every residue below its prime: `peer_residues`, which
    `triplets_l` uses too) and `KeyExchangeError` raised otherwise; the
    reference reads them unchecked (`setup.py:47-52`);
  - `gen=None` draws a fresh seed from `os.urandom`, where the reference
    falls back to the fixed `jax.random.PRNGKey(0)` (`setup.py:59`), which
    gives every default key pair the same key.

The frame helpers take numpy arrays (residues as uint32, the reference's
frames byte for byte) and return numpy, for the callers to check and place.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ...fabric import messages
from ...fabric.transport import Transport
from ...ops.modular32 import to_uint32
from ..bgv.bgv import Ciphertext, Keypair, encrypt_slots, keygen
from ..bgv.params import BgvParams
from ..errors import KeyExchangeError


def _send_arrays(transport: Transport, *arrays):
    transport.send(messages.encode_arrays(list(arrays)))


def _exchange(transport: Transport, *arrays) -> list:
    """One frame each way (party 0 sends first) -> the peer's numpy arrays."""
    return messages.decode_arrays(transport.exchange(messages.encode_arrays(list(arrays))))


@dataclass
class SetupState:
    """Per-party state after the key exchange (`LowGear` fields
    `lowgear/mod.rs:38-65`: params, keypair, other_pk, other_mac_enc)."""

    params: BgvParams
    keypair: Keypair
    other_pk_a: torch.Tensor
    other_pk_b: torch.Tensor
    other_mac_enc: Ciphertext


def fresh_generator(device) -> torch.Generator:
    """A generator on `device` seeded from `os.urandom`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(os.urandom(8), "little") & ((1 << 63) - 1))
    return gen


def peer_residues(q_col: torch.Tensor, width: int, arr, lead: tuple = ()) -> torch.Tensor:
    """The peer's residues as an int64 tensor on the device of `q_col`, the
    RNS primes as an (L, 1) column; raises `KeyExchangeError` unless they
    are a uint32 array of shape (*lead, L, width) with every residue below
    its prime.  The primes are below 2^31, so the array crosses to the
    device as its zero-copy int32 view and is widened there (a word of 2^31
    or more turns negative and is refused)."""
    want = tuple(lead) + (q_col.shape[0], width)
    if not isinstance(arr, np.ndarray) or arr.dtype != np.uint32 or arr.shape != want:
        raise KeyExchangeError(f"peer sent residues {getattr(arr, 'shape', None)} "
                               f"{getattr(arr, 'dtype', type(arr))}, expected {want} uint32")
    t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32)).to(q_col.device)
    t = t.to(torch.int64)
    if bool(((t < 0) | (t >= q_col)).any()):
        raise KeyExchangeError("peer sent residues that are not below their RNS primes")
    return t


def exchange_ciphertext(transport: Transport, params: BgvParams, ct: Ciphertext) -> Ciphertext:
    """Send our (L, N) ciphertext, receive and check the peer's."""
    c0, c1 = _exchange(transport, to_uint32(ct.c0), to_uint32(ct.c1))
    return Ciphertext(peer_residues(params._q, params.n, c0),
                      peer_residues(params._q, params.n, c1))


def run_key_exchange(transport: Transport, params: BgvParams, mac_share_slots,
                     gen: torch.Generator | None = None) -> SetupState:
    """Generate a keypair, exchange public keys, then exchange encrypted MAC
    key shares (party 0 sends first throughout)."""
    if gen is None:
        gen = fresh_generator(params.device)
    keypair = keygen(params, gen)

    # round 1: public keys
    other_a, other_b = (peer_residues(params._q, params.n, pk) for pk in _exchange(
        transport, to_uint32(keypair.pk_a), to_uint32(keypair.pk_b)))

    # round 2: enc(mac_share) under OUR key (the peer multiplies its
    # plaintexts by our MAC share homomorphically and returns masked results)
    my_mac_enc = encrypt_slots(params, keypair.pk_a, keypair.pk_b, mac_share_slots, gen)
    return SetupState(params=params, keypair=keypair, other_pk_a=other_a,
                      other_pk_b=other_b,
                      other_mac_enc=exchange_ciphertext(transport, params, my_mac_enc))
