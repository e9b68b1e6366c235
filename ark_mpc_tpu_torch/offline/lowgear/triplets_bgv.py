"""BGV-based LowGear triple generation over the prototype's plaintext field
F_t (the Fig. 7 pipeline).

Counterpart of `ark_mpc_tpu/offline/lowgear/triplets_bgv.py`
(`offline-phase/src/lowgear/triplets.rs:30-234`): both parties sample slot
vectors a, b; exchange enc(a) under a ZK proof of plaintext knowledge
(V = 32 challenge rows, `offline/bgv/zkpok.py`); compute the cross
products homomorphically with drowning masks (`share_product`); and
authenticate every share against the counterparty's encrypted MAC key
(`authenticate_vec`).

Generic over the BGV plaintext prime t, with the small test parameter sets
(`offline/bgv/params.py`): the PROTOTYPE.  The production pipeline over
l is `triplets_l.py`, ZK-gated at 2^-128.  Slot vectors are int64 tensors
(N,) of values below t on the parameter set's device; randomness comes
from a `torch.Generator` (the reference's from a `jax.random` key), and
every residue array the peer sends is checked (`setup.peer_residues`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...fabric import messages
from ...fabric.transport import Transport
from ...ops import modular32 as m32
from ..bgv.bgv import Ciphertext, add_pt, decrypt_slots, encode_slots, mul_pt, rerandomize
from ..bgv.zkpok import (
    CiphertextWithProof,
    encrypt_and_prove_batch,
    proof_from_arrays,
    proof_to_arrays,
    verify_proof,
)
from ..errors import KeyExchangeError
from .setup import SetupState, exchange_ciphertext, peer_residues

ZK_V = 32  # challenge rows of the enc(a) proof (soundness 2^-32 a batch)


def _rand_slots(params, gen: torch.Generator, n=None) -> torch.Tensor:
    return torch.randint(0, params.t, (n or params.n,), generator=gen,
                         device=params.device, dtype=torch.int64)


def _slot_mul(params, a, b):
    # mont_mul32(a R, b) = a b directly (one Montgomery factor cancels)
    spec = params.t_spec
    return m32.mont_mul32(spec, m32.to_mont32(spec, a), b)


def _slot_add(params, a, b):
    return m32.add32(params.t_spec, a, b)


def _slot_sub(params, a, b):
    return m32.sub32(params.t_spec, a, b)


def share_product(transport: Transport, st: SetupState, enc_other: Ciphertext,
                  my_factor, gen: torch.Generator):
    """One direction of the LowGear cross product, both ways in one round:
    given the peer's enc(x) (under THEIR key), send enc(x) my_factor - mask,
    drowned, for the peer to decrypt; decrypt what the peer sent.
    -> (my mask, my decrypted share of the peer's product)."""
    params = st.params
    mask = _rand_slots(params, gen)
    prod = mul_pt(params, enc_other, encode_slots(params, my_factor))
    neg_mask = _slot_sub(params, torch.zeros_like(mask), mask)
    masked = add_pt(params, prod, encode_slots(params, neg_mask))
    masked = rerandomize(params, st.other_pk_a, st.other_pk_b, masked, gen)
    theirs = exchange_ciphertext(transport, params, masked)
    dec = torch.from_numpy(decrypt_slots(params, st.keypair.sk, theirs).astype(np.int64))
    return mask, dec.to(params.device)


def authenticate_vec(transport: Transport, st: SetupState, my_key_share, values,
                     gen: torch.Generator) -> torch.Tensor:
    """MAC shares of an additively shared vector (`triplets.rs:104-114`):
    mac^i = key_i v_i + [share of key_j v_i] + [share of key_i v_j]."""
    params = st.params
    mask, dec = share_product(transport, st, st.other_mac_enc, values, gen)
    local = _slot_mul(params, values, int(my_key_share))
    return _slot_add(params, local, _slot_add(params, mask, dec))


@dataclass
class BgvTriples:
    """Authenticated triple shares over F_t (slot vectors)."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    a_mac: torch.Tensor
    b_mac: torch.Tensor
    c_mac: torch.Tensor


def generate_triples(transport: Transport, st: SetupState, my_key_share,
                     gen: torch.Generator) -> BgvTriples:
    """One PoK batch of triples (n = slots): a = a0 + a1, b = b0 + b1,
    c = a b via homomorphic cross products; all three authenticated."""
    trip, _ = generate_triple_pairs(transport, st, my_key_share, gen, with_pair=False)
    return trip


def _peer_proof(st: SetupState, items) -> CiphertextWithProof:
    """The peer's enc(a) proof from its frame, every part checked."""
    params = st.params
    if not isinstance(items, list) or len(items) != 8:
        raise KeyExchangeError("peer sent a malformed proof frame")
    c0, c1, a0, a1, zb, *resp = items
    for r in (c0, c1):
        peer_residues(params._q, params.n, r, (1,))
    for r in (a0, a1):
        peer_residues(params._q, params.n, r, (ZK_V,))
    if not isinstance(zb, bytes) or len(zb) != ZK_V * params.n * 16:
        raise KeyExchangeError("peer sent a malformed proof response")
    for r in resp:
        if not isinstance(r, np.ndarray) or r.dtype != np.int64 or r.shape != (ZK_V, params.n):
            raise KeyExchangeError("peer sent a malformed proof response")
    return proof_from_arrays(items, ZK_V, params.n, device=params.device)


def generate_triple_pairs(transport: Transport, st: SetupState, my_key_share,
                          gen: torch.Generator, with_pair: bool = True):
    """LowGear Fig. 7 shape: (a, b, c = a b) plus, sharing the SAME a and the
    same exchanged enc(a), a second (b', c' = a b'), which the pair
    sacrifice consumes (`triplets.rs:30-147`).  The proof's masks come from
    an OS-entropy CSPRNG."""
    params = st.params
    a_i = _rand_slots(params, gen)
    b_i = _rand_slots(params, gen)

    # round 1: exchange enc(a_i) gated on a ZK proof of plaintext knowledge
    # (`triplets.rs:69-81`)
    coeffs = encode_slots(params, a_i)[None]
    proof = encrypt_and_prove_batch(params, st.keypair.pk_a, st.keypair.pk_b, coeffs, gen,
                                    v=ZK_V)
    frame = messages.encode_arrays(proof_to_arrays(proof))
    peer_proof = _peer_proof(st, messages.decode_arrays(transport.exchange(frame)))
    if not verify_proof(params, st.other_pk_a, st.other_pk_b, peer_proof):
        raise KeyExchangeError("peer's ciphertext proof of knowledge failed")
    enc_other_a = Ciphertext(peer_proof.cts.c0[0], peer_proof.cts.c1[0])

    def product_with(b_vec):
        mask, dec = share_product(transport, st, enc_other_a, b_vec, gen)
        c_vec = _slot_add(params, _slot_mul(params, a_i, b_vec), _slot_add(params, mask, dec))
        b_mac = authenticate_vec(transport, st, my_key_share, b_vec, gen)
        c_mac = authenticate_vec(transport, st, my_key_share, c_vec, gen)
        return c_vec, b_mac, c_mac

    c_i, b_mac, c_mac = product_with(b_i)
    a_mac = authenticate_vec(transport, st, my_key_share, a_i, gen)
    trip = BgvTriples(a_i, b_i, c_i, a_mac, b_mac, c_mac)
    if not with_pair:
        return trip, None
    b2_i = _rand_slots(params, gen)
    c2_i, b2_mac, c2_mac = product_with(b2_i)
    return trip, BgvTriples(a_i, b2_i, c2_i, a_mac, b2_mac, c2_mac)
