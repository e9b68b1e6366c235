"""LowGear triple generation over the share field F_l.

Counterpart of `ark_mpc_tpu/offline/lowgear/triplets_l.py`: BGV over l
(`offline/bgv/bgv_l.py`) drives the Fig. 7 flow of LowGear
(`lowgear/triplets.rs:30-234`): key exchange with a proved encryption of
each party's MAC-key share, the ZK-gated enc(a) exchange, homomorphic cross
products with drowning, and homomorphic MACs.  The outputs are
`ScalarShare` batches over the Curve25519 order field that `MpcFabric`
consumes directly.  Also authenticated shared randomness the real way
(`lowgear/shared_random.rs:56-71`): local sampling + homomorphic MAC.

One call makes whole slot batches (`ring.slots` values each: 24,480 at the
production ring).  `generate_triple_pairs_batch_l` stacks any number of
them into 3 wire rounds a call; every l-field ciphertext exchange is gated
by the word-form proof (`offline/bgv/zkpok_words.py`) at 2^-128 knowledge
error (`ZK_ROWS`).

Randomness.  Every value that reaches a share comes from the caller's host
numpy generator, drawn in the reference's order and shapes; keys,
encryption randomness and drowning noise come from one `torch.Generator`
on the ring's device, consumed in sequence where the reference splits a
`jax.random` key.  The BGV randomness cancels in decryption, so the same
numpy seeds give the reference's shares bit for bit, whatever the keys.

Received residues (public keys, proved and product ciphertexts) must be
uint32 arrays of the expected shape with every residue below its prime, or
`KeyExchangeError`.  Each stage's seconds are added to `SetupL.timing`
under the reference's `ARK_MPC_TIMING` labels (plus `zk/prove` and
`zk/verify`); nothing is printed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ...algebra.scalar import Scalar
from ...algebra.share import ScalarShare
from ...fabric.transport import Transport
from ..bgv.bgv_l import (
    CiphertextL,
    KeypairL,
    add_pt_l,
    decode_slots_l,
    decrypt_l,
    encode_slots_l,
    keygen_l,
    mul_pt_l,
    rerandomize_l,
)
from ..bgv.zkpok_words import (
    encrypt_and_prove_batch,
    proof_from_arrays,
    proof_to_arrays,
    verify_proof,
)
from ..errors import KeyExchangeError
from ...ops.modular32 import to_uint32
from .setup import _exchange, peer_residues

ZK_ROWS = 128  # Fiat-Shamir binary challenge rows: knowledge error 2^-128
#                per exchange (`mp-spdz-rs/src/fhe/keys.rs:74-81`,
#                `fhe/params.rs:13` DEFAULT_DROWN_SEC)


def stack_chunk(ring) -> int:
    """Slot-batch rows per stacked call for this ring.  It is also the unit
    `LowGear` rounds its batch counts up to, so it fixes how many triples a
    call makes and how many values it draws: 4 at the production ring, 64
    at the test and medium rings, as in the reference."""
    row_bytes = len(ring.q_specs) * ring.phi * 4 * 2
    c = min(64, max(1, (384 << 20) // (row_bytes * 9)))
    if c <= 4:
        return 4
    return 1 << (c.bit_length() - 1)  # round down to a power of two


@dataclass
class SetupL:
    """Per-party state after the l-field key exchange.  `timing` adds up
    each stage's seconds (host clock) by label; clear it to start over."""

    ring: object
    keypair: KeypairL
    other_pk_a: torch.Tensor
    other_pk_b: torch.Tensor
    other_mac_enc: CiphertextL
    mac_key_share: Scalar  # shape ()
    timing: dict = field(default_factory=dict)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(st: SetupL, label: str, t0: float) -> float:
    now = time.perf_counter()
    st.timing[label] = st.timing.get(label, 0.0) + (now - t0)
    return now


def key_exchange_l(transport: Transport, ring, rng: np.random.Generator,
                   gen: torch.Generator) -> SetupL:
    """Sample a MAC key share, generate a BGV keypair, exchange PKs and
    encrypted MAC shares (`setup.rs:13-32` over the real field).  The
    MAC-share ciphertext exchange is gated behind the l-field proof, as the
    reference's `run_key_exchange` (encrypt_and_prove / verify_proof)."""
    kp = keygen_l(ring, gen)
    mac_key_share = Scalar.random((), rng, device=ring.device)

    other_a, other_b = _exchange(transport, to_uint32(kp.pk_a), to_uint32(kp.pk_b))
    st = SetupL(ring, kp, peer_residues(ring._q, ring.phi, other_a, ()),
                peer_residues(ring._q, ring.phi, other_b, ()), None, mac_key_share)
    key_slots = Scalar(mac_key_share.broadcast_to((ring.slots,)).limbs.contiguous())
    st.other_mac_enc = _exchange_encryption_proven(
        transport, st, encode_slots_l(ring, key_slots), rng, gen)
    return st


def _masked_products_l(ring, pk_a, pk_b, ct: CiphertextL, factors: Scalar,
                       neg_masks: Scalar, gen: torch.Generator) -> CiphertextL:
    """The cross-product compute stage over a stacked batch
    (`triplets.rs:155-183` homomorphic side): enc_other(x) * factors -
    masks, drowned.  `factors`/`neg_masks` are (rows, S) slot stacks; `ct`
    is (L, phi) (broadcast over the rows) or (rows, L, phi)."""
    prod = mul_pt_l(ring, ct, encode_slots_l(ring, factors))
    masked = add_pt_l(ring, prod, encode_slots_l(ring, neg_masks))
    return rerandomize_l(ring, pk_a, pk_b, masked, gen)


def _decrypt_decode_l(ring, sk, ct: CiphertextL) -> Scalar:
    """Batched decrypt + slot decode."""
    return decode_slots_l(ring, decrypt_l(ring, sk, ct))


def share_products_grouped_l(transport: Transport, st: SetupL, groups: list,
                             rng: np.random.Generator, gen: torch.Generator):
    """N cross-products over F_l with ONE wire exchange
    (`triplets.rs:155-234`, coalesced): `groups` is a list of
    `(enc_other, factors)` where `factors` is a Scalar stack (Ni, S) and
    `enc_other` a CiphertextL of shape (L, phi) (same ciphertext for every
    row, e.g. enc(mac_share)) or (Ni, L, phi).  Both parties MUST pass
    groups in the same canonical order: rows ride one frame each way.
    Compute runs in `stack_chunk(ring)`-row stacked calls (a device-memory
    cap; the values do not depend on it); the results are read back with
    one copy.
    Returns [(mask_i, dec_i)] per group, each (Ni, S)."""
    ring = st.ring
    chunk = stack_chunk(ring)
    t0 = time.perf_counter()
    sizes = [int(f.shape[0]) for _, f in groups]
    masks = [Scalar.random((n, ring.slots), rng, device=ring.device) for n in sizes]
    t0 = _mark(st, "grouped/mask-sample", t0)

    c0s, c1s = [], []
    for (ct, factors), mask, n in zip(groups, masks, sizes):
        neg = -mask
        for beg in range(0, n, chunk):
            end = min(beg + chunk, n)
            sub = ct if ct.c0.dim() == 2 else CiphertextL(ct.c0[beg:end], ct.c1[beg:end])
            out = _masked_products_l(ring, st.other_pk_a, st.other_pk_b, sub,
                                     factors[beg:end], neg[beg:end], gen)
            c0s.append(out.c0)
            c1s.append(out.c1)
    t0 = _mark(st, "grouped/compute-dispatch", t0)
    frame = to_uint32(torch.stack([torch.cat(c0s), torch.cat(c1s)]))
    del c0s, c1s
    t0 = _mark(st, "grouped/readback", t0)

    their0, their1 = _exchange(transport, frame[0], frame[1])
    t0 = _mark(st, "grouped/exchange", t0)

    total = sum(sizes)
    th0 = peer_residues(ring._q, ring.phi, their0, (total,))
    th1 = peer_residues(ring._q, ring.phi, their1, (total,))
    decs, off = [], 0
    for n in sizes:
        parts = [_decrypt_decode_l(ring, st.keypair.sk,
                                   CiphertextL(th0[beg:min(beg + chunk, off + n)],
                                               th1[beg:min(beg + chunk, off + n)]))
                 for beg in range(off, off + n, chunk)]
        decs.append(parts[0] if len(parts) == 1 else Scalar.concatenate(parts))
        off += n
    _sync(ring.device)
    _mark(st, "grouped/decrypt", t0)
    return list(zip(masks, decs))


def share_product_l(transport: Transport, st: SetupL, enc_other: CiphertextL,
                    my_factor: Scalar, rng: np.random.Generator, gen: torch.Generator):
    """Cross-product step over F_l (`triplets.rs:155-234`): returns
    (my mask share, decrypted share of the peer's product).  Single-row
    form of `share_products_grouped_l`."""
    S = st.ring.slots
    (mask, dec), = share_products_grouped_l(
        transport, st, [(enc_other, my_factor.reshape(1, S))], rng, gen)
    return mask.reshape(S), dec.reshape(S)


def authenticate_vec_l(transport: Transport, st: SetupL, values: Scalar,
                       rng: np.random.Generator, gen: torch.Generator) -> Scalar:
    """Homomorphic MAC shares of an additively shared vector
    (`triplets.rs:104-114`)."""
    mask, dec = share_product_l(transport, st, st.other_mac_enc, values, rng, gen)
    return values * st.mac_key_share + mask + dec


def _exchange_encryptions_proven(transport: Transport, st: SetupL,
                                 pt_coeff_list: list, rng, gen: torch.Generator) -> CiphertextL:
    """Exchange U ciphertexts each way under ONE amortized proof of
    plaintext knowledge (`params.rs:65-67`: one proof covers a batch, so
    the V challenge rows are paid once per U).  Proving runs under OUR
    public key, verification under the PEER's.  -> the peer's ciphertexts,
    (U, L, phi)."""
    ring = st.ring
    u = len(pt_coeff_list)
    t0 = time.perf_counter()
    proof = encrypt_and_prove_batch(ring, st.keypair.pk_a, st.keypair.pk_b,
                                    pt_coeff_list, gen, v=ZK_ROWS, host_rng=rng)
    items = proof_to_arrays(proof)
    del proof
    t0 = _mark(st, "zk/prove", t0)
    peer_items = _exchange(transport, *items)
    del items
    t0 = time.perf_counter()
    if len(peer_items) != 8:
        raise KeyExchangeError(f"peer's proof has {len(peer_items)} arrays, expected 8")
    cts = [peer_residues(ring._q, ring.phi, c, (u,)) for c in peer_items[:2]]
    peer = proof_from_arrays(cts + list(peer_items[2:]), device=ring.device)
    # v and expected_u are PINNED to the protocol's values, never read from
    # the peer's proof (a short proof would shrink soundness)
    if not verify_proof(ring, st.other_pk_a, st.other_pk_b, peer, v=ZK_ROWS, expected_u=u):
        raise KeyExchangeError("peer's l-field ciphertext proof failed")
    _mark(st, "zk/verify", t0)
    return peer.cts


def _exchange_encryption_proven(transport: Transport, st: SetupL, pt_coeffs: Scalar,
                                rng, gen: torch.Generator) -> CiphertextL:
    """Single-ciphertext form of `_exchange_encryptions_proven` (key
    exchange, `setup.rs:13-32`)."""
    cts = _exchange_encryptions_proven(transport, st, [pt_coeffs], rng, gen)
    return CiphertextL(cts.c0[0], cts.c1[0])


def generate_triples_l(transport: Transport, st: SetupL, rng: np.random.Generator,
                       gen: torch.Generator):
    """One slot-batch of authenticated triples over F_l:
    ([a], [b], [c=a*b]) as ScalarShares of shape (slots,)."""
    ring = st.ring
    S = ring.slots
    a_i = Scalar.random((1, S), rng, device=ring.device)
    b_i = Scalar.random((1, S), rng, device=ring.device)

    enc_a = _exchange_encryptions_proven(
        transport, st, [encode_slots_l(ring, a_i[0])], rng, gen)

    mac = st.other_mac_enc
    # one exchange: the b-product + auths of a and b
    (mc, dc), (ma, da), (mb, db) = share_products_grouped_l(
        transport, st, [(enc_a, b_i), (mac, a_i), (mac, b_i)], rng, gen)
    c_i = a_i * b_i + mc + dc
    k_s = st.mac_key_share
    a_mac = a_i * k_s + ma + da
    b_mac = b_i * k_s + mb + db
    # second exchange: authenticate c
    (mcm, dcm), = share_products_grouped_l(transport, st, [(mac, c_i)], rng, gen)
    c_mac = c_i * k_s + mcm + dcm

    return (
        ScalarShare(a_i.reshape(S), a_mac.reshape(S)),
        ScalarShare(b_i.reshape(S), b_mac.reshape(S)),
        ScalarShare(c_i.reshape(S), c_mac.reshape(S)),
    )


def generate_triple_pairs_l(transport: Transport, st: SetupL, rng: np.random.Generator,
                            gen: torch.Generator):
    """Fig. 7 pair over F_l: (a, b, c=ab) and (a, b', c'=ab') sharing the
    same a and the same exchanged enc(a): the sacrifice's input."""
    return generate_triple_pairs_batch_l(transport, st, 1, rng, gen)


def generate_triple_pairs_batch_l(transport: Transport, st: SetupL, n_batches: int,
                                  rng: np.random.Generator, gen: torch.Generator):
    """`n_batches` slot-batches of Fig. 7 pairs, fully coalesced
    (`lowgear/triplets.rs:30-234`, stacked across slot-batches):

      - all `n_batches` enc(a) ciphertexts ride ONE ZK proof
        (`params.rs:65-67`);
      - the 5U independent cross-products of stage A (c = a*b, c' = a*b',
        and the homomorphic MACs of a, b, b') ride ONE wire exchange in the
        canonical row order [c | c' | auth a | auth b | auth b'];
      - stage B (MACs of the derived c, c', which depend on stage A's
        decryptions) rides a second single exchange.

    3 wire rounds a call, whatever `n_batches`.  Returns the 5-tuple (a, b,
    c, b', c') of ScalarShares, shape (n_batches * slots,)."""
    ring = st.ring
    S = ring.slots
    U = n_batches
    dev = ring.device
    a = Scalar.random((U, S), rng, device=dev)
    b1 = Scalar.random((U, S), rng, device=dev)
    b2 = Scalar.random((U, S), rng, device=dev)

    t0 = time.perf_counter()
    pts = encode_slots_l(ring, a)
    enc_a = _exchange_encryptions_proven(transport, st, [pts[i] for i in range(U)], rng, gen)
    _mark(st, "pairs/enc_a-proof-exchange", t0)
    mac = st.other_mac_enc
    k_s = st.mac_key_share

    # stage A: both products + auths of a, b, b' -- ONE exchange
    (m1, d1), (m2, d2), (ma, da), (mb1, db1), (mb2, db2) = share_products_grouped_l(
        transport, st, [(enc_a, b1), (enc_a, b2), (mac, a), (mac, b1), (mac, b2)], rng, gen)
    c1 = a * b1 + m1 + d1
    c2 = a * b2 + m2 + d2
    a_mac = a * k_s + ma + da
    b1_mac = b1 * k_s + mb1 + db1
    b2_mac = b2 * k_s + mb2 + db2

    # stage B: auths of c, c' -- ONE exchange
    (mc1, dc1), (mc2, dc2) = share_products_grouped_l(
        transport, st, [(mac, c1), (mac, c2)], rng, gen)
    c1_mac = c1 * k_s + mc1 + dc1
    c2_mac = c2 * k_s + mc2 + dc2

    n = U * S
    return (
        ScalarShare(a.reshape(n), a_mac.reshape(n)),
        ScalarShare(b1.reshape(n), b1_mac.reshape(n)),
        ScalarShare(c1.reshape(n), c1_mac.reshape(n)),
        ScalarShare(b2.reshape(n), b2_mac.reshape(n)),
        ScalarShare(c2.reshape(n), c2_mac.reshape(n)),
    )


def generate_input_masks_l(transport: Transport, st: SetupL, n: int, local_first: bool,
                           rng: np.random.Generator, gen: torch.Generator):
    """Input masks over F_l (`lowgear/input_masks.rs:15-58`): the OWNING
    party samples the cleartext mask and holds it as its whole share; the
    counterparty's share is 0; MACs come from the homomorphic authenticate.

    `local_first`: my stream before the peer's (both parties agree: party
    0's masks first).  The batch count rounds UP to `stack_chunk(ring)` and
    every generated mask is returned: the surplus is inventory for the
    caller's stores.  Returns (my clear masks, my share of stream A, my
    share of stream B), stream A being party 0's masks."""
    ring = st.ring
    S = ring.slots
    c = stack_chunk(ring)
    n_chunks = max(c, -(-max(1, -(-n // S)) // c) * c)
    mine = Scalar.random((n_chunks, S), rng, device=ring.device)
    zeros = Scalar.zeros((n_chunks, S), device=ring.device)
    # canonical group order: party 0's stream first; ONE exchange for both
    va, vb = (mine, zeros) if local_first else (zeros, mine)
    (ma, da), (mb, db) = share_products_grouped_l(
        transport, st, [(st.other_mac_enc, va), (st.other_mac_enc, vb)], rng, gen)
    k_s = st.mac_key_share
    total = n_chunks * S
    share_a = ScalarShare(va.reshape(total), (va * k_s + ma + da).reshape(total))
    share_b = ScalarShare(vb.reshape(total), (vb * k_s + mb + db).reshape(total))
    my_clear = mine.reshape(total)
    if local_first:
        return my_clear, share_a, share_b
    return my_clear, share_b, share_a


def generate_authenticated_randomness_l(transport: Transport, st: SetupL,
                                        rng: np.random.Generator, gen: torch.Generator,
                                        n_batches: int = 1) -> ScalarShare:
    """Authenticated random shares (`lowgear/shared_random.rs:56-71`):
    sample locally, authenticate homomorphically, all `n_batches`
    slot-batches under ONE wire exchange."""
    S = st.ring.slots
    r = Scalar.random((n_batches, S), rng, device=st.ring.device)
    (m, d), = share_products_grouped_l(transport, st, [(st.other_mac_enc, r)], rng, gen)
    n = n_batches * S
    return ScalarShare(r.reshape(n), (r * st.mac_key_share + m + d).reshape(n))
