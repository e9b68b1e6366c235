"""LowGear offline-phase orchestrator.

Counterpart of `ark_mpc_tpu/offline/lowgear/core.py` (`offline-phase/src/
lowgear/mod.rs:38-271`): holds the per-party state, sequences
`run_offline_phase` (`lowgear/mod.rs:178-190`): triples (with the
pair-sacrifice malicious check), inverse tuples, shared bits, shared
randomness, input masks; and packages a `LowGearPrep` the online fabric
consumes.

Two modes:

- mode="bgv" (the production path, dealer-free): raw triple pairs,
  authenticated randomness and input masks come from the BGV-over-l
  pipeline (`triplets_l.py`) after a key exchange with a proved
  enc(mac_share).  The pair sacrifice, MAC checks, inverse tuples and bit
  generation run downstream as two-party protocols over the transport.
- mode="dealer" (tests): raw candidate material comes from an honest-dealer
  source with the same shapes, so the downstream protocols run alone.

State lives on `device` (default: the CUDA card; in bgv mode the ring's
device).  The BGV randomness comes from one `torch.Generator` on that
device (`gen`), the shares' values from the host generator `rng`.
"""

from __future__ import annotations

import io
import json
import secrets
import time

import numpy as np
import torch

from ...algebra.scalar import Scalar
from ...device import resolve_device
from ...fabric.context import MpcFabric
from ...fabric.transport import Transport
from ...utils.csprng import default_crypto_rng
from ..base import TrustedDealerSource
from ..bgv.bgv_l import CiphertextL, KeypairL, production_ring, rlwe_secure_128
from ..bgv.cyclotomic import CyclotomicRing
from ..bgv.powerful import PowerfulRing
from ..errors import SacrificeError
from ..structs import LowGearPrep, OfflineSizingParams
from . import protocols, triplets_l

# The dealer mode's seed: both parties build the same dealer from it, as the
# reference's default does.
DEALER_SEED = 0xA5A5


def resolve_bgv_ring(ring, allow_insecure_ring: bool, device=None):
    """Ring-selection policy for bgv-mode `LowGear`: default to the
    RLWE-secure production ring (built on `device`); refuse rings failing
    the 128-bit check unless the caller explicitly opted out (tests and
    benchmarks)."""
    if ring is None:
        ring = production_ring(device=device)
    elif device is not None and ring.device != resolve_device(device):
        raise ValueError(f"ring lives on {ring.device}, LowGear asked for {device}")
    if not allow_insecure_ring and not rlwe_secure_128(ring):
        raise ValueError(
            f"ring m={ring.m} (phi={ring.phi}) fails the 128-bit RLWE "
            f"security check and was not explicitly allowed; pass "
            f"allow_insecure_ring=True ONLY for tests/benchmarks "
            f"(docs/security_params.md §2)")
    return ring


class LowGear:
    """Per-party offline-phase state machine."""

    def __init__(self, party_id: int, transport: Transport,
                 rng: np.random.Generator | None = None,
                 mode: str = "dealer",
                 ring=None, gen: torch.Generator | None = None, setup=None,
                 allow_insecure_ring: bool = False, device=None):
        """mode="bgv": dealer-free; mode="dealer": honest-dealer raw
        material (tests of the downstream protocols).

        `setup`: a previously exchanged `SetupL` (`get_setup_params` /
        `from_setup_params`): skips the key exchange, so a party can
        reconnect over a fresh transport (`LowGear::new_from_params`,
        `lowgear/mod.rs:92-127`).

        SECURE BY DEFAULT: in bgv mode the ring defaults to the production
        ring (m = 118965), and a ring failing the 128-bit RLWE check (the
        m = 132 prototype, the m = 1155 medium ring) is REFUSED unless
        `allow_insecure_ring=True`.  Without `rng`, values come from OS
        entropy; without `gen`, the BGV generator is seeded from it."""
        if mode not in ("dealer", "bgv"):
            raise ValueError(f"mode must be 'dealer' or 'bgv', got {mode!r}")
        self.party_id = party_id
        self.transport = transport
        self.mode = mode
        self.rng = default_crypto_rng() if rng is None else rng
        if mode == "bgv":
            candidate = setup.ring if setup is not None else ring
            self.ring = resolve_bgv_ring(candidate, allow_insecure_ring, device)
            self.device = self.ring.device
            if gen is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(secrets.randbits(63))
            self.gen = gen
            self.setup = setup if setup is not None else triplets_l.key_exchange_l(
                transport, self.ring, self.rng, self.gen)
            self.timing = self.setup.timing
            self.mac_key_share = self.setup.mac_key_share
            self._dealer = None
        else:
            self.device = resolve_device(device)
            self.timing = {}
            # Both parties construct the dealer with the same seed, mirroring
            # `mock_lowgear_with_keys` (`offline-phase/src/lib.rs:125-232`).
            self._dealer = TrustedDealerSource(party_id, seed=DEALER_SEED, device=self.device)
            self.mac_key_share = self._dealer.get_mac_key_share()
        self.prep = LowGearPrep(mac_key_share=self.mac_key_share)
        # The generation fabric's Beaver rounds consume triples out of the
        # prep stores being built (bgv mode) or raw dealer material.
        source = self.prep if mode == "bgv" else self._dealer
        self.fabric = MpcFabric(party_id, transport, source, rng=self.rng, device=self.device)

    def _round_batches(self, n_batches: int) -> int:
        """Round a slot-batch count up to `triplets_l.stack_chunk(ring)`, as
        the reference does: every call makes whole chunks, the surplus is
        kept as inventory."""
        c = triplets_l.stack_chunk(self.ring)
        return max(c, -(-n_batches // c) * c)

    # -- generation steps (`lowgear/mod.rs:178-190` sequencing) ------------

    def generate_triples(self, n: int) -> None:
        """Candidate triple pairs + pair sacrifice
        (`lowgear/triplets.rs:118-147`): with (a,b,c) and (a,b',c') sharing
        `a`, draw a public coin r, open rho = r*b - b', then check
        r*c - c' - rho*a opens to zero."""
        a, b, c, b2, c2 = self._raw_triple_pairs(n)
        n = a.size  # bgv mode rounds up to whole slot batches

        t0 = time.perf_counter()
        r = protocols.public_coin_scalars(self.fabric, n)
        rho = protocols.open_and_check_macs(self.fabric, b.mul_public(r) - b2)
        tau_share = c.mul_public(r) - c2 - a.mul_public(rho)
        tau = protocols.open_and_check_macs(self.fabric, tau_share)
        if not bool(tau.is_zero().all()):
            raise SacrificeError("triple sacrifice check failed")
        self.timing["sacrifice"] = self.timing.get("sacrifice", 0.0) + time.perf_counter() - t0
        self.prep.triples.add(a, b, c)

    def generate_inverse_tuples(self, n: int) -> None:
        a, a_inv = protocols.generate_inverse_tuples(self.fabric, n)
        self.prep.inverse_pairs.add(a, a_inv)

    def generate_shared_bits(self, n: int) -> None:
        self.prep.bits.add(protocols.generate_shared_bits(self.fabric, n))

    def generate_shared_randomness(self, n: int) -> None:
        if self.mode == "bgv":
            # local sampling + homomorphic MAC (`shared_random.rs:56-71`);
            # all slot-batches under ONE stacked exchange
            phi = self.ring.slots
            self.prep.randomness.add(triplets_l.generate_authenticated_randomness_l(
                self.transport, self.setup, self.rng, self.gen,
                n_batches=self._round_batches((n + phi - 1) // phi)))
            return
        self.prep.randomness.add(protocols.generate_shared_randomness(self.fabric, n))

    def generate_input_masks(self, n: int) -> None:
        """Input masks (`lowgear/input_masks.rs:15-58`).

        bgv mode generates whole rounded-up chunks and KEEPS the surplus: a
        later request that fits the inventory makes no BGV exchange.  (The
        skip is symmetric: both parties' stores shrink in lockstep.)"""
        if self.mode == "bgv":
            have = min(len(self.prep.my_mask_shares),
                       len(self.prep.counterparty_mask_shares))
            if have >= n:
                return  # served from the rounded-up surplus inventory
            clear, mine, cp = triplets_l.generate_input_masks_l(
                self.transport, self.setup, n - have,
                local_first=(self.party_id == 0), rng=self.rng, gen=self.gen)
            self.prep.my_masks_clear.append(clear)
            self.prep.my_mask_shares.add(mine)
            self.prep.counterparty_mask_shares.add(cp)
            return
        # Both parties consume the dealer streams in the SAME order: stream
        # 1 = party 0's local masks, stream 2 = party 1's.
        d = self._dealer
        if self.party_id == 0:
            clear, share = d.next_local_input_mask_batch(n)
            cp = d.next_counterparty_input_mask_batch(n)
        else:
            cp = d.next_counterparty_input_mask_batch(n)
            clear, share = d.next_local_input_mask_batch(n)
        self.prep.my_masks_clear.append(clear)
        self.prep.my_mask_shares.add(share)
        self.prep.counterparty_mask_shares.add(cp)

    def run_offline_phase(self, sizing: OfflineSizingParams) -> None:
        if self.mode == "bgv":
            # The derived protocols (inverse tuples, bits) run Beaver rounds
            # and draw randomness through the generation fabric, which in
            # bgv mode is backed by the prep stores themselves, so stock
            # enough BGV-generated material FIRST.
            extra_triples = sizing.num_inverse_pairs + sizing.num_bits
            extra_rand = 2 * sizing.num_inverse_pairs + sizing.num_bits
            self.generate_shared_randomness(sizing.num_randomness + extra_rand)
            self.generate_triples(sizing.num_triples + extra_triples)
        else:
            self.generate_triples(sizing.num_triples)
        self.generate_inverse_tuples(sizing.num_inverse_pairs)
        self.generate_shared_bits(sizing.num_bits)
        if self.mode != "bgv":
            self.generate_shared_randomness(sizing.num_randomness)
        self.generate_input_masks(sizing.num_input_masks)

    def get_offline_result(self) -> LowGearPrep:
        return self.prep

    # -- setup persistence (`lowgear/mod.rs:92-127`) ------------------------

    def get_setup_params(self) -> bytes:
        """Serialize the post-key-exchange state (ring identity, own BGV
        keypair, counterparty PK, counterparty's proved enc(MAC share), MAC
        key share) in the reference's blob layout, so the offline phase can
        resume over a fresh transport without a second key exchange
        (`lowgear/mod.rs:92-104`, `integration/src/lowgear.rs:19-24`)."""
        if self.mode != "bgv":
            raise ValueError("setup persistence is a bgv-mode feature")
        from ...convert import residues_to_numpy as u32  # convert imports this package

        r = self.ring
        kind = type(r).__name__
        meta = {"kind": kind, "m": int(r.m), "n_q": len(r.q_primes),
                "cbd_k": int(r.cbd_k), "drown_sec": int(r.drown_sec)}
        if kind == "PowerfulRing":
            meta["zk_sec"] = int(r.zk_sec)
            meta["u_max"] = int(r.u_max)
        st = self.setup
        buf = io.BytesIO()
        np.savez(
            buf,
            meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
            q_primes=np.asarray(r.q_primes, np.uint64),
            sk=u32(st.keypair.sk), pk_a=u32(st.keypair.pk_a), pk_b=u32(st.keypair.pk_b),
            other_pk_a=u32(st.other_pk_a), other_pk_b=u32(st.other_pk_b),
            mac_c0=u32(st.other_mac_enc.c0), mac_c1=u32(st.other_mac_enc.c1),
            mac_key_share=np.frombuffer(self.mac_key_share.to_bytes_le(), np.uint8),
        )
        return buf.getvalue()

    @classmethod
    def from_setup_params(cls, party_id: int, transport: Transport, blob: bytes,
                          rng: np.random.Generator | None = None,
                          gen: torch.Generator | None = None,
                          allow_insecure_ring: bool = False, device=None) -> "LowGear":
        """Rebuild a bgv-mode `LowGear` from a blob of either package's
        `get_setup_params` over a (possibly new) transport, on `device`;
        no key exchange (`LowGear::new_from_params`,
        `lowgear/mod.rs:107-127`)."""
        from ...convert import to_residues  # convert imports this package

        device = resolve_device(device)
        with np.load(io.BytesIO(blob)) as z:
            meta = json.loads(z["meta"].tobytes().decode())
            q_primes = [int(q) for q in z["q_primes"]]
            arrs = {k: z[k] for k in ("sk", "pk_a", "pk_b", "other_pk_a",
                                      "other_pk_b", "mac_c0", "mac_c1")}
            mac_bytes = z["mac_key_share"].tobytes()

        if meta["kind"] == "PowerfulRing":
            ring = PowerfulRing(meta["m"], n_q_primes=meta["n_q"], cbd_k=meta["cbd_k"],
                                drown_sec=meta["drown_sec"], zk_sec=meta["zk_sec"],
                                u_max=meta["u_max"], device=device)
        elif meta["kind"] == "CyclotomicRing":
            ring = CyclotomicRing(meta["m"], n_q_primes=meta["n_q"], cbd_k=meta["cbd_k"],
                                  drown_sec=meta["drown_sec"], device=device)
        else:
            raise ValueError(f"unknown ring kind {meta['kind']!r}")
        if [int(q) for q in ring.q_primes] != q_primes:
            raise ValueError("reconstructed ring RNS basis mismatch")

        dev = {k: to_residues(ring, v, lead=0) for k, v in arrs.items()}
        mac_key_share = Scalar.from_bytes_le(mac_bytes, device=device).reshape()
        st = triplets_l.SetupL(ring, KeypairL(ring, dev["sk"], dev["pk_a"], dev["pk_b"]),
                               dev["other_pk_a"], dev["other_pk_b"],
                               CiphertextL(dev["mac_c0"], dev["mac_c1"]), mac_key_share)
        return cls(party_id, transport, rng=rng, mode="bgv", gen=gen, setup=st,
                   allow_insecure_ring=allow_insecure_ring, device=device)

    # -- raw material (BGV swap-in point) ----------------------------------

    def _raw_triple_pairs(self, n: int):
        """-> ([a], [b], [c=ab], [b'], [c'=ab']) candidate authenticated
        triple pairs.  bgv mode: the BGV pipeline (`triplets.rs:30-114`), in
        whole chunks of slot-batches under one amortized proof; dealer mode
        keeps the same shapes for downstream-protocol tests."""
        if self.mode == "bgv":
            phi = self.ring.slots
            return triplets_l.generate_triple_pairs_batch_l(
                self.transport, self.setup, self._round_batches((n + phi - 1) // phi),
                self.rng, self.gen)
        d = self._dealer
        a_v = Scalar.random(n, d.rng, device=d.device)
        b_v = Scalar.random(n, d.rng, device=d.device)
        b2_v = Scalar.random(n, d.rng, device=d.device)
        a = d._mine(d._deal(a_v))
        b = d._mine(d._deal(b_v))
        c = d._mine(d._deal(a_v * b_v))
        b2 = d._mine(d._deal(b2_v))
        c2 = d._mine(d._deal(a_v * b2_v))
        return a, b, c, b2, c2
