"""The MPC fabric: an eager, round-based batched runtime on torch tensors.

Counterpart of `ark_mpc_tpu/fabric/context.py` (`MpcFabric`) without the
mesh, curve-point protocols and tracer, which come with later slices of the
port.  Shares are limb tensors on the fabric's device; each protocol step
is a batched computation followed by at most one coalesced exchange:

  - `open`: one message each way carrying all n shares, one local combine.
  - `open_authenticated`: open + MAC-check values + ONE commitment + one
    value exchange + one blinder exchange, regardless of n.
  - Beaver mul: one triple batch, one open round of the concatenated (d, e)
    masks, one combine (the `beaver_round` kernel on the card).
  - Party 0 always sends first.

Limbs travel as numpy uint32 arrays, so frames are byte-identical to the
reference's.  MAC checks can be deferred and verified by a single
commit-reveal round (optionally folded to one scalar by a public-coin
random linear combination).
"""

from __future__ import annotations

import numpy as np
import torch

from ..algebra import limbs as lb
from ..algebra.scalar import Scalar
from ..algebra.share import PARTY0, PARTY1, ScalarShare
from ..device import resolve_device
from ..offline.base import PreprocessingPhase
from ..ops import fp_kernels
from ..utils.csprng import CSPRNG, default_crypto_rng
from . import commitment, messages
from .errors import AuthenticationError
from .transport import Transport


def _wire(s: Scalar) -> np.ndarray:
    """A limb tensor as the uint32 numpy array the wire codec packs."""
    return s.limbs.cpu().numpy().astype(np.uint32)


class MpcFabric:
    """Two-party SPDZ online-phase context for one party.

    `device` (default: the CUDA card) is where shares live; the offline
    source must serve material on the same device."""

    def __init__(self, party_id: int, transport: Transport,
                 offline: PreprocessingPhase,
                 rng: np.random.Generator | None = None, device=None):
        if party_id != transport.party_id:
            raise ValueError("party_id does not match the transport's party")
        self.party_id = party_id
        self.transport = transport
        self.offline = offline
        self.device = resolve_device(device)
        self.mac_key = offline.get_mac_key_share()
        if self.mac_key.device != self.device:
            raise ValueError(
                f"offline source serves material on {self.mac_key.device}, "
                f"fabric runs on {self.device}")
        # the share field is carried by the offline source's MAC key
        self.field = type(self.mac_key)
        self.rng = default_crypto_rng() if rng is None else rng
        # deferred MAC-check accumulators (flattened d-value Scalars)
        self._deferred: list[Scalar] = []
        self.n_rounds = 0

    def _from_wire(self, arr: np.ndarray) -> Scalar:
        return self.field(torch.from_numpy(arr.astype(np.int32)).to(self.device))

    # -- low-level messaging ----------------------------------------------
    def _exchange_arrays(self, items):
        """One coalesced frame each way; party 0 sends first."""
        self.n_rounds += 1
        frame = messages.encode_arrays(items)
        return messages.decode_arrays(self.transport.exchange(frame))

    def send_arrays(self, items):
        self.transport.send(messages.encode_arrays(items))

    def recv_arrays(self):
        return messages.decode_arrays(self.transport.recv())

    def exchange_scalars(self, s: Scalar) -> Scalar:
        """Exchange Montgomery-form limb arrays."""
        (theirs,) = self._exchange_arrays([_wire(s)])
        return self._from_wire(theirs)

    # -- properties --------------------------------------------------------
    def mac_key_share(self) -> Scalar:
        return self.mac_key

    @property
    def peer_id(self) -> int:
        return PARTY1 if self.party_id == PARTY0 else PARTY0

    # -- input sharing -----------------------------------------------------
    def share_values(self, values: Scalar | None, sender: int,
                     n: int | None = None) -> ScalarShare:
        """Secret-share `values` held by `sender` into authenticated shares.

        The sender masks with an offline input mask and sends v - mask; both
        parties add the public masked value onto their mask share."""
        if self.party_id == sender:
            if values is None:
                raise ValueError("the sender must pass its values")
            n = values.size
            mask, mask_share = self.offline.next_local_input_mask_batch(n)
            masked = values.reshape(n) - mask
            self.send_arrays([_wire(masked)])
            shape = values.shape
        else:
            if n is None:
                raise ValueError("the receiver must pass n")
            mask_share = self.offline.next_counterparty_input_mask_batch(n)
            (raw,) = self.recv_arrays()
            masked = self._from_wire(raw)
            shape = masked.shape
        mask_share = mask_share.reshape(mask_share.size)
        out = mask_share.add_public(masked.reshape(masked.size), self.mac_key,
                                    self.party_id)
        return out.reshape(*shape)

    def share_public(self, values: Scalar) -> ScalarShare:
        """Both parties know `values`; produce a valid authenticated sharing
        (zero share + add_public), no communication."""
        zero = ScalarShare.zeros(values.shape, field=self.field, device=self.device)
        return zero.add_public(values, self.mac_key, self.party_id)

    # -- opening -----------------------------------------------------------
    def open(self, x: ScalarShare) -> Scalar:
        """Open shares without MAC check: one exchange of the share vector,
        one combine."""
        (theirs,) = self._exchange_arrays([_wire(x.share)])
        return x.share + self._from_wire(theirs)

    def open_authenticated(self, x: ScalarShare, defer: bool = False) -> Scalar:
        """Open and check MACs.

        With `defer=True` the commit-reveal check round is postponed; call
        `verify_deferred()` once at the end of the program.  Raises
        `AuthenticationError` on a bad MAC (malicious abort)."""
        value = self.open(x)
        d = self.mac_key * value - x.mac
        flat = d.reshape(d.size)
        if defer:
            self._deferred.append(flat)
        else:
            self._run_mac_check(flat)
        return value

    def verify_deferred(self, fold: bool = False) -> None:
        """Run ONE commit-reveal MAC check over every deferred open.

        With `fold=True` the check values are first collapsed to ONE scalar
        by a public-coin random linear combination (the SPDZ aggregated
        check): O(1) wire bytes instead of O(n)."""
        if not self._deferred:
            return
        d = (self._deferred[0] if len(self._deferred) == 1
             else self.field.concatenate(self._deferred))
        self._deferred = []
        if fold:
            self._run_mac_check_folded(d)
        else:
            self._run_mac_check(d)

    def public_coin_rng(self) -> CSPRNG:
        """Jointly-seeded CSPRNG via commit-reveal seed exchange (3 small
        rounds): each party commits to its 32-byte seed contribution before
        either reveals."""
        mine = self.rng.bytes(32)
        blinder = self.field.random((), self.rng, device=self.device)
        my_comm = commitment.commit_bytes(mine, blinder)
        peer_comm = self.exchange_scalars(my_comm)
        (peer_seed,) = self._exchange_arrays([bytes(mine)])
        peer_blinder = self.exchange_scalars(blinder)
        if not commitment.verify_bytes(bytes(peer_seed), peer_blinder, peer_comm):
            raise AuthenticationError("public coin commitment failed to verify")
        seeds = ((mine, bytes(peer_seed)) if self.party_id == PARTY0
                 else (bytes(peer_seed), mine))
        return CSPRNG(b"ark-mpc-tpu/public-coin" + seeds[0] + seeds[1])

    def _run_mac_check_folded(self, d: Scalar) -> None:
        """Fold d to one scalar with public-coin coefficients (sampled AFTER
        every d value is fixed), then one commit-reveal zero test."""
        coin = self.public_coin_rng()
        coeffs = self.field.random(d.size, coin, device=self.device)
        self._run_mac_check((d * coeffs).sum().reshape(1))

    def _run_mac_check(self, d: Scalar) -> None:
        """Commit-exchange-reveal-verify of MAC check values."""
        blinder = self.field.random((), self.rng, device=self.device)
        my_comm = commitment.commit(d, blinder)
        # Round 1: exchange commitments.
        peer_comm = self.exchange_scalars(my_comm)
        # Round 2: exchange MAC-check values (canonical limbs, hash-ready).
        canon = self.field(d.canonical_limbs())
        (peer_d_canon,) = self._exchange_arrays([_wire(canon)])
        # Round 3: exchange blinders.
        peer_blinder = self.exchange_scalars(blinder)

        # Verify: peer's commitment opens AND d_mine + d_peer == 0 pairwise.
        peer_d = self.field(lb.to_mont(self.field.spec,
                                       self._from_wire(peer_d_canon).limbs))
        if not commitment.verify(peer_d, peer_blinder, peer_comm):
            raise AuthenticationError("MAC check commitment failed to verify")
        if not bool((d + peer_d).is_zero().all()):
            raise AuthenticationError(
                "MAC check failed: shares of key*v - mac do not sum to zero")

    # -- authenticated arithmetic -----------------------------------------
    def mul(self, x: ScalarShare, y: ScalarShare) -> ScalarShare:
        """Beaver multiplication, element-wise over the batch: one triple
        batch, ONE open round for the concatenated (d, e) masks, one
        combine."""
        shape = x.shape
        n = x.size
        a, b, c = self.offline.next_triplet_batch(n)
        masked = self.field.concatenate([(x.reshape(n) - a).share,
                                         (y.reshape(n) - b).share])
        (theirs,) = self._exchange_arrays([_wire(masked)])
        opened = masked + self._from_wire(theirs)
        d, e = opened[:n], opened[n:]
        return self._beaver_combine_dispatch(a, b, c, d, e).reshape(*shape)

    def _beaver_combine_dispatch(self, a, b, c, d, e) -> ScalarShare:
        """Post-open Beaver combine through the `beaver_round` kernel (its
        plain version for CPU tensors).  The CUDA kernel masks its own tail,
        so every batch size takes it."""
        zs, zm = fp_kernels.beaver_round(
            self.field.spec, self.party_id,
            a.share.limbs, a.mac.limbs, b.share.limbs, b.mac.limbs,
            c.share.limbs, c.mac.limbs, d.limbs, e.limbs, self.mac_key.limbs)
        return ScalarShare(self.field(zs), self.field(zm))

    def mul_public(self, x: ScalarShare, k: Scalar) -> ScalarShare:
        return x.mul_public(k)

    def add_public(self, x: ScalarShare, k: Scalar) -> ScalarShare:
        return x.add_public(k, self.mac_key, self.party_id)

    def sub_public(self, x: ScalarShare, k: Scalar) -> ScalarShare:
        return x.sub_public(k, self.mac_key, self.party_id)

    def inverse(self, x: ScalarShare, defer_check: bool = False) -> ScalarShare:
        """Batched shared inversion via masked open: [x^-1] = r *
        open(x*r)^-1.  Zero inputs map to zero output."""
        shape = x.shape
        n = x.size
        r = self.random_shared_scalars(n)
        m = self.mul(x.reshape(n), r)
        m_open = self.open_authenticated(m, defer=defer_check)
        return r.mul_public(m_open.inverse()).reshape(*shape)

    def pow(self, x: ScalarShare, e: int) -> ScalarShare:
        """Public-exponent exponentiation: LSB-first square-and-multiply with
        each step's two independent products (result*base, base*base)
        batched into ONE width-2n Beaver round."""
        e = int(e)
        if e == 0:
            return self.share_public(self.field.ones(x.shape, device=self.device))
        shape = x.shape
        n = x.size
        result, base = None, x.reshape(n)
        while True:
            if e & 1:
                if result is None:
                    result = base
                elif e > 1:
                    both = self.mul(
                        ScalarShare.concatenate([result, base]),
                        ScalarShare.concatenate([base, base]),
                    )
                    result, base = both[:n], both[n:]
                    e >>= 1
                    continue
                else:
                    result = self.mul(result, base)
            e >>= 1
            if e == 0:
                break
            base = self.mul(base, base)
        return result.reshape(*shape)

    # -- offline sampling passthroughs ------------------------------------
    def next_triple_batch(self, n: int):
        return self.offline.next_triplet_batch(n)

    def random_shared_scalars(self, n: int) -> ScalarShare:
        return self.offline.next_shared_value_batch(n)

    def random_inverse_pairs(self, n: int):
        return self.offline.next_shared_inverse_pair_batch(n)

    def random_shared_bits(self, n: int) -> ScalarShare:
        return self.offline.next_shared_bit_batch(n)

    # -- constants ---------------------------------------------------------
    def zero_authenticated(self, shape=()) -> ScalarShare:
        return ScalarShare.zeros(shape, field=self.field, device=self.device)

    def one_authenticated(self, shape=()) -> ScalarShare:
        return self.share_public(self.field.ones(shape, device=self.device))

    def shutdown(self):
        self.transport.close()
