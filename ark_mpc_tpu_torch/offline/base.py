"""Preprocessing-phase interface and test/dealer sources.

Counterpart of `ark_mpc_tpu/offline/base.py`: the interface the online
fabric consumes offline material through (MAC key share, input masks,
shared bits/values/inverse pairs, Beaver triples), batch-first, plus

  - `PartyIDBeaverSource`: the deterministic mock: a=2, b=3, c=6 with
    [a]=(1,1), [b]=(3,0), [c]=(2,4); MAC key share = party_id (global key 1).
  - `TrustedDealerSource`: honest-dealer randomized preprocessing from a
    seed both parties share.  It draws from the same host numpy generator
    in the same order as the reference, so one seed gives the same material
    bit for bit in both packages.

Both take a `device` (default: the CUDA card) on which they serve material.
"""

from __future__ import annotations

import numpy as np

from ..algebra.scalar import Scalar
from ..algebra.share import ScalarShare
from ..device import resolve_device


class PreprocessingPhase:
    """Source of offline randomness for one party (batch-first API)."""

    def get_mac_key_share(self) -> Scalar:
        raise NotImplementedError

    def next_triplet_batch(self, n: int):
        """-> ([a], [b], [c]) ScalarShares of shape (n,) with c = a*b."""
        raise NotImplementedError

    def next_shared_value_batch(self, n: int) -> ScalarShare:
        raise NotImplementedError

    def next_shared_inverse_pair_batch(self, n: int):
        """-> ([r], [r^-1]) of shape (n,)."""
        raise NotImplementedError

    def next_shared_bit_batch(self, n: int) -> ScalarShare:
        raise NotImplementedError

    def next_local_input_mask_batch(self, n: int):
        """-> (mask cleartext Scalar(n,), [mask] ScalarShare(n,))."""
        raise NotImplementedError

    def next_counterparty_input_mask_batch(self, n: int) -> ScalarShare:
        raise NotImplementedError

    def next_matrix_triplet(self, m: int, k: int, n: int):
        """Matrix Beaver triple ([P](m,k), [Q](k,n), [P@Q](m,n))."""
        raise NotImplementedError(
            "matrix triples come with slice B of ROADMAP.md (ops/matmul.py)")

    def next_poly_triplet(self, da: int, db: int):
        """Polynomial Beaver triple ([P] deg da, [Q] deg db, [P*Q])."""
        raise NotImplementedError(
            "polynomial triples come with slice B of ROADMAP.md (algebra/poly.py)")


class PartyIDBeaverSource(PreprocessingPhase):
    """Deterministic mock preprocessing."""

    def __init__(self, party_id: int, device=None):
        if party_id not in (0, 1):
            raise ValueError(f"party_id must be 0 or 1, got {party_id}")
        self.party_id = party_id
        self.device = resolve_device(device)

    def _ints(self, values) -> Scalar:
        return Scalar.from_ints(values, device=self.device)

    def get_mac_key_share(self) -> Scalar:
        return Scalar.from_ints(self.party_id, device=self.device)

    def _const_share(self, share_val: int, value: int, n: int) -> ScalarShare:
        pid = self.party_id
        return ScalarShare(self._ints([share_val] * n),
                           self._ints([pid * value] * n))

    def next_triplet_batch(self, n: int):
        if self.party_id == 0:
            sa, sb, sc = 1, 3, 2
        else:
            sa, sb, sc = 1, 0, 4
        return (
            self._const_share(sa, 2, n),
            self._const_share(sb, 3, n),
            self._const_share(sc, 6, n),
        )

    def next_shared_value_batch(self, n: int) -> ScalarShare:
        pid = self.party_id
        return ScalarShare(self._ints([pid] * n), self._ints([pid] * n))

    def next_shared_inverse_pair_batch(self, n: int):
        v = self.next_shared_value_batch(n)
        return v, self.next_shared_value_batch(n)

    def next_shared_bit_batch(self, n: int) -> ScalarShare:
        return self.next_shared_value_batch(n)

    def next_local_input_mask_batch(self, n: int):
        pid = self.party_id
        mask = self._ints([3] * n)
        share = ScalarShare(self._ints([pid * 3] * n), self._ints([pid * 3] * n))
        return mask, share

    def next_counterparty_input_mask_batch(self, n: int) -> ScalarShare:
        pid = self.party_id
        value = 3 * pid
        return ScalarShare(self._ints([value] * n), self._ints([pid * value] * n))


class TrustedDealerSource(PreprocessingPhase):
    """Honest-dealer randomized preprocessing from a shared seed.

    Both parties construct this with the same seed; each keeps only its own
    half.  The dealer samples the MAC key k = k0 + k1, values, and
    consistent MACs.  INSECURE by construction; exists for tests and
    benches.
    """

    def __init__(self, party_id: int, seed: int = 0, field=Scalar, device=None):
        if party_id not in (0, 1):
            raise ValueError(f"party_id must be 0 or 1, got {party_id}")
        self.party_id = party_id
        self.field = field
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        key_halves = self._rand_scalars(2)
        self._mac_key_shares = key_halves
        self.mac_key = key_halves[0] + key_halves[1]

    def _rand_scalars(self, n) -> Scalar:
        return self.field.random(n, self.rng, device=self.device)

    def _deal(self, values: Scalar) -> tuple[ScalarShare, ScalarShare]:
        """Split values into two authenticated shares."""
        n = values.shape[0]
        s0 = self._rand_scalars(n)
        s1 = values - s0
        macs = values * self.mac_key
        m0 = self._rand_scalars(n)
        m1 = macs - m0
        return ScalarShare(s0, m0), ScalarShare(s1, m1)

    def _mine(self, pair):
        return pair[self.party_id]

    def get_mac_key_share(self) -> Scalar:
        return self._mac_key_shares[self.party_id]

    def next_triplet_batch(self, n: int):
        a = self._rand_scalars(n)
        b = self._rand_scalars(n)
        c = a * b
        return (
            self._mine(self._deal(a)),
            self._mine(self._deal(b)),
            self._mine(self._deal(c)),
        )

    def next_shared_value_batch(self, n: int) -> ScalarShare:
        return self._mine(self._deal(self._rand_scalars(n)))

    def next_shared_inverse_pair_batch(self, n: int):
        r = self._rand_scalars(n)
        r_inv = r.inverse()
        return self._mine(self._deal(r)), self._mine(self._deal(r_inv))

    def next_shared_bit_batch(self, n: int) -> ScalarShare:
        bits = self.field.from_ints(self.rng.integers(0, 2, size=n).tolist(),
                                    device=self.device)
        return self._mine(self._deal(bits))

    # Input masks: the sending party calls `next_local_input_mask_batch` at
    # the same protocol step where the receiver calls
    # `next_counterparty_input_mask_batch`, so both draw the SAME mask and
    # share split from the synchronized dealer stream; each keeps its half.

    def next_local_input_mask_batch(self, n: int):
        mask = self._rand_scalars(n)
        shares = self._deal(mask)
        return mask, self._mine(shares)

    def next_counterparty_input_mask_batch(self, n: int) -> ScalarShare:
        mask = self._rand_scalars(n)
        shares = self._deal(mask)
        return self._mine(shares)
