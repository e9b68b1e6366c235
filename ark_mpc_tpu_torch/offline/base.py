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
  - `ShardedSource`: one rank's slice of a source every rank of a mesh
    holds alike (what a mesh-attached `MpcFabric` draws through), or the
    whole batch, marked replicated, for replicated operands.

The first two take a `device` (default: the CUDA card) on which they serve material.
"""

from __future__ import annotations

import numpy as np

from ..algebra.placement import mark
from ..algebra.scalar import Scalar
from ..algebra.share import ScalarShare
from ..device import resolve_device
from ..parallel.step import batch_sharding, shard, shard_share


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
        """Matrix Beaver triple ([P](m,k), [Q](k,n), [P@Q](m,n)): shared
        matmul communication O(mk + kn) instead of O(mkn)."""
        raise NotImplementedError

    def next_poly_triplet(self, da: int, db: int):
        """Polynomial Beaver triple: coefficient ScalarShares of random polys
        ([P] deg da, [Q] deg db, [P*Q]).  A source without them makes
        `algebra.poly.poly_mul` take one scalar Beaver round instead."""
        raise NotImplementedError


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

    def next_matrix_triplet(self, m: int, k: int, n: int):
        pid = self.party_id

        def mat(shape, share_val, value):
            cnt = shape[0] * shape[1]
            return ScalarShare(self._ints([share_val] * cnt).reshape(*shape),
                               self._ints([pid * value] * cnt).reshape(*shape))

        # P = all-2, Q = all-3, C = P@Q = all-(6k); splits follow the scalar
        # triple's
        c_share = 2 * k if pid == 0 else 4 * k
        return (mat((m, k), 1, 2), mat((k, n), 3 if pid == 0 else 0, 3),
                mat((m, n), c_share, 6 * k))

    def next_poly_triplet(self, da: int, db: int):
        pid = self.party_id
        p_vals = [2] * (da + 1)
        q_vals = [3] * (db + 1)
        c_vals = [6 * (min(k, da) - max(0, k - db) + 1) for k in range(da + db + 1)]

        def share_of(vals, share_vals):
            return ScalarShare(self._ints(share_vals),
                               self._ints([pid * v for v in vals]))

        return (share_of(p_vals, [1] * (da + 1)),
                share_of(q_vals, [3 if pid == 0 else 0] * (db + 1)),
                share_of(c_vals, c_vals if pid == 0 else [0] * len(c_vals)))


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

    def next_matrix_triplet(self, m: int, k: int, n: int):
        p = self._rand_scalars(m * k).reshape(m, k)
        q = self._rand_scalars(k * n).reshape(k, n)
        c = p @ q

        def deal_mat(v):
            mine = self._mine(self._deal(v.reshape(v.size)))
            return mine.reshape(*v.shape)

        return deal_mat(p), deal_mat(q), deal_mat(c)

    def next_poly_triplet(self, da: int, db: int):
        from ..algebra.poly import _conv_coeffs

        p = self._rand_scalars(da + 1)
        q = self._rand_scalars(db + 1)
        c = self.field(_conv_coeffs(p.limbs, q.limbs))
        return (self._mine(self._deal(p)), self._mine(self._deal(q)),
                self._mine(self._deal(c)))


class ShardedSource(PreprocessingPhase):
    """One rank's view of a source that every rank of `mesh` (a
    `parallel.step.Mesh`) holds alike (the same dealer seed on every rank
    of a party).

    Asked for a batch of n, it draws the global batch of n * `size` from
    the wrapped source and keeps the rank's n: every rank draws the same
    stream, so the rank holds the material at its own global positions,
    which is what the reference's dealer places there, and no triple is
    used on two ranks.  `draw_whole` draws a batch whole instead, marked
    replicated (material for replicated operands); polynomial triples are
    always whole, and a matrix triple keeps the rank's rows of P and C and
    the whole Q.  The MAC key share is the wrapped source's, the same on
    every rank."""

    def __init__(self, inner: PreprocessingPhase, mesh):
        self.inner, self.mesh, self.size = inner, mesh, mesh.size

    def _keep(self, x):
        """The rank's columns of a global batch (Scalar or ScalarShare)."""
        return shard_share(x, self.mesh) if isinstance(x, ScalarShare) else shard(x, self.mesh)

    def draw_whole(self, method: str, *args):
        """The wrapped source's `method(*args)` as it is, every share (and
        cleartext) marked replicated: each rank draws the same material."""
        out = getattr(self.inner, method)(*args)
        for x in out if isinstance(out, tuple) else (out,):
            mark(x)
        return out

    def get_mac_key_share(self) -> Scalar:
        return self.inner.get_mac_key_share()

    def next_triplet_batch(self, n: int):
        return tuple(self._keep(s) for s in self.inner.next_triplet_batch(n * self.size))

    def next_shared_value_batch(self, n: int) -> ScalarShare:
        return self._keep(self.inner.next_shared_value_batch(n * self.size))

    def next_shared_inverse_pair_batch(self, n: int):
        return tuple(self._keep(s) for s in
                     self.inner.next_shared_inverse_pair_batch(n * self.size))

    def next_shared_bit_batch(self, n: int) -> ScalarShare:
        return self._keep(self.inner.next_shared_bit_batch(n * self.size))

    def next_local_input_mask_batch(self, n: int):
        return tuple(self._keep(s) for s in
                     self.inner.next_local_input_mask_batch(n * self.size))

    def next_counterparty_input_mask_batch(self, n: int) -> ScalarShare:
        return self._keep(self.inner.next_counterparty_input_mask_batch(n * self.size))

    def next_matrix_triplet(self, m: int, k: int, n: int):
        """The global triple ([P](m, k), [Q](k, n), [P@Q](m, n)): the rank's
        rows of P and C, and the whole Q, marked replicated.  `m` must be a
        multiple of the mesh size (`ValueError` naming the mesh)."""
        rows = batch_sharding(self.mesh, m)
        p, q, c = self.inner.next_matrix_triplet(m, k, n)
        return p[rows], mark(q), c[rows]

    def next_poly_triplet(self, da: int, db: int):
        """The whole triple, replicated: shared polynomials are whole on
        every rank."""
        return self.draw_whole("next_poly_triplet", da, db)
