"""The MPC fabric: an eager, round-based batched runtime on torch tensors.

Counterpart of `ark_mpc_tpu/fabric/context.py` (`MpcFabric`); the
curve-point protocols live in `fabric/points.py` and the traced circuit
scheduler in `fabric/scheduler.py`.  Shares are limb tensors on the
fabric's device; each protocol step is a batched computation followed by at
most one coalesced exchange:

  - `open`: one message each way carrying all n shares, one local combine.
  - `open_authenticated`: open + MAC-check values + ONE commitment + one
    value exchange + one blinder exchange, regardless of n.
  - Beaver mul: one triple batch, one open round of the concatenated (d, e)
    masks, one combine (the `beaver_round` kernel on the card).
  - Party 0 always sends first.

Limbs travel as numpy uint32 arrays, so frames are byte-identical to the
reference's.  Unlike the reference, every field-element array received is
checked for its shape, 16-bit limbs and values below the modulus before use
(`_from_wire`).  MAC checks can be deferred and verified by a single
commit-reveal round (optionally folded to one scalar by a public-coin
random linear combination).

Mesh (`mesh=`, a `parallel.step.Mesh`): the process is one rank of a mesh,
and every value it holds has one of two placements (`algebra/placement.py`):

  - a shard: the rank's columns of a global batch at least as large as
    the mesh.  Values held whole (unmarked) enter through `_place` (the
    rank's slice); a value already marked a shard, such as one opened from
    a shard, stays as it is; sizes given to the fabric (`n` of
    `share_values`, the offline passthroughs) are global, and one at
    least the mesh size must be a multiple of it, else `ValueError` naming
    the mesh, where the reference's `_place` raises (so does an inversion
    of such a global batch);
  - replicated (`replicated = True`): every rank of the party holds the
    whole, with the same limbs: a global batch smaller than the mesh, or
    a single value (`parallel.step.small`: nothing to shard, as the
    reference's `_place` leaves it), the result of a reduction over the
    batch axis (`ScalarShare.sum` through `parallel.step.sharded_sum`,
    point sums and MSM through `sharded_point_sum`), a shared polynomial
    (its coefficients gathered over the party's ranks), a matrix triple's
    Q, and what opening or element-wise operations make of such values.
    A public batch the fabric places itself (`share_public`, shared
    points) whose size the mesh does not divide is held replicated too,
    as the reference leaves it unsharded; `_place` leaves a replicated
    value whole.

Offline material is one draw of the global batch (`_draw_parts`,
`ShardedSource.draw_parts`): a fused call on several items (`mul_many`,
`inverse_many`, `points.beaver_mul_points_many`, the tracer's levels)
draws their concatenation in item order, as the reference concatenates
them, and each rank keeps its columns of a shard item and all of a
replicated one, so every position holds the reference dealer's material
whatever placements the call mixes.

Element-wise operations carry the placement and raise `ValueError` naming
the mesh where a shard meets a replicated batch of more than one element;
`parallel.step.gather` returns a replicated value as it is.  Rank r's two
parties exchange rank r's values over rank r's own transport: N frames a
round where the reference sends one, the same bytes in all for shards.

Opening a replicated share: each rank pair exchanges the whole value and
computes its own check values d = key * v - mac from it.  These enter the
deferred fold on every rank beside the shards', each rank pair with its
own public coin (the simulator seeds each rank pair apart), so the
party-wide fold holds sum_r r_r . e for an error e in the value a cheating
peer sent, with independent uniform r_r; it is zero with probability 1/l
unless e is, on every rank, and a peer who sends different values to
different ranks makes some rank's e nonzero.  Unfolded, each rank pair
zero-tests its own d.  Either way every MAC check's outcome is agreed over
the party's ranks (a MIN `all_reduce`, `all_ranks_ok`) before any rank
raises, so one cheating rank pair aborts every rank and none is left
waiting in a collective.  `verify_deferred` folds by default on a mesh,
through `sharded_rlc_fold`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..algebra import limbs as lb
from ..algebra.placement import join, mark, placement, set_thread_mesh, split
from ..algebra.scalar import Scalar, public_exponent
from ..algebra.share import PARTY0, PARTY1, ScalarShare
from ..device import resolve_device
from ..offline.base import PreprocessingPhase, ShardedSource
from ..ops import fp_kernels
from ..parallel.step import all_ranks_ok, batch_sharding, shard, sharded_rlc_fold, small
from ..utils.csprng import CSPRNG, default_crypto_rng
from ..utils.stats import FabricStats
from . import commitment, messages
from .errors import AuthenticationError
from .transport import Transport


def _wire(s: Scalar) -> np.ndarray:
    """A limb tensor as the uint32 numpy array the wire codec packs."""
    return s.limbs.cpu().numpy().astype(np.uint32)


class MpcFabric:
    """Two-party SPDZ online-phase context for one party.

    `device` (default: the mesh's, else the CUDA card) is where shares live;
    the offline source must serve material on the same device.
    `collect_stats=True` attaches a `FabricStats` (`self.stats`) that the
    protocol steps record into.  `mesh` makes this fabric one rank of a
    mesh (module docstring); its `group` must be this party's alone."""

    def __init__(self, party_id: int, transport: Transport,
                 offline: PreprocessingPhase,
                 rng: np.random.Generator | None = None,
                 collect_stats: bool = False, device=None, mesh=None):
        if party_id != transport.party_id:
            raise ValueError("party_id does not match the transport's party")
        self.party_id = party_id
        self.transport = transport
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device if device is None else device
            offline = ShardedSource(offline, mesh)
        set_thread_mesh(mesh)
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
        self.stats = FabricStats() if collect_stats else None
        # deferred MAC-check accumulators (flattened d-value Scalars)
        self._deferred: list[Scalar] = []
        self._deferred_points: list = []  # flattened point check values
        self.n_rounds = 0

    def _from_wire(self, arr: np.ndarray, shape) -> Scalar:
        """The peer's limbs as a Scalar of `shape`.  Raises
        `AuthenticationError` unless they are a (16, *shape) array of 16-bit
        limbs, each element below the field's modulus: the field arithmetic
        takes its inputs in [0, m), so a peer could otherwise shift an opened
        value by a multiple of m that no MAC check sees."""
        arr = np.asarray(arr)
        want = (lb.NLIMBS, *shape)
        if arr.shape != want:
            raise AuthenticationError(
                f"received field elements of shape {arr.shape}, expected {want}")
        if not lb.limbs_below(arr, self.field.spec.modulus):
            raise AuthenticationError("received field elements are not canonical "
                                      "16-bit limbs below the modulus")
        return self.field(torch.from_numpy(arr.astype(np.int32)).to(self.device))

    # -- mesh placement ----------------------------------------------------
    def _place(self, x: Scalar) -> Scalar:
        """The rank's slice of a batch held whole (leading axis): an
        unmarked value (`algebra/placement.py`); a batch smaller than the
        mesh, or one whose size the mesh does not divide, stays whole,
        marked replicated, as the reference's `share_public` keeps it.  A
        single element is a constant, and a replicated value or a shard (a
        value opened from a shard, say) stays as it is.  No-op without a
        mesh."""
        if self.mesh is None or not x.shape or x.replicated is not None:
            return x
        return shard(x, self.mesh, hold_uneven=True)

    def _draw(self, method: str, n: int, replicated: bool = False):
        """`n` elements of offline material (`method` of the source) for
        operands of this placement (`_draw_parts` of one part)."""
        return self._draw_parts(method, [(n, replicated)])

    def _draw_parts(self, method: str, parts: list):
        """Offline material for a fused call on items of these (the rank's
        element count, replicated) parts end to end: off a mesh one batch
        of their total; on a mesh one draw of their global batch in item
        order, as the reference draws the concatenation, each rank keeping
        its own columns of a shard and all of a replicated item
        (`ShardedSource.draw_parts`)."""
        if self.mesh is None:
            return getattr(self.offline, method)(sum(n for n, _ in parts))
        return self.offline.draw_parts(method, parts)

    def _draw_global(self, method: str, n: int, hold_uneven: bool = False):
        """`_draw` for a global batch of `n`: the rank's slice, or the whole
        of a batch smaller than the mesh (and, with `hold_uneven`, of one
        whose size the mesh does not divide); else such a batch raises
        `ValueError` naming the mesh, as the reference's `_place` does."""
        if self.mesh is None:
            return self._draw(method, n)
        if hold_uneven and n % self.mesh.size:
            return self._draw(method, n, True)
        cols = batch_sharding(self.mesh, n)
        return self._draw(method, cols.stop - cols.start, small(self.mesh, n))

    def _timed(self, op: str, n: int = 0):
        if self.stats is None:
            return contextlib.nullcontext()
        return self.stats.timed(op, n)

    # -- low-level messaging ----------------------------------------------
    def _exchange_arrays(self, items):
        """One coalesced frame each way; party 0 sends first."""
        self.n_rounds += 1
        if self.stats is not None:
            self.stats.rounds += 1
        frame = messages.encode_arrays(items)
        return messages.decode_arrays(self.transport.exchange(frame))

    def send_arrays(self, items):
        self.transport.send(messages.encode_arrays(items))

    def recv_arrays(self):
        return messages.decode_arrays(self.transport.recv())

    def exchange_scalars(self, s: Scalar) -> Scalar:
        """Exchange Montgomery-form limb arrays."""
        (theirs,) = self._exchange_arrays([_wire(s)])
        return self._from_wire(theirs, s.shape)

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
        parties add the public masked value onto their mask share.  On a
        mesh, `values` and `n` are the global batch's; each rank shares its
        slice, or all of a batch smaller than the mesh (replicated)."""
        if self.party_id == sender:
            if values is None:
                raise ValueError("the sender must pass its values")
            if self.mesh is not None:
                values = shard(values, self.mesh)
            n = values.size
            mask, mask_share = self._draw("next_local_input_mask_batch", n,
                                          bool(values.replicated))
            masked = values.local.reshape(n) - mask
            self.send_arrays([_wire(masked)])
            shape = values.shape
        else:
            if n is None:
                raise ValueError("the receiver must pass n")
            mask_share = self._draw_global("next_counterparty_input_mask_batch", n)
            n = mask_share.size
            (raw,) = self.recv_arrays()
            masked = self._from_wire(raw, (n,))
            shape = masked.shape
        mask_share = mask_share.local.reshape(mask_share.size)
        out = mask_share.add_public(masked.local.reshape(masked.size), self.mac_key,
                                    self.party_id)
        return out.local.reshape(*shape)

    def share_public(self, values: Scalar) -> ScalarShare:
        """Both parties know `values`; produce a valid authenticated sharing
        (zero share + add_public), no communication.  On a mesh an unmarked
        batch is the global one and each rank keeps its slice (a replicated
        value or a shard stays as it is)."""
        values = self._place(values)
        zero = ScalarShare.zeros(values.shape, field=self.field, device=self.device,
                                 replicated=values.replicated)
        return zero.add_public(values, self.mac_key, self.party_id)

    # -- opening -----------------------------------------------------------
    def open(self, x: ScalarShare) -> Scalar:
        """Open shares without MAC check: one exchange of the share vector,
        one combine.  The value has the share's placement."""
        return self.open_many([x])[0]

    def open_many(self, xs: list) -> list:
        """Open several shares in ONE exchange of their elements end to end
        (`placement.join`: each rank pair sends the rank's columns of a
        shard and all of a replicated value); -> their values, each with its
        share's placement and shape.  A replicated share (a batch smaller
        than the mesh, say) is exchanged and combined whole on every rank,
        as the reference combines an open whose width does not divide the
        mesh (`ark_mpc_tpu/fabric/context.py:239-257`)."""
        joined = join(xs)
        with self._timed("open", joined.size):
            (theirs,) = self._exchange_arrays([_wire(joined.share)])
            return split(joined.share + self._from_wire(theirs, joined.shape), xs)

    def open_authenticated(self, x: ScalarShare, defer: bool = False) -> Scalar:
        """Open and check MACs.

        With `defer=True` the commit-reveal check round is postponed; call
        `verify_deferred()` once at the end of the program.  Raises
        `AuthenticationError` on a bad MAC (malicious abort)."""
        return self.open_authenticated_many([x], defer)[0]

    def open_authenticated_many(self, xs: list, defer: bool = False) -> list:
        """`open_authenticated` of several shares in one exchange and one
        check (module docstring: a replicated share's check values enter
        the check on every rank)."""
        values = self.open_many(xs)
        d = [self.field((self.mac_key * v - x.mac).limbs.reshape(lb.NLIMBS, -1))
             for x, v in zip(xs, values)]
        d = d[0] if len(d) == 1 else self.field.concatenate(d)
        if defer:
            self._deferred.append(d)
        else:
            self._run_mac_check(d)
        return values

    def verify_deferred(self, fold: bool | None = None) -> None:
        """Run ONE commit-reveal MAC check over every deferred open, and one
        for the deferred point opens, if any.

        With `fold=True` (the default when a mesh is attached) the scalar
        check values are first collapsed to ONE scalar by a public-coin
        random linear combination (the SPDZ aggregated check): O(1) wire
        bytes instead of O(n); on a mesh through `sharded_rlc_fold`."""
        if self._deferred:
            d = (self._deferred[0] if len(self._deferred) == 1
                 else self.field.concatenate(self._deferred))
            self._deferred = []
            if fold is None:
                fold = self.mesh is not None
            if fold:
                self._run_mac_check_folded(d)
            else:
                self._run_mac_check(d)
        if self._deferred_points:
            from . import points

            points.verify_deferred_points(self)

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
        every d value is fixed), then one commit-reveal zero test.  On a mesh
        each rank pair's coin covers its own shard, the party-wide sum comes
        from one `all_reduce`, and every rank pair zero-tests that sum."""
        coin = self.public_coin_rng()
        coeffs = self.field.random(d.size, coin, device=self.device)
        if self.mesh is None:
            t = (d * coeffs).sum()
        else:
            t = self.field(sharded_rlc_fold(self.mesh, d.limbs, coeffs.limbs,
                                            self.field.spec).limbs)
        self._run_mac_check(t.reshape(1))

    def _run_mac_check(self, d: Scalar) -> None:
        """Commit-exchange-reveal-verify of MAC check values."""
        with self._timed("mac_check", d.size):
            self._agreed_check(lambda: self._mac_check_round(d), "MAC check")

    def _agreed_check(self, check, what: str) -> None:
        """Run `check`, which raises `AuthenticationError` on a bad MAC.  On
        a mesh its outcome is agreed over the party's ranks before any rank
        raises, so one cheating rank pair aborts every rank."""
        try:
            check()
        except AuthenticationError as err:
            failure = err
        else:
            failure = None
        if self.mesh is not None and not all_ranks_ok(failure is None, self.mesh):
            raise failure or AuthenticationError(
                f"{what} failed on another rank of the {self.mesh.size}-rank mesh")
        if failure is not None:
            raise failure

    def _mac_check_round(self, d: Scalar) -> None:
        """One commit-reveal zero test; raises `AuthenticationError`."""
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
                                       self._from_wire(peer_d_canon, d.shape).limbs))
        if not commitment.verify(peer_d, peer_blinder, peer_comm):
            raise AuthenticationError("MAC check commitment failed to verify")
        if not bool((d + peer_d).is_zero().all()):
            raise AuthenticationError(
                "MAC check failed: shares of key*v - mac do not sum to zero")

    # -- authenticated arithmetic -----------------------------------------
    def mul(self, x: ScalarShare, y: ScalarShare) -> ScalarShare:
        """Beaver multiplication, element-wise over the batch: one triple
        batch, ONE open round for the concatenated (d, e) masks, one
        combine.  Replicated operands take a whole triple batch and give a
        replicated product."""
        return self.mul_many([x], [y])[0]

    def mul_many(self, xs: list, ys: list) -> list:
        """`mul` of several pairs in ONE fused call, whatever placements they
        mix: one triple batch for the pairs end to end (on a mesh, one draw
        of their global batch in the reference's column order,
        `_draw_parts`), ONE open round, one combine (one `beaver_round`
        launch on the card); -> each pair's product, in the pair's
        placement and shape."""
        reps = [placement(x, y) for x, y in zip(xs, ys)]
        x, y = join(xs, all(reps)), join(ys, all(reps))
        n = x.size
        with self._timed("beaver_mul", n):
            a, b, c = self._draw_parts("next_triplet_batch", [(v.size, r) for v, r in zip(xs, reps)])
            masked = self.field.concatenate([(x - a).share, (y - b).share])
            (theirs,) = self._exchange_arrays([_wire(masked)])
            opened = masked + self._from_wire(theirs, (2 * n,))
            d, e = opened.local[:n], opened.local[n:]
            return split(self._beaver_combine_dispatch(a, b, c, d, e, all(reps)), xs, reps)

    def _beaver_combine_dispatch(self, a, b, c, d, e, replicated=False) -> ScalarShare:
        """Post-open Beaver combine through the `beaver_round` kernel (its
        plain version for CPU tensors).  The CUDA kernel masks its own tail,
        so every batch size takes it."""
        zs, zm = fp_kernels.beaver_round(
            self.field.spec, self.party_id,
            a.share.limbs, a.mac.limbs, b.share.limbs, b.mac.limbs,
            c.share.limbs, c.mac.limbs, d.limbs, e.limbs, self.mac_key.limbs)
        return ScalarShare(self.field(zs), self.field(zm), replicated)

    def mul_public(self, x: ScalarShare, k: Scalar) -> ScalarShare:
        return x.mul_public(k)

    def add_public(self, x: ScalarShare, k: Scalar) -> ScalarShare:
        return x.add_public(k, self.mac_key, self.party_id)

    def sub_public(self, x: ScalarShare, k: Scalar) -> ScalarShare:
        return x.sub_public(k, self.mac_key, self.party_id)

    def inverse(self, x: ScalarShare, defer_check: bool = False) -> ScalarShare:
        """Batched shared inversion via masked open: [x^-1] = r *
        open(x*r)^-1.  Zero inputs map to zero output."""
        return self.inverse_many([x], defer_check)[0]

    def inverse_many(self, xs: list, defer_check: bool = False) -> list:
        """`inverse` of several shares in one fused call, whatever placements
        they mix: one draw of r and one of the triples for them end to end
        (`_draw_parts`), one Beaver round, one authenticated open; -> each
        inverse, in its share's placement and shape.  On a mesh their
        global batch must be smaller than the mesh or a multiple of its
        size, else `ValueError` naming the mesh, as the reference's draw of
        r raises (`ark_mpc_tpu/fabric/context.py:483`)."""
        parts = [(x.size, x.replicated) for x in xs]
        if self.mesh is not None:
            batch_sharding(self.mesh, sum(n if rep else n * self.mesh.size for n, rep in parts))
        rs = split(self._draw_parts("next_shared_value_batch", parts), xs)
        ms = self.mul_many(xs, rs)
        opened = self.open_authenticated_many(ms, defer=defer_check)
        return [r.mul_public(o.inverse()) for r, o in zip(rs, opened)]

    def pow(self, x: ScalarShare, e: int) -> ScalarShare:
        """Public-exponent exponentiation: LSB-first square-and-multiply with
        each step's two independent products (result*base, base*base)
        batched into ONE width-2n Beaver round (`mul_many`, the reference's
        column order on a mesh).  A negative e raises `ValueError` before
        any triple is drawn or round started."""
        e = public_exponent(e)
        if e == 0:
            return self.share_public(mark(self.field.ones(x.shape, device=self.device),
                                          x.replicated))
        shape = x.shape
        n = x.size
        result, base = None, x.local.reshape(n)
        while True:
            if e & 1:
                if result is None:
                    result = base
                elif e > 1:
                    result, base = self.mul_many([result, base], [base, base])
                    e >>= 1
                    continue
                else:
                    result = self.mul(result, base)
            e >>= 1
            if e == 0:
                break
            base = self.mul(base, base)
        return result.local.reshape(*shape)

    # -- curve-point protocols (`fabric/points.py`) ------------------------
    def share_points(self, points=None, sender: int = 0, n: int | None = None):
        from . import points as pts

        return pts.share_points(self, points, sender, n)

    def share_public_points(self, points):
        from . import points as pts

        return pts.share_public_points(self, points)

    def open_points(self, ps):
        from . import points as pts

        return pts.open_points(self, ps)

    def open_authenticated_points(self, ps, defer: bool = False):
        from . import points as pts

        return pts.open_authenticated_points(self, ps, defer)

    def mul_points(self, x, ps):
        from . import points as pts

        return pts.beaver_mul_points(self, x, ps)

    def mul_generator(self, x):
        from . import points as pts

        return pts.mul_generator(self, x)

    def msm(self, scalars, points):
        from . import points as pts

        return pts.msm_authenticated(self, scalars, points)

    # -- offline sampling passthroughs (n: the global batch; on a mesh each
    # rank gets its slice, or all of a batch smaller than the mesh) -------
    def next_triple_batch(self, n: int):
        return self._draw_global("next_triplet_batch", n)

    def random_shared_scalars(self, n: int) -> ScalarShare:
        return self._draw_global("next_shared_value_batch", n)

    def random_inverse_pairs(self, n: int):
        return self._draw_global("next_shared_inverse_pair_batch", n)

    def random_shared_bits(self, n: int) -> ScalarShare:
        return self._draw_global("next_shared_bit_batch", n)

    # -- constants (shapes: the global batch's) ----------------------------
    def zero_authenticated(self, shape=()) -> ScalarShare:
        zero = self._place(self.field.zeros(shape, device=self.device))
        return ScalarShare.zeros(zero.shape, field=self.field, device=self.device,
                                 replicated=bool(zero.replicated))

    def one_authenticated(self, shape=()) -> ScalarShare:
        return self.share_public(self.field.ones(shape, device=self.device))

    def tracer(self):
        """Start a batched-circuit trace (see `fabric/scheduler.py`)."""
        from .scheduler import Tracer

        return Tracer(self)

    def num_ops(self) -> int:
        """Fused protocol calls so far (0 without `collect_stats=True`): one
        `mul` over a batch of 2^20 elements counts as 1."""
        if self.stats is None:
            return 0
        return sum(self.stats.op_counts.values())

    def shutdown(self):
        self.transport.close()
