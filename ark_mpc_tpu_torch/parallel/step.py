"""Fused protocol steps and their mesh-sharded forms.

Counterpart of `ark_mpc_tpu/parallel/step.py`: the authenticated Beaver
combine and the MAC-check fold as plain functions on shares (they reach the
`mont_mul` kernel for every product on the card), then the same step with
the batch split over a mesh of ranks.

    combine   [xy] = de + d[b] + e[a] + [c]           (party-0 add_public)
    check     t    = key*(xy_open) - mac              (per element)
    fold      T    = sum_i r_i * t_i                  (random linear comb.)

Scale-out is SPMD over `torch.distributed`, one process per device
(`parallel/launch.py` starts them): each rank holds the local shard of every
batch-sharded vector, so the element-wise stages run unchanged on the shard
and only reductions over the batch axis cross ranks.  The reference instead
holds a `jax.sharding.Mesh` in one controller and lets XLA insert the
collectives; `Mesh` here is the rank's view of the process group (gloo on
the CPU, NCCL on the card).  A field reduction (the fold, a share's sum) is
each rank's modular partial sum, ONE integer `all_reduce` of its 16-bit
limb columns, then one `reduce_wide`; a point sum all-gathers each rank's
partial and adds them in rank order.  Both give a replicated result
(`algebra/placement.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..algebra import limbs as lb
from ..algebra.fields import SCALAR_FIELD, FieldSpec
from ..algebra.limbs import NLIMBS
from ..algebra.placement import mark
from ..algebra.point_share import PointShare
from ..algebra.scalar import FieldArray, Scalar
from ..algebra.share import ScalarShare
from ..device import resolve_device


def beaver_mul_step(party_id: int, x: ScalarShare, y: ScalarShare,
                    a: ScalarShare, b: ScalarShare, c: ScalarShare,
                    d: Scalar, e: Scalar, mac_key: Scalar) -> ScalarShare:
    """Post-open Beaver combine for the whole batch."""
    de = d * e
    res = b.mul_public(d) + a.mul_public(e) + c
    return res.add_public(de, mac_key, party_id)


def mac_check_fold(mac_key: Scalar, opened: Scalar, mac: Scalar,
                   coeffs: Scalar) -> Scalar:
    """Random-linear-combination MAC-check fold:
    T = sum_i r_i * (key*v_i - mac_i)."""
    t = mac_key * opened - mac
    return (t * coeffs).sum()


def flagship_forward(x0: ScalarShare, y0: ScalarShare, a0: ScalarShare,
                     b0: ScalarShare, c0: ScalarShare, d: Scalar, e: Scalar,
                     mac_key0: Scalar, coeffs: Scalar):
    """Party 0's Beaver combine plus its MAC-check fold contribution for the
    (to-be-opened) product.  The fold is linear, so shares work in place of
    the opened value."""
    z0 = beaver_mul_step(0, x0, y0, a0, b0, c0, d, e, mac_key0)
    t0 = mac_check_fold(mac_key0, z0.share, z0.mac, coeffs)
    return z0, t0


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: the process `group` its collectives
    run in, the mesh `size`, this process's `rank` in it and its `device`.
    `parties` holds two meshes over the same ranks with a process group of
    their own each, so that two parties run by one process (the simulator)
    never interleave their collectives; `make_mesh` makes them."""

    group: object
    size: int
    rank: int
    device: torch.device
    axis: str = "batch"
    parties: tuple = field(default=(), repr=False)

    def party(self, party_id: int) -> "Mesh":
        return self.parties[party_id]


def make_mesh(n_devices: int | None = None, group=None, device=None,
              axis: str = "batch") -> Mesh:
    """The mesh over `group` (default: every rank of the initialized process
    group), with the two party groups made in the same order on every rank.
    Call it on every rank.  `device` defaults to the current CUDA card
    (`parallel.launch` sets rank r's to cuda:r); pass "cpu" for gloo ranks.
    Raises without an initialized process group, or if `n_devices` is not
    the group's size."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (see ark_mpc_tpu_torch.parallel.launch)")
    group = dist.group.WORLD if group is None else group
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"asked for a {n_devices}-device mesh, but the process "
                         f"group has {size} ranks")
    device = resolve_device(device)
    ranks = dist.get_process_group_ranks(group)
    parties = tuple(Mesh(dist.new_group(ranks), size, rank, device, axis)
                    for _ in (0, 1))
    return Mesh(group, size, rank, device, axis, parties)


def small(mesh: Mesh, n: int) -> bool:
    """Whether a global batch of `n` elements is held replicated on `mesh`:
    it is smaller than the mesh, so there is nothing to shard (the
    reference's `_place`, `ark_mpc_tpu/fabric/context.py:139-160`, leaves
    such a batch on every device)."""
    return n < mesh.size


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """The rank's columns of a global batch of `n` (the counterpart of the
    reference's `NamedSharding`: a torch tensor carries no sharding, the
    rank just holds these columns): all of them for a batch smaller than
    the mesh (`small`).  Raises `ValueError` naming the mesh for a larger
    batch that is no multiple of its size, as the reference does."""
    if small(mesh, n):
        return slice(0, n)
    if n % mesh.size:
        raise ValueError(
            f"a batch of {n} elements does not divide the {mesh.size}-rank mesh; "
            f"pad the batch to a multiple of the mesh size (every rank of a "
            f"mesh holds an equal shard of each batch at least as large as "
            f"the mesh)")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard(x, mesh: Mesh, hold_uneven: bool = False):
    """The rank's shard of a global batch (leading axis), on its device,
    marked a shard; a single element or a batch smaller than the mesh
    (`small`) comes back whole, marked replicated, and so, with
    `hold_uneven`, does a batch whose size the mesh does not divide (the
    reference leaves such a global array unsharded where it places it
    itself: a selection, `share_public`, a point batch); without it such a
    batch raises `ValueError` naming the mesh, as the reference's `_place`
    does for input shares and offline draws.  Takes field arrays, point
    batches and their shares (share and MAC alike)."""
    if isinstance(x, (ScalarShare, PointShare)):
        sh = shard(x.share, mesh, hold_uneven)
        return type(x)(sh, shard(x.mac, mesh, hold_uneven), sh.replicated)
    if not isinstance(x, FieldArray):  # a point batch: each coordinate
        return type(x)(*(shard(c, mesh, hold_uneven) for c in x._coords()))
    if not x.shape or small(mesh, x.shape[0]) or (hold_uneven and x.shape[0] % mesh.size):
        return mark(type(x)(x.limbs.to(mesh.device)))
    cols = batch_sharding(mesh, x.shape[0])
    return mark(type(x)(x.limbs[:, cols].contiguous().to(mesh.device)), False)


def shard_share(share: ScalarShare, mesh: Mesh) -> ScalarShare:
    """`shard` of a share: the rank's columns of its (16, n) share and MAC."""
    return shard(share, mesh)


def replicate(x: FieldArray, mesh: Mesh) -> FieldArray:
    """x whole on the rank's device (every rank holds all of it)."""
    return type(x)(x.limbs.to(mesh.device))


def _all_gather(t: torch.Tensor, mesh: Mesh) -> list:
    """Every rank's `t` (equal shapes), in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return parts


def gather(x, mesh: Mesh):
    """The global batch from every rank's shard (the counterpart of
    `jax.device_get` of a sharded array): a collective, so every rank of
    `mesh` calls it; each gets the whole, marked replicated.  A replicated
    or 0-d value is returned as it is, with no collective (every rank
    calls it alike).  Takes field arrays, curve points and their shares."""
    if x.replicated or not x.shape:
        return x
    if isinstance(x, (ScalarShare, PointShare)):  # the share's mark rules
        return type(x)(_whole(x.share, mesh), _whole(x.mac, mesh), True)
    return _whole(x, mesh)


def _whole(x, mesh: Mesh):
    """The global batch of a shard's field array or point batch, marked
    replicated."""
    if isinstance(x, FieldArray):
        return mark(type(x)(torch.cat(_all_gather(x.limbs, mesh), dim=1)))
    coords = torch.stack([c.limbs for c in x._coords()])  # a point batch
    whole = torch.cat(_all_gather(coords, mesh), dim=2)
    return mark(type(x)(*(type(c)(t) for c, t in zip(x._coords(), whole))))


def all_ranks_ok(ok: bool, mesh: Mesh) -> bool:
    """True only where every rank of `mesh` passed `ok` true (an integer
    MIN `all_reduce`): ranks agree on an abort before any of them raises,
    so none is left waiting in a later collective."""
    flag = torch.tensor([int(bool(ok))], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(flag.item())


# ---------------------------------------------------------------------------
# sharded step
# ---------------------------------------------------------------------------


def sharded_rlc_fold(mesh: Mesh, t_limbs: torch.Tensor, coeff_limbs: torch.Tensor,
                     spec: FieldSpec = SCALAR_FIELD) -> Scalar:
    """sum_i coeff_i * t_i over a batch-sharded (16, n) limb array: the
    rank's modular partial sum, ONE integer `all_reduce` of its 16-bit limb
    column, one Montgomery reduction.  The columns stay below size * 2^16,
    exact in int64 for any realistic mesh, and the summed value stays below
    m * 2^256 as `reduce_wide` needs while size < 2^252.  The Montgomery
    form is linear mod m, so reducing the column sum gives the Montgomery
    encoding of the modular sum (a Scalar of `spec`'s field for the
    default; the caller rewraps for another field)."""
    part = lb.tree_sum(spec, lb.mont_mul(spec, t_limbs, coeff_limbs), axis=1)
    return Scalar(_all_reduce_sum(mesh, spec, part))


def _all_reduce_sum(mesh: Mesh, spec: FieldSpec, part: torch.Tensor) -> torch.Tensor:
    """The modular sum over the ranks of each rank's (16, *rest) partial:
    ONE int64 `all_reduce` of the limb columns, one `reduce_wide`."""
    cols = part.reshape(NLIMBS, -1).to(torch.int64)
    dist.all_reduce(cols, op=dist.ReduceOp.SUM, group=mesh.group)
    return lb.reduce_wide(spec, cols).reshape(part.shape)


def sharded_sum(mesh: Mesh, x: FieldArray) -> FieldArray:
    """sum over the batch axis (leading) of a batch-sharded field array: the
    rank's `tree_sum`, then the columns' `all_reduce` and `reduce_wide` as
    in `sharded_rlc_fold` (the Montgomery form is linear mod m, so this is
    the encoding of the modular sum).  The result is replicated: every rank
    of `mesh` calls it and gets the same limbs."""
    part = lb.tree_sum(x.spec, x.limbs, axis=1)
    return mark(type(x)(_all_reduce_sum(mesh, x.spec, part)))


def sharded_point_sum(mesh: Mesh, pt):
    """sum over the batch axis (leading) of a batch-sharded point batch
    (`CurvePoint` or `G1`): the rank's tree sum, an all-gather of every
    rank's partial, then their sum in rank order (a tree over the
    rank-ordered partials, the same on every rank).  The result is
    replicated."""
    return mark(gather(pt.sum().reshape(1), mesh).sum())


def sharded_mul_mac_step(mesh: Mesh, party_id: int, x, y, a, b, c, d, e,
                         mac_key, coeffs):
    """The sharded step on the rank's shard: the Beaver combine (element-
    wise, no collective), then the MAC-check fold of the product through
    `sharded_rlc_fold` (one `all_reduce`).  -> (the rank's shard of z, the
    folded value, the same on every rank)."""
    z = beaver_mul_step(party_id, x, y, a, b, c, d, e, mac_key)
    t = mac_key * z.share - z.mac
    return z, sharded_rlc_fold(mesh, t.limbs, coeffs.limbs)
