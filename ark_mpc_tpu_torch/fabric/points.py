"""Authenticated curve-point protocols.

Counterpart of `ark_mpc_tpu/fabric/points.py`: opening with point MAC
checks, Beaver scalar-x-point multiplication via the generator trick,
generator multiplication, and authenticated MSM.  Batch-first: one open
round moves the whole point batch as canonical affine coordinate arrays.

Curve-generic: every protocol takes the curve class from its operands or
from the fabric's share field (`Scalar.curve = CurvePoint`).

Every point received off the wire is validated before use: canonical
coordinates, on the curve and in the prime-order subgroup (`windowed_mul`
by the order l).  A failure raises `AuthenticationError`.

On a mesh point shares are sharded like scalars (`fabric/context.py`):
`share_points` shards the sender's global points and both parties take
their mask slices from `ShardedSource`; the element-wise protocols run on
the rank's shard (the `windowed_mul` kernel on each rank's shard on the
card); `PointShare.sum`, and so both MSMs, add the party's ranks' partials
into a replicated result; a point MAC check's outcome is agreed over the
party's ranks before any rank raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..algebra import limbs as lb
from ..algebra.curve import CurvePoint
from ..algebra.placement import mark, placement
from ..algebra.point_share import PointShare, _mul_both, scalar_share_mul_point
from ..algebra.share import ScalarShare
from ..parallel.step import shard
from . import commitment
from .errors import AuthenticationError

# ---------------------------------------------------------------------------
# wire conversion: points travel as canonical affine coordinate limb arrays
# ---------------------------------------------------------------------------


def _wire_arrays(pt: CurvePoint):
    x, y = pt.to_affine()
    return tuple(lb.from_mont(c.spec, c.limbs).cpu().numpy().astype(np.uint32)
                 for c in (x, y))


def _canonical(arr: np.ndarray, modulus: int) -> bool:
    """Every (16, ...) limb column is a 16-bit limb vector below `modulus`."""
    return lb.limbs_below(np.asarray(arr).reshape(lb.NLIMBS, -1), modulus)


def _points_valid(pt: CurvePoint):
    """On the curve AND in the prime-order subgroup: without the subgroup
    check a malicious peer can inject small-order components and learn
    MAC-key-share bits from the revealed key * Q in the point MAC check;
    without the curve check, invalid-curve attacks apply."""
    return pt.is_on_curve() & pt.is_in_prime_subgroup()


def _point_from_wire_checked(fabric, curve, xc, yc):
    """Points from received affine coordinates, rejecting any non-canonical,
    invalid or out-of-subgroup point (malicious abort)."""
    modulus = curve.base_field.spec.modulus
    if not (_canonical(xc, modulus) and _canonical(yc, modulus)):
        raise AuthenticationError("received point has non-canonical coordinates")
    pt = curve.from_wire_affine(*(torch.from_numpy(np.asarray(a).astype(np.int32))
                                  .to(fabric.device) for a in (xc, yc)))
    if not bool(_points_valid(pt).all()):
        raise AuthenticationError("received point failed curve/subgroup validation")
    return pt


def _bytes_be(xs: np.ndarray, ys: np.ndarray) -> bytes:
    xb = xs.reshape(lb.NLIMBS, -1).astype(">u2")[::-1].T  # most-significant first
    yb = ys.reshape(lb.NLIMBS, -1).astype(">u2")[::-1].T
    return np.concatenate([xb, yb], axis=1).tobytes()


def point_bytes_be(pt: CurvePoint) -> bytes:
    """Canonical affine (x || y) big-endian bytes per point (the commitment
    encoding)."""
    return _bytes_be(*_wire_arrays(pt))


# ---------------------------------------------------------------------------
# protocols
# ---------------------------------------------------------------------------


def _fabric_curve(fabric):
    """Curve class for a fabric: the share field's linked curve."""
    return getattr(fabric.field, "curve", CurvePoint)


def share_points(fabric, points=None, sender: int = 0,
                 n: int | None = None) -> PointShare:
    """Input-share points via scalar masks and the generator trick: the
    sender sends P - mask*G; [P] = [mask]*G + masked."""
    curve = type(points) if points is not None else _fabric_curve(fabric)
    if fabric.party_id == sender:
        if points is None:
            raise ValueError("the sender must pass its points")
        if fabric.mesh is not None:
            points = type(points)(*(shard(c, fabric.mesh)
                                    for c in points.reshape(points.size)._coords()))
        n = points.size
        mask, mask_share = fabric.offline.next_local_input_mask_batch(n)
        gen = curve.generator((n,), device=fabric.device)
        masked = points.reshape(n) - gen.mul(mask)
        fabric.send_arrays(list(_wire_arrays(masked)))
        shape = points.shape
    else:
        if n is None:
            raise ValueError("the receiver must pass n")
        n = fabric._local_n(n)
        mask_share = fabric.offline.next_counterparty_input_mask_batch(n)
        xc, yc = fabric.recv_arrays()
        masked = _point_from_wire_checked(fabric, curve, xc, yc)
        shape = (n,)
    gen = curve.generator((n,), device=fabric.device)
    out = scalar_share_mul_point(mask_share, gen).add_public(
        masked, fabric.mac_key, fabric.party_id)
    return out.reshape(*shape)


def share_public_points(fabric, points) -> PointShare:
    """Both parties know the points; make a valid authenticated sharing.
    On a mesh an unmarked batch is the global one and each rank keeps its
    slice (a replicated batch or a shard stays as it is)."""
    if fabric.mesh is not None and points.shape and points.replicated is None:
        points = type(points)(*(shard(c, fabric.mesh) for c in points._coords()))
    return PointShare.identity(points.shape, curve=type(points), device=fabric.device,
                               replicated=points.replicated).add_public(
        points, fabric.mac_key, fabric.party_id)


def open_points(fabric, ps: PointShare) -> CurvePoint:
    """Open without MAC check: one exchange of affine share coordinates and
    one point add.  The points have the share's placement."""
    return open_points_many(fabric, [ps])[0]


def open_points_many(fabric, pss: list) -> list:
    """Open several point shares in ONE exchange (their coordinate arrays
    side by side, so shards and replicated values travel unmixed)."""
    theirs = fabric._exchange_arrays([a for ps in pss for a in _wire_arrays(ps.share)])
    out = []
    for i, ps in enumerate(pss):
        their_pt = _point_from_wire_checked(fabric, ps.curve, *theirs[2 * i:2 * i + 2])
        out.append(mark(ps.share + their_pt.reshape(*ps.shape), ps.replicated))
    return out


def open_authenticated_points(fabric, ps: PointShare,
                              defer: bool = False) -> CurvePoint:
    """Open + point MAC check: commit to the check points' bytes, exchange,
    verify that the two parties' check points sum to the identity."""
    return open_authenticated_points_many(fabric, [ps], defer)[0]


def open_authenticated_points_many(fabric, pss: list, defer: bool = False) -> list:
    """`open_authenticated_points` of several shares in one exchange and one
    check (each rank pair tests the check values of what it opened)."""
    opened = open_points_many(fabric, pss)
    # key_share * opened - mac_share
    ds = [(v.mul(fabric.mac_key) - ps.mac).reshape(ps.size) for v, ps in zip(opened, pss)]
    flat = ds[0] if len(ds) == 1 else type(ds[0]).concatenate(ds)
    if defer:
        fabric._deferred_points.append(flat)
    else:
        run_point_mac_check(fabric, flat)
    return opened


def run_point_mac_check(fabric, d: CurvePoint) -> None:
    """Commit-reveal zero test of point check values, agreed over the
    party's ranks on a mesh (`MpcFabric._agreed_check`)."""
    fabric._agreed_check(lambda: _point_mac_check_round(fabric, d), "point MAC check")


def _point_mac_check_round(fabric, d: CurvePoint) -> None:
    blinder = fabric.field.random((), fabric.rng, device=fabric.device)
    wire = _wire_arrays(d)
    my_comm = commitment.commit_bytes(_bytes_be(*wire), blinder)

    peer_comm = fabric.exchange_scalars(my_comm)
    theirs = fabric._exchange_arrays(list(wire))
    peer_blinder = fabric.exchange_scalars(blinder)

    peer_d = _point_from_wire_checked(fabric, type(d), theirs[0], theirs[1])
    # the validated affine arrays are the canonical encoding of peer_d
    if not commitment.verify_bytes(_bytes_be(*theirs), peer_blinder, peer_comm):
        raise AuthenticationError("point MAC check commitment failed")
    if not bool((d + peer_d).is_identity().all()):
        raise AuthenticationError("point MAC check failed")


def verify_deferred_points(fabric) -> None:
    ds = fabric._deferred_points
    if not ds:
        return
    d = ds[0] if len(ds) == 1 else type(ds[0]).concatenate(ds)
    fabric._deferred_points = []
    run_point_mac_check(fabric, d)


def mul_generator(fabric, x: ScalarShare) -> PointShare:
    """[x] * G, local."""
    gen = _fabric_curve(fabric).generator(x.shape, device=fabric.device)
    return scalar_share_mul_point(x, gen)


def mul_public_point(x: ScalarShare, points: CurvePoint) -> PointShare:
    """[x] * P for public P, local."""
    return scalar_share_mul_point(x, points)


def beaver_mul_points(fabric, x: ScalarShare, ps: PointShare) -> PointShare:
    """[x * P] via the generator-trick Beaver protocol: with a scalar triple
    (a, b, c), open d = x - a and E = P - b*G; the result is
    d*E (party 0) + d*[bG] + [a]*E + [c]*G."""
    n = x.size
    rep = placement(x, ps)
    xf = x.reshape(n)
    pf = ps.reshape(n)
    a, b, c = fabric._draw("next_triplet_batch", n, rep)
    b_gen = mul_generator(fabric, b)

    # one coalesced round: scalar masks + point masks
    masked_scalar = (xf - a).share
    masked_point = (pf - b_gen).share
    ms = masked_scalar.limbs.cpu().numpy().astype(np.uint32)
    theirs = fabric._exchange_arrays([ms, *_wire_arrays(masked_point)])
    d = masked_scalar + fabric._from_wire(theirs[0], (n,))
    e_pt = masked_point + _point_from_wire_checked(fabric, ps.curve,
                                                   theirs[1], theirs[2])
    return _beaver_point_combine(fabric, a, b_gen, c, d, e_pt).reshape(*x.shape)


def _beaver_point_combine(fabric, a: ScalarShare, b_gen: PointShare,
                          c: ScalarShare, d, e_pt: CurvePoint) -> PointShare:
    """d*[bG] + [a]*E + [c]*G, then d*E added publicly; the seven scalar
    multiplications go through one batched call."""
    gen = type(e_pt).generator(c.shape, device=fabric.device)
    db_s, db_m, ae_s, ae_m, c_s, c_m, de = _mul_both(
        [b_gen.share, b_gen.mac, e_pt, e_pt, gen, gen, e_pt],
        [d, d, a.share, a.mac, c.share, c.mac, d])
    res = PointShare(db_s, db_m) + PointShare(ae_s, ae_m) + PointShare(c_s, c_m)
    share = res.share + de if fabric.party_id == 0 else res.share
    return PointShare(share, res.mac + de.mul(fabric.mac_key), c.replicated)


def msm_authenticated(fabric, scalars: ScalarShare,
                      points: PointShare) -> PointShare:
    """Authenticated MSM = batched Beaver products + tree point sum (on a
    mesh: of the rank's shard, then over the party's ranks)."""
    return beaver_mul_points(fabric, scalars, points).sum()


def msm_public_points(scalars: ScalarShare, points: CurvePoint) -> PointShare:
    """MSM with public points: one local batch, no communication."""
    return scalar_share_mul_point(scalars, points).sum()
