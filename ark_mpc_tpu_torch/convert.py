"""State carried between the JAX package and the port.

This system's counterpart of model weights is its state: field elements,
authenticated shares and offline material.  Everything crosses as numpy:

  - a (16, ...) uint32 limb array (Montgomery form) <-> a `FieldArray`;
  - a (share, mac) pair of such arrays <-> a `ScalarShare`;
  - a (4, 16, ...) uint32 array of canonical X, Y, Z, T limbs <-> a
    `CurvePoint`, a (3, 16, ...) array of Montgomery-form Jacobian X, Y, Z
    limbs <-> a BN254 `G1` (`curve=G1`), and a (share, mac) pair of either
    <-> a `PointShare`;
  - a (16, deg + 1) coefficient limb array <-> a `DensePoly`, and a
    (share, mac) pair of those <-> an `AuthenticatedDensePoly`;
  - a dict of exported offline material <-> a preprocessing source that
    serves it:

        {"mac_key_share": (16,) uint32,
         "triples": [((a_share, a_mac), (b_share, b_mac), (c_share, c_mac)),
                     ...]}                      # one entry per batch, in order

`export_source` reads any object with the preprocessing interface whose
values carry a `.limbs` array (a torch tensor, or anything `numpy.asarray`
accepts), so one party's material can be taken from either package.
"""

from __future__ import annotations

import numpy as np
import torch

from .algebra.bn254 import G1
from .algebra.curve import CurvePoint
from .algebra.limbs import NLIMBS
from .algebra.point_share import PointShare
from .algebra.poly import AuthenticatedDensePoly, DensePoly
from .algebra.scalar import FieldArray, Scalar
from .algebra.share import ScalarShare
from .device import resolve_device
from .offline.base import PreprocessingPhase


def limbs_to_numpy(limbs) -> np.ndarray:
    """A limb array of either package -> (16, ...) uint32 numpy."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs)
    if arr.shape[:1] != (NLIMBS,):
        raise ValueError(f"limb axis must be {NLIMBS}, got shape {arr.shape}")
    return arr.astype(np.uint32)


def to_field(limbs, field=Scalar, device=None) -> FieldArray:
    """(16, ...) uint32 limbs (Montgomery form) -> `field` on `device`."""
    arr = limbs_to_numpy(limbs)
    if arr.size and int(arr.max()) > 0xFFFF:
        raise ValueError("limbs must be 16-bit values")
    return field(torch.from_numpy(arr.astype(np.int32)).to(resolve_device(device)))


def from_field(x) -> np.ndarray:
    """A field array of either package -> (16, ...) uint32 numpy."""
    return limbs_to_numpy(x.limbs)


def to_share(pair, field=Scalar, device=None) -> ScalarShare:
    share, mac = pair
    return ScalarShare(to_field(share, field, device), to_field(mac, field, device))


def from_share(sh) -> tuple[np.ndarray, np.ndarray]:
    return from_field(sh.share), from_field(sh.mac)


POINT_COORDS = {CurvePoint: 4, G1: 3}


def to_point(arr, device=None, curve=CurvePoint):
    """(4, 16, ...) uint32 limbs of X, Y, Z, T -> `CurvePoint` on `device`;
    with `curve=G1`, (3, 16, ...) limbs of X, Y, Z -> `G1`."""
    arr = np.asarray(arr)
    k = POINT_COORDS[curve]
    if arr.shape[:1] != (k,):
        raise ValueError(f"point arrays must be ({k}, 16, ...), got shape {arr.shape}")
    return curve(*(to_field(c, curve.base_field, device) for c in arr))


def from_point(pt) -> np.ndarray:
    """A point batch of either package -> (4 or 3, 16, ...) uint32 numpy."""
    return np.stack([from_field(c) for c in pt._coords()])


def to_point_share(pair, device=None, curve=CurvePoint) -> PointShare:
    share, mac = pair
    return PointShare(to_point(share, device, curve), to_point(mac, device, curve))


def from_point_share(ps) -> tuple[np.ndarray, np.ndarray]:
    return from_point(ps.share), from_point(ps.mac)


def to_poly(coeffs, device=None) -> DensePoly:
    """(16, deg + 1) uint32 coefficient limbs -> `DensePoly` on `device`."""
    return DensePoly(to_field(coeffs, Scalar, device))


def from_poly(poly) -> np.ndarray:
    """A public polynomial of either package -> (16, deg + 1) uint32."""
    return from_field(poly.coeffs)


def to_auth_poly(pair, device=None) -> AuthenticatedDensePoly:
    return AuthenticatedDensePoly(to_share(pair, Scalar, device))


def from_auth_poly(poly) -> tuple[np.ndarray, np.ndarray]:
    return from_share(poly.coeffs)


def export_source(source, batch_sizes) -> dict:
    """Draw the MAC-key share and one triple batch per size from `source`."""
    triples = []
    for n in batch_sizes:
        triples.append(tuple(from_share(s) for s in source.next_triplet_batch(n)))
    return {"mac_key_share": from_field(source.get_mac_key_share()),
            "triples": triples}


class ServedSource(PreprocessingPhase):
    """Serves exported material: the MAC-key share and the triple batches in
    the order they were exported.  Anything else raises."""

    def __init__(self, material: dict, field=Scalar, device=None):
        self.field = field
        self.device = resolve_device(device)
        self._key = to_field(material["mac_key_share"], field, self.device)
        self._triples = list(material["triples"])

    def get_mac_key_share(self):
        return self._key

    def next_triplet_batch(self, n: int):
        if not self._triples:
            raise RuntimeError("served material has no triple batches left")
        got = limbs_to_numpy(self._triples[0][0][0]).shape[1:]
        if got != (n,):
            raise ValueError(f"next served triple batch has shape {got}, asked for ({n},)")
        batch = self._triples.pop(0)
        return tuple(to_share(pair, self.field, self.device) for pair in batch)

