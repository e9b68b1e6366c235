"""State carried between the JAX package and the port.

This system's counterpart of model weights is its state: field elements,
authenticated shares and offline material.  Everything crosses as numpy:

  - a (16, ...) uint32 limb array (Montgomery form) <-> a `FieldArray`;
  - a (share, mac) pair of such arrays <-> a `ScalarShare`;
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

from .algebra.limbs import NLIMBS
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

