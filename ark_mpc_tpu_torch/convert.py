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

BGV-over-l state (`offline/bgv/`) crosses as uint32 residue arrays (..., L,
phi), each residue canonical below its prime, in the ring's own form (eval
form for `PowerfulRing`, coefficients for `CyclotomicRing`):

  - a keypair as ``(sk, pk_a, pk_b)``, each (L, phi), as `KeypairL` holds them;
  - a `CiphertextL` as ``(c0, c1)``, each (..., L, phi);
  - a `RelinKeyL` as ``(b, a)``, each (L, L, phi);
  - a ZK proof as the list `zkpok_words.proof_to_arrays` gives (it reads
    either package's proofs), the wire format: the
    ciphertexts (U, L, phi) and commitments (V, L, phi) as uint32, then the
    int64 word planes z, zu, ze0, ze1.

LowGear state (`offline/lowgear/`, `offline/structs.py`):

  - a `SetupL` as a dict of the keypair ``sk, pk_a, pk_b``, the peer's
    ``other_pk_a, other_pk_b`` (each (L, phi) residues), the peer's proved
    enc(MAC share) ``mac_c0, mac_c1`` and the ``mac_key_share`` limbs (16,);
  - a `LowGearPrep` as a dict with ``mac_key_share`` (16,), one list of
    (share, mac) pairs of (16, n) arrays per store, each part's batches
    concatenated (``triples`` 3 parts, ``inverse_pairs`` 2, ``bits``,
    ``randomness``, ``my_mask_shares``, ``counterparty_mask_shares`` 1),
    and ``my_masks_clear`` (16, n).

Rings are not carried: both packages build the same ring from (m,
n_q_primes).  The `to_*` functions take the port's ring, check each array
against its basis and put it on the ring's device; the `from_*` functions
read the JAX package's objects and the port's alike.
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
from .offline.bgv.bgv_l import CiphertextL, KeypairL, RelinKeyL
from .offline.bgv.zkpok_words import CiphertextWithProofW, proof_from_arrays
from .offline.lowgear.triplets_l import SetupL
from .offline.structs import LowGearPrep


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



# ---------------------------------------------------------------------------
# BGV-over-l keys, ciphertexts and proofs
# ---------------------------------------------------------------------------


def residues_to_numpy(x) -> np.ndarray:
    """A residue array of either package -> uint32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    arr = np.asarray(x)
    if arr.size and (int(arr.min()) < 0 or int(arr.max()) > 0xFFFFFFFF):
        raise ValueError("residues must be 32-bit values")
    return arr.astype(np.uint32)


def to_residues(ring, arr, lead: int | None = None) -> torch.Tensor:
    """(..., L, phi) residues -> an int64 tensor on the ring's device; every
    residue must be canonical (below its prime).  `lead` fixes the number of
    leading batch axes."""
    arr = residues_to_numpy(arr)
    tail = (len(ring.q_primes), ring.phi)
    if arr.shape[-2:] != tail or (lead is not None and arr.ndim != lead + 2):
        raise ValueError(f"residues must be (..., {tail[0]}, {tail[1]}), got {arr.shape}")
    if (arr >= np.array(ring.q_primes, dtype=np.uint32)[:, None]).any():
        raise ValueError("residues must be canonical (below their RNS prime)")
    return torch.as_tensor(arr.astype(np.int64), device=ring.device)


def from_keypair(kp) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return tuple(residues_to_numpy(x) for x in (kp.sk, kp.pk_a, kp.pk_b))


def to_keypair(ring, arrays) -> KeypairL:
    sk, pk_a, pk_b = (to_residues(ring, a, lead=0) for a in arrays)
    return KeypairL(ring, sk, pk_a, pk_b)


def from_ciphertext(ct) -> tuple[np.ndarray, np.ndarray]:
    return residues_to_numpy(ct.c0), residues_to_numpy(ct.c1)


def to_ciphertext(ring, pair) -> CiphertextL:
    c0, c1 = (to_residues(ring, a) for a in pair)
    if c0.shape != c1.shape:
        raise ValueError(f"c0 {tuple(c0.shape)} and c1 {tuple(c1.shape)} differ")
    return CiphertextL(c0, c1)


def from_relin_key(rlk) -> tuple[np.ndarray, np.ndarray]:
    return residues_to_numpy(rlk.b), residues_to_numpy(rlk.a)


def to_relin_key(ring, pair) -> RelinKeyL:
    n_q = len(ring.q_primes)
    b, a = (to_residues(ring, x, lead=1) for x in pair)
    if b.shape[0] != n_q or a.shape[0] != n_q:
        raise ValueError(f"a relinearization key has {n_q} digit rows")
    return RelinKeyL(b, a)


def to_proof(ring, items) -> CiphertextWithProofW:
    """The wire list (`proof_to_arrays` of either package) -> a proof for
    `verify_proof`: residues checked against the ring's basis, ciphertexts on
    its device, commitments on the host (the verifier checks the shapes)."""
    cts = [to_residues(ring, c, lead=1) for c in items[:2]]
    comm = [residues_to_numpy(c) for c in items[2:4]]
    return proof_from_arrays(cts + comm + list(items[4:]), device=ring.device)


# ---------------------------------------------------------------------------
# LowGear state: the key-exchange result and the prep stores
# ---------------------------------------------------------------------------


def from_setup(st) -> dict:
    """A `SetupL` of either package -> numpy arrays."""
    return {"sk": residues_to_numpy(st.keypair.sk), "pk_a": residues_to_numpy(st.keypair.pk_a),
            "pk_b": residues_to_numpy(st.keypair.pk_b),
            "other_pk_a": residues_to_numpy(st.other_pk_a),
            "other_pk_b": residues_to_numpy(st.other_pk_b),
            "mac_c0": residues_to_numpy(st.other_mac_enc.c0),
            "mac_c1": residues_to_numpy(st.other_mac_enc.c1),
            "mac_key_share": from_field(st.mac_key_share)}


def to_setup(ring, arrays: dict) -> SetupL:
    """Numpy arrays (`from_setup`) -> the port's `SetupL` on the ring's
    device, every residue checked against the ring's basis."""
    res = {k: to_residues(ring, arrays[k], lead=0)
           for k in ("sk", "pk_a", "pk_b", "other_pk_a", "other_pk_b", "mac_c0", "mac_c1")}
    key = to_field(arrays["mac_key_share"], Scalar, ring.device)
    if key.shape != ():
        raise ValueError(f"the MAC key share is one element, got shape {key.shape}")
    return SetupL(ring, KeypairL(ring, res["sk"], res["pk_a"], res["pk_b"]),
                  res["other_pk_a"], res["other_pk_b"],
                  CiphertextL(res["mac_c0"], res["mac_c1"]), key)


PREP_STORES = ("triples", "inverse_pairs", "bits", "randomness", "my_mask_shares",
               "counterparty_mask_shares")


def _concat(arrays: list, axis: int = 1) -> np.ndarray:
    return arrays[0] if len(arrays) == 1 else np.concatenate(arrays, axis=axis)


def from_prep(prep) -> dict:
    """A `LowGearPrep` of either package -> numpy arrays (the stores are
    read, not consumed)."""
    out = {"mac_key_share": from_field(prep.mac_key_share)}
    for name in PREP_STORES:
        store = getattr(prep, name)
        out[name] = [tuple(_concat([from_field(getattr(batch[j], kind)) for batch in store.items])
                           for kind in ("share", "mac"))
                     for j in range(store.parts)] if store.items else []
    clear = [from_field(c) for c in prep.my_masks_clear]
    out["my_masks_clear"] = _concat(clear) if clear else np.zeros((NLIMBS, 0), np.uint32)
    return out


def to_prep(arrays: dict, device=None) -> LowGearPrep:
    """Numpy arrays (`from_prep`) -> the port's `LowGearPrep` on `device`,
    one batch a store."""
    prep = LowGearPrep(mac_key_share=to_field(arrays["mac_key_share"], Scalar, device))
    for name in PREP_STORES:
        if arrays[name]:
            getattr(prep, name).add(*(to_share(pair, Scalar, device) for pair in arrays[name]))
    if arrays["my_masks_clear"].shape[1]:
        prep.my_masks_clear.append(to_field(arrays["my_masks_clear"], Scalar, device))
    return prep
