"""Malicious-peer programs for the port's checks of received field elements.

Shared by `test_torch_online.py` (CPU) and `test_torch_cuda.py` (the card,
where the product's combine is the CUDA `beaver_round`); imports only torch
and the port.  Party 1 edits the field elements it sends: with the shifted
Beaver masks it also combines with the edited values, as the peer that
found the fault did; otherwise it keeps its honest values.  Every edited
frame must make party 0 raise `AuthenticationError`: the field arithmetic assumes values in [0, m),
so without the check an encoding shifted by a multiple of m changes an
opened product while every MAC check passes.
"""

import numpy as np
import torch

from ark_mpc_tpu_torch.algebra import limbs as lb

XS, YS = [3, 7, 11, 13], [5, 9, 2, 4]
PRODUCTS = [x * y for x, y in zip(XS, YS)]


def _add_multiple(arr, k: int, modulus: int, cols):
    """arr with k * modulus added to the values of columns `cols`."""
    vals = lb.limb_array_to_ints(arr)
    for c in cols:
        vals[c] += k * modulus
    return lb.ints_to_limb_array(vals)


def _widen_limb(arr, modulus: int):
    """The same value in column 0, but with a limb above 0xFFFF: limb 0
    takes 2^16 from a nonzero higher limb."""
    out = arr.copy()
    i = next(i for i in range(1, lb.NLIMBS) if out[i, 0])
    out[i, 0] -= 1
    out[0, 0] += 1 << lb.LIMB_BITS
    return out


def _drop_column(arr, modulus: int):
    return arr[:, 1:].copy()


def _tamper_next_frame(fabric, edit):
    """Party's next frame goes out with its first array edited; the party
    itself goes on with its honest values."""
    send = fabric._exchange_arrays

    def tampered(items):
        fabric._exchange_arrays = send
        return send([edit(np.asarray(items[0]), fabric.field.spec.modulus),
                     *items[1:]])

    fabric._exchange_arrays = tampered


def _dishonest_mul(fabric, x, y, edit):
    """`MpcFabric.mul` as a dishonest party runs it: its (d, e) masks go out
    re-encoded by `edit`, and it opens and combines with the re-encoded
    masks itself, so both parties hold the same (d, e)."""
    n = x.size
    a, b, c = fabric.offline.next_triplet_batch(n)
    masked = fabric.field.concatenate([(x.reshape(n) - a).share,
                                       (y.reshape(n) - b).share])
    arr = edit(masked.limbs.cpu().numpy().astype(np.uint32),
               fabric.field.spec.modulus)
    (theirs,) = fabric._exchange_arrays([arr])
    mine, theirs = (fabric.field(torch.from_numpy(v.astype(np.int32)).to(fabric.device))
                    for v in (arr, theirs))
    opened = mine + theirs
    return fabric._beaver_combine_dispatch(a, b, c, opened[:n], opened[n:])


def product_program(edit=None, consistent=False):
    """x * y over the four pairs, opened with a MAC check; `edit` changes
    party 1's (d, e) frame of the Beaver round, and with `consistent` party
    1 combines with the edited masks too."""
    def prog(fabric):
        dev, n = fabric.device, len(XS)
        x = fabric.share_values(fabric.field.from_ints(XS, device=dev)
                                if fabric.party_id == 0 else None, sender=0, n=n)
        y = fabric.share_values(fabric.field.from_ints(YS, device=dev)
                                if fabric.party_id == 1 else None, sender=1, n=n)
        if edit is not None and fabric.party_id == 1:
            if consistent:
                return fabric.open_authenticated(
                    _dishonest_mul(fabric, x, y, edit)).to_ints()
            _tamper_next_frame(fabric, edit)
        return fabric.open_authenticated(fabric.mul(x, y)).to_ints()
    return prog


def open_zero_program(edit):
    """An authenticated open of a shared 0; `edit` changes party 1's share
    frame."""
    def prog(fabric):
        dev = fabric.device
        z = fabric.share_values(fabric.field.from_ints([0], device=dev)
                                if fabric.party_id == 0 else None, sender=0, n=1)
        if fabric.party_id == 1:
            _tamper_next_frame(fabric, edit)
        return fabric.open_authenticated(z).to_ints()
    return prog


FAULTS = {
    # e-share encodings + 15 m (still below 2^256)
    "e_share_plus_15m": product_program(
        lambda a, m: _add_multiple(a, 15, m, range(a.shape[1] // 2, a.shape[1])),
        consistent=True),
    "open_share_plus_2m": open_zero_program(
        lambda a, m: _add_multiple(a, 2, m, range(a.shape[1]))),
    "wide_limb": product_program(_widen_limb),
    "wrong_shape": product_program(_drop_column),
}
