"""`bucket_reduce`'s plain version against the reference epilogue (CPU).

The reference's `_reduce_body` runs eagerly, as
`tests/test_msm_bucket_fast.py` runs it, on the same tiny bucket grid
(w_real == W, so no virtual rows): the port runs the same formula sequence
(suffix scan with identity shifted in, lane tree, Horner), so the result is
bit-identical.
"""

import numpy as np
import torch

from ark_mpc_tpu.algebra.curve import CurvePoint as RPoint
from ark_mpc_tpu.algebra.scalar import Scalar as RScalar
from ark_mpc_tpu.ops.msm_kernels import _reduce_body
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.algebra.curve import CurvePoint
from ark_mpc_tpu_torch.algebra.scalar import Scalar
from ark_mpc_tpu_torch.ops import msm_kernels as mk

torch.set_num_threads(1)


def port_of(rpt) -> CurvePoint:
    return convert.to_point(convert.from_point(rpt), device="cpu")


def test_bucket_reduce_matches_reference_body_bit_for_bit():
    W, nb, c = 2, 4, 2  # w_real == W: no virtual rows
    r = np.random.default_rng(9)
    base = RPoint.generator((W * nb,)).mul(
        RScalar.from_ints([int(x) for x in r.integers(1, 2**30, size=W * nb)]))
    ref_coords = [c_.limbs.reshape(16, W, nb) for c_ in base._coords()]
    rx, ry, rz, rt = _reduce_body(*ref_coords, w_real=W, c_bits=c, static_horner=True)
    want = [np.asarray(a[:, 0, 0]) for a in (rx, ry, rz, rt)]
    got = mk.bucket_reduce(*(torch.from_numpy(np.asarray(a).astype(np.int32))
                             for a in ref_coords), c_bits=c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), w)
    # and the direct formula: sum_w 2^(c w) sum_d d B[w, d]
    pt = port_of(base).reshape(W, nb)
    acc = None
    for w in reversed(range(W)):
        s = pt[w].mul(Scalar.from_ints(list(range(nb)), device="cpu")).sum()
        acc = s if acc is None else acc.mul(Scalar.from_ints(1 << c, device="cpu")) + s
    assert bool(CurvePoint.from_coords(got, ()).equals(acc))
