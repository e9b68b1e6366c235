"""`bucket_reduce`'s plain version against the reference epilogue (CPU).

The reference's `_reduce_body` runs eagerly, as
`tests/test_msm_bucket_fast.py` runs it, on the same tiny bucket grid
(w_real == W, so no virtual rows): the port runs the same formula sequence
(suffix scan with identity shifted in, lane tree, Horner), so the result is
bit-identical.  The grid is small and c = 1 (no T-less doubles in the
Horner): each distinct shape costs the reference an XLA compile of its
jitted formulas, which dominates this file.
"""

import jax.numpy as jnp
import numpy as np
import torch

from ark_mpc_tpu.ops.msm_kernels import _reduce_body
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.algebra.curve import CurvePoint
from ark_mpc_tpu_torch.algebra.scalar import Scalar
from ark_mpc_tpu_torch.ops import msm_kernels as mk

torch.set_num_threads(1)


def test_bucket_reduce_matches_reference_body_bit_for_bit():
    W, nb, c = 2, 4, 1  # w_real == W: no virtual rows
    r = np.random.default_rng(9)
    base = CurvePoint.generator((W * nb,), device="cpu").mul(Scalar.from_ints(
        [int(x) for x in r.integers(1, 2**30, size=W * nb)], device="cpu"))
    coords = [a.reshape(16, W, nb) for a in convert.from_point(base)]
    rx, ry, rz, rt = _reduce_body(*(jnp.asarray(a) for a in coords), w_real=W,
                                  c_bits=c, static_horner=True)
    want = [np.asarray(a[:, 0, 0]) for a in (rx, ry, rz, rt)]
    got = mk.bucket_reduce(*(torch.from_numpy(a.astype(np.int32)) for a in coords),
                           c_bits=c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), w)
    # and the direct formula: sum_w 2^(c w) sum_d d B[w, d]
    pt = base.reshape(W, nb)
    acc = None
    for w in reversed(range(W)):
        s = pt[w].mul(Scalar.from_ints(list(range(nb)), device="cpu")).sum()
        acc = s if acc is None else acc.mul(Scalar.from_ints(1 << c, device="cpu")) + s
    assert bool(CurvePoint.from_coords(got, ()).equals(acc))
