"""Fused protocol steps, single-device half.

Counterpart of the single-chip functions in `ark_mpc_tpu/parallel/step.py`:
the authenticated Beaver combine and the MAC-check fold as plain functions
on shares (they reach the `mont_mul` kernel for every product on the
card).  The mesh-sharded forms come with a later slice of the port.

    combine   [xy] = de + d[b] + e[a] + [c]           (party-0 add_public)
    check     t    = key*(xy_open) - mac              (per element)
    fold      T    = sum_i r_i * t_i                  (random linear comb.)
"""

from __future__ import annotations

from ..algebra.scalar import Scalar
from ..algebra.share import ScalarShare


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
