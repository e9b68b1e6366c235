"""Dense polynomial algebra, public and authenticated.

Counterpart of `ark_mpc_tpu/algebra/poly.py`: evaluation, +, -, x, inverse
mod x^t and floor division via the reversal transform, over the Curve25519
scalar field.  That field has 2-adicity 2, so there is no radix-2 NTT:
products are convolutions (public x public and public x share, local) and
a polynomial Beaver triple for share x share (one open round of two masked
polynomials), or, from a source without polynomial triples, one scalar
Beaver round over every coefficient pair.

A convolution is ONE batched Montgomery product of every coefficient pair
and anti-diagonal sums by field adds.  Field sums are exact, so any order
gives the canonical limbs the JAX package's scan gives.

Shared polynomials are coefficient `ScalarShare`s; the batch axis is the
coefficient index.  New coefficients are made on the device of the operand.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import limbs as lb
from .fields import SCALAR_FIELD
from .limbs import NLIMBS
from .scalar import Scalar
from .share import ScalarShare


def _diag_sums(prod: torch.Tensor) -> torch.Tensor:
    """(16, na, nb) products -> (16, na + nb - 1): column c sums the entries
    (i, j) with i + j = c.  Row i is skewed right by i (rows padded to
    na + nb, read back as rows of na + nb - 1), then a field tree sum."""
    na, nb = prod.shape[1], prod.shape[2]
    width = na + nb - 1
    pad = prod.new_zeros((NLIMBS, na, na))
    flat = torch.cat([prod, pad], dim=2).reshape(NLIMBS, na * (width + 1))
    skew = flat[:, :na * width].reshape(NLIMBS, na, width)
    return lb.tree_sum(SCALAR_FIELD, skew, axis=1)


def _conv_coeffs(a_limbs: torch.Tensor, b_limbs: torch.Tensor) -> torch.Tensor:
    """Polynomial product coefficients: (16, da+1), (16, db+1) ->
    (16, da+db+1), all Montgomery form."""
    na, nb = a_limbs.shape[1], b_limbs.shape[1]
    shape = (NLIMBS, na, nb)
    prod = lb.mont_mul(SCALAR_FIELD, a_limbs[:, :, None].expand(shape),
                       b_limbs[:, None, :].expand(shape))
    return _diag_sums(prod)


@dataclass
class DensePoly:
    """Public polynomial with Scalar coefficients, low degree first."""

    coeffs: Scalar

    @property
    def degree(self):
        return self.coeffs.shape[0] - 1

    @property
    def device(self):
        return self.coeffs.device

    @classmethod
    def from_ints(cls, ints, device=None):
        return cls(Scalar.from_ints(list(ints), device=device))

    def __add__(self, other: "DensePoly"):
        a, b = _align(self.coeffs, other.coeffs)
        return DensePoly(a + b)

    def __sub__(self, other: "DensePoly"):
        a, b = _align(self.coeffs, other.coeffs)
        return DensePoly(a - b)

    def __neg__(self):
        return DensePoly(-self.coeffs)

    def __mul__(self, other):
        if isinstance(other, DensePoly):
            return DensePoly(Scalar(_conv_coeffs(self.coeffs.limbs,
                                                 other.coeffs.limbs)))
        if isinstance(other, Scalar):
            return DensePoly(self.coeffs * other)
        return NotImplemented

    def eval(self, x: Scalar) -> Scalar:
        """Horner evaluation; x may be a batch."""
        n = self.coeffs.shape[0]
        acc = self.coeffs[n - 1].broadcast_to(x.shape)
        for i in range(n - 2, -1, -1):
            acc = acc * x + self.coeffs[i].broadcast_to(x.shape)
        return acc

    def rev(self, n: int | None = None) -> "DensePoly":
        """Coefficient reversal rev_n(f) = x^n f(1/x)."""
        n = self.degree if n is None else n
        c = self.extend(n + 1).coeffs
        return DensePoly(Scalar(torch.flip(c.limbs, dims=[1])))

    def extend(self, n_coeffs: int) -> "DensePoly":
        cur = self.coeffs.shape[0]
        if cur >= n_coeffs:
            return self
        pad = Scalar.zeros(n_coeffs - cur, device=self.device)
        return DensePoly(Scalar.concatenate([self.coeffs, pad]))

    def truncate(self, n_coeffs: int) -> "DensePoly":
        return DensePoly(self.coeffs[:n_coeffs])

    def inverse_mod_t(self, t: int) -> "DensePoly":
        """f^{-1} mod x^t by Newton iteration g <- g (2 - f g), doubling the
        precision.  Requires f(0) != 0."""
        g = DensePoly(self.coeffs[0].inverse().reshape(1))
        two = DensePoly(Scalar.from_ints([2], device=self.device))
        prec = 1
        while prec < t:
            prec = min(2 * prec, t)
            fg = (self.truncate(prec) * g).truncate(prec)
            g = (g * (two - fg)).truncate(prec)
        return g

    def __floordiv__(self, other: "DensePoly") -> "DensePoly":
        """Floor division via the reversal transform."""
        n, m = self.degree, other.degree
        if n < m:
            return DensePoly(Scalar.zeros(1, device=self.device))
        t = n - m + 1
        q_rev = (self.rev(n) * other.rev(m).inverse_mod_t(t)).truncate(t)
        return q_rev.rev(t - 1)

    def to_ints(self):
        return self.coeffs.to_ints()


def _align(a: Scalar, b: Scalar):
    na, nb = a.shape[0], b.shape[0]
    n = max(na, nb)

    def pad(x: Scalar, cur: int) -> Scalar:
        if cur == n:
            return x
        return Scalar.concatenate([x, Scalar.zeros(n - cur, device=x.device)])

    return pad(a, na), pad(b, nb)


# ---------------------------------------------------------------------------
# authenticated polynomials
# ---------------------------------------------------------------------------


@dataclass
class AuthenticatedDensePoly:
    """Shared polynomial: coefficient ScalarShares."""

    coeffs: ScalarShare

    @property
    def degree(self):
        return self.coeffs.shape[0] - 1

    @property
    def device(self):
        return self.coeffs.device

    def __add__(self, other):
        if isinstance(other, AuthenticatedDensePoly):
            sa, sb = _align_shares(self.coeffs, other.coeffs)
            return AuthenticatedDensePoly(sa + sb)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, AuthenticatedDensePoly):
            sa, sb = _align_shares(self.coeffs, other.coeffs)
            return AuthenticatedDensePoly(sa - sb)
        return NotImplemented

    def __neg__(self):
        return AuthenticatedDensePoly(-self.coeffs)

    def mul_public(self, other: DensePoly) -> "AuthenticatedDensePoly":
        """Share x public polynomial product: local (linear in the share)."""
        share = _conv_coeffs(self.coeffs.share.limbs, other.coeffs.limbs)
        mac = _conv_coeffs(self.coeffs.mac.limbs, other.coeffs.limbs)
        return AuthenticatedDensePoly(ScalarShare(Scalar(share), Scalar(mac)))

    def scale(self, k: Scalar) -> "AuthenticatedDensePoly":
        return AuthenticatedDensePoly(self.coeffs.mul_public(k))

    def eval(self, x: Scalar) -> ScalarShare:
        """Evaluate at a public point: a local linear combination (Horner)."""
        n = self.coeffs.shape[0]
        acc = self.coeffs[n - 1]
        for i in range(n - 2, -1, -1):
            acc = acc.mul_public(x) + self.coeffs[i]
        return acc

    def extend(self, n_coeffs: int) -> "AuthenticatedDensePoly":
        cur = self.coeffs.shape[0]
        if cur >= n_coeffs:
            return self
        z = ScalarShare.zeros(n_coeffs - cur, device=self.device)
        return AuthenticatedDensePoly(ScalarShare.concatenate([self.coeffs, z]))

    def truncate(self, n_coeffs: int) -> "AuthenticatedDensePoly":
        return AuthenticatedDensePoly(self.coeffs[:n_coeffs])

    def rev(self, n: int | None = None) -> "AuthenticatedDensePoly":
        n = self.degree if n is None else n
        c = self.extend(n + 1).coeffs
        return AuthenticatedDensePoly(
            ScalarShare(Scalar(torch.flip(c.share.limbs, dims=[1])),
                        Scalar(torch.flip(c.mac.limbs, dims=[1]))))


# -- fabric-level protocols (communication) ---------------------------------


def poly_mul(fabric, a: AuthenticatedDensePoly,
             b: AuthenticatedDensePoly) -> AuthenticatedDensePoly:
    """Shared x shared polynomial product via a polynomial Beaver triple:
    one coalesced open of (a - P, b - Q), then local convolutions.  A
    source without polynomial triples takes `_poly_mul_beaver_conv`."""
    da, db = a.degree, b.degree
    try:
        p_sh, q_sh, c_sh = fabric.offline.next_poly_triplet(da, db)
    except NotImplementedError:
        return _poly_mul_beaver_conv(fabric, a, b)
    p = AuthenticatedDensePoly(p_sh)
    q = AuthenticatedDensePoly(q_sh)
    c = AuthenticatedDensePoly(c_sh)
    masked = ScalarShare.concatenate([a.coeffs - p_sh, b.coeffs - q_sh])
    opened = fabric.open(masked)
    d = DensePoly(opened[: da + 1])
    e = DensePoly(opened[da + 1:])
    res = q.mul_public(d) + p.mul_public(e) + c
    de = d * e
    return AuthenticatedDensePoly(
        fabric.add_public(res.coeffs, de.extend(da + db + 1).coeffs))


def _poly_mul_beaver_conv(fabric, a: AuthenticatedDensePoly,
                          b: AuthenticatedDensePoly) -> AuthenticatedDensePoly:
    """Share x share product from scalar triples: ONE Beaver round over all
    (da+1)(db+1) coefficient pairs, then anti-diagonal sums."""
    na, nb = a.degree + 1, b.degree + 1

    def tile(share: ScalarShare, lhs: bool) -> ScalarShare:
        def t(s: Scalar) -> Scalar:
            rows = s.limbs[:, :, None] if lhs else s.limbs[:, None, :]
            return Scalar(rows.expand(NLIMBS, na, nb).reshape(NLIMBS, na * nb))

        return ScalarShare(t(share.share), t(share.mac))

    prod = fabric.mul(tile(a.coeffs, True), tile(b.coeffs, False))
    sums = [Scalar(_diag_sums(v.limbs.reshape(NLIMBS, na, nb)))
            for v in (prod.share, prod.mac)]
    return AuthenticatedDensePoly(ScalarShare(*sums))


def poly_open(fabric, a: AuthenticatedDensePoly,
              authenticated: bool = True, defer: bool = False) -> DensePoly:
    """Open all coefficients."""
    if authenticated:
        return DensePoly(fabric.open_authenticated(a.coeffs, defer=defer))
    return DensePoly(fabric.open(a.coeffs))


def poly_inverse_mod_t(fabric, a: AuthenticatedDensePoly, t: int,
                       defer_check: bool = False) -> AuthenticatedDensePoly:
    """[f^{-1} mod x^t] via masked open: sample a shared random poly r, open
    r f mod x^t, invert publicly, then f^{-1} = r (r f)^{-1} locally."""
    r = AuthenticatedDensePoly(fabric.random_shared_scalars(t))
    rf = poly_mul(fabric, r, a.truncate(t) if a.degree >= t else a)
    rf_open = DensePoly(fabric.open_authenticated(rf.truncate(t).coeffs,
                                                  defer=defer_check))
    return r.mul_public(rf_open.inverse_mod_t(t)).truncate(t)


def poly_div(fabric, f: AuthenticatedDensePoly, g: DensePoly,
             defer_check: bool = False) -> AuthenticatedDensePoly:
    """Floor division of a shared polynomial by a public one via the
    reversal transform (local)."""
    n, m = f.degree, g.degree
    if n < m:
        return AuthenticatedDensePoly(ScalarShare.zeros(1, device=f.device))
    t = n - m + 1
    rev_g_inv = g.rev(m).inverse_mod_t(t)
    q_rev = f.rev(n).mul_public(rev_g_inv).truncate(t)
    return q_rev.rev(t - 1)


def _align_shares(a: ScalarShare, b: ScalarShare):
    na, nb = a.shape[0], b.shape[0]
    n = max(na, nb)

    def pad(x: ScalarShare, cur: int) -> ScalarShare:
        if cur == n:
            return x
        return ScalarShare.concatenate([x, ScalarShare.zeros(n - cur, device=x.device)])

    return pad(a, na), pad(b, nb)
