"""The port's polynomial layer against the JAX package (CPU).

The public and shared polynomial operations of `tests/test_poly.py` at
small degree: the same coefficients go through both packages and the
results must be identical limb for limb (public products, evaluation,
inverse mod x^t, floor division; shared products under the dealer's
polynomial triples and, from a source without them, under one scalar Beaver
round; shared inverse and division), and the products must equal Python
ints.  The polynomial converters round-trip both packages' values.
"""

import random

import numpy as np
import pytest
import torch

import ark_mpc_tpu as ref
import ark_mpc_tpu_torch as port
from ark_mpc_tpu.algebra import poly as rpoly
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.algebra import poly as ppoly

torch.set_num_threads(1)

L = port.Scalar.spec.modulus
rng = random.Random(31)


def rand_poly(deg):
    c = [rng.randrange(L) for _ in range(deg + 1)]
    c[0] = max(1, c[0])
    c[-1] = max(1, c[-1])
    return c


def ref_mul(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % L
    return out


def limbs(x) -> np.ndarray:
    if isinstance(x.limbs, torch.Tensor):
        return x.limbs.cpu().numpy().astype(np.uint32)
    return np.asarray(x.limbs)


F, G = rand_poly(6), rand_poly(3)
X_EVAL = rng.randrange(L)


def test_public_ops_match_reference():
    pf, pg = (ppoly.DensePoly.from_ints(c, device="cpu") for c in (F, G))
    rf, rg = (rpoly.DensePoly.from_ints(c) for c in (F, G))
    pairs = [
        (pf * pg, rf * rg),
        (pf + pg, rf + rg),
        (pg - pf, rg - rf),
        (pf // pg, rf // rg),       # inverse mod x^t inside
        (pg // pf, rg // rf),   # deg f > deg g: the zero polynomial
        (pf.rev(8), rf.rev(8)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(limbs(got.coeffs), limbs(want.coeffs))
    assert (pf * pg).to_ints() == ref_mul(F, G)
    x = port.Scalar.from_ints([X_EVAL, 3], device="cpu")
    got = pf.eval(x)
    np.testing.assert_array_equal(limbs(got), limbs(rf.eval(ref.Scalar.from_ints([X_EVAL, 3]))))
    assert got.to_ints() == [sum(c * pow(v, i, L) for i, c in enumerate(F)) % L
                             for v in (X_EVAL, 3)]


class _NoPolyTriples:
    """A dealer without polynomial triples: `poly_mul` then takes one scalar
    Beaver round over every coefficient pair."""

    def next_poly_triplet(self, da, db):
        raise NotImplementedError


class PortNoPoly(_NoPolyTriples, port.TrustedDealerSource):
    pass


class RefNoPoly(_NoPolyTriples, ref.TrustedDealerSource):
    pass


def is_port(fabric) -> bool:
    return isinstance(fabric, port.MpcFabric)


def share_in(fabric, vals, sender):
    if is_port(fabric):
        v = port.Scalar.from_ints(vals, device=fabric.device)
    else:
        v = ref.Scalar.from_ints(vals)
    return fabric.share_values(v if fabric.party_id == sender else None,
                               sender=sender, n=len(vals))


def prog_shared(fabric, products_only=False):
    P = ppoly if is_port(fabric) else rpoly
    dev = {"device": fabric.device} if is_port(fabric) else {}
    field = type(fabric.mac_key)
    sf = P.AuthenticatedDensePoly(share_in(fabric, F, 0))
    sg = P.AuthenticatedDensePoly(share_in(fabric, G, 1))
    prod = P.poly_mul(fabric, sf, sg)
    ev = prod.eval(field.from_ints(X_EVAL, **dev))
    outs = {"prod": P.poly_open(fabric, prod, defer=True)}
    if not products_only:
        inv = P.poly_inverse_mod_t(fabric, sf, 4, defer_check=True)
        q = P.poly_div(fabric, sf, P.DensePoly.from_ints(G, **dev))
        lin = (sf - sg) + (-sf).scale(field.from_ints(5, **dev))
        outs.update(inv=P.poly_open(fabric, inv, defer=True),
                    div=P.poly_open(fabric, q, defer=True),
                    lin=P.poly_open(fabric, lin, defer=True))
    res = {k: v.to_ints() for k, v in outs.items()}
    res["eval"] = fabric.open_authenticated(ev, defer=True).to_ints()
    fabric.verify_deferred()
    res["prod_share"] = [limbs(prod.coeffs.share), limbs(prod.coeffs.mac)]
    return res


def prog_products(fabric):
    return prog_shared(fabric, products_only=True)


@pytest.mark.parametrize("no_poly_triples", [False, True], ids=["poly_triples", "beaver_conv"])
def test_shared_ops_match_reference(no_poly_triples):
    """Under the dealer's polynomial triples every shared op; from a source
    without them (one scalar Beaver round), the product and evaluation."""
    if no_poly_triples:
        got = port.execute_mock_mpc(prog_products, device="cpu", offline_factory=lambda pid:
                                    PortNoPoly(pid, seed=7, device="cpu"))
        want = ref.execute_mock_mpc(prog_products,
                                    offline_factory=lambda pid: RefNoPoly(pid, seed=7))
    else:
        got = port.execute_mock_mpc_dealer(prog_shared, device="cpu")
        want = ref.execute_mock_mpc_dealer(prog_shared)
    for party in (0, 1):
        assert got[party].keys() == want[party].keys()
        for key, value in want[party].items():
            if key == "prod_share":
                for g, w in zip(got[party][key], value):
                    np.testing.assert_array_equal(g, w)
            else:
                assert got[party][key] == value, key
    res = got[0]
    assert res["prod"] == ref_mul(F, G)
    assert res["eval"] == [sum(c * pow(X_EVAL, i, L) for i, c in enumerate(ref_mul(F, G))) % L]
    if not no_poly_triples:
        assert ref_mul(F, res["inv"])[:4] == [1, 0, 0, 0]
        rem = [(a - b) % L for a, b in zip(F, ref_mul(res["div"], G) + [0] * 8)]
        assert all(v == 0 for v in rem[len(G) - 1:])


def test_poly_converters_round_trip():
    rf = rpoly.DensePoly.from_ints(F)
    pf = convert.to_poly(convert.from_poly(rf), device="cpu")
    assert pf.to_ints() == F
    np.testing.assert_array_equal(convert.from_poly(pf), convert.from_poly(rf))
    sh = port.ScalarShare(pf.coeffs, pf.coeffs * pf.coeffs)
    ap = convert.to_auth_poly(convert.from_auth_poly(ppoly.AuthenticatedDensePoly(sh)),
                              device="cpu")
    assert ap.degree == len(F) - 1
    np.testing.assert_array_equal(limbs(ap.coeffs.mac), limbs(sh.mac))
