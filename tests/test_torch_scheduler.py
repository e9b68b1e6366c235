"""The port's traced circuit scheduler against the JAX package (CPU).

The tier-1 programs of `tests/test_scheduler.py` (round fusion, inverse and
sum, a deep mul chain, the affine-form term cap and mixed coefficients) and
the README's traced example run through both packages' fabrics under the
same dealers: opened values, output share and MAC limbs and round counts
must be identical.  The programs the reference marks `slow` (point
circuit, pow, open reuse, gadgets, a long add chain) run through the port
only, at a tiny n, against Python ints.  `FabricStats` is held to
`tests/test_stats.py`.
"""

import json
import random

import numpy as np
import pytest
import torch

import ark_mpc_tpu as ref
import ark_mpc_tpu_torch as port
from ark_mpc_tpu_torch.algebra.curve import CurvePoint
from ark_mpc_tpu_torch.fabric.transport import NoRecvTransport
from ark_mpc_tpu_torch.gadgets import bit_xor, bit_xor_public, prefix_product

torch.set_num_threads(1)

L = port.Scalar.spec.modulus
N = 4  # one batch width for every program, so each jitted reference op compiles once
rng = random.Random(53)
XS = [rng.randrange(L) for _ in range(N)]
YS = [rng.randrange(L) for _ in range(N)]
INV = [rng.randrange(1, L) for _ in range(N)]
TREE = [rng.randrange(L) for _ in range(16 * N)]
MIX = [rng.randrange(L) for _ in range(5)]
CHAIN = 16


def is_port(fabric) -> bool:
    return isinstance(fabric, port.MpcFabric)


def ints(fabric, vals):
    if is_port(fabric):
        return fabric.field.from_ints(vals, device=fabric.device)
    return fabric.field.from_ints(vals)


def share_in(fabric, vals, sender):
    return fabric.share_values(ints(fabric, vals) if fabric.party_id == sender
                               else None, sender=sender, n=len(vals))


def limbs(x) -> np.ndarray:
    if isinstance(x.limbs, torch.Tensor):
        return x.limbs.cpu().numpy().astype(np.uint32)
    return np.asarray(x.limbs)


def shares(sh) -> list:
    return [limbs(sh.share), limbs(sh.mac)]


# -- the tier-1 programs of tests/test_scheduler.py --------------------------


def prog_fuses_rounds(fabric):
    sx, sy = share_in(fabric, XS, 0), share_in(fabric, YS, 1)
    base = fabric.n_rounds
    tr = fabric.tracer()
    x, y = tr.wrap(sx), tr.wrap(sy)
    a, b, c = x * y, x * x, y * y      # level 1: ONE exchange
    d = a * b                          # level 2
    e = (c + d) * ints(fabric, 3) - x
    oa, oe = a.open(), e.open()
    (out,) = tr.run(outputs=[e])
    return {"open": oa.value.to_ints() + oe.value.to_ints(),
            "rounds": fabric.n_rounds - base, "out": shares(out)}


def prog_inverse_and_sum(fabric):
    tr = fabric.tracer()
    x = tr.wrap(share_in(fabric, INV, 0))
    total = (x * x.inverse()).sum()
    o = total.open()
    (out,) = tr.run(outputs=[total])
    return {"open": o.value.to_ints(), "out": shares(out)}


def prog_deep_mul_chain(fabric):
    sx = share_in(fabric, [2] * N, 0)
    base = fabric.n_rounds
    tr = fabric.tracer()
    v = x = tr.wrap(sx)
    for _ in range(CHAIN):
        v = v * x
    o = v.open()
    (out,) = tr.run(outputs=[v])
    return {"open": o.value.to_ints(), "rounds": fabric.n_rounds - base,
            "out": shares(out)}


def prog_term_cap_tree_sum(fabric):
    """16 leaves: the pairwise sums pass _MAX_TERMS = 12 and materialize."""
    sv = share_in(fabric, TREE, 0)
    tr = fabric.tracer()
    leaves = [tr.wrap(sv[i:i + N]) for i in range(0, len(TREE), N)]
    while len(leaves) > 1:
        leaves = [leaves[i] + leaves[i + 1] for i in range(0, len(leaves), 2)]
    o = leaves[0].open()
    (out,) = tr.run(outputs=[leaves[0]])
    return {"open": o.value.to_ints(), "out": shares(out)}


def prog_mixed_coefficients(fabric):
    x_v, y_v, k1, k2, c = MIX
    sx, sy = share_in(fabric, [x_v] * N, 0), share_in(fabric, [y_v] * N, 1)
    base = fabric.n_rounds
    tr = fabric.tracer()
    tx, ty = tr.wrap(sx), tr.wrap(sy)
    lin = (tx * ints(fabric, k1) - ty * ints(fabric, k2) + ints(fabric, c) - (-ty))
    op = (tx * ty).open()              # mid-circuit open
    dyn = lin * op.as_public()         # dynamic public coefficient
    o = dyn.open()
    (out,) = tr.run(outputs=[dyn])
    return {"open": o.value.to_ints(), "rounds": fabric.n_rounds - base,
            "out": shares(out)}


def prog_readme_traced(fabric):
    sx, sy = share_in(fabric, XS, 0), share_in(fabric, YS, 1)
    base = fabric.n_rounds
    tr = fabric.tracer()
    x, y = tr.wrap(sx), tr.wrap(sy)
    z = (x * y + x).sum()
    out = z.open()
    tr.run()
    return {"open": out.value.to_ints(), "rounds": fabric.n_rounds - base}


x_v, y_v, k1, k2, c = MIX
CASES = {
    "fuses_rounds": (prog_fuses_rounds,
                     [x * y % L for x, y in zip(XS, YS)]
                     + [((y * y + (x * y) * (x * x)) * 3 - x) % L
                        for x, y in zip(XS, YS)]),
    "inverse_and_sum": (prog_inverse_and_sum, [N]),
    "deep_mul_chain": (prog_deep_mul_chain, [pow(2, CHAIN + 1, L)] * N),
    "term_cap_tree_sum": (prog_term_cap_tree_sum,
                          [sum(TREE[j::N]) % L for j in range(N)]),
    "mixed_coefficients": (prog_mixed_coefficients,
                           [(x_v * k1 - y_v * k2 + c + y_v) * (x_v * y_v) % L] * N),
    "readme_traced": (prog_readme_traced,
                      [sum(x * y + x for x, y in zip(XS, YS)) % L]),
}


def prog_all(fabric):
    return {name: prog(fabric) for name, (prog, _) in CASES.items()}


@pytest.fixture(scope="module")
def both_runs():
    """Every program once per package, in one mock-MPC run each."""
    return (port.execute_mock_mpc_dealer(prog_all, device="cpu"),
            ref.execute_mock_mpc_dealer(prog_all))


@pytest.mark.parametrize("name", list(CASES))
def test_traced_program_matches_reference(both_runs, name):
    got, want = both_runs
    expected = CASES[name][1]
    for party in (0, 1):
        g, w = got[party][name], want[party][name]
        assert g.keys() == w.keys()
        for key, value in w.items():
            if key == "out":
                for a, b in zip(g[key], value):
                    np.testing.assert_array_equal(a, b)
            else:
                assert g[key] == value, key
        assert g["open"] == expected
    if name == "fuses_rounds":
        # 2 mul levels + 1 open flush + 3 deferred-MAC-check exchanges
        assert got[0][name]["rounds"] == 6


# -- the reference's slow programs, port only, against Python ints ----------


def test_traced_point_circuit():
    ks = [rng.randrange(L) for _ in range(2)]
    base = [5, 9]

    def prog(fabric):
        dev = fabric.device
        pts = CurvePoint.generator((2,), device=dev).mul(port.Scalar.from_ints(base, device=dev))
        sp = fabric.share_points(pts if fabric.party_id == 0 else None, sender=0, n=2)
        sk = share_in(fabric, ks, 1)
        start = fabric.n_rounds
        tr = fabric.tracer()
        p, k = tr.wrap_points(sp), tr.wrap(sk)
        expr = p.mul(k) + p            # one fused Beaver level, then linear
        o1, o2 = expr.open(), expr.sum().open()
        tr.run()
        aff = [tuple(c.to_ints()) for c in o1.value.to_affine()]
        tot = [c.to_int() for c in o2.value.reshape(1).to_affine()]
        return aff, tot, fabric.n_rounds - start

    (e0, t0, r0), (e1, t1, _) = port.execute_mock_mpc_dealer(prog, device="cpu")
    want = CurvePoint.generator((2,), device="cpu").mul(port.Scalar.from_ints(
        [(k + 1) * b % L for k, b in zip(ks, base)], device="cpu"))
    assert e0 == e1 == [tuple(c.to_ints()) for c in want.to_affine()]
    assert t0 == t1 == [c.to_int() for c in want.sum().reshape(1).to_affine()]
    assert r0 > 0


def test_traced_pow_open_reuse_and_gadgets():
    xs = [rng.randrange(1, L) for _ in range(3)]
    ys = [rng.randrange(L) for _ in range(3)]
    a_bits = [rng.randrange(2) for _ in range(3)]
    b_bits = [rng.randrange(2) for _ in range(3)]

    def prog(fabric):
        tr = fabric.tracer()
        x, y = tr.wrap(share_in(fabric, xs, 0)), tr.wrap(share_in(fabric, ys, 1))
        ta, tb = tr.wrap(share_in(fabric, a_bits, 0)), tr.wrap(share_in(fabric, b_bits, 1))
        po = (x * y).open()
        pub = po.as_public()
        q = y * pub + x - pub                  # share ops against an opened value
        r = (pub * pub).inverse() * x          # public arithmetic + apply
        outs = [x.pow(13), x ** 1, x ** 0, q, r, bit_xor(fabric, ta, tb),
                bit_xor_public(fabric, ta, ints(fabric, b_bits)),
                prefix_product(fabric, x)]
        handles = [po] + [o.open() for o in outs]
        tr.run()
        return [h.value.to_ints() for h in handles]

    r0, r1 = port.execute_mock_mpc_dealer(prog, device="cpu")
    p = [a * b % L for a, b in zip(xs, ys)]
    prefix = [xs[0], xs[0] * xs[1] % L, xs[0] * xs[1] * xs[2] % L]
    xor = [u ^ v for u, v in zip(a_bits, b_bits)]
    want = [p, [pow(a, 13, L) for a in xs], xs, [1, 1, 1],
            [(b * q + a - q) % L for a, b, q in zip(xs, ys, p)],
            [pow(q * q, -1, L) * a % L for a, q in zip(xs, p)],
            xor, xor, prefix]
    assert r0 == r1 == want


def test_gate_throughput_chain_on_norecv_transport():
    """A long add chain through `tr.run(outputs=[v])` with no peer: every
    gate folds into one affine form, and the traversal is iterative."""
    fabric = port.MpcFabric(0, NoRecvTransport(), port.PartyIDBeaverSource(0, device="cpu"),
                            device="cpu")
    tr = fabric.tracer()
    x = tr.wrap(fabric.share_public(port.Scalar.from_ints([1], device="cpu")))
    v = x
    for _ in range(100_000):
        v = v + x
    (out,) = tr.run(outputs=[v])
    assert out.share.to_ints() == [100_001]  # party 0 holds the public value
    assert fabric.n_rounds == 0


# -- FabricStats (tests/test_stats.py) ---------------------------------------


def test_fabric_stats_dump():
    def prog(fabric):
        fab = port.MpcFabric(fabric.party_id, fabric.transport,
                             port.TrustedDealerSource(fabric.party_id, seed=7, device="cpu"),
                             rng=fabric.rng, collect_stats=True, device="cpu")
        sq = fab.mul(*[share_in(fab, [3, 4], 0)] * 2)
        fab.open_authenticated(sq)
        assert fab.num_ops() >= 3
        json.loads(fab.stats.dump(fab.transport.stats))
        return fab.stats.snapshot(fab.transport.stats)

    for s in port.execute_mock_mpc_dealer(prog, device="cpu"):
        assert s["ops"]["beaver_mul"]["calls"] == 1
        assert s["ops"]["beaver_mul"]["elements"] == 2
        assert s["ops"]["open"]["calls"] == 1
        assert s["ops"]["mac_check"]["calls"] == 1
        assert s["rounds"] >= 5
        assert s["network"]["bytes_sent"] > 0
    plain = port.MpcFabric(0, NoRecvTransport(), port.PartyIDBeaverSource(0, device="cpu"),
                           device="cpu")
    assert plain.stats is None and plain.num_ops() == 0


@pytest.mark.parametrize("e", [-1, -5])
def test_traced_pow_rejects_negative_exponent(e):
    def prog(fabric):
        tr = fabric.tracer()
        x = tr.wrap(share_in(fabric, XS, 0))
        stream = fabric.offline.rng.bit_generator.state
        with pytest.raises(ValueError, match="exponent"):
            x.pow(e)
        # no triple was drawn: the dealer's stream has not moved
        assert fabric.offline.rng.bit_generator.state == stream
        o = (x * x).open()
        tr.run()
        return o.value.to_ints()

    v0, v1 = port.execute_mock_mpc_dealer(prog, device="cpu")
    assert v0 == v1 == [x * x % L for x in XS]
