"""The port's field matrix product, matrix and polynomial triples and the
flagship circuits against the JAX package (CPU).

`mont_matmul` must equal the reference's limb for limb at the shapes of
`tests/test_matmul.py`, and Python ints where k crosses the reference's
k chunk (K_CHUNK = 1024; the reference is left out there, its unrolled
compile is slow).  The dealers' matrix and polynomial triples are identical
for one seed, and `shared_matmul`, `inner_product` and `poly_eval` run
through both packages' fabrics with identical results.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_mpc_tpu as ref
import ark_mpc_tpu_torch as port
from ark_mpc_tpu.models import circuits as ref_circuits
from ark_mpc_tpu.ops.matmul import K_CHUNK as REF_K_CHUNK
from ark_mpc_tpu.ops.matmul import mont_matmul as ref_mont_matmul
from ark_mpc_tpu_torch.algebra.fields import SCALAR_FIELD
from ark_mpc_tpu_torch.models import circuits as port_circuits
from ark_mpc_tpu_torch.ops import matmul

torch.set_num_threads(1)

L = SCALAR_FIELD.modulus
rng = random.Random(17)


def rand_mat(m, n):
    return [[rng.randrange(L) for _ in range(n)] for _ in range(m)]


def ref_product(a, b):
    k, n = len(b), len(b[0])
    return [sum(a[i][t] * b[t][j] for t in range(k)) % L
            for i in range(len(a)) for j in range(n)]


def limbs(x) -> np.ndarray:
    if isinstance(x.limbs, torch.Tensor):
        return x.limbs.cpu().numpy().astype(np.uint32)
    return np.asarray(x.limbs)


def is_port(fabric) -> bool:
    return isinstance(fabric, port.MpcFabric)


def ints(fabric, vals):
    if isinstance(vals, list):
        vals = np.array(vals, dtype=object)
    if is_port(fabric):
        return fabric.field.from_ints(vals, device=fabric.device)
    return fabric.field.from_ints(vals)


def share_in(fabric, vals, sender, shape=None):
    n = int(np.prod(np.shape(vals)))
    sh = fabric.share_values(ints(fabric, vals) if fabric.party_id == sender
                             else None, sender=sender, n=n)
    return sh.reshape(*shape) if shape else sh


@pytest.mark.parametrize("m,k,n", [(5, 7, 3), (33, 33, 33)])
def test_mont_matmul_matches_reference(m, k, n):
    a, b = rand_mat(m, k), rand_mat(k, n)
    pa = port.Scalar.from_ints(np.array(a, dtype=object), device="cpu")
    pb = port.Scalar.from_ints(np.array(b, dtype=object), device="cpu")
    got = matmul.mont_matmul(SCALAR_FIELD, pa.limbs, pb.limbs)
    want = ref_mont_matmul(ref.Scalar.spec, jnp.asarray(limbs(pa)), jnp.asarray(limbs(pb)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    assert (pa @ pb).to_ints() == ref_product(a, b)


@pytest.mark.parametrize("k", [REF_K_CHUNK, REF_K_CHUNK + 6])
def test_mont_matmul_exact_across_the_k_chunk(k):
    """Operands at m - 1 (the largest canonical values) and random ones."""
    a = [[L - 1] * k, [rng.randrange(L) for _ in range(k)]]
    b = [[L - 1, rng.randrange(L)] for _ in range(k)]
    pa = port.Scalar.from_ints(np.array(a, dtype=object), device="cpu")
    pb = port.Scalar.from_ints(np.array(b, dtype=object), device="cpu")
    assert (pa @ pb).to_ints() == ref_product(a, b)


def test_mont_matmul_chunks_k(monkeypatch):
    """The port's own k chunks (summed by field adds) change nothing."""
    a, b = rand_mat(3, 9), rand_mat(9, 2)
    pa = port.Scalar.from_ints(np.array(a, dtype=object), device="cpu")
    pb = port.Scalar.from_ints(np.array(b, dtype=object), device="cpu")
    whole = matmul.mont_matmul(SCALAR_FIELD, pa.limbs, pb.limbs)
    monkeypatch.setattr(matmul, "K_CHUNK", 4)
    monkeypatch.setattr(matmul, "_MAX_INTER_BYTES", 1)  # one row per m chunk
    assert torch.equal(matmul.mont_matmul(SCALAR_FIELD, pa.limbs, pb.limbs), whole)
    with pytest.raises(ValueError, match="inner dimensions"):
        matmul.mont_matmul(SCALAR_FIELD, pa.limbs, pa.limbs)


@pytest.mark.parametrize("party", [0, 1])
def test_dealer_matrix_and_poly_triples_match_reference(party):
    p = port.TrustedDealerSource(party, seed=23, device="cpu")
    r = ref.TrustedDealerSource(party, seed=23)
    pp, rp = port.PartyIDBeaverSource(party, device="cpu"), ref.PartyIDBeaverSource(party)
    for src_p, src_r in ((p, r), (pp, rp)):
        for draw in (lambda s: s.next_matrix_triplet(2, 3, 2),
                     lambda s: s.next_poly_triplet(3, 2)):
            for ps, rs in zip(draw(src_p), draw(src_r)):
                np.testing.assert_array_equal(limbs(ps.share), limbs(rs.share))
                np.testing.assert_array_equal(limbs(ps.mac), limbs(rs.mac))


A, B = rand_mat(2, 3), rand_mat(3, 2)
COEFFS = [rng.randrange(L) for _ in range(6)]
X_EVAL = rng.randrange(L)
VX, VY = [rng.randrange(L) for _ in range(8)], [rng.randrange(L) for _ in range(8)]


def prog_shared_matmul(fabric):
    mod = port_circuits if is_port(fabric) else ref_circuits
    sa, sb = share_in(fabric, A, 0, (2, 3)), share_in(fabric, B, 1, (3, 2))
    sc = mod.shared_matmul(fabric, sa, sb)
    return {"open": fabric.open_authenticated(sc.reshape(4)).to_ints(),
            "share": limbs(sc.share), "mac": limbs(sc.mac)}


def prog_poly_eval_and_inner_product(fabric):
    mod = port_circuits if is_port(fabric) else ref_circuits
    res = mod.poly_eval(fabric, share_in(fabric, COEFFS, 0), ints(fabric, X_EVAL))
    ip = mod.inner_product(fabric, share_in(fabric, VX, 0), share_in(fabric, VY, 1))
    both = type(res).concatenate([res.reshape(1), ip.reshape(1)])
    return {"open": fabric.open_authenticated(both).to_ints(),
            "share": limbs(both.share), "mac": limbs(both.mac)}


@pytest.mark.parametrize("prog,dealer,expected", [
    (prog_shared_matmul, False, ref_product(A, B)),
    (prog_poly_eval_and_inner_product, True,
     [sum(c * pow(X_EVAL, i, L) for i, c in enumerate(COEFFS)) % L,
      sum(x * y for x, y in zip(VX, VY)) % L]),
], ids=["shared_matmul_partyid", "poly_eval_inner_product_dealer"])
def test_circuit_matches_reference(prog, dealer, expected):
    run_p = port.execute_mock_mpc_dealer if dealer else port.execute_mock_mpc
    run_r = ref.execute_mock_mpc_dealer if dealer else ref.execute_mock_mpc
    got, want = run_p(prog, device="cpu"), run_r(prog)
    for party in (0, 1):
        assert got[party]["open"] == want[party]["open"] == expected
        for key in ("share", "mac"):
            np.testing.assert_array_equal(got[party][key], want[party][key])


def test_shared_matmul_dealer():
    """The dealer's random matrix triple, through the port only."""
    a, b = rand_mat(4, 5), rand_mat(5, 3)

    def prog(fabric):
        sc = port_circuits.shared_matmul(fabric, share_in(fabric, a, 0, (4, 5)),
                                         share_in(fabric, b, 1, (5, 3)))
        return fabric.open_authenticated(sc.reshape(12)).to_ints()

    r0, r1 = port.execute_mock_mpc_dealer(prog, device="cpu")
    assert r0 == r1 == ref_product(a, b)
