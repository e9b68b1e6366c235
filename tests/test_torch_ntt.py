"""The port's NTT and prime-factor DFT (`ark_mpc_tpu_torch/ops/ntt.py`,
`ops/pfa.py`) against the JAX package's, on the CPU.

The cases of `tests/test_ntt.py` and `tests/test_pfa.py`: the same
numpy-seeded residues go through both packages, and the forward and
inverse transforms and `poly_mul_mod` must be equal exactly (tolerance 0),
and equal to Python-int arithmetic (a schoolbook negacyclic product, a
dense DFT).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.ops import modular32 as ref_m32
from ark_mpc_tpu.ops import ntt as ref_ntt
from ark_mpc_tpu.ops import pfa as ref_pfa
from ark_mpc_tpu_torch.ops import modular32 as m32
from ark_mpc_tpu_torch.ops import ntt as port_ntt
from ark_mpc_tpu_torch.ops import pfa as port_pfa

torch.set_num_threads(1)


def residues(rng, q, shape) -> np.ndarray:
    return rng.integers(0, q, size=shape, dtype=np.int64)


def ref_out(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def negacyclic_mul(a, b, q):
    n = len(a)
    out = [0] * n
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            k = i + j
            if k < n:
                out[k] = (out[k] + x * y) % q
            else:
                out[k - n] = (out[k - n] - x * y) % q
    return out


def test_find_primes_and_mont32():
    """`tests/test_ntt.py`'s first case: the prime search and the
    Montgomery product round trip, equal to the reference and to Python
    ints."""
    (q,) = m32.find_primes(1, order=1 << 13, bits=30)
    assert q == ref_m32.find_primes(1, order=1 << 13, bits=30)[0] and q % (1 << 13) == 1
    spec, ref_spec = m32.PrimeSpec(q), ref_m32.PrimeSpec(q)
    rng = np.random.default_rng(61)
    a, b = residues(rng, q, 64), residues(rng, q, 64)
    got = m32.from_mont32(spec, m32.mont_mul32(spec, m32.to_mont32(spec, torch.from_numpy(a)),
                                               m32.to_mont32(spec, torch.from_numpy(b))))
    am = ref_m32.to_mont32(ref_spec, jnp.asarray(a.astype(np.uint32)))
    bm = ref_m32.to_mont32(ref_spec, jnp.asarray(b.astype(np.uint32)))
    want = ref_out(ref_m32.from_mont32(ref_spec, ref_m32.mont_mul32(ref_spec, am, bm)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [int(x) * int(y) % q for x, y in zip(a, b)]


@pytest.mark.parametrize("n", [256, 1024])
def test_ntt_roundtrip_and_mul_match_reference(n):
    """Forward, inverse and `poly_mul_mod` (its extra R^2 scaling included)
    equal the JAX package's bit for bit; the product equals the schoolbook
    negacyclic product."""
    (q,) = m32.find_primes(1, order=2 * n, bits=30)
    plan, ref_plan = port_ntt.NttPlan(q, n, device="cpu"), ref_ntt.NttPlan(q, n)
    rng = np.random.default_rng(n)
    a, b = residues(rng, q, n), residues(rng, q, n)
    ja, jb = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    fwd = port_ntt.ntt(plan, torch.from_numpy(a))
    np.testing.assert_array_equal(fwd.numpy(), ref_out(ref_ntt.ntt(ref_plan, ja)))
    inv = port_ntt.ntt(plan, torch.from_numpy(a), inverse=True)
    np.testing.assert_array_equal(inv.numpy(), ref_out(ref_ntt.ntt(ref_plan, ja, inverse=True)))
    assert port_ntt.ntt(plan, fwd, inverse=True).tolist() == a.tolist()
    prod = port_ntt.poly_mul_mod(plan, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(prod.numpy(), ref_out(ref_ntt.poly_mul_mod(ref_plan, ja, jb)))
    if n == 256:  # the schoolbook product is n^2 Python-int steps
        assert prod.tolist() == negacyclic_mul(a.tolist(), b.tolist(), q)


def test_ntt_batched_and_cyclic():
    """`tests/test_ntt.py`'s batched case (5 x 32 at a 29-bit prime) and
    the cyclic (X^N - 1) form, equal to the reference."""
    rng = np.random.default_rng(62)
    n = 32
    (q,) = m32.find_primes(1, order=2 * n, bits=29)
    for negacyclic in (True, False):
        plan = port_ntt.NttPlan(q, n, negacyclic, device="cpu")
        ref_plan = ref_ntt.NttPlan(q, n, negacyclic)
        batch = residues(rng, q, (5, n))
        fwd = port_ntt.ntt(plan, torch.from_numpy(batch))
        np.testing.assert_array_equal(
            fwd.numpy(), ref_out(ref_ntt.ntt(ref_plan, jnp.asarray(batch.astype(np.uint32)))))
        assert port_ntt.ntt(plan, fwd, inverse=True).tolist() == batch.tolist()


def test_stacked_plan_equals_one_prime_at_a_time():
    """A plan of L primes (the RNS ring's) equals L single-prime plans, forward, inverse and in `poly_mul_mod`."""
    n = 64
    primes = m32.find_primes(4, order=2 * n, bits=30)
    plans = [port_ntt.NttPlan(q, n, device="cpu") for q in primes]
    stacked = port_ntt.NttPlan(primes, n, device="cpu")
    rng = np.random.default_rng(63)
    x = torch.from_numpy(np.stack([residues(rng, q, (3, n)) for q in primes], axis=1))
    y = torch.from_numpy(np.stack([residues(rng, q, (3, n)) for q in primes], axis=1))
    for inverse in (False, True):
        got = port_ntt.ntt(stacked, x, inverse)
        for i, plan in enumerate(plans):
            assert torch.equal(got[:, i], port_ntt.ntt(plan, x[:, i], inverse))
    prod = port_ntt.poly_mul_mod(stacked, x, y)
    for i, plan in enumerate(plans):
        assert torch.equal(prod[:, i], port_ntt.poly_mul_mod(plan, x[:, i], y[:, i]))


def test_plans_default_to_cuda():
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ntt.NttPlan(m32.find_primes(1, order=128, bits=30)[0], 64)


def dense_dft(x, w, q):
    m = len(x)
    return [sum(int(x[n]) * pow(w, n * k % m, q) for n in range(m)) % q for k in range(m)]


@pytest.mark.parametrize("m", [132, 105, 15])
def test_pfa_matches_reference_and_dense_dft(m):
    (q,) = m32.find_primes(1, order=m, bits=29)
    plan, ref_plan = port_pfa.PfaPlan(q, m, device="cpu"), ref_pfa.PfaPlan(q, m)
    rng = np.random.default_rng(77 + m)
    x = residues(rng, q, m)
    got = port_pfa.pfa_dft(plan, torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), ref_out(ref_pfa.pfa_dft(ref_plan, jnp.asarray(x.astype(np.uint32)))))
    assert got.tolist() == dense_dft(x, m32.primitive_root_of_unity(q, m), q)
    back = port_pfa.pfa_dft(plan, got, inverse=True)
    np.testing.assert_array_equal(
        back.numpy(), ref_out(ref_pfa.pfa_dft(ref_plan, jnp.asarray(got.numpy().astype(np.uint32)),
                                              inverse=True)))
    assert back.tolist() == x.tolist()


def test_pfa_batched():
    m = 105
    (q,) = m32.find_primes(1, order=m, bits=28)
    plan, ref_plan = port_pfa.PfaPlan(q, m, device="cpu"), ref_pfa.PfaPlan(q, m)
    x = residues(np.random.default_rng(78), q, (4, m))
    f = port_pfa.pfa_dft(plan, torch.from_numpy(x))
    np.testing.assert_array_equal(
        f.numpy(), ref_out(ref_pfa.pfa_dft(ref_plan, jnp.asarray(x.astype(np.uint32)))))
    assert port_pfa.pfa_dft(plan, f, inverse=True).tolist() == x.tolist()
