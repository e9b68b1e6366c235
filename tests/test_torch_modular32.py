"""Word-size RNS arithmetic in the port (`ark_mpc_tpu_torch/ops/modular32.py`)
against the JAX package's `ops/modular32.py`, exactly: the Montgomery product
and its conversions on random u32 values and the edges 0, q - 1 and 2^32 - 1,
the prime search and the roots of unity, and the exact float64 per-prime
matrix product against Python ints."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.ops import modular32 as ref
from ark_mpc_tpu_torch.ops import modular32 as m32

torch.set_num_threads(1)

PRIMES = ref.find_primes(3, 118965)


def _operands(q: int, seed: int):
    """Random u32 pairs plus every pair of edge values."""
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, q - 1, q, 1 << 31, (1 << 32) - 1], dtype=np.uint64)
    a = np.concatenate([rng.integers(0, 1 << 32, 2000, dtype=np.uint64), np.repeat(edges, 6)])
    b = np.concatenate([rng.integers(0, 1 << 32, 2000, dtype=np.uint64), np.tile(edges, 6)])
    return a.astype(np.uint32), b.astype(np.uint32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(want, got) -> bool:
    want = np.asarray(want).astype(np.int64)
    return want.shape == tuple(got.shape) and bool((want == got.numpy()).all())


@pytest.mark.parametrize("q", PRIMES)
def test_mont_mul32_any_u32(q):
    a, b = _operands(q, q % 1000)
    want = ref.mont_mul32(ref.PrimeSpec(q), jnp.asarray(a), jnp.asarray(b))
    assert _same(want, m32.mont_mul32(m32.PrimeSpec(q), _t(a), _t(b)))


@pytest.mark.parametrize("q", PRIMES)
def test_mont_conversions_and_add_sub(q):
    a, b = _operands(q, q % 997)
    rs, ps = ref.PrimeSpec(q), m32.PrimeSpec(q)
    assert (ps.r, ps.r2, ps.qinv_neg) == (rs.r, rs.r2, rs.qinv_neg)
    assert _same(ref.to_mont32(rs, jnp.asarray(a)), m32.to_mont32(ps, _t(a)))
    assert _same(ref.from_mont32(rs, jnp.asarray(a)), m32.from_mont32(ps, _t(a)))
    ac, bc = a % np.uint32(q), b % np.uint32(q)   # add32/sub32 take residues
    assert _same(ref.add32(rs, jnp.asarray(ac), jnp.asarray(bc)), m32.add32(ps, _t(ac), _t(bc)))
    assert _same(ref.sub32(rs, jnp.asarray(ac), jnp.asarray(bc)), m32.sub32(ps, _t(ac), _t(bc)))


@pytest.mark.parametrize("order,n", [(35, 29), (132, 21), (1155, 29), (118965, 27)])
def test_find_primes_and_roots(order, n):
    primes = m32.find_primes(n, order)
    assert primes == ref.find_primes(n, order)
    for q in primes[:4]:
        assert m32.primitive_root_of_unity(q, order) == ref.primitive_root_of_unity(q, order)


def test_residue_matmul_exact():
    """The float64 product of 11-bit thirds against Python ints, at the
    largest inner size it accepts and at residues next to q."""
    rng = np.random.default_rng(3)
    k = m32.MAX_INNER - 1
    mats = np.stack([rng.integers(q - 1000, q, (5, k)) for q in PRIMES])   # (L, 5, k)
    x = np.stack([rng.integers(q - 1000, q, (4, k)) for q in PRIMES])      # (L, 4, k)
    q_col = torch.tensor(PRIMES).reshape(-1, 1, 1)
    got = m32.residue_matmul(_t(x), m32.split_matrices(_t(mats)), q_col).numpy()
    for i, q in enumerate(PRIMES):
        for r in range(4):
            want = [sum(int(a) * int(b) for a, b in zip(mats[i, o], x[i, r])) % q for o in range(5)]
            assert got[i, r].tolist() == want
    with pytest.raises(ValueError):
        m32.split_matrices(torch.zeros(1, 2, m32.MAX_INNER, dtype=torch.int64))
