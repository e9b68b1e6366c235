"""The hand-written CUDA kernels against their plain versions on the card.

Needs an NVIDIA card with nvcc (sm_90a); skipped without one.  This module
imports no JAX, so it runs on a machine that has only torch:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.fields import SCALAR_FIELD
from ark_mpc_tpu_torch.algebra.scalar import Scalar
from ark_mpc_tpu_torch.ops import fp_kernels as fk

BN254_FR = lb.FieldSpec(
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
    "bn254-fr")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    return torch.device("cuda")


def operands(spec, n, count, seed, dev):
    class F(Scalar):
        pass

    F.spec = spec
    rng = np.random.default_rng(seed)
    return ([F.random(n, rng, device=dev).limbs for _ in range(count)],
            [F.random((), rng, device=dev).limbs for _ in range(2)])


@pytest.mark.parametrize("spec", [SCALAR_FIELD, BN254_FR], ids=lambda s: s.name)
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_kernels_match_plain(dev, spec, n):
    arr, keys = operands(spec, n, 18, n, dev)
    before = fk.launch_counts()
    got = fk.mont_mul(spec, arr[0], arr[1])
    assert torch.equal(got, lb.mont_mul_plain(spec, arr[0], arr[1]))
    for party in (0, 1):
        args = (spec, party, *arr[:8], keys[0])
        for g, w in zip(fk.beaver_round(*args), fk.beaver_round_plain(*args)):
            assert torch.equal(g, w)
    args = (spec, 2, *arr[:17], *keys, arr[17])
    for g, w in zip(fk.beaver_chain(*args), fk.beaver_chain_plain(*args)):
        assert torch.equal(g, w)
    after = fk.launch_counts()
    # the chain's fold reduction ends with one Montgomery product
    assert [after[k] - before[k] for k in after] == [2, 2, 1]


def test_chain_splits_long_runs(dev, monkeypatch):
    """More rounds than one launch takes: the wrapper chains launches.  130
    rounds also need more than 48 KiB of shared accumulators, the opt-in
    path of the launch."""
    monkeypatch.setattr(fk, "CHAIN_MAX_ROUNDS", 129)
    arr, keys = operands(SCALAR_FIELD, 300, 18, 5, dev)
    args = (SCALAR_FIELD, 130, *arr[:17], *keys, arr[17])
    before = fk.beaver_chain.launches
    for g, w in zip(fk.beaver_chain(*args), fk.beaver_chain_plain(*args)):
        assert torch.equal(g, w)
    assert fk.beaver_chain.launches - before == 2
