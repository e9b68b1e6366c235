"""The port's field engine against `ark_mpc_tpu.algebra.limbs`, bit for bit.

Inputs are made from a numpy seed, fed as the same (16, n) uint32 limb
arrays to both packages, and the outputs must be identical (tolerance zero:
all values are exact integers).  Fields: the Curve25519 scalar field l, the
pseudo-Mersenne Ed25519 base field, and BN254 Fr and Fq.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.algebra import limbs as ref_lb
from ark_mpc_tpu.algebra.bn254 import BN254_BASE as REF_BN254_FQ
from ark_mpc_tpu.algebra.bn254 import BN254_SCALAR as REF_BN254_FR
from ark_mpc_tpu.algebra.fields import BASE_FIELD as REF_BASE
from ark_mpc_tpu.algebra.fields import SCALAR_FIELD as REF_SCALAR
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.fields import BASE_FIELD, SCALAR_FIELD

torch.set_num_threads(1)

BN254_FR = lb.FieldSpec(REF_BN254_FR.modulus, "bn254-fr")
BN254_FQ = lb.FieldSpec(REF_BN254_FQ.modulus, "bn254-fq")
FIELDS = {
    "l": (SCALAR_FIELD, REF_SCALAR),
    "ed25519-base": (BASE_FIELD, REF_BASE),
    "bn254-fr": (BN254_FR, REF_BN254_FR),
    "bn254-fq": (BN254_FQ, REF_BN254_FQ),
}
N = 64


def rand_ints(modulus: int, n: int, seed: int) -> list:
    """n values in [0, m) from a numpy seed, with 0, 1, m-1 up front."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 9), dtype=np.uint64)
    vals = [sum(int(w) << (32 * k) for k, w in enumerate(row)) % modulus
            for row in words]
    vals[:3] = [0, 1, modulus - 1]
    return vals


def limbs(vals) -> np.ndarray:
    return lb.ints_to_limb_array(vals)


def port(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(arr.astype(np.int32))


def assert_same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == lb.LIMB_DTYPE
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.fixture(params=list(FIELDS), ids=list(FIELDS))
def field(request):
    return FIELDS[request.param]


def test_spec_constants(field):
    spec, ref = field
    assert spec.pm_c == ref.pm_c and spec.n0 == ref.n0
    assert spec.r == ref.r and spec.r2 == ref.r2
    np.testing.assert_array_equal(spec.mod_limbs, ref.mod_limbs)
    np.testing.assert_array_equal(spec.one_mont, ref.one_mont)
    assert tuple(spec.inv_exp_bits) == tuple(int(b) for b in ref.inv_exp_bits)
    assert (spec.modulus * spec.n0_32) % (1 << 32) == (1 << 32) - 1


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_op(field, op):
    spec, ref = field
    a = limbs(rand_ints(spec.modulus, N, 1))
    b = limbs(rand_ints(spec.modulus, N, 2))
    got = getattr(lb, op)(spec, port(a), port(b))
    assert_same(got, getattr(ref_lb, op)(ref, jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont", "is_zero"])
def test_unary_op(field, op):
    spec, ref = field
    a = limbs(rand_ints(spec.modulus, N, 3))
    got = getattr(lb, op)(spec, port(a))
    want = getattr(ref_lb, op)(ref, jnp.asarray(a))
    if op == "is_zero":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert_same(got, want)


def test_eq(field):
    spec, _ = field
    a = limbs(rand_ints(spec.modulus, N, 4))
    b = a.copy()
    b[3, 5:9] ^= 1
    np.testing.assert_array_equal(lb.eq(port(a), port(b)).numpy(),
                                  np.asarray(ref_lb.eq(jnp.asarray(a), jnp.asarray(b))))


def test_reduce_wide(field):
    spec, ref = field
    rng = np.random.default_rng(5)
    wide = np.zeros((32, N), dtype=np.uint32)
    wide[:28] = rng.integers(0, 1 << 16, size=(28, N), dtype=np.uint32)
    wide[:28, 0] = 0xFFFF  # the largest 448-bit value
    assert_same(lb.reduce_wide(spec, port(wide)),
                ref_lb.reduce_wide(ref, jnp.asarray(wide)))


def test_inverse(field):
    spec, ref = field
    a = limbs(rand_ints(spec.modulus, N, 6))
    assert_same(lb.inverse(spec, port(a)), ref_lb.inverse(ref, jnp.asarray(a)))


def test_mont_pow_fixed(field):
    spec, ref = field
    bits = (1, 0, 1, 1, 0, 0, 1)
    a = limbs(rand_ints(spec.modulus, N, 7))
    assert_same(lb.mont_pow_fixed(spec, port(a), bits),
                ref_lb.mont_pow_fixed(ref, jnp.asarray(a), bits))


def test_pack_unpack(field):
    spec, ref = field
    vals = rand_ints(spec.modulus, N, 8) + [spec.modulus + 5]
    packed = lb.pack_ints(spec, vals, device="cpu")
    assert_same(packed, ref_lb.pack_ints(ref, vals))
    assert lb.unpack_ints(spec, packed) == ref_lb.unpack_ints(ref, ref_lb.pack_ints(ref, vals))
    raw = lb.pack_ints(spec, vals, mont=False, device="cpu")
    assert lb.unpack_ints(spec, raw, mont=False) == [v % spec.modulus for v in vals]


def test_mont_mul_python_ints(field):
    """The product against Python ints: x*y*R^-1 (Montgomery) or x*y
    (pseudo-Mersenne, canonical)."""
    spec, _ = field
    a, b = rand_ints(spec.modulus, N, 9), rand_ints(spec.modulus, N, 10)
    got = lb.unpack_ints(spec, lb.mont_mul(spec, port(limbs(a)), port(limbs(b))),
                         mont=False)
    r_inv = 1 if spec.pm_c else pow(1 << 256, -1, spec.modulus)
    assert got == [u * v * r_inv % spec.modulus for u, v in zip(a, b)]


def test_int_limb_helpers():
    v = (1 << 255) - 12345
    np.testing.assert_array_equal(lb.int_to_limbs(v), ref_lb.int_to_limbs(v))
    assert lb.limbs_to_int(lb.int_to_limbs(v)) == v
    with pytest.raises(ValueError):
        lb.int_to_limbs(1 << 256)
