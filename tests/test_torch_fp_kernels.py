"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package, bit for bit.

  - `mont_mul` against `limbs.mont_mul`, Python ints, and `mont_mul_pallas`
    in interpret mode at one tile (n = 512);
  - `beaver_round` against `parallel/step.py:beaver_mul_step`, both parties;
  - `beaver_chain` + its fold against a loop of `beaver_mul_step` and
    `(cf * v).sum()` (the reference's own Pallas chain test is skipped on
    CPU, so the port is held to the plain-JAX path);
  - `fold_reduce`, which finishes the CUDA chain's fold, against Python ints.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_mpc_tpu.algebra import limbs as ref_lb
from ark_mpc_tpu.algebra.bn254 import BN254_SCALAR as REF_BN254_FR
from ark_mpc_tpu.algebra.fields import SCALAR_FIELD as REF_SCALAR
from ark_mpc_tpu.algebra.scalar import Scalar as RefScalar
from ark_mpc_tpu.algebra.share import ScalarShare as RefShare
from ark_mpc_tpu.ops.fp_kernels import BLOCK, mont_mul_pallas
from ark_mpc_tpu.parallel.step import beaver_mul_step
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.fields import BASE_FIELD, SCALAR_FIELD
from ark_mpc_tpu_torch.ops import fp_kernels as fk

torch.set_num_threads(1)

BN254_FR = lb.FieldSpec(REF_BN254_FR.modulus, "bn254-fr")
MONT_FIELDS = {"l": (SCALAR_FIELD, REF_SCALAR), "bn254-fr": (BN254_FR, REF_BN254_FR)}


def rand_limbs(spec, shape, rng) -> np.ndarray:
    """Canonical values in [0, m) (valid Montgomery forms) as uint32 limbs."""
    shape = (shape,) if isinstance(shape, int) else shape
    n = int(np.prod(shape)) if shape else 1
    words = rng.integers(0, 1 << 32, size=(n, 9), dtype=np.uint64)
    vals = [sum(int(w) << (32 * k) for k, w in enumerate(row)) % spec.modulus
            for row in words]
    return lb.ints_to_limb_array(vals).reshape((16,) + shape)


def port(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def assert_same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))


@pytest.fixture(params=list(MONT_FIELDS), ids=list(MONT_FIELDS))
def field(request):
    return MONT_FIELDS[request.param]


def test_mont_mul_matches_reference(field):
    spec, ref = field
    rng = np.random.default_rng(20)
    x, y = rand_limbs(spec, 64, rng), rand_limbs(spec, 64, rng)
    got = fk.mont_mul(spec, port(x), port(y))
    assert_same(got, ref_lb.mont_mul(ref, jnp.asarray(x), jnp.asarray(y)))
    r_inv = pow(1 << 256, -1, spec.modulus)
    xs, ys = lb.limb_array_to_ints(x), lb.limb_array_to_ints(y)
    assert lb.limb_array_to_ints(got.numpy()) == [
        u * v * r_inv % spec.modulus for u, v in zip(xs, ys)]


def test_mont_mul_matches_pallas_interpret():
    """One tile of the TPU kernel under the Pallas interpreter, as
    tests/test_fp_kernels.py runs it."""
    rng = np.random.default_rng(21)
    x, y = rand_limbs(SCALAR_FIELD, BLOCK, rng), rand_limbs(SCALAR_FIELD, BLOCK, rng)
    want = mont_mul_pallas(REF_SCALAR, jnp.asarray(x), jnp.asarray(y))
    assert_same(fk.mont_mul(SCALAR_FIELD, port(x), port(y)), want)


def test_mont_mul_batch_shapes():
    rng = np.random.default_rng(22)
    x, y = rand_limbs(SCALAR_FIELD, (3, 5), rng), rand_limbs(SCALAR_FIELD, (3, 5), rng)
    got = fk.mont_mul(SCALAR_FIELD, port(x), port(y))
    assert tuple(got.shape) == (16, 3, 5)
    assert_same(got, ref_lb.mont_mul(REF_SCALAR, jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("name", ["mont_mul", "beaver_round", "beaver_chain"])
def test_wrappers_reject_pseudo_mersenne(name):
    """The kernels compute Montgomery products; the reference's
    `mont_mul_pallas` silently does so for the Ed25519 base field too."""
    x = torch.zeros((16, 4), dtype=torch.int32)
    args = {"mont_mul": (x, x), "beaver_round": (0,) + (x,) * 8 + (x[:, 0],),
            "beaver_chain": (1,) + (x,) * 17 + (x[:, 0], x[:, 0], x)}[name]
    with pytest.raises(ValueError, match="pseudo-Mersenne"):
        fk.KERNELS[name](BASE_FIELD, *args)


def test_cpu_tensors_take_the_plain_path():
    fk.reset_launches()
    rng = np.random.default_rng(23)
    x = port(rand_limbs(SCALAR_FIELD, 8, rng))
    torch.testing.assert_close(fk.mont_mul(SCALAR_FIELD, x, x),
                               lb.mont_mul_plain(SCALAR_FIELD, x, x), rtol=0, atol=0)
    assert fk.launch_counts() == {"mont_mul": 0, "beaver_round": 0, "beaver_chain": 0}


def _ref_share(s, m) -> RefShare:
    return RefShare(RefScalar(jnp.asarray(s)), RefScalar(jnp.asarray(m)))


@pytest.mark.parametrize("party", [0, 1])
def test_beaver_round_matches_beaver_mul_step(party):
    n = 64
    rng = np.random.default_rng(30 + party)
    a_s, a_m, b_s, b_m, c_s, c_m, d, e = (rand_limbs(SCALAR_FIELD, n, rng)
                                          for _ in range(8))
    key = rand_limbs(SCALAR_FIELD, (), rng)
    got_s, got_m = fk.beaver_round(SCALAR_FIELD, party, *map(port, (
        a_s, a_m, b_s, b_m, c_s, c_m, d, e, key)))
    # x, y do not enter the post-open combine
    want = beaver_mul_step(party, None, None, _ref_share(a_s, a_m),
                           _ref_share(b_s, b_m), _ref_share(c_s, c_m),
                           RefScalar(jnp.asarray(d)), RefScalar(jnp.asarray(e)),
                           RefScalar(jnp.asarray(key)))
    assert_same(got_s, want.share.limbs)
    assert_same(got_m, want.mac.limbs)


def test_beaver_chain_matches_step_loop():
    """Two dependent rounds at n = 1024, as the reference's chain test runs
    them: final shares and every round's three fold inner products."""
    from ark_mpc_tpu.offline.base import TrustedDealerSource

    n, rounds = 1024, 2
    rng = np.random.default_rng(7)
    dealer = TrustedDealerSource(0, seed=42)
    key0 = dealer.get_mac_key_share()
    key1 = dealer._mac_key_shares[1]
    x = RefScalar.random(n, rng)
    y = RefScalar.random(n, rng)
    x0, x1 = dealer._deal(x)
    y0, y1 = dealer._deal(y)
    av, bv = RefScalar.random(n, rng), RefScalar.random(n, rng)
    a0, a1 = dealer._deal(av)
    b0, b1 = dealer._deal(bv)
    c0, c1 = dealer._deal(av * bv)
    cf = RefScalar.random(n, rng)
    e = (y0 - b0).share + (y1 - b1).share
    ea0, ea1, eam0, eam1 = (e * t for t in (a0.share, a1.share, a0.mac, a1.mac))

    arrays = (x0.share, x1.share, e, a0.share, a1.share, b0.share, b1.share,
              b0.mac, b1.mac, c0.share, c1.share, c0.mac, c1.mac,
              ea0, ea1, eam0, eam1, key0, key1, cf)
    xf0, xf1, fold = fk.beaver_chain(SCALAR_FIELD, rounds,
                                     *(port(a.limbs) for a in arrays))
    assert tuple(fold.shape) == (16, rounds, 3)

    cx0, cx1 = x0, x1
    for r in range(rounds):
        d = (cx0 - a0).share + (cx1 - a1).share
        z0 = beaver_mul_step(0, cx0, y0, a0, b0, c0, d, e, key0)
        z1 = beaver_mul_step(1, cx1, y1, a1, b1, c1, d, e, key1)
        v = z0.share + z1.share
        for which, want in enumerate(((cf * v).sum(), (cf * z0.mac).sum(),
                                      (cf * z1.mac).sum())):
            assert_same(fold[:, r, which], want.limbs)
        cx0, cx1 = z0, z1
    assert_same(xf0, cx0.share.limbs)
    assert_same(xf1, cx1.share.limbs)


def test_fold_reduce_matches_python_ints(field):
    """`fold_reduce` finishes the CUDA chain's fold: given the 32-bit word
    sums of the 512-bit products cf*t, it returns sum(cf*t)*R^-1 mod m (the
    Montgomery form of sum of the values) as (16, K, 3)."""
    spec, _ = field
    rng = np.random.default_rng(40)
    k, n = 2, 300
    cf = lb.limb_array_to_ints(rand_limbs(spec, n, rng))
    ts = [[lb.limb_array_to_ints(rand_limbs(spec, n, rng)) for _ in range(3)]
          for _ in range(k)]
    sums = torch.zeros((k, 3, 16), dtype=torch.int64)
    want = np.zeros((16, k, 3), dtype=np.uint32)
    r_inv = pow(1 << 256, -1, spec.modulus)
    for r in range(k):
        for which in range(3):
            prods = [c * t for c, t in zip(cf, ts[r][which])]
            for w in range(16):
                sums[r, which, w] = sum((p >> (32 * w)) & 0xFFFFFFFF for p in prods)
            total = sum(prods) * r_inv % spec.modulus
            want[:, r, which] = lb.int_to_limbs(total)
    assert_same(fk.fold_reduce(spec, sums), want)


def chain_model(spec, rounds, x0, x1, e, a0, a1, b0, b1, bm0, bm1, c0, c1,
                cm0, cm1, ea0, ea1, eam0, eam1, k0, k1, cf):
    """The CUDA chain kernel's arithmetic in Python ints, element by element:
    the invariants B_p, C_p, M_p, G_p, CM_p, two Montgomery products a
    round, and the block accumulators [K + 1][3][16] of 32-bit word sums
    (cf*v, d*G_0, d*G_1 per round; [0, K_0, K_1] in the last row), finished
    by the wrapper's `chain_word_sums` and `fold_reduce`."""
    m = spec.modulus
    r_inv = pow(1 << 256, -1, m)

    def mont(a, b):
        return a * b * r_inv % m

    def add_words(row, p):
        for w in range(16):
            row[w] += (p >> (32 * w)) & 0xFFFFFFFF

    acc = [[[0] * 16 for _ in range(3)] for _ in range(rounds + 1)]
    out0, out1 = [], []
    for i in range(len(x0)):
        big_b = ((b0[i] + e[i]) % m, b1[i])
        big_c = ((ea0[i] + c0[i]) % m, (ea1[i] + c1[i]) % m)
        g = [mont(cf[i], (bm + mont(k, e[i])) % m)
             for bm, k in ((bm0[i], k0), (bm1[i], k1))]
        for q, (eam, cm) in enumerate(((eam0[i], cm0[i]), (eam1[i], cm1[i]))):
            add_words(acc[rounds][1 + q], cf[i] * ((eam + cm) % m))
        s0, s1 = x0[i], x1[i]
        for r in range(rounds):
            d = ((s0 - a0[i]) % m + (s1 - a1[i]) % m) % m
            s0 = (mont(d, big_b[0]) + big_c[0]) % m
            s1 = (mont(d, big_b[1]) + big_c[1]) % m
            add_words(acc[r][0], cf[i] * ((s0 + s1) % m))
            add_words(acc[r][1], d * g[0])
            add_words(acc[r][2], d * g[1])
        out0.append(s0)
        out1.append(s1)
    fold = fk.fold_reduce(spec, fk.chain_word_sums(torch.tensor(acc, dtype=torch.int64)))
    return out0, out1, fold


@pytest.mark.parametrize("operands", ["random", "all_m_minus_1"])
def test_chain_identities_match_plain(field, operands):
    """The redesigned kernel's identities (two reductions a round, the MAC
    folds through G_p and K_p) give `beaver_chain_plain`'s shares and fold
    bit for bit: n = 300, K = 3, random operands or every operand at m - 1
    (the largest carries and word sums)."""
    spec, _ = field
    n, rounds = 300, 3
    rng = np.random.default_rng(50)
    if operands == "random":
        arrs = [rand_limbs(spec, n, rng) for _ in range(18)]
        keys = [rand_limbs(spec, (), rng) for _ in range(2)]
    else:
        arrs = [lb.ints_to_limb_array([spec.modulus - 1] * n) for _ in range(18)]
        keys = [lb.int_to_limbs(spec.modulus - 1) for _ in range(2)]
    ints = [lb.limb_array_to_ints(a) for a in arrs]
    k0, k1 = (lb.limbs_to_int(k) for k in keys)
    got0, got1, got_fold = chain_model(spec, rounds, *ints[:17], k0, k1, ints[17])
    want0, want1, want_fold = fk.beaver_chain_plain(
        spec, rounds, *map(port, arrs[:17]), *map(port, keys), port(arrs[17]))
    assert got0 == lb.limb_array_to_ints(want0.numpy())
    assert got1 == lb.limb_array_to_ints(want1.numpy())
    assert torch.equal(got_fold, want_fold)
