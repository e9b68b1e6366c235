"""The hand-written CUDA kernels against their plain versions on the card.

Needs an NVIDIA card with nvcc (sm_90a); skipped without one.  This module
imports no JAX, so it runs on a machine that has only torch:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import _torch_wire_faults as wire_faults
from ark_mpc_tpu_torch import AuthenticationError, execute_mock_mpc_dealer
from ark_mpc_tpu_torch.algebra import limbs as lb
from ark_mpc_tpu_torch.algebra.bn254 import BN254_BASE, BN254_SCALAR
from ark_mpc_tpu_torch.algebra.fields import SCALAR_FIELD
from ark_mpc_tpu_torch.algebra.scalar import Scalar
from ark_mpc_tpu_torch.ops import fp_kernels as fk


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


@pytest.mark.parametrize("spec", [SCALAR_FIELD, BN254_SCALAR, BN254_BASE], ids=lambda s: s.name)
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


@pytest.mark.parametrize("spec", [SCALAR_FIELD, BN254_SCALAR], ids=lambda s: s.name)
def test_chain_all_operands_m_minus_1(dev, spec):
    """Every operand and key at m - 1 (the largest carries, reductions and
    fold word sums) at n = 4096 + 7, an odd tail past the last full tile."""
    n = 4096 + 7
    big = torch.from_numpy(lb.ints_to_limb_array([spec.modulus - 1] * n)
                           .astype(np.int32)).to(dev)
    key = big[:, 0].contiguous()
    args = (spec, 3, *[big.clone() for _ in range(17)], key, key.clone(), big.clone())
    for g, w in zip(fk.beaver_chain(*args), fk.beaver_chain_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("spec", [SCALAR_FIELD, BN254_SCALAR], ids=lambda s: s.name)
def test_chain_one_round(dev, spec):
    arr, keys = operands(spec, 4096 + 7, 18, 17, dev)
    args = (spec, 1, *arr[:17], *keys, arr[17])
    for g, w in zip(fk.beaver_chain(*args), fk.beaver_chain_plain(*args)):
        assert torch.equal(g, w)


def test_chain_launch_config(dev):
    """The persistent grid: resident blocks x SMs, capped by the tiles; at
    the headline's 64 rounds two blocks (16 warps) are resident per SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = fk.chain_launch_config(1 << 22, 64, dev)
    assert cfg["blocks_per_sm"] >= 2 and cfg["warps_per_sm"] >= 16
    assert cfg["grid"] == cfg["blocks_per_sm"] * sms
    assert fk.chain_launch_config(1000, 64, dev)["grid"] == 4


def test_chain_splits_long_runs(dev, monkeypatch):
    """More rounds than one launch takes: the wrapper chains launches, each
    recomputing the invariants and adding its own K_p.  129 rounds in one
    launch need 120 KiB of shared memory: one block per SM."""
    monkeypatch.setattr(fk, "CHAIN_MAX_ROUNDS", 129)
    arr, keys = operands(SCALAR_FIELD, 300, 18, 5, dev)
    args = (SCALAR_FIELD, 130, *arr[:17], *keys, arr[17])
    before = fk.beaver_chain.launches
    for g, w in zip(fk.beaver_chain(*args), fk.beaver_chain_plain(*args)):
        assert torch.equal(g, w)
    assert fk.beaver_chain.launches - before == 2


# ---------------------------------------------------------------------------
# the curve kernels (ops/curve_kernels.py, ops/msm_kernels.py)
# ---------------------------------------------------------------------------


def curve_operands(n, seed, dev):
    from ark_mpc_tpu_torch.algebra.curve import CurvePoint

    rng = np.random.default_rng(seed)
    pts = CurvePoint.random(n, rng, device="cpu")  # hash-to-curve on the host
    coords = [c.limbs.to(dev).contiguous() for c in pts._coords()]
    canon = Scalar.random(n, rng, device=dev).canonical_limbs().contiguous()
    return canon, coords


def same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_curve_kernels_match_plain(dev, n, monkeypatch):
    from ark_mpc_tpu_torch.ops import curve_kernels as ck
    from ark_mpc_tpu_torch.ops import msm_kernels as mk

    canon, co = curve_operands(n, 100 + n, dev)
    before = mk.launch_counts()
    assert same(ck.windowed_mul(canon, *co), ck.windowed_mul_plain(canon, *co))
    assert same(ck.ladder(canon, *co), ck.ladder_plain(canon, *co))
    monkeypatch.setattr(ck, "WS_MAX_LANES", 3)  # a few lanes of many tiles each
    assert same(ck.window_sums(canon, *co), ck.window_sums_plain(canon, *co))
    idx, off = mk.bucket_prologue(canon)
    buckets = mk.bucket_accumulate(idx, off, *co)
    assert same(buckets, mk.bucket_accumulate_plain(idx, off, *co))
    assert same(mk.bucket_reduce(*buckets), mk.bucket_reduce_plain(*buckets))
    torch.cuda.synchronize()
    after = mk.launch_counts()
    # bucket_accumulate launches its kernel once a pass
    assert [after[k] - before[k] for k in after] == [1, 1, 1, mk.bucket_passes(n), 1]


def test_ladder_edge_scalars_and_subgroup_check(dev):
    """Scalars 0, 1, 2, l - 1, 2^253 - 1 (every bit the ladder reads) and l,
    and the ladder's l * P of subgroup points is the identity."""
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    _, co = curve_operands(6, 9, dev)
    ks = [0, 1, 2, SCALAR_FIELD.modulus - 1, (1 << 253) - 1, SCALAR_FIELD.modulus]
    canon = torch.from_numpy(lb.ints_to_limb_array(ks).astype(np.int32)).to(dev)
    assert same(ck.ladder(canon, *co), ck.ladder_plain(canon, *co))
    from ark_mpc_tpu_torch.algebra.curve import CurvePoint

    pts = CurvePoint.from_coords(co, (6,))
    assert bool(ck.mul_by_order(pts, kernel="ladder").is_identity().all())


# ---------------------------------------------------------------------------
# ladder: one thread a point, loose values, P cached in shared memory,
# products on carry chains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 4097])
def test_ladder_block_and_wave_edges(dev, n):
    """A lone point, part-filled warps, either side of a 128-thread block
    and a ragged last block, bit for bit, each call one launch."""
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    canon, co = curve_operands(n, 500 + n, dev)
    before = ck.ladder.launches
    got = ck.ladder(canon, *co)
    assert ck.ladder.launches == before + 1
    assert same(got, ck.ladder_plain(canon, *co))


def test_ladder_empty_batch_launches_nothing(dev):
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    empty = torch.zeros((16, 0), dtype=torch.int32, device=dev)
    before = ck.ladder.launches
    outs = ck.ladder(empty, empty, empty, empty, empty)
    assert ck.ladder.launches == before
    assert all(tuple(o.shape) == (16, 0) for o in outs)


def test_ladder_launch_config(dev):
    """128 threads (points) a block and 4 resident blocks, 16 warps, per
    SM: on 132 SMs the 512 blocks of 2^16 points take one wave."""
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = ck.ladder_launch_config(1 << 16, dev)
    assert cfg["threads"] == cfg["points_per_block"] == 128 and cfg["grid"] == 512
    assert cfg["blocks_per_sm"] >= 4 and cfg["warps_per_sm"] >= 16
    assert cfg["waves"] == 512 / (cfg["blocks_per_sm"] * sms)
    assert ck.ladder_launch_config(129, dev)["grid"] == 2


@pytest.mark.parametrize("m,k,n", [(5, 7, 3), (2, 1030, 2), (64, 64, 64)])
def test_mont_matmul_on_the_card(dev, m, k, n):
    """The float64 route on the card equals the same route on the CPU."""
    from ark_mpc_tpu_torch.ops.matmul import mont_matmul

    rng = np.random.default_rng(m * k * n)
    a = Scalar.random((m, k), rng, device="cpu")
    b = Scalar.random((k, n), rng, device="cpu")
    want = mont_matmul(SCALAR_FIELD, a.limbs, b.limbs)
    got = mont_matmul(SCALAR_FIELD, a.limbs.to(dev), b.limbs.to(dev))
    assert torch.equal(got.cpu(), want)


def test_bucket_accumulate_clustered_digits(dev):
    """Every scalar equal: each window's points all land in one bucket."""
    from ark_mpc_tpu_torch.ops import msm_kernels as mk

    n = 1000
    _, co = curve_operands(n, 7, dev)
    canon = Scalar.from_ints([(1 << 252) + 0x0102030405] * n, device=dev).canonical_limbs()
    idx, off = mk.bucket_prologue(canon.contiguous())
    assert int((off[:, 1:] - off[:, :-1]).max()) == n
    buckets = mk.bucket_accumulate(idx, off, *co)
    assert same(buckets, mk.bucket_accumulate_plain(idx, off, *co))
    assert same(mk.bucket_reduce(*buckets), mk.bucket_reduce_plain(*buckets))


def bucket_operands(n, layout, seed, dev):
    """Points on the card and the prologue of scalars whose 8-bit digits
    follow `layout`: "top" (window 31's digits all in 1..15, the deep
    buckets of real scalars), "cluster" (every scalar equal: each window's
    points in one bucket, the most passes) or "chunk" (buckets of exactly
    CHUNK and CHUNK + 1 points)."""
    from ark_mpc_tpu_torch.algebra.curve import CurvePoint
    from ark_mpc_tpu_torch.ops import msm_kernels as mk

    rng = np.random.default_rng(seed)
    pts = CurvePoint.generator((n,), device=dev).mul(Scalar.random(n, rng, device=dev))
    if layout == "top":
        digits = rng.integers(0, 256, (32, n))
        digits[31] = rng.integers(1, 16, n)
    elif layout == "cluster":
        digits = np.repeat(rng.integers(0, 256, (32, 1)), n, 1)
    else:
        seq = np.concatenate([np.full(mk.CHUNK + (d & 1), d) for d in range(1, 256)])
        digits = np.stack([rng.permutation(np.resize(seq, n)) for _ in range(32)])
    canon = torch.from_numpy((digits[0::2] | (digits[1::2] << 8)).astype(np.int32))
    idx, off = mk.bucket_prologue(canon.to(dev))
    return (idx, off, *[c.limbs.contiguous() for c in pts._coords()])


@pytest.mark.parametrize("layout", ["top", "cluster", "chunk"])
@pytest.mark.parametrize("n", [1, 17, 4097, 1 << 16])
def test_bucket_accumulate_chunked_passes(dev, n, layout):
    """The chunked passes equal the plain version bit for bit, one launch a
    pass."""
    from ark_mpc_tpu_torch.ops import msm_kernels as mk

    args = bucket_operands(n, layout, n, dev)
    if layout == "cluster":
        assert int((args[1][:, 1:] - args[1][:, :-1]).max()) == n
    before = mk.bucket_accumulate.launches
    got = mk.bucket_accumulate(*args)
    assert mk.bucket_accumulate.launches - before == mk.bucket_passes(n)
    assert same(got, mk.bucket_accumulate_plain(*args))


def test_bucket_launch_config(dev):
    """Pass 1 over every chunk of the 2^21 entries at 2^16, the last pass a
    thread a bucket, 16 resident warps per SM."""
    from ark_mpc_tpu_torch.ops import msm_kernels as mk

    cfg = mk.bucket_launch_config(1 << 16, dev)
    assert cfg["chunk"] == mk.CHUNK and cfg["passes"] == mk.bucket_passes(1 << 16)
    assert cfg["grids"][0] * cfg["threads"] >= 32 * (1 << 16) // mk.CHUNK
    assert cfg["grids"][-1] * cfg["threads"] == 32 * 256
    assert cfg["warps_per_sm"] >= 16


# ---------------------------------------------------------------------------
# windowed_mul: four lanes per point, the table in shared memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("windows", [1, 17, 64])
@pytest.mark.parametrize("n", [1, 3, 33, 1000, 4097])
def test_windowed_mul_tails_and_windows(dev, n, windows):
    """A lone quad, a part-filled warp and block, and a ragged last block,
    bit for bit, each call one launch."""
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    canon, co = curve_operands(n, 200 + n, dev)
    before = ck.windowed_mul.launches
    got = ck.windowed_mul(canon, *co, windows=windows)
    assert ck.windowed_mul.launches == before + 1
    assert same(got, ck.windowed_mul_plain(canon, *co, windows=windows))


def test_windowed_mul_edge_scalars_and_subgroup_check(dev):
    """Scalars 0, 1, l - 1, 2^253 - 1 and l, and the windowed l * P of
    subgroup points is the identity."""
    from ark_mpc_tpu_torch.algebra.curve import CurvePoint
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    _, co = curve_operands(5, 19, dev)
    ks = [0, 1, SCALAR_FIELD.modulus - 1, (1 << 253) - 1, SCALAR_FIELD.modulus]
    canon = torch.from_numpy(lb.ints_to_limb_array(ks).astype(np.int32)).to(dev)
    assert same(ck.windowed_mul(canon, *co), ck.windowed_mul_plain(canon, *co))
    pts = CurvePoint.from_coords(co, (5,))
    assert bool(ck.mul_by_order(pts).is_identity().all())


def test_windowed_mul_empty_batch_launches_nothing(dev):
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    empty = torch.zeros((16, 0), dtype=torch.int32, device=dev)
    before = ck.windowed_mul.launches
    outs = ck.windowed_mul(empty, empty, empty, empty, empty)
    assert ck.windowed_mul.launches == before
    assert all(tuple(o.shape) == (16, 0) for o in outs)


def test_windowed_launch_config(dev):
    """32 points (128 threads) a block and at least 3 resident blocks, 12
    warps, per SM."""
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    cfg = ck.windowed_launch_config(1 << 16, dev)
    assert cfg["lanes_per_point"] == 4 and cfg["threads"] == 128
    assert cfg["points_per_block"] == 32 and cfg["grid"] == 2048
    assert cfg["blocks_per_sm"] >= 3 and cfg["warps_per_sm"] >= 12
    assert ck.windowed_launch_config(33, dev)["grid"] == 2


# ---------------------------------------------------------------------------
# window_sums: a block a lane, a quad a window, tables in shared memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("windows", [1, 17, 64])
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 4097])
def test_window_sums_tails_and_windows(dev, n, windows):
    """A lone point, a part-filled tile and a ragged last lane, bit for
    bit, each call one launch."""
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    canon, co = curve_operands(n, 300 + n, dev)
    before = ck.window_sums.launches
    got = ck.window_sums(canon, *co, windows=windows)
    assert ck.window_sums.launches == before + 1
    assert all(tuple(g.shape) == (windows, 16, ck.default_lanes(n)) for g in got)
    assert same(got, ck.window_sums_plain(canon, *co, windows=windows))


def test_window_sums_launch_config(dev):
    """256 lanes (blocks) of 256 points at 2^16; at least one block of the
    tile's tables resident per SM."""
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    cfg = ck.window_sums_launch_config(1 << 16, dev)
    assert cfg["lanes"] == cfg["grid"] == 256 and cfg["lane_points"] == 256
    assert cfg["threads"] % 32 == 0 and cfg["blocks_per_sm"] >= 1
    assert cfg["smem_bytes"] > 16 * 64 * cfg["tile"]  # 2 KiB of table a point
    assert ck.window_sums_launch_config(65, dev)["grid"] == 2


@pytest.mark.parametrize("windows", [1, 5, 64])
def test_bucket_reduce_two_buckets(dev, windows):
    """The window-sum MSM's Horner: 2 buckets a window, 4-bit windows."""
    from ark_mpc_tpu_torch.ops import msm_kernels as mk

    _, co = curve_operands(2 * windows, 400 + windows, dev)
    buckets = [c.reshape(16, windows, 2) for c in co]
    before = mk.bucket_reduce.launches
    assert same(mk.bucket_reduce(*buckets, c_bits=4),
                mk.bucket_reduce_plain(*buckets, c_bits=4))
    assert mk.bucket_reduce.launches == before + 1


def reduce_buckets(W, nb, seed, dev, identity_windows=()):
    """(16, W, nb) bucket sums of random points; the windows named are all
    identity."""
    from ark_mpc_tpu_torch.algebra.curve import CurvePoint
    from ark_mpc_tpu_torch.ops import curve_kernels as ck

    rng = np.random.default_rng(seed)
    pts = CurvePoint.generator((W * nb,), device=dev).mul(Scalar.random(W * nb, rng,
                                                                        device=dev))
    buckets = [c.limbs.reshape(16, W, nb).clone() for c in pts._coords()]
    ident = ck.identity_coords(buckets[0][:, :1, 0])
    for b, i in zip(buckets, ident):
        for w in identity_windows:
            b[:, w, :] = i.to(b.dtype)
    return buckets


def reduce_matches_plain(buckets, c_bits, marks=None):
    from ark_mpc_tpu_torch.ops import msm_kernels as mk

    before = mk.bucket_reduce.launches
    got = mk.bucket_reduce(*buckets, c_bits=c_bits, marks=marks)
    torch.cuda.synchronize()
    assert mk.bucket_reduce.launches == before + 1
    return same(got, mk.bucket_reduce_plain(*buckets, c_bits=c_bits))


@pytest.mark.parametrize("c_bits", [1, 4, 8])
@pytest.mark.parametrize("nb", [1, 2, 4, 256])
@pytest.mark.parametrize("W", [1, 2, 31, 32, 64])
def test_bucket_reduce_shapes(dev, W, nb, c_bits):
    """The window kernel and the quad Horner against the plain version bit
    for bit: no Horner (W = 1), a lone bucket, a warp's worth of windows
    and either side of it, one launch a call."""
    assert reduce_matches_plain(reduce_buckets(W, nb, 1000 * W + nb, dev), c_bits)


@pytest.mark.parametrize("W,nb,c_bits", [(32, 256, 8), (64, 2, 4), (5, 4, 1)])
def test_bucket_reduce_identity_windows(dev, W, nb, c_bits):
    """Windows whose buckets are all the identity (the top one among them),
    then an input that is the identity everywhere; and the marks' two-call
    path gives the same limbs."""
    top = (W - 1,) + tuple(range(0, W, 3))
    assert reduce_matches_plain(reduce_buckets(W, nb, W + nb, dev, top), c_bits)
    everywhere = reduce_buckets(W, nb, W + nb + 1, dev, tuple(range(W)))
    assert reduce_matches_plain(everywhere, c_bits)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    assert reduce_matches_plain(reduce_buckets(W, nb, W + nb + 2, dev), c_bits, marks)
    assert marks[0].elapsed_time(marks[2]) > 0


def test_bucket_reduce_launch_config_and_limits(dev):
    from ark_mpc_tpu_torch.ops import msm_kernels as mk

    cfg = mk.reduce_launch_config(32, 256)
    assert cfg["window"] == {"grid": 32, "threads": 256, "smem_bytes": 256 * 128}
    assert cfg["horner"]["grid"] == 1 and cfg["horner"]["threads"] == 32
    assert cfg["horner"]["smem_bytes"] >= 31 * 128
    for W, nb in ((2, 3), (2, 512), (mk.MAX_REDUCE_WINDOWS + 1, 2)):
        with pytest.raises(ValueError):
            mk.bucket_reduce(*reduce_buckets(W, nb, 5, dev))


@pytest.mark.parametrize("n", [1, 1000, 1 << 16])
def test_msm_windowsum_matches_ladder_route(dev, n):
    """The winsum route (one window_sums and one bucket_reduce launch)
    equals the windowed route projectively."""
    from ark_mpc_tpu_torch.algebra.curve import CurvePoint
    from ark_mpc_tpu_torch.ops import curve_kernels as ck
    from ark_mpc_tpu_torch.ops import msm_kernels as mk

    rng = np.random.default_rng(n)
    pts = CurvePoint.generator((n,), device=dev).mul(Scalar.random(n, rng, device=dev))
    k = Scalar.random(n, rng, device=dev)
    before = mk.launch_counts()
    got = ck.msm_windowsum(pts, k)
    after = mk.launch_counts()
    assert after["window_sums"] - before["window_sums"] == 1
    assert after["bucket_reduce"] - before["bucket_reduce"] == 1
    assert bool(got.equals(pts.mul(k).sum()))


# ---------------------------------------------------------------------------
# received field elements are checked (the combine is the CUDA beaver_round)
# ---------------------------------------------------------------------------


def test_honest_product_under_the_wire_checks_on_the_card(dev):
    before = fk.beaver_round.launches
    got = execute_mock_mpc_dealer(wire_faults.product_program(), device=dev)
    assert got[0] == got[1] == wire_faults.PRODUCTS
    assert fk.beaver_round.launches - before == 2


@pytest.mark.parametrize("fault", list(wire_faults.FAULTS))
def test_malformed_received_field_elements_abort_on_the_card(dev, fault):
    with pytest.raises(AuthenticationError):
        execute_mock_mpc_dealer(wire_faults.FAULTS[fault], device=dev)


# ---------------------------------------------------------------------------
# BN254 G1 on the card (plain torch; every Fq product through mont_mul) and
# the plaintext TCP transport's native IO with card-made limbs
# ---------------------------------------------------------------------------


def test_g1_ops_on_the_card_match_the_cpu(dev):
    """double, add (with the equal, opposite and identity selects) and mul
    on the card equal the same calls on the CPU, limb for limb, and launch
    the mont_mul kernel."""
    from ark_mpc_tpu_torch.algebra.bn254 import G1, Fr

    rng = np.random.default_rng(90)
    n = 8
    k = Fr.random(n, rng, device="cpu")
    cpu_p = G1.generator((n,), device="cpu").mul(k)
    cpu_q = cpu_p.double()
    cpu_q = G1.concatenate([cpu_q[:4], cpu_p[4:6], -cpu_p[6:7], G1.identity((1,), device="cpu")])
    on = {name: G1(*(type(c)(c.limbs.to(dev)) for c in pt._coords()))
          for name, pt in (("p", cpu_p), ("q", cpu_q))}
    s = Fr.random(n, rng, device="cpu")
    before = fk.mont_mul.launches
    got = [on["p"].double(), on["p"] + on["q"], on["p"].mul(Fr(s.limbs.to(dev)))]
    assert fk.mont_mul.launches - before > 0
    want = [cpu_p.double(), cpu_p + cpu_q, cpu_p.mul(s)]
    for g, w in zip(got, want):
        for gc, wc in zip(g._coords(), w._coords()):
            assert torch.equal(gc.limbs.cpu(), wc.limbs)


def test_tcp_plaintext_exchange_of_card_limbs(dev):
    """Two threads exchange limbs made on the card over `TcpTransport(tls=
    False)`, which takes the native IO library."""
    import socket
    import threading

    from ark_mpc_tpu_torch.fabric import messages
    from ark_mpc_tpu_torch.fabric.transport import TcpTransport

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mine = [Scalar.random(1000, np.random.default_rng(p), device=dev) for p in (0, 1)]
    wire = [messages.encode_arrays([x.limbs.cpu().numpy().astype(np.uint32)]) for x in mine]
    got = {}

    def listener():
        t1 = TcpTransport(1, "127.0.0.1", port, timeout=30, tls=False)
        got[1], got["io1"] = t1.exchange(wire[1]), t1.io
        t1.close()

    th = threading.Thread(target=listener, daemon=True)
    th.start()
    t0 = TcpTransport(0, "127.0.0.1", port, timeout=30, tls=False)
    got[0] = t0.exchange(wire[0])
    th.join(timeout=30)
    t0.close()
    assert not th.is_alive() and t0.io == got["io1"] == "native"
    for p in (0, 1):
        (arr,) = messages.decode_arrays(got[p])
        theirs = torch.from_numpy(arr.astype(np.int32)).to(dev)
        assert torch.equal(theirs, mine[1 - p].limbs)
