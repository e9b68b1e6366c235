"""The port's mesh (slices F and G) against the JAX package, on gloo CPU ranks.

The sharded step, the mesh-attached fabric, the operations slice G gave it
(sums, inner products, traced sums, shared matmul, shared polynomials, the
curve-point protocols and MSM) and its aborts run in a fresh interpreter
(`tests/_torch_mesh_prog.py`, torch only) that spawns N gloo ranks, one
process each.  This module makes their inputs from numpy seeds; the JAX
side runs on the same inputs on a 4-device virtual CPU mesh
(`jax_num_cpu_devices` = 4) in a JAX-only interpreter
(`tests/_jax_mesh_ref.py`), so that its XLA compilations do not stay in
the test worker.  No shape of the programs depends on the mesh size, so
the JAX package's gathered record is the same on every mesh (a slow test
holds its 2-device record to its 4-device one): it runs once, started
before either torch mesh and beside them, and every torch mesh is held to
it.  It runs with XLA's CPU backend at optimization level 0, which
compiles faster and computes the same integers (the slow test compares
with the default level too).  Every comparison is exact (tolerance 0):
gathered limbs are equal bit for bit, opened values equal Python ints.  The point
protocols are held to the port's unsharded fabric on the same inputs
(`tests/test_torch_points.py` holds that to the JAX package): bit for bit
element-wise, projectively for sums; the JAX mesh's point program (minutes
of XLA compilation; projectively, as the two packages' curve formulas
leave different coordinates) and G1 at Fr are slow tests.  N = 8 is
marked slow, as the reference's own 8-device mesh test is.
"""

import os
import pickle
import random
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_mesh_prog as mesh_prog
import ark_mpc_tpu_torch as port
from ark_mpc_tpu_torch.algebra.fields import SCALAR_FIELD
from ark_mpc_tpu_torch.fabric.simulator import execute_mock_mpc_dealer
from ark_mpc_tpu_torch.offline.base import ShardedSource, TrustedDealerSource
from ark_mpc_tpu_torch.parallel import Mesh, launch, make_mesh
from tests.test_multichip import _cpu_env

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = SCALAR_FIELD.modulus
# seconds: a stuck collective fails the test, never hangs it.  The JAX side
# (~180 s alone from an empty compile cache) runs beside the two torch
# meshes (~40 s each, one after the other), so with every subprocess timing
# out the mesh tests end within JAX_TIMEOUT of the module's start.
PROG_TIMEOUT = 200
JAX_TIMEOUT = 500
JAX_DEVICES = 4
FAST_XLA = "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true"


def start(cmd: list, env=None) -> subprocess.Popen:
    """`cmd` from the repo, in a session of its own."""
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO, env=env, start_new_session=True)


def finish(proc: subprocess.Popen, ok_line: str, timeout: float = PROG_TIMEOUT) -> str:
    """Wait for `proc`; -> its stdout, which must hold `ok_line`.  On
    timeout the whole session is killed, spawned ranks included: a stuck
    collective fails the test and leaves nothing running."""
    try:
        out, err = proc.communicate(timeout=max(timeout, 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{proc.args} did not finish within its {timeout:.0f} s:\n{err[-3000:]}")
    assert proc.returncode == 0, (err[-3000:], out[-500:])
    assert ok_line in out
    return out


STEP_N = 32  # the sharded step's batch: 4 elements a rank at N = 8
FABRIC_N = 8  # the mesh-fabric program's batch (`test_multichip.py`'s in-process size)


def make_inputs() -> dict:
    """The sharded step's limb arrays, the mesh-fabric program's values
    (`tests/_mesh_fabric_prog.py`'s program) and the scalar operations' and
    point protocols' values (`_torch_mesh_prog.op_inputs`), from numpy
    seeds; every mesh size splits the same global inputs."""
    n = STEP_N
    rng = np.random.default_rng(700)

    def arr(shape=n):
        return port.Scalar.random(shape, rng, device="cpu").limbs.numpy()

    inp = {f"{k}_{part}": arr() for k in mesh_prog.ARRAYS for part in "sm"}
    inp.update(d=arr(), e=arr(), coeffs=arr(), t=arr(), key=arr(()))
    prng = random.Random(500)
    inp["xs"] = [prng.randrange(1, L) for _ in range(FABRIC_N)]
    inp["ys"] = [prng.randrange(1, L) for _ in range(FABRIC_N)]
    inp.update(mesh_prog.op_inputs(rng, FABRIC_N))
    return inp


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """-> (the inputs, their file)."""
    tmp = tmp_path_factory.mktemp("mesh")
    inp = make_inputs()
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    return inp, tmp / "in.pkl"


def jax_mesh(n_ranks: int, in_path, out_path, *extra, fast: bool = True) -> subprocess.Popen:
    """The JAX package's side on an n-device CPU mesh, started (with
    `fast`, at XLA optimization level 0)."""
    env = _cpu_env()
    if fast:
        env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} {FAST_XLA}".strip()
    return start([sys.executable, os.path.join(REPO, "tests", "_jax_mesh_ref.py"),
                  str(n_ranks), str(in_path), str(out_path), *extra], env=env)


def torch_mesh(n_ranks: int, in_path, out_path) -> subprocess.Popen:
    return start([sys.executable, os.path.join(REPO, "tests", "_torch_mesh_prog.py"),
                  str(n_ranks), str(in_path), str(out_path)])


def load(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


class Side:
    """One subprocess whose record the tests share: `result()` waits for
    it (within `timeout` of its start) and keeps the record."""

    def __init__(self, proc: subprocess.Popen, out_path, ok_line: str, timeout: float):
        self.proc, self.out_path, self.ok_line = proc, out_path, ok_line
        self.started, self.timeout = time.monotonic(), timeout
        self.record = None

    def result(self):
        if self.record is None:
            left = self.timeout - (time.monotonic() - self.started)
            finish(self.proc, self.ok_line, timeout=left)
            self.record = load(self.out_path)
        return self.record

    def stop(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()


class Sides:
    """The module's subprocesses: the JAX side on a JAX_DEVICES-device
    mesh, started with the module, and one torch mesh a size, each started
    when asked for or when the size before it has finished."""

    def __init__(self, in_path, tmp):
        self.in_path, self.tmp = in_path, tmp
        self.jax = Side(jax_mesh(JAX_DEVICES, in_path, tmp / "ref.pkl"), tmp / "ref.pkl",
                        f"JAX_MESH_REF_OK {JAX_DEVICES}", JAX_TIMEOUT)
        self.torch = {}

    def torch_side(self, n_ranks: int) -> Side:
        if n_ranks not in self.torch:
            out = self.tmp / f"out{n_ranks}.pkl"
            self.torch[n_ranks] = Side(torch_mesh(n_ranks, self.in_path, out), out,
                                       f"MESH_PROG_OK {n_ranks}", PROG_TIMEOUT)
        return self.torch[n_ranks]

    def stop(self) -> None:
        for side in (self.jax, *self.torch.values()):
            side.stop()


@pytest.fixture(scope="module")
def sides(inputs, tmp_path_factory):
    sides = Sides(inputs[1], tmp_path_factory.mktemp("mesh"))
    yield sides
    sides.stop()


@pytest.fixture(scope="module", params=[
    2, 4, pytest.param(8, marks=pytest.mark.slow)], ids=lambda n: f"{n}ranks")
def mesh_run(request, inputs, sides):
    """-> (N, inputs, [rank r's {case: ("ok", result) | ("error", tb)}],
    the JAX package's results on the same inputs).  The torch side runs in
    a fresh interpreter while the JAX side computes, and the next mesh size
    starts as soon as this one is done; a side that fails or hangs is
    killed with its session."""
    n_ranks = request.param
    ranks = sides.torch_side(n_ranks).result()
    if n_ranks == 2:
        sides.torch_side(4)  # runs beside the rest of the JAX side
    record = sides.jax.result()
    assert len(ranks) == n_ranks
    return n_ranks, inputs[0], ranks, record


def case(ranks, name) -> list:
    """Every rank's result of one case (a failed case shows its traceback)."""
    out = []
    for rank, res in enumerate(ranks):
        status, value = res[name]
        assert status == "ok", f"rank {rank}, case {name}:\n{value}"
        out.append(value)
    return out


def test_sharded_step_matches_reference(mesh_run):
    """Gathered z and the fold equal JAX's `sharded_mul_mac_step` on an
    N-device mesh and its unsharded `beaver_mul_step` + `mac_check_fold`,
    for both parties, on every rank."""
    _, _, ranks, jax_ref = mesh_run
    for pid in (0, 1):
        want = jax_ref["step"][pid]
        for got in case(ranks, "step"):
            for g, w, u in zip(got[pid], want["sharded"], want["unsharded"]):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, u)


def test_sharded_rlc_fold_matches_reference(mesh_run):
    _, _, ranks, jax_ref = mesh_run
    want, want_plain = jax_ref["step"]["rlc"]
    np.testing.assert_array_equal(want, want_plain)
    for got in case(ranks, "step"):
        np.testing.assert_array_equal(got["rlc"], want)


def test_mesh_fabric_program_matches_reference(mesh_run):
    """Share -> Beaver mul -> masked-open inverse -> folded deferred check:
    the opens equal Python ints, and the product's gathered shares equal
    the JAX fabric's on an N-device mesh (each rank drew its slice of the
    same dealer stream)."""
    _, inp, ranks, jax_ref = mesh_run
    xs, ys = inp["xs"], inp["ys"]
    want_ref = jax_ref["fabric"]
    for parties in case(ranks, "fabric"):
        for pid in (0, 1):
            o1, o2, share, mac = parties[pid]
            assert o1 == [(a * b) % L for a, b in zip(xs, ys)]
            assert o2 == xs
            r1, r2, r_share, r_mac = want_ref[pid]
            assert (o1, o2) == (r1, r2)
            np.testing.assert_array_equal(share, r_share)
            np.testing.assert_array_equal(mac, r_mac)


def test_corrupted_mac_aborts_every_rank(mesh_run):
    _, _, ranks, _ = mesh_run
    assert case(ranks, "corrupt") == [("abort", "abort")] * len(ranks)


def test_one_cheating_rank_pair_aborts_every_rank(mesh_run):
    """Party 1 of the last rank alone corrupts its MACs under an unfolded
    check, so only that rank pair's zero test fails: the agreement over the
    party's ranks makes every rank of both parties raise, and nothing hangs
    (the subprocess is time-bounded)."""
    _, _, ranks, _ = mesh_run
    assert case(ranks, "cheat_one_rank_pair") == [("abort", "abort")] * len(ranks)


def test_each_rank_pair_draws_its_own_public_coin(mesh_run):
    """Both parties of a rank pair hold the same coin, and no two rank pairs
    do: equal coefficients on two ranks would let errors cancel across
    ranks in the folded check."""
    n_ranks, _, ranks, _ = mesh_run
    coins = case(ranks, "coins")
    assert all(c0 == c1 for c0, c1 in coins)
    assert len({c0 for c0, _ in coins}) == n_ranks


def test_unaligned_batch_raises_naming_the_mesh(mesh_run):
    _, _, ranks, _ = mesh_run
    for msg in case(ranks, "unaligned"):
        assert msg.startswith("ValueError") and "mesh" in msg, msg


def test_verify_deferred_folds_by_default_on_a_mesh(mesh_run):
    """Rounds of `verify_deferred()` (public coin 3 + check 3) and of
    `verify_deferred(fold=False)` (check 3)."""
    _, _, ranks, _ = mesh_run
    assert case(ranks, "fold_default") == [([6, 3], [6, 3])] * len(ranks)


def test_verify_deferred_does_not_fold_without_a_mesh():
    def prog(fabric):
        rounds = []
        for fold in (None, True):
            sx = fabric.share_values(port.Scalar.from_ints([3, 4], device="cpu")
                                     if fabric.party_id == 0 else None, sender=0, n=2)
            fabric.open_authenticated(sx, defer=True)
            before = fabric.n_rounds
            fabric.verify_deferred(fold=fold)
            rounds.append(fabric.n_rounds - before)
        return rounds

    assert port.execute_mock_mpc_dealer(prog, device="cpu") == ([3, 6], [3, 6])


def test_batch_rule_on_a_mesh(mesh_run):
    """Every global batch given to a mesh fabric is a multiple of the mesh
    size: one element a rank works; any other size, a single value, or an
    offline draw of another size raises `ValueError` naming the mesh."""
    n_ranks, _, ranks, _ = mesh_run
    want = [v * v % L for v in range(2, 2 + n_ranks)]
    for res in case(ranks, "batch_rule"):
        assert res["aligned"] == (want, want)
        for key in ("odd_sizes", "single_value", "passthrough"):
            assert res[key].startswith("ValueError") and "mesh" in res[key], res[key]


def test_prefix_product_still_refuses_on_a_mesh(mesh_run):
    """The one operation the mesh fabric refuses, eager and traced: it
    draws n + 1 inverse pairs, and the reference raises there too."""
    _, _, ranks, _ = mesh_run
    for res in case(ranks, "prefix_product_refuses"):
        assert len(res) == 2
        for msg in res:
            assert msg.startswith("NotImplementedError") and "mesh" in msg, msg
            assert "ark_mpc_tpu/gadgets/products.py:52" in msg, msg


OPS = ("sum", "sum_times_open", "sum_plus_open", "inner_product", "traced_sum",
       "shared_matmul", "poly_eval", "poly_mul", "poly_inverse_mod_t", "poly_div")


@pytest.mark.parametrize("op", OPS)
def test_scalar_op_matches_the_jax_mesh(mesh_run, op):
    """The opened value and the gathered share and MAC limbs of each party,
    on every rank, equal the JAX package's on its mesh (the traced sum
    brings the traced circuit's other output and its opens along).  Where
    a batch is added to a one-element share, the reference keeps party 1's
    share 0-d and the port broadcasts it to the batch: the limbs equal the
    reference's broadcast."""
    _, _, ranks, jax_ref = mesh_run
    names = (op, "traced_w") if op == "traced_sum" else (op,)
    for parties in case(ranks, "ops"):
        for pid in (0, 1):
            got, want = parties[pid], jax_ref["ops"][pid]
            for name in names:
                (v, sh, mac), (wv, wsh, wmac) = got[name], want[name]
                assert v == wv, name
                if name == "sum_plus_open" and pid == 1:
                    assert wsh.shape == (16,) and sh.shape == mac.shape
                    wsh = np.broadcast_to(wsh[:, None], sh.shape)
                np.testing.assert_array_equal(sh, wsh)
                np.testing.assert_array_equal(mac, wmac)
            if op == "traced_sum":
                assert got["traced_opens"] == want["traced_opens"]


def poly_mul_ints(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] += x * y
    return [v % L for v in out]


def test_scalar_ops_equal_python_ints(mesh_run):
    n_ranks, inp, ranks, _ = mesh_run
    xs, ys, f = inp["xs"], inp["ys"], inp["poly_f"]
    prod = [x * y % L for x, y in zip(xs, ys)]
    m, k, n = mesh_prog.MAT_DIMS
    a, b = inp["mat_a"][:m * k], inp["mat_b"][:k * n]
    want = {
        "sum": [sum(xs) % L], "inner_product": [sum(prod) % L],
        "sum_times_open": [sum(xs) * x % L for x in xs],
        "sum_plus_open": [(sum(xs) + x) % L for x in xs],
        "traced_sum": [sum(prod) % L],
        "traced_w": [(x * p + sum(prod)) % L for x, p in zip(xs, prod)],
        "shared_matmul": [sum(a[i * k + j] * b[j * n + c] for j in range(k)) % L
                          for i in range(m) for c in range(n)],
        "poly_eval": [sum(c * pow(inp["x_eval"], i, L) for i, c in enumerate(f)) % L],
        "poly_mul": poly_mul_ints(f, inp["poly_g"]),
        "share_public_of_open": [x % L for x in xs], "pow_zero": [1] * len(xs),
    }
    t = mesh_prog.POLY_T
    for parties in case(ranks, "ops"):
        for got in parties:
            for name, w in want.items():
                assert got[name][0] == w, name
            assert got["traced_opens"] == [want["traced_sum"], prod, want["traced_w"]]
            inv = got["poly_inverse_mod_t"][0]
            assert poly_mul_ints(f, inv)[:t] == [1] + [0] * (t - 1)
            q, h = got["poly_div"][0], inp["poly_h"]
            rem = [(u - v) % L for u, v in zip(f, poly_mul_ints(q, h) + [0] * len(f))]
            assert len(q) == len(f) - len(h) + 1 and not any(rem[len(h) - 1:])


def test_traced_levels_that_mix_placements(mesh_run):
    """A level whose muls and inversions mix a product of two sums with
    shards takes one fused call per placement: the opens equal Python ints
    on every rank."""
    _, inp, ranks, _ = mesh_run
    xs, ys = inp["xs"], inp["ys"]
    sums = sum(xs) * sum(ys) % L
    want = [[x * y % L for x, y in zip(xs, ys)], [sums], [pow(sums, -1, L)],
            [pow(x, -1, L) for x in xs]]
    assert case(ranks, "traced_mixed_levels") == [(want, want)] * len(ranks)


@pytest.fixture(scope="module")
def unsharded_points(inputs):
    """The point protocols' program on the port's unsharded fabric."""
    inp, _ = inputs
    return execute_mock_mpc_dealer(mesh_prog.points_program(inp), device="cpu")


def points_of(arr) -> port.CurvePoint:
    return port.CurvePoint(*(port.BaseFelt(torch.from_numpy(c.astype(np.int32)))
                             for c in arr))


ELEMENTWISE = ("share_points", "mul_generator", "mul_public_point", "beaver_mul_points")
SUMS = ("msm_authenticated", "msm_public_points")
PORT_ONLY = ("share_public_points",)  # not in the JAX mesh's record


def test_point_protocols_match_the_unsharded_fabric(mesh_run, unsharded_points):
    """Gathered over the party's ranks, the element-wise protocols' shares
    and MACs (and those of the opened shared batch, shared again as public
    points) equal the unsharded fabric's bit for bit, the two MSMs' sums
    equal them projectively, and every opened point is the same; on every
    rank, for both parties."""
    _, inp, ranks, _ = mesh_run
    for parties in case(ranks, "points"):
        for pid in (0, 1):
            got, want = parties[pid], unsharded_points[pid]
            assert sorted(got) == sorted(ELEMENTWISE + SUMS + PORT_ONLY)
            for name in ELEMENTWISE + SUMS + PORT_ONLY:
                (opened, sh, mac), (w_opened, w_sh, w_mac) = got[name], want[name]
                assert opened == w_opened, name
                if name not in SUMS:
                    np.testing.assert_array_equal(sh, w_sh)
                    np.testing.assert_array_equal(mac, w_mac)
                else:
                    for g, w in ((sh, w_sh), (mac, w_mac)):
                        assert g.shape == w.shape == (4, 16, 1), name
                        assert bool(points_of(g).equals(points_of(w)).all()), name


def test_one_cheating_rank_pair_aborts_every_rank_on_points(mesh_run):
    """Party 1 of the last rank alone corrupts its point MACs: every rank of
    both parties raises `AuthenticationError`, and nothing hangs."""
    _, _, ranks, _ = mesh_run
    assert case(ranks, "point_cheat_one_rank_pair") == [("abort", "abort")] * len(ranks)


def test_mixing_a_shard_with_a_replicated_batch_raises(mesh_run):
    """Every element-wise way a shard can meet a replicated batch of two
    elements raises `ValueError` naming the mesh, a replicated share of two
    elements operated on with a shard's opened value does too (the
    reference raises on the shapes), and a concatenation of the two does
    too; `gather` returns a replicated value once."""
    n_ranks, _, ranks, _ = mesh_run
    n = 2 * n_ranks
    for res in case(ranks, "mixing"):
        assert res.pop("gathered_sum") == [n * (n + 1) // 2]
        assert res.pop("gathered_coeffs") == [1, 2]
        assert len(res) == 8
        for name, msg in res.items():
            assert msg.startswith("ValueError") and f"{n_ranks}-rank mesh" in msg, (name, msg)


@pytest.mark.slow
def test_jax_record_does_not_depend_on_the_mesh_or_the_xla_level(inputs, sides, tmp_path):
    """The JAX side's record on a 2-device mesh at XLA's default
    optimization level equals the module's (4 devices, level 0) exactly:
    what lets one JAX run hold every torch mesh."""
    _, in_path = inputs
    finish(jax_mesh(2, in_path, tmp_path / "ref2.pkl", fast=False), "JAX_MESH_REF_OK 2",
           timeout=900)
    assert pickle.dumps(load(tmp_path / "ref2.pkl")) == pickle.dumps(sides.jax.result())


@pytest.mark.slow
def test_point_protocols_match_the_jax_mesh(inputs, tmp_path):
    """The point protocols on a 2-rank port mesh against the JAX package's
    on a 2-device mesh: opened points equal, and every share and MAC equal
    projectively (the two packages' curve formulas leave different
    projective coordinates, unsharded too; minutes of XLA compilation on
    the JAX side)."""
    inp, in_path = inputs
    jax_side = jax_mesh(2, in_path, tmp_path / "ref.pkl", "points")
    try:
        finish(torch_mesh(2, in_path, tmp_path / "out.pkl"), "MESH_PROG_OK 2")
        out, err = jax_side.communicate(timeout=900)
        assert jax_side.returncode == 0 and "JAX_MESH_REF_OK 2" in out, err[-3000:]
    finally:
        if jax_side.poll() is None:
            os.killpg(jax_side.pid, signal.SIGKILL)
            jax_side.communicate()
    want = load(tmp_path / "ref.pkl")["points"]
    for parties in case(load(tmp_path / "out.pkl"), "points"):
        for pid in (0, 1):
            for name in ELEMENTWISE + SUMS:
                (opened, sh, mac), (w_opened, w_sh, w_mac) = parties[pid][name], want[pid][name]
                assert opened == w_opened, name
                for g, w in ((sh, w_sh), (mac, w_mac)):
                    assert g.shape == w.shape, name
                    assert bool(points_of(g).equals(points_of(w)).all()), name


@pytest.mark.slow
def test_g1_point_protocols_on_a_mesh_match_the_unsharded_fabric():
    """G1 shares at Fr go through the same mesh code: on 2 gloo ranks the
    Beaver product's gathered shares equal the unsharded fabric's bit for
    bit and the MSM's projectively, and the opened points are equal (a few
    minutes: G1 arithmetic is plain torch)."""
    gs, ks = [3, 5, 7, 11], [1, 2, 3, 4]
    want = mesh_prog.run_g1(gs, ks)
    for parties in launch(mesh_prog.g1_rank, 2, gs, ks, device="cpu", timeout=900):
        for got, w in zip(parties, want):
            (o, sh, mac), (wo, wsh, wmac) = got["beaver_mul_points"], w["beaver_mul_points"]
            assert o == wo
            np.testing.assert_array_equal(sh, wsh)
            np.testing.assert_array_equal(mac, wmac)
            (o, sh, mac), (wo, wsh, wmac) = got["msm_authenticated"], w["msm_authenticated"]
            assert o == wo
            for g, x in ((sh, wsh), (mac, wmac)):
                pg, px = (port.G1(*(port.Fq(torch.from_numpy(c.astype(np.int32))) for c in a))
                          for a in (g, x))
                assert bool(pg.equals(px).all())


def test_sharded_source_slices_the_global_draws():
    """Rank r of N keeps columns r n : (r + 1) n of the global draw of n N,
    with the same MAC key share on every rank; a matrix triple keeps the
    rank's rows of P and C and the whole Q, and a polynomial triple is
    whole, both marked replicated where whole.  A matrix triple whose rows
    do not divide the mesh raises `ValueError` naming it."""
    n, size, (m, k, c) = 3, 4, (8, 3, 2)
    whole = TrustedDealerSource(1, seed=9, device="cpu")
    want = whole.next_triplet_batch(n * size) + (whole.next_shared_value_batch(n * size),)
    want_mat = whole.next_matrix_triplet(m, k, c)
    want_poly = whole.next_poly_triplet(2, 3)
    for rank in range(size):
        mesh = Mesh(None, size, rank, torch.device("cpu"))
        src = ShardedSource(TrustedDealerSource(1, seed=9, device="cpu"), mesh)
        got = src.next_triplet_batch(n) + (src.next_shared_value_batch(n),)
        assert torch.equal(src.get_mac_key_share().limbs, whole.get_mac_key_share().limbs)
        for g, w in zip(got, want):
            cols = slice(rank * n, (rank + 1) * n)
            assert not g.replicated
            assert torch.equal(g.share.limbs, w.share.limbs[:, cols])
            assert torch.equal(g.mac.limbs, w.mac.limbs[:, cols])
        rows = slice(rank * m // size, (rank + 1) * m // size)
        (p, q, pq), (wp, wq, wpq) = src.next_matrix_triplet(m, k, c), want_mat
        assert (p.replicated, q.replicated, pq.replicated) == (False, True, False)
        for g, w in ((p, wp[rows]), (q, wq), (pq, wpq[rows])):
            assert torch.equal(g.share.limbs, w.share.limbs)
            assert torch.equal(g.mac.limbs, w.mac.limbs)
        for g, w in zip(src.next_poly_triplet(2, 3), want_poly):
            assert g.replicated
            assert torch.equal(g.share.limbs, w.share.limbs)
            assert torch.equal(g.mac.limbs, w.mac.limbs)
    with pytest.raises(ValueError, match="4-rank mesh"):
        src.next_matrix_triplet(2, 2, 2)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")


def test_launch_reports_a_failing_rank():
    """A rank that raises while another waits in a collective: the launch
    raises with its traceback and stops every rank."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(mesh_prog.raise_on_rank_one, 2, device="cpu", timeout=120)


def test_dryrun_two_ranks():
    """`python -m ark_mpc_tpu_torch.parallel --dryrun 2`: the sharded step,
    the traced mesh program and the sharded ct x pt on two gloo ranks."""
    out = finish(start([sys.executable, "-m", "ark_mpc_tpu_torch.parallel", "--dryrun", "2"]),
                 "dryrun_multichip OK: 2 ranks (gloo)")
    assert "offline ct*pt stack sharded over 2 ranks OK" in out
