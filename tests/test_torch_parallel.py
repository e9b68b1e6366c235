"""The port's mesh (slice F) against the JAX package, on gloo CPU ranks.

The sharded step, the mesh-attached fabric and its aborts run in a fresh
interpreter (`tests/_torch_mesh_prog.py`, torch only) that spawns N gloo
ranks, one process each.  This module makes their inputs from numpy seeds;
the JAX side runs on the same inputs on a one-device CPU mesh, where the
reference's sharded code path computes the same values as on N devices, in
a JAX-only interpreter beside it (`tests/_jax_mesh_ref.py`), so that its
~2 GiB of XLA compilations do not stay in the test worker.  Every
comparison is exact (tolerance 0): gathered limbs are equal bit for bit,
opened values equal Python ints.  N = 8 is marked slow, as the reference's
own 8-device mesh test is.
"""

import os
import pickle
import random
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mesh_prog as mesh_prog
import ark_mpc_tpu_torch as port
from ark_mpc_tpu_torch.algebra.fields import SCALAR_FIELD
from ark_mpc_tpu_torch.offline.base import ShardedSource, TrustedDealerSource
from ark_mpc_tpu_torch.parallel import Mesh, launch, make_mesh
from tests.test_multichip import _cpu_env

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = SCALAR_FIELD.modulus
PROG_TIMEOUT = 300  # seconds: a stuck collective fails the test, never hangs it


def start(cmd: list, env=None) -> subprocess.Popen:
    """`cmd` from the repo, in a session of its own."""
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO, env=env, start_new_session=True)


def finish(proc: subprocess.Popen, ok_line: str) -> str:
    """Wait for `proc`; -> its stdout, which must hold `ok_line`.  On
    timeout the whole session is killed, spawned ranks included: a stuck
    collective fails the test and leaves nothing running."""
    try:
        out, err = proc.communicate(timeout=PROG_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{proc.args} did not finish within {PROG_TIMEOUT} s:\n{err[-3000:]}")
    assert proc.returncode == 0, (err[-3000:], out[-500:])
    assert ok_line in out
    return out


STEP_N = 32  # the sharded step's batch: 4 elements a rank at N = 8
FABRIC_N = 8  # the mesh-fabric program's batch (`test_multichip.py`'s in-process size)


def make_inputs() -> dict:
    """The sharded step's limb arrays and the mesh-fabric program's values
    (`tests/_mesh_fabric_prog.py`'s program), from numpy seeds; every mesh
    size splits the same global inputs, so the JAX side runs once."""
    n = STEP_N
    rng = np.random.default_rng(700)

    def arr(shape=n):
        return port.Scalar.random(shape, rng, device="cpu").limbs.numpy()

    inp = {f"{k}_{part}": arr() for k in mesh_prog.ARRAYS for part in "sm"}
    inp.update(d=arr(), e=arr(), coeffs=arr(), t=arr(), key=arr(()))
    prng = random.Random(500)
    inp["xs"] = [prng.randrange(1, L) for _ in range(FABRIC_N)]
    inp["ys"] = [prng.randrange(1, L) for _ in range(FABRIC_N)]
    return inp


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """-> (the inputs, their file, the JAX side's process, started on them
    so that it runs beside the first mesh)."""
    tmp = tmp_path_factory.mktemp("mesh")
    inp = make_inputs()
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    jax_side = start([sys.executable, os.path.join(REPO, "tests", "_jax_mesh_ref.py"),
                      str(tmp / "in.pkl"), str(tmp / "ref.pkl")], env=_cpu_env())
    yield inp, tmp / "in.pkl", jax_side
    if jax_side.poll() is None:
        os.killpg(jax_side.pid, signal.SIGKILL)
        jax_side.communicate()


@pytest.fixture(scope="module", params=[
    2, 4, pytest.param(8, marks=pytest.mark.slow)], ids=lambda n: f"{n}ranks")
def mesh_run(request, inputs, tmp_path_factory):
    """-> (N, inputs, [rank r's {case: ("ok", result) | ("error", tb)}],
    the JAX package's results on the same inputs)."""
    n_ranks = request.param
    inp, in_path, jax_side = inputs
    out_path = tmp_path_factory.mktemp(f"mesh{n_ranks}") / "out.pkl"
    finish(start([sys.executable, os.path.join(REPO, "tests", "_torch_mesh_prog.py"),
                  str(n_ranks), str(in_path), str(out_path)]),
           f"MESH_PROG_OK {n_ranks}")
    if jax_side.returncode is None:
        finish(jax_side, "JAX_MESH_REF_OK")
    assert jax_side.returncode == 0
    with open(out_path, "rb") as fh:
        ranks = pickle.load(fh)
    with open(in_path.parent / "ref.pkl", "rb") as fh:
        jax_ref = pickle.load(fh)
    assert len(ranks) == n_ranks
    return n_ranks, inp, ranks, jax_ref


def case(ranks, name) -> list:
    """Every rank's result of one case (a failed case shows its traceback)."""
    out = []
    for rank, res in enumerate(ranks):
        status, value = res[name]
        assert status == "ok", f"rank {rank}, case {name}:\n{value}"
        out.append(value)
    return out


def test_sharded_step_matches_reference(mesh_run):
    """Gathered z and the fold equal JAX's `sharded_mul_mac_step` on a
    one-device mesh and its unsharded `beaver_mul_step` + `mac_check_fold`,
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
    the JAX fabric's on a one-device mesh (each rank drew its slice of the
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


def test_batch_axis_reductions_refuse_on_a_mesh(mesh_run):
    """No reduction over the batch axis returns a rank's partial: each one
    the mesh fabric lacks raises `NotImplementedError` naming the mesh."""
    _, _, ranks, _ = mesh_run
    for res in case(ranks, "refusals"):
        assert len(res) == 8
        for name, msg in res.items():
            assert msg.startswith("NotImplementedError") and "mesh" in msg, (name, msg)


def test_sharded_source_slices_the_global_draws():
    """Rank r of N keeps columns r n : (r + 1) n of the global draw of n N,
    with the same MAC key share on every rank."""
    n, size = 3, 4
    whole = TrustedDealerSource(1, seed=9, device="cpu")
    want = whole.next_triplet_batch(n * size) + (whole.next_shared_value_batch(n * size),)
    for rank in range(size):
        mesh = Mesh(None, size, rank, torch.device("cpu"))
        src = ShardedSource(TrustedDealerSource(1, seed=9, device="cpu"), mesh)
        got = src.next_triplet_batch(n) + (src.next_shared_value_batch(n),)
        assert torch.equal(src.get_mac_key_share().limbs, whole.get_mac_key_share().limbs)
        for g, w in zip(got, want):
            cols = slice(rank * n, (rank + 1) * n)
            assert torch.equal(g.share.limbs, w.share.limbs[:, cols])
            assert torch.equal(g.mac.limbs, w.mac.limbs[:, cols])
    with pytest.raises(NotImplementedError, match="mesh"):
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
