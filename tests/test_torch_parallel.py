"""The port's mesh against the JAX package, on gloo CPU ranks.

The sharded step, the mesh-attached fabric, the operations slice G gave it
(sums, inner products, traced sums, shared matmul, shared polynomials, the
curve-point protocols and MSM), the global view and its aborts run in a
fresh interpreter (`tests/_torch_mesh_prog.py`, torch only) that spawns N
gloo ranks, one process each.  This module makes their inputs from numpy
seeds; the JAX side runs on the same inputs on a 4-device virtual CPU mesh
(`jax_num_cpu_devices` = 4) in JAX-only interpreters
(`tests/_jax_mesh_ref.py`, one a mode of `JAX_MODES`, all started with the
module beside both torch meshes), so that their XLA compilations do not
stay in the test worker.  No shape of the programs depends on the mesh
size, so the JAX package's gathered record is the same on every mesh (a
slow test holds its records on another mesh size to these): it runs once
and every torch mesh is held to it.  It runs with XLA's CPU backend at
optimization level 0, which compiles faster and computes the same integers
(the slow test compares with the default level too).  Every comparison is
exact (tolerance 0): gathered limbs are equal bit for bit, opened values
equal Python ints.  The point protocols are held to the port's unsharded
fabric on the same inputs (`tests/test_torch_points.py` holds that to the
JAX package): bit for bit element-wise, projectively for sums; the JAX
mesh's point program (minutes of XLA compilation; projectively, as the two
packages' curve formulas leave different coordinates) and G1 at Fr are
slow tests.  N = 8 is marked slow, as the reference's own 8-device mesh
test is.  Batches smaller than the mesh (1 and 3 elements, and
`prefix_product` at n + 1 <= the mesh size) are held replicated, as the
reference holds them: their draws are whole, so the JAX package's 4-device
record holds them on every mesh where they are smaller than it.  The
global view (indexing and reshaping a shard select global positions, with
every index type the reference takes; a selection whose size the mesh
neither exceeds nor divides is held replicated; `shared_matmul` at every
shape the reference takes), `prefix_product` of such selections, and
traced levels that mix placements (one fused call a level, in the
reference's column order) are held to the JAX record; the point
selections and point levels to the port's unsharded fabric.  Each JAX
process writes its record after each program, so one cut short fails only
the tests of the keys it did not write (`JaxSide`).  A complete JAX record
is kept under `tests/.jax_cache` for the next run on the same inputs and
sources (`Memo`).
"""

import hashlib
import os
import pathlib
import pickle
import random
import signal
import subprocess
import sys
import tempfile
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
# seconds: a stuck collective fails the test, never hangs it.  The JAX
# side's five processes (`JAX_MODES`, ~85-130 s each alone from an empty
# compile cache, 8-core host) and the two torch meshes (~100 s each alone)
# all start with the module.  A torch side is one launch a group of cases
# (`mesh_prog.GROUPS`, at most ~40 s of work each alone), each within its
# own `mesh_prog.LAUNCH_TIMEOUT` and all within `mesh_prog.SIDE_TIMEOUT`; a
# launch that fails or times out (or finds the side's time spent) records
# its message as each of its cases' error, which names each rank's case, so
# it fails only those tests.  The side's own limit adds the interpreter's
# start and the record's writing.  Six copies of the module at once, each
# from an empty cache, took JAX processes of up to 1,109 s; the limit
# leaves a fifth more.  A JAX process never waits for another, so one
# that uses no CPU time for `JAX_STALL` seconds (blocked for good) is
# stopped then, without waiting out its limit.
PROG_TIMEOUT = mesh_prog.SIDE_TIMEOUT + 40
JAX_TIMEOUT = 1350
JAX_STALL = 120
JAX_DEVICES = 4
FAST_XLA = "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true"


def start(cmd: list, env=None) -> subprocess.Popen:
    """`cmd` from the repo, in a session of its own, its output to
    temporary files: a pipe that nobody reads while the process runs
    fills (a JAX process logs a line for each compilation it loads from
    the shared cache) and stops it."""
    logs = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
    proc = subprocess.Popen(cmd, stdout=logs[0], stderr=logs[1], text=True, cwd=REPO,
                            env=env, start_new_session=True)
    proc.logs = logs
    return proc


def output(proc: subprocess.Popen) -> tuple:
    """-> (stdout, stderr) of a process `start` made, so far."""
    texts = []
    for fh in proc.logs:
        fh.seek(0)
        texts.append(fh.read())
    return tuple(texts)


def stop(proc: subprocess.Popen) -> None:
    """Kill `proc`'s whole session (spawned ranks included) and reap it."""
    os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def cpu_seconds(pid: int):
    """The CPU time process `pid` has used so far (every thread), or None
    where `/proc` does not say."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
    except OSError:
        return None
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def wait(proc: subprocess.Popen, timeout: float, stall: float = 0):
    """Wait for `proc` at most `timeout` seconds and, with `stall`, only
    while it uses CPU time within every `stall` seconds; -> None once it
    has ended, else why it has not."""
    end = time.monotonic() + max(timeout, 1)
    used, since = None, time.monotonic()
    while True:
        try:
            proc.wait(timeout=max(min(end - time.monotonic(), stall / 4 or timeout), 0.01))
            return None
        except subprocess.TimeoutExpired:
            now = time.monotonic()
        if now >= end:
            return f"did not finish within its {timeout:.0f} s"
        cpu = cpu_seconds(proc.pid) if stall else None
        if cpu is None or cpu != used:
            used, since = cpu, now
        elif now - since >= stall:
            return f"used no CPU time for {now - since:.0f} s (stalled; its limit {timeout:.0f} s)"


def finish(proc: subprocess.Popen, ok_line: str, timeout: float = PROG_TIMEOUT,
           stall: float = 0) -> str:
    """Wait for `proc` (`wait`); -> its stdout, which must hold `ok_line`.
    On timeout (or stall) the whole session is killed, spawned ranks
    included: a stuck collective fails the test and leaves nothing
    running."""
    why = wait(proc, timeout, stall)
    if why:
        stop(proc)
        pytest.fail(f"{proc.args} {why}:\n{output(proc)[1][-3000:]}")
    out, err = output(proc)
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
    # the small-batch programs' values (batches of 1 and 3)
    inp["small_xs"] = [prng.randrange(1, L) for _ in range(3)]
    inp["small_ys"] = [prng.randrange(1, L) for _ in range(3)]
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
    it (within `timeout` of its start, and with `stall` as `wait` says)
    and keeps the record; or a record kept from an earlier run (`record`,
    no subprocess)."""

    def __init__(self, proc, out_path=None, ok_line="", timeout: float = 0, record=None,
                 stall: float = 0):
        self.proc, self.out_path, self.ok_line = proc, out_path, ok_line
        self.started, self.timeout, self.stall = time.monotonic(), timeout, stall
        self.record = record

    def result(self):
        if self.record is None:
            left = self.timeout - (time.monotonic() - self.started)
            finish(self.proc, self.ok_line, timeout=left, stall=self.stall)
            self.record = load(self.out_path)
        return self.record

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            stop(self.proc)


class JaxSide(Side):
    """A JAX process (`_jax_mesh_ref.py`), which writes its record again
    after each program: `key(k)` is that program's record once the process
    has ended, whether it finished or not, so a process cut short (its
    limit, a crash) fails only the tests of the keys it did not write.
    `complete` says whether it finished."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.failure, self.complete = None, self.record is not None

    def key(self, k):
        if self.record is None and self.failure is None:
            try:
                self.result()
                self.complete = True
            except (AssertionError, pytest.fail.Exception) as err:
                self.failure = err
                self.record = load(self.out_path) if os.path.exists(self.out_path) else {}
        if k not in self.record:
            pytest.fail(f"the JAX record has no {k!r}: {self.failure}")
        return self.record[k]


# the JAX side's processes by mode (`_jax_mesh_ref.py`), each with the keys
# of the record it writes, in order, apart so that no process's
# compilations lengthen another's (each shares few with the others and
# holds at most ~220): the step, the mesh fabric and the shared
# polynomials; the other scalar operations; the global view's programs
# (every index type); the small-batch programs; and, on a 2-device mesh,
# the uneven prefix products and the traced levels that mix placements
JAX_MODES = {"main": ("step", "fabric", "poly"), "ops": ("ops",), "view": ("view",),
             "small": ("small",), "uneven": ("prefix", "mixed")}


class Memo:
    """A JAX side's record kept from an earlier run under
    `tests/.jax_cache` (where the XLA compilations are kept), keyed by the
    inputs, the JAX package's and `_jax_mesh_ref.py`'s sources, the mode,
    the mesh size, the XLA flags and the jax version: the record is a
    function of these alone, so a run that finds it reads it instead of
    recomputing it.  A run from an empty cache computes every record."""

    DIR = os.path.join(REPO, "tests", ".jax_cache", "mesh_records")

    def __init__(self, in_path, mode: str):
        import jax

        h = hashlib.sha256()
        with open(in_path, "rb") as fh:
            h.update(fh.read())
        sources = sorted(pathlib.Path(REPO, "ark_mpc_tpu").rglob("*.py"))
        for path in [*sources, pathlib.Path(REPO, "tests", "_jax_mesh_ref.py")]:
            h.update(str(path.relative_to(REPO)).encode() + path.read_bytes())
        h.update(f"{mode} {JAX_DEVICES} {FAST_XLA} {jax.__version__}".encode())
        self.path = os.path.join(self.DIR, f"{mode}-{h.hexdigest()[:32]}.pkl")

    def load(self):
        try:
            return load(self.path)
        except (OSError, EOFError, pickle.UnpicklingError):
            return None

    def save(self, record) -> None:
        os.makedirs(self.DIR, exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(record, fh)
        os.replace(tmp, self.path)


class Record:
    """The JAX package's record, read key by key: a key waits only for the
    JAX process that writes it, and a process that failed or was cut
    short fails only the tests of the keys it did not write (`JaxSide`).
    A complete record is kept for the next run (`Memo`)."""

    def __init__(self, sides, modes=None):
        self.sides, self.modes = sides, JAX_MODES if modes is None else modes

    def __getitem__(self, key):
        mode = next(m for m, keys in self.modes.items() if key in keys)
        side = self.sides.jax[mode]
        kept = side.complete
        value = side.key(key)
        if side.complete and not kept:
            self.sides.memos[mode].save(side.record)
        return value


class Sides:
    """The module's subprocesses: the JAX side on a JAX_DEVICES-device mesh
    (one process a mode of `JAX_MODES`) and the torch meshes of the fast
    tests (2 and 4 ranks), all started with the module, and any other torch
    mesh when asked for."""

    def __init__(self, in_path, tmp):
        self.in_path, self.tmp = in_path, tmp
        ok = f"JAX_MESH_REF_OK {JAX_DEVICES}"
        self.jax, self.memos = {}, {}
        for mode in JAX_MODES:
            self.memos[mode] = memo = Memo(in_path, mode)
            kept = memo.load()
            if kept is not None:
                self.jax[mode] = JaxSide(None, record=kept)
                continue
            out = tmp / f"ref_{mode}.pkl"
            self.jax[mode] = JaxSide(jax_mesh(JAX_DEVICES, in_path, out, mode), out, ok,
                                     JAX_TIMEOUT, stall=JAX_STALL)
        self.torch = {}
        for n_ranks in (2, 4):
            self.torch_side(n_ranks)

    def torch_side(self, n_ranks: int) -> Side:
        if n_ranks not in self.torch:
            out = self.tmp / f"out{n_ranks}.pkl"
            self.torch[n_ranks] = Side(torch_mesh(n_ranks, self.in_path, out), out,
                                       f"MESH_PROG_OK {n_ranks}", PROG_TIMEOUT)
        return self.torch[n_ranks]

    def stop(self) -> None:
        for side in (*self.jax.values(), *self.torch.values()):
            side.stop()


@pytest.fixture(scope="module")
def sides(inputs, tmp_path_factory):
    sides = Sides(inputs[1], tmp_path_factory.mktemp("mesh"))
    yield sides
    sides.stop()


@pytest.fixture(scope="module", params=[
    2, 4, pytest.param(8, marks=pytest.mark.slow)], ids=lambda n: f"{n}ranks")
def mesh_run(request, inputs, unsharded_points, sides):
    """-> (N, inputs, [rank r's {case: ("ok", result) | ("error", tb)}],
    the JAX package's results on the same inputs).  Each torch side runs
    in a fresh interpreter beside the JAX side; a side that fails or hangs
    is killed with its session.  (`unsharded_points`, ~1 CPU-minute in
    this worker, is computed before the subprocesses start: beside them,
    six copies of the module at once starved it past the simulator's
    limit.)"""
    n_ranks = request.param
    ranks = sides.torch_side(n_ranks).result()
    assert len(ranks) == n_ranks
    return n_ranks, inputs[0], ranks, Record(sides)


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
    """Sharing a batch of 9 (larger than the mesh, no multiple of its size)
    raises `ValueError` naming the mesh, as the JAX package's mesh of the
    same size does."""
    n_ranks, _, ranks, jax_ref = mesh_run
    want = jax_ref["prefix"]["refused"][(min(n_ranks, JAX_DEVICES), "share 9")]
    assert want.startswith("ValueError") and "mesh" in want, want
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
    """A global batch given to a mesh fabric that is at least as large as
    the mesh is a multiple of its size: one element a rank works; a larger
    batch of another size, or an offline draw of one, raises `ValueError`
    naming the mesh.  A single value is held replicated, as the reference
    holds it: its opened value and both parties' share and MAC limbs equal
    the JAX package's."""
    n_ranks, _, ranks, jax_ref = mesh_run
    want = [v * v % L for v in range(2, 2 + n_ranks)]
    single = jax_ref["small"]["single_value"]
    assert [opened for opened, _, _ in single] == [[5], [5]]
    for res in case(ranks, "batch_rule"):
        assert res["aligned"] == (want, want)
        for key in ("odd_sizes", "passthrough"):
            assert res[key].startswith("ValueError") and "mesh" in res[key], res[key]
        for got, w in zip(res["single_value"], single):
            assert got[0] == w[0]
            np.testing.assert_array_equal(got[1], w[1])
            np.testing.assert_array_equal(got[2], w[2])


def test_prefix_product_still_refuses_on_a_mesh(mesh_run):
    """prefix_product of a shard of 2 elements a rank, eager and traced,
    raises `ValueError` naming the mesh where its 2 size + 1 inverse pairs
    are drawn, as the JAX package's mesh refuses the 9 pairs of its
    8-element shard (the reference's `_place`)."""
    n_ranks, _, ranks, jax_ref = mesh_run
    want = jax_ref["prefix"]["refused"][(JAX_DEVICES, 8)]
    assert want.startswith("ValueError") and "batch of 9 elements" in want, want
    for res in case(ranks, "prefix_product_refuses"):
        assert len(res) == 2
        for msg in res:
            assert msg.startswith("ValueError") and f"{n_ranks}-rank mesh" in msg, msg
            assert f"a batch of {2 * n_ranks + 1} elements" in msg, msg


def refuses(size: int, n: int) -> bool:
    """Whether a mesh of `size` refuses a draw of n (the reference's
    `_place`: at least the mesh size and no multiple of it)."""
    return n >= size and n % size != 0


def prefix_want(xs: list, n: int) -> list:
    out = [xs[0]]
    for v in xs[1:n]:
        out.append(out[-1] * v % L)
    return out


@pytest.mark.parametrize("n", mesh_prog.PREFIX_SELECTIONS)
def test_prefix_product_of_a_selection_matches_the_jax_mesh(mesh_run, n):
    """prefix_product of x[:n] for an 8-element shared batch x, eager and
    traced: where the mesh takes its n + 1 inverse pairs (n + 1 below the
    mesh size or a multiple of it), the opens equal Python ints and the JAX
    package's, and both parties' share and MAC limbs and the traced
    circuit's rounds equal the JAX package's bit for bit (x[:7] on 4
    ranks: [2, 6, 30, ...] for [2, 3, 5, ...]); elsewhere both packages
    raise `ValueError` naming the mesh."""
    n_ranks, inp, ranks, jax_ref = mesh_run
    rec = jax_ref["prefix"]
    if refuses(n_ranks, n + 1):
        want = rec["refused"][(n_ranks, n)]
        assert want.startswith("ValueError") and f"batch of {n + 1} elements" in want, want
        for res in case(ranks, "prefix_selections"):
            got = res[n]
            assert got.startswith("ValueError") and f"{n_ranks}-rank mesh" in got, got
            assert f"a batch of {n + 1} elements" in got, got
        return
    want = prefix_want(inp["xs"], n)
    for res in case(ranks, "prefix_selections"):
        for pid in (0, 1):
            got, ref = res[n][pid], rec["records"][n][pid]
            for name in ("eager", "traced"):
                assert got[name][0] == want, (n, name)
                assert_same_record(got[name], ref[name], (n, name))
            assert got["traced_rounds"] == ref["traced_rounds"]


SMALL_OPS = ("share", "mul", "sum", "inner_product")


def assert_same_record(got, want, name):
    (v, sh, mac), (wv, wsh, wmac) = got, want
    assert v == wv, name
    np.testing.assert_array_equal(sh, wsh)
    np.testing.assert_array_equal(mac, wmac)


@pytest.mark.parametrize("op", SMALL_OPS + ("share_points",))
def test_one_element_batch_matches_the_jax_mesh(mesh_run, op):
    """A batch of one element is held replicated on every mesh (nothing to
    shard, as the reference's `_place` leaves it): the opened value and
    both parties' share and MAC limbs equal the JAX package's on its
    4-device mesh, on every rank and every mesh size (a replicated draw
    does not depend on the mesh size).  The one-point batch's opened point
    is the same and its share and MAC are equal projectively (the two
    packages' curve formulas leave different projective coordinates)."""
    _, inp, ranks, jax_ref = mesh_run
    x, y = inp["small_xs"][0], inp["small_ys"][0]
    want_ints = {"share": [x], "mul": [x * y % L], "sum": [x], "inner_product": [x * y % L]}
    for parties in case(ranks, "small_one"):
        for pid in (0, 1):
            got, want = parties[pid][op], jax_ref["small"]["one"][pid][op]
            if op != "share_points":
                assert got[0] == want_ints[op]
                assert_same_record(got, want, op)
                continue
            (opened, sh, mac), (w_opened, w_sh, w_mac) = got, want
            assert opened == w_opened
            for g, w in ((sh, w_sh), (mac, w_mac)):
                assert g.shape == w.shape == (4, 16, 1)
                assert bool(points_of(g).equals(points_of(w)).all())


def test_three_element_batch_on_a_mesh(mesh_run):
    """A batch of 3: on a mesh of more than 3 ranks it is replicated and
    every result (share, mul, sum, inner product) equals the JAX package's
    on its 4-device mesh bit for bit; on 2 ranks it is larger than the
    mesh and does not divide it, and both packages raise `ValueError`
    naming the mesh."""
    n_ranks, inp, ranks, jax_ref = mesh_run
    small = jax_ref["small"]
    if n_ranks < 4:
        assert small["three_on_2"].startswith("ValueError"), small["three_on_2"]
        assert "2-device mesh" in small["three_on_2"], small["three_on_2"]
        for msg in case(ranks, "small_three"):
            assert msg.startswith("ValueError") and f"{n_ranks}-rank mesh" in msg, msg
        return
    xs, ys = inp["small_xs"], inp["small_ys"]
    prod = [a * b % L for a, b in zip(xs, ys)]
    want_ints = {"share": xs, "mul": prod, "sum": [sum(xs) % L],
                 "inner_product": [sum(prod) % L]}
    for parties in case(ranks, "small_three"):
        for pid in (0, 1):
            assert sorted(parties[pid]) == sorted(SMALL_OPS)
            for op in SMALL_OPS:
                assert parties[pid][op][0] == want_ints[op], op
                assert_same_record(parties[pid][op], small["three"][pid][op], op)


def test_prefix_product_on_a_batch_smaller_than_the_mesh(mesh_run):
    """prefix_product runs on a mesh where its n + 1 inverse pairs fit it,
    eager and traced: on 2 ranks at n = 1 the opens equal Python ints; on
    4 ranks at n = 2 and n = 3 the opens, both parties' share and MAC limbs
    and the traced circuit's rounds equal the JAX package's on its
    4-device mesh."""
    n_ranks, inp, ranks, jax_ref = mesh_run
    xs = inp["small_xs"]
    sizes = mesh_prog.prefix_sizes(n_ranks)
    assert sizes == ((1,) if n_ranks == 2 else (2, 3))
    for res in case(ranks, "prefix_small"):
        assert sorted(res) == list(sizes)
        for n in sizes:
            want = [xs[0]]
            for v in xs[1:n]:
                want.append(want[-1] * v % L)
            for pid in (0, 1):
                got = res[n][pid]
                for name in ("eager", "traced"):
                    assert got[name][0] == want, (n, name)
                    if n_ranks > 2:
                        assert_same_record(got[name], jax_ref["small"]["prefix"][n][pid][name],
                                           (n, name))
                if n_ranks > 2:
                    assert got["traced_rounds"] == \
                        jax_ref["small"]["prefix"][n][pid]["traced_rounds"]


POLY_OPS = ("poly_eval", "poly_mul", "poly_inverse_mod_t", "poly_div")
OPS = ("sum", "sum_times_open", "sum_plus_open", "inner_product", "traced_sum",
       "shared_matmul") + POLY_OPS + ("pow",)


def ops_records(res: dict) -> list:
    """Both parties' records of the ops case's two programs, merged."""
    return [{k: v for part in mesh_prog.OPS_PARTS for k, v in res[part][pid].items()}
            for pid in (0, 1)]


@pytest.mark.parametrize("op", OPS)
def test_scalar_op_matches_the_jax_mesh(mesh_run, op):
    """The opened value and the gathered share and MAC limbs of each party,
    on every rank, equal the JAX package's on its mesh (the traced sum
    brings the traced circuit's other output and its opens along; x^7
    pairs two products in one call, drawn in the reference's column
    order).  Where a batch is added to a one-element share, the reference
    keeps party 1's share 0-d and the port broadcasts it to the batch: the
    limbs equal the reference's broadcast."""
    _, _, ranks, jax_ref = mesh_run
    names = (op, "traced_w") if op == "traced_sum" else (op,)
    for res in case(ranks, "ops"):
        parties = ops_records(res)
        for pid in (0, 1):
            got, want = parties[pid], jax_ref["poly" if op in POLY_OPS else "ops"][pid]
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
        "pow": [pow(x, 7, L) for x in xs],
    }
    t = mesh_prog.POLY_T
    for res in case(ranks, "ops"):
        for got in ops_records(res):
            for name, w in want.items():
                assert got[name][0] == w, name
            assert got["traced_opens"] == [want["traced_sum"], prod, want["traced_w"]]
            inv = got["poly_inverse_mod_t"][0]
            assert poly_mul_ints(f, inv)[:t] == [1] + [0] * (t - 1)
            q, h = got["poly_div"][0], inp["poly_h"]
            rem = [(u - v) % L for u, v in zip(f, poly_mul_ints(q, h) + [0] * len(f))]
            assert len(q) == len(f) - len(h) + 1 and not any(rem[len(h) - 1:])


def test_traced_levels_that_mix_placements(mesh_run):
    """A traced circuit whose first level's muls mix a product of two sums
    (replicated) with a sharded product and whose second level's
    inversions mix four inverses of the sums with the product's: each level is
    one fused call in the reference's column order, so the opens equal
    Python ints and the JAX package's, both parties' share and MAC limbs
    equal the JAX package's bit for bit, and the circuit takes the JAX
    package's rounds, on every rank."""
    _, inp, ranks, jax_ref = mesh_run
    xs, ys = inp["xs"], inp["ys"]
    prod = [x * y % L for x, y in zip(xs, ys)]
    sums = sum(xs) * sum(ys) % L
    want = {"prod": prod, "sums": [sums], "x_inverse": [pow(x, -1, L) for x in xs],
            "prod_inverse": [pow(p, -1, L) for p in prod],
            **{f"(sums + {k})_inverse" if k else "sums_inverse": [pow(sums + k, -1, L)]
               for k in (0,) + mesh_prog.MIXED_SHIFTS}}
    ref = jax_ref["mixed"]
    for parties in case(ranks, "traced_mixed_levels"):
        for pid in (0, 1):
            (got, rounds), (w_rec, w_rounds) = parties[pid], ref[pid]
            assert rounds == w_rounds
            assert sorted(got) == sorted(want)
            for name, ints in want.items():
                assert got[name][0] == ints, name
                assert_same_record(got[name], w_rec[name], name)


@pytest.fixture(scope="module")
def unsharded_points(inputs):
    """The point protocols' program and the index program on the port's
    unsharded fabric."""
    inp, _ = inputs
    out = {part: execute_mock_mpc_dealer(mesh_prog.points_program(inp, part), device="cpu")
           for part in mesh_prog.POINT_PARTS}
    out["index"] = execute_mock_mpc_dealer(mesh_prog.index_program(inp), device="cpu")
    out["index_types"] = execute_mock_mpc_dealer(mesh_prog.index_types_program(inp), device="cpu")
    out["mixed_points"] = execute_mock_mpc_dealer(mesh_prog.mixed_points_program(inp),
                                                  device="cpu")
    return out


def point_records(source) -> list:
    """Both parties' records of the point program's halves, merged:
    `source(part)` -> the half's (party 0, party 1)."""
    halves = [source(part) for part in mesh_prog.POINT_PARTS]
    return [{k: v for half in halves for k, v in half[pid].items()} for pid in (0, 1)]


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
    plain = point_records(unsharded_points.__getitem__)
    for rank in range(len(ranks)):
        parties = point_records(lambda part: case(ranks, f"points_{part}")[rank])
        for pid in (0, 1):
            got, want = parties[pid], plain[pid]
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


INDEX_NAMES = tuple(name for name, _ in mesh_prog.SELECTIONS)


def selected(values: list) -> dict:
    """`mesh_prog.SELECTIONS` of a Python list: {name: ints, row-major}."""
    arr = np.asarray(values, dtype=object)
    return {name: np.ravel(sel(arr)).tolist() for name, sel in mesh_prog.SELECTIONS}


def test_indexing_a_shard_reads_the_global_batch(mesh_run):
    """[10, 20, 30, 40] shared on the mesh: x[0] opens to [10] and x[1:3]
    to [20, 30] on every rank, as the JAX package's mesh gives them (slicing
    the rank's own columns gave 10 on rank 0 and 30 on rank 1, and [20, 40],
    on 2 ranks)."""
    _, _, ranks, _ = mesh_run
    assert case(ranks, "index_values") == [([[10], [20, 30]],) * 2] * len(ranks)


def test_indexing_a_shard_selects_global_positions(mesh_run):
    """x[0], x[-1], x[1:3], x[::2] and x.reshape(2, -1) of a shared
    8-element batch and of its opened value select the global batch's
    positions (the reshape is the global (2, 4)): the opens equal Python
    ints and the JAX package's on its 4-device mesh, and both parties'
    gathered share and MAC limbs equal the JAX package's bit for bit, on
    every rank."""
    _, inp, ranks, jax_ref = mesh_run
    want = selected(inp["xs"])
    for parties in case(ranks, "index"):
        for pid in (0, 1):
            got, ref = parties[pid], jax_ref["view"]["index"][pid]
            assert got["open"] == ref["open"] == want
            assert sorted(got["share"]) == sorted(INDEX_NAMES)
            for name in INDEX_NAMES:
                assert got["share"][name][0] == want[name], name
                assert_same_record(got["share"][name], ref["share"][name], name)


def test_indexing_a_point_shard_selects_global_positions(mesh_run, unsharded_points):
    """The same selections of a shared 8-point batch: the opened points are
    the selected g_i * G, and the gathered share and MAC coordinates equal
    the same program's on the port's unsharded fabric bit for bit, on
    every rank, for both parties (the slow
    `test_point_protocols_match_the_jax_mesh` holds them to the JAX
    package's mesh projectively)."""
    _, inp, ranks, _ = mesh_run
    gen = port.CurvePoint.generator((len(inp["gs"]),), device="cpu")
    x, y = (selected(c.to_ints()) for c in
            gen.mul(port.Scalar.from_ints(inp["gs"], device="cpu")).to_affine())
    for parties in case(ranks, "index"):
        for pid in (0, 1):
            got = parties[pid]["points"]
            plain = unsharded_points["index"][pid]["points"]
            assert sorted(got) == sorted(INDEX_NAMES)
            for name in INDEX_NAMES:
                opened, sh, mac = got[name]
                assert opened == [x[name], y[name]] == plain[name][0], name
                np.testing.assert_array_equal(sh, plain[name][1])
                np.testing.assert_array_equal(mac, plain[name][2])


def held_replicated(n_ranks: int, rows: int) -> bool:
    """The small-batch rule for a selection of a shard: a shard where its
    rows are at least the mesh size and a multiple of it, else held
    replicated."""
    return rows < n_ranks or rows % n_ranks != 0


# each of `mesh_prog.INDEX_TYPES`' leading-axis size (1: a single element)
INDEX_TYPE_ROWS = {"[0, 2, 5]": 3, "np.array([1, 6])": 2, "torch.tensor([7, 0])": 2, "mask": 4,
                   ":7": 7, "(4, 2)[1, 0]": 1, "(4, 2)[:, 1]": 4, "(4, 2)[[0, 3]]": 2}


def test_index_placement_follows_the_small_batch_rule(mesh_run):
    """A selection with fewer elements (or a reshape with fewer rows) than
    the mesh is replicated (a single element always), one whose size the
    mesh size divides is a shard, and one of any other size (3 or 7 of 8
    elements) is held replicated, alike for shares, point shares and
    opened values and for every index type; a float index raises
    `TypeError`, as it does in the JAX package."""
    n_ranks, _, ranks, jax_ref = mesh_run
    sizes = {"0": 1, "-1": 1, "1:3": 2, "::2": 4, "reshape(2, -1)": 2, **INDEX_TYPE_ROWS}
    want_refused = jax_ref["view"]["index_types"][0]["refused"]
    assert sorted(want_refused) == ["open", "share"]
    for name in ("index", "index_types"):
        for parties in case(ranks, name):
            for pid in (0, 1):
                for sel, marks in parties[pid]["placement"].items():
                    assert marks == (held_replicated(n_ranks, sizes[sel]),) * 3, (sel, marks)
                if name == "index_types":
                    refused = parties[pid]["refused"]
                    assert sorted(refused) == ["open", "points", "share"]
                    for kind, msg in refused.items():
                        assert msg.startswith("TypeError"), (kind, msg)
                        assert want_refused.get(kind, msg).startswith("TypeError")


INDEX_TYPE_NAMES = tuple(name for name, _ in mesh_prog.INDEX_TYPES)


def selected_types(values: list) -> dict:
    """`mesh_prog.INDEX_TYPES` of a Python list: {name: ints, row-major}."""
    arr = np.asarray(values, dtype=object)
    return {name: np.ravel(sel(arr)).tolist() for name, sel in mesh_prog.INDEX_TYPES}


@pytest.mark.parametrize("name", INDEX_TYPE_NAMES)
def test_index_type_matches_the_jax_mesh(mesh_run, unsharded_points, name):
    """Each index type the reference takes (a list, numpy and torch
    integer arrays, a boolean mask, x[:7] whose 7 elements the mesh size
    neither exceeds nor divides, and tuples of the global (4, 2) reshape)
    of an 8-element shared batch and of its opened value: the opens equal
    Python ints, and both parties' gathered share and MAC limbs equal the
    JAX package's selection on its 4-device mesh bit for bit; of an 8-point
    shared batch: the opened points are the selected g_i
    * G and the gathered share and MAC coordinates equal the unsharded
    fabric's bit for bit; on every rank."""
    _, inp, ranks, jax_ref = mesh_run
    want = selected_types(inp["xs"])[name]
    gen = port.CurvePoint.generator((len(inp["gs"]),), device="cpu")
    x, y = (selected_types(c.to_ints())[name] for c in
            gen.mul(port.Scalar.from_ints(inp["gs"], device="cpu")).to_affine())
    for parties in case(ranks, "index_types"):
        for pid in (0, 1):
            got, ref = parties[pid], jax_ref["view"]["index_types"][pid]["types"][name]
            plain = unsharded_points["index_types"][pid]["points"][name]
            assert got["open"][name] == got["share"][name][0] == want
            assert_same_record(got["share"][name], (want, *ref), name)
            opened, sh, mac = got["points"][name]
            assert opened == [x, y] == plain[0]
            np.testing.assert_array_equal(sh, plain[1])
            np.testing.assert_array_equal(mac, plain[2])


MATMUL_IDS = [f"{m}x{k}@{k}x{n}" for m, k, n in mesh_prog.MATMUL_SHAPES]


@pytest.mark.parametrize("shape", mesh_prog.MATMUL_SHAPES, ids=MATMUL_IDS)
def test_shared_matmul_at_the_reference_shapes(mesh_run, shape):
    """shared_matmul with operands below the mesh size (replicated) and
    shards holding part of a row: the opened product equals Python ints
    and the JAX package's on its 4-device mesh, and both parties' gathered
    share and MAC limbs equal the JAX package's bit for bit, on every rank;
    the product is replicated where it has fewer rows than the mesh, else
    row-sharded.  (1, 3) @ (3, 1) on 2 ranks: both packages refuse the
    3-element operand with `ValueError` naming the mesh."""
    n_ranks, inp, ranks, jax_ref = mesh_run
    view = jax_ref["view"]
    m, k, n = shape
    if shape not in mesh_prog.matmul_shapes(n_ranks):
        msg = view["matmul_131_on_2"]
        assert msg.startswith("ValueError") and "2-device mesh" in msg, msg
        for res in case(ranks, "matmul_shapes"):
            got = res["refused"]
            assert got.startswith("ValueError") and f"{n_ranks}-rank mesh" in got, got
        return
    a, b = inp["mat_a"][:m * k], inp["mat_b"][:k * n]
    want = [sum(a[i * k + j] * b[j * n + c] for j in range(k)) % L
            for i in range(m) for c in range(n)]
    for res in case(ranks, "matmul_shapes"):
        for pid in (0, 1):
            opened, sh, mac, rep = res[shape][pid]
            assert opened == want
            assert_same_record((opened, sh, mac), view["matmul"][shape][pid], shape)
            assert sh.shape == (16, m, n)
            assert rep == (m < n_ranks)


def test_traced_point_level_that_mixes_placements(mesh_run, unsharded_points):
    """A traced level whose point products mix each shared point times its
    scalar (a shard) with the points' sum times the scalars' sum
    (replicated) is one fused Beaver point product: the opened points and
    the circuit's rounds equal the unsharded fabric's, the products' share
    and MAC coordinates equal them bit for bit and the sums' projectively
    (the mesh adds the ranks' partial sums in rank order), on every rank,
    for both parties."""
    _, _, ranks, _ = mesh_run
    for parties in case(ranks, "traced_mixed_points"):
        for pid in (0, 1):
            (got, rounds), (want, w_rounds) = parties[pid], unsharded_points["mixed_points"][pid]
            assert rounds == w_rounds
            for name in ("products", "sums"):
                (opened, sh, mac), (w_opened, w_sh, w_mac) = got[name], want[name]
                assert opened == w_opened, name
                for g, w in ((sh, w_sh), (mac, w_mac)):
                    assert g.shape == w.shape, name
                    if name == "products":
                        np.testing.assert_array_equal(g, w)
                    else:
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
    """The JAX side's records on another mesh size at XLA's default
    optimization level equal the module's (level 0) exactly: what lets
    one JAX run hold every torch mesh.  main's and ops' on a 2-device mesh
    (the module's run on 4); the uneven programs on 4 devices (the
    module's run on 2): the mixed levels' record whole, and the
    prefix products and refusals of a 4-device mesh (x[:3] and x[:7]; x[:5]
    and x[:8] refused).  (view and small hold programs that a 2-device
    mesh refuses; the mesh tests hold them at 2 and 4 ranks.)"""
    _, in_path = inputs
    runs = {"main": (2,), "ops": (2,), "uneven": (JAX_DEVICES, str(JAX_DEVICES))}
    procs = {mode: jax_mesh(n, in_path, tmp_path / f"{mode}.pkl", mode, *at, fast=False)
             for mode, (n, *at) in runs.items()}
    try:
        for mode, (n, *_) in runs.items():
            finish(procs[mode], f"JAX_MESH_REF_OK {n}", timeout=900)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                stop(proc)
    for mode in ("main", "ops"):
        got, want = load(tmp_path / f"{mode}.pkl"), sides.jax[mode].result()
        assert pickle.dumps({k: got[k] for k in JAX_MODES[mode]}) == \
            pickle.dumps({k: want[k] for k in JAX_MODES[mode]}), mode
    got, want = load(tmp_path / "uneven.pkl"), sides.jax["uneven"].result()
    assert pickle.dumps(got["mixed"]) == pickle.dumps(want["mixed"])
    got, want = got["prefix"], want["prefix"]
    assert sorted(got["records"]) == [3, 7]
    assert set(got["refused"]) == {(JAX_DEVICES, 5), (JAX_DEVICES, 8), (JAX_DEVICES, "share 9")}
    for part in ("records", "refused"):
        for key, rec in got[part].items():
            assert pickle.dumps(rec) == pickle.dumps(want[part][key]), (part, key)


@pytest.mark.slow
def test_point_protocols_match_the_jax_mesh(inputs, tmp_path):
    """The point protocols, and the index program's selections of a shared
    point batch, on a 2-rank port mesh against the JAX package's on a
    2-device mesh: opened points equal, and every share and MAC equal
    projectively (the two packages' curve formulas leave different
    projective coordinates, unsharded too; minutes of XLA compilation on
    the JAX side)."""
    inp, in_path = inputs
    jax_side = jax_mesh(2, in_path, tmp_path / "ref.pkl", "points")
    try:
        finish(torch_mesh(2, in_path, tmp_path / "out.pkl"), "MESH_PROG_OK 2")
        finish(jax_side, "JAX_MESH_REF_OK 2", timeout=900)
    finally:
        if jax_side.poll() is None:
            stop(jax_side)
    record, ranks = load(tmp_path / "ref.pkl"), load(tmp_path / "out.pkl")
    want = point_records(record["points"].__getitem__)
    pairs = [(point_records(lambda part: case(ranks, f"points_{part}")[rank]), want,
              ELEMENTWISE + SUMS) for rank in range(len(ranks))]
    pairs += [({pid: got[pid]["points"] for pid in (0, 1)},
               {pid: record["index"][pid]["points"] for pid in (0, 1)}, INDEX_NAMES)
              for got in case(ranks, "index")]
    for parties, want, names in pairs:
        for pid in (0, 1):
            for name in names:
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
    whole, both marked replicated where whole.  A matrix triple with fewer
    rows than the mesh is whole and replicated (the dealer's, as the
    reference keeps it); one with more rows that do not divide the mesh
    raises `ValueError` naming it."""
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
    small = src.next_matrix_triplet(2, 2, 2)
    want_small = whole.next_matrix_triplet(2, 2, 2)
    for g, w in zip(small, want_small):
        assert g.replicated
        assert torch.equal(g.share.limbs, w.share.limbs)
        assert torch.equal(g.mac.limbs, w.mac.limbs)
    with pytest.raises(ValueError, match="4-rank mesh"):
        src.next_matrix_triplet(6, 2, 2)


def batches() -> list:
    """An 8-element value of each type the global view covers."""
    x = port.Scalar.from_ints(list(range(10, 90, 10)), device="cpu")
    pts = port.CurvePoint.generator((8,), device="cpu").mul(x)
    return [x, port.ScalarShare(x, x + 1), pts, port.PointShare(pts, pts.double())]


def limb_tensors(v) -> list:
    parts = [v.share, v.mac] if hasattr(v, "mac") else [v]
    return [c.limbs for p in parts for c in (p._coords() if hasattr(p, "_coords") else [p])]


def same(a, b) -> bool:
    la, lb = limb_tensors(a), limb_tensors(b)
    return len(la) == len(lb) and all(u.shape == w.shape and torch.equal(u, w)
                                      for u, w in zip(la, lb))


def test_local_accessor_off_a_mesh():
    """Off a mesh `x.local[idx]` is `x[idx]` for every index (integers,
    slices, tuples, index tensors), and `x.local.reshape` is `reshape`, for
    field arrays, shares, point batches and point shares."""
    from ark_mpc_tpu_torch.algebra.placement import thread_mesh

    assert thread_mesh() is None
    idxs = [0, -1, slice(1, 3), slice(None, None, 2), (slice(None),), torch.tensor([0, 5])]
    for x in batches():
        for idx in idxs:
            assert same(x.local[idx], x[idx]), (type(x).__name__, idx)
        for shape in ((2, 4), (2, -1), ((4, 2),)):
            assert same(x.local.reshape(*shape), x.reshape(*shape)), (type(x).__name__, shape)
        assert same(x.reshape(2, 4).local[1], x.local[4:])


def test_global_view_of_a_shard_without_a_collective():
    """On a 2-rank mesh (a thread mesh with no process group, so any
    collective would raise): `local[...]` and `local.reshape` take the
    rank's own elements, a reshape whose rows the mesh divides is the
    rank's rows of the global shape (its -1 the global batch's), a
    replicated value indexes as it is, a float index of a shard raises
    `TypeError` and a reshape to a shape the global batch does not take
    `ValueError` naming the mesh, before any collective."""
    from ark_mpc_tpu_torch.algebra.placement import mark, set_thread_mesh

    set_thread_mesh(Mesh(None, 2, 0, torch.device("cpu")))
    try:
        for whole in batches():
            rep = whole.local[0:8]
            if isinstance(rep, (port.ScalarShare, port.PointShare)):
                rep.replicated = True
            else:
                mark(rep)
            assert same(rep[1:3], whole.local[1:3])
            x = whole.local[0:4]
            if isinstance(x, (port.ScalarShare, port.PointShare)):
                x.replicated = False
            else:
                mark(x, False)
            assert same(x.local[1:3], whole.local[1:3])
            rows = x.reshape(4, 2)  # the global (4, 2): the rank's 2 rows, no collective
            assert rows.shape == (2, 2) and rows.replicated is False
            assert same(rows, x.local.reshape(2, 2))
            half = x.reshape(2, -1)  # the global (2, 4), not the rank's (2, 2)
            assert half.shape == (1, 4) and half.replicated is False
            assert same(half, x.local.reshape(1, 4))
            assert same(x.local.reshape(4, 1), whole.local[0:4].local.reshape(4, 1))
            for idx in (1.5, np.array([0.5]), (slice(None), 1.5), torch.tensor([0.0])):
                with pytest.raises(TypeError, match="integer or boolean"):
                    x[idx]
            for shape in ((4, 1), (3, -1)):
                with pytest.raises(ValueError, match="2-rank mesh"):
                    x.reshape(*shape)
    finally:
        set_thread_mesh(None)


# how the stub process ends, its limit, its stall time and the message
STUB_ENDS = {"cut": ("time.sleep(60)", 5, 0, "did not finish within its 5 s"),
             "crash": ("raise SystemExit(1)", 5, 0, "returncode: 1"),
             "stall": ("time.sleep(60)", 60, 2, r"used no CPU time for \d+ s \(stalled")}


@pytest.mark.parametrize("end", sorted(STUB_ENDS))
def test_a_cut_jax_process_fails_only_the_keys_it_did_not_write(tmp_path, end):
    """A JAX process that writes its record after its first program and is
    then cut at its limit, crashes, or blocks (stopped once it has used no
    CPU time for its stall time, long before its limit): the first key's
    record reads as written, a later key fails its own test with the
    process's message, and nothing is kept for the next run (a stub
    process in the place of `_jax_mesh_ref.py`)."""
    out = tmp_path / "ref.pkl"
    body, timeout, stall, why = STUB_ENDS[end]
    stub = ("import pickle, time\n"
            f"pickle.dump({{'first': 1}}, open({str(out)!r}, 'wb'))\n"
            "print('JAX_MESH_REF_KEY first', flush=True)\n" + body)
    side = JaxSide(start([sys.executable, "-c", stub]), out, "JAX_MESH_REF_OK", timeout=timeout,
                   stall=stall)
    saved = []
    memo = type("Memo", (), {"save": lambda self, record: saved.append(record)})()
    sides = type("Sides", (), {"jax": {"stub": side}, "memos": {"stub": memo}})()
    record = Record(sides, {"stub": ("first", "second")})
    t0 = time.monotonic()
    try:
        assert record["first"] == 1
        with pytest.raises(pytest.fail.Exception, match=f"(?s)no 'second': .*{why}"):
            record["second"]
        assert not side.complete and not saved
        assert time.monotonic() - t0 < 30
    finally:
        side.stop()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")


def test_launch_reports_a_failing_rank():
    """A rank that raises while another waits in a collective: the launch
    raises with its traceback and each rank's last note, and stops every
    rank."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose") as err:
        launch(mesh_prog.raise_on_rank_one, 2, device="cpu", timeout=120)
    assert "rank 1: case 'raise_on_rank_one' on rank 1 (" in str(err.value)


def test_launch_names_each_ranks_note_on_timeout():
    """Ranks that do not finish: `TimeoutError` names the mesh and, one
    line a rank, its last note (or that it made none yet), and every rank
    is stopped."""
    with pytest.raises(TimeoutError) as err:
        launch(mesh_prog.stall, 2, device="cpu", timeout=6)
    msg = str(err.value)
    assert "the 2-rank mesh did not finish within 6 s; each rank's last note:" in msg, msg
    for rank in (0, 1):
        line = next(ln for ln in msg.splitlines() if ln.startswith(f"  rank {rank}: "))
        assert (f"case 'stall' on rank {rank} (" in line
                or "no note (not started, or no case begun)" in line), line


def test_dryrun_two_ranks():
    """`python -m ark_mpc_tpu_torch.parallel --dryrun 2`: the sharded step,
    the traced mesh program and the sharded ct x pt on two gloo ranks."""
    out = finish(start([sys.executable, "-m", "ark_mpc_tpu_torch.parallel", "--dryrun", "2"]),
                 "dryrun_multichip OK: 2 ranks (gloo)", timeout=200)
    assert "offline ct*pt stack sharded over 2 ranks OK" in out
