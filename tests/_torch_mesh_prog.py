"""Subprocess body for the port's mesh tests: torch and the port only.

    python tests/_torch_mesh_prog.py N IN.pkl OUT.pkl

spawns N gloo CPU ranks (`ark_mpc_tpu_torch.parallel.launch`) and runs every
case below on each rank; each case's result, or its traceback, is kept by
name, and the list of the ranks' results is written to OUT.pkl.  IN.pkl
holds the inputs the test made from numpy seeds: the sharded step's limb
arrays and the mesh-fabric program's values (`tests/_mesh_fabric_prog.py`).
`test_torch_parallel.py` holds the results against the JAX package.
"""

import os
import pickle
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ark_mpc_tpu_torch import AuthenticationError, Scalar, ScalarShare  # noqa: E402
from ark_mpc_tpu_torch.algebra.poly import AuthenticatedDensePoly  # noqa: E402
from ark_mpc_tpu_torch.fabric.simulator import execute_mock_mpc_dealer  # noqa: E402
from ark_mpc_tpu_torch.gadgets import prefix_product  # noqa: E402
from ark_mpc_tpu_torch.models.circuits import inner_product, poly_eval, shared_matmul  # noqa: E402
from ark_mpc_tpu_torch.parallel import launch  # noqa: E402
from ark_mpc_tpu_torch.parallel.step import (  # noqa: E402
    beaver_mul_step,
    gather,
    mac_check_fold,
    replicate,
    shard,
    shard_share,
    sharded_mul_mac_step,
    sharded_rlc_fold,
)

ARRAYS = ("x", "y", "a", "b", "c")


def scalar(arr, device="cpu") -> Scalar:
    return Scalar(torch.from_numpy(np.asarray(arr, dtype=np.int32)).to(device))


def limbs(x) -> np.ndarray:
    return x.limbs.cpu().numpy().astype(np.uint32)


def step_inputs(inp, device="cpu"):
    """The step's global inputs as port objects."""
    shares = [ScalarShare(scalar(inp[k + "_s"], device), scalar(inp[k + "_m"], device))
              for k in ARRAYS]
    return shares, [scalar(inp[k], device) for k in ("d", "e", "key", "coeffs")]


def case_step(mesh, inp):
    """Both parties' sharded steps, gathered; and the fold of `t` alone."""
    (x, y, a, b, c), (d, e, key, cf) = step_inputs(inp, mesh.device)
    out = {}
    for pid in (0, 1):
        z, folded = sharded_mul_mac_step(
            mesh, pid, *(shard_share(s, mesh) for s in (x, y, a, b, c)),
            shard(d, mesh), shard(e, mesh), replicate(key, mesh), shard(cf, mesh))
        z = gather(z, mesh)
        out[pid] = (limbs(z.share), limbs(z.mac), limbs(folded))
    t = scalar(inp["t"], mesh.device)
    out["rlc"] = limbs(sharded_rlc_fold(mesh, shard(t, mesh).limbs, shard(cf, mesh).limbs))
    return out


def share_in(fabric, vals, sender, n=None):
    values = (Scalar.from_ints(vals, device=fabric.device)
              if fabric.party_id == sender else None)
    return fabric.share_values(values, sender=sender, n=len(vals) if n is None else n)


def honest_program(xs, ys):
    """`tests/_mesh_fabric_prog.py`'s honest program; the opens and the
    product's shares are gathered over the party's mesh."""

    def prog(fabric):
        sx, sy = share_in(fabric, xs, 0), share_in(fabric, ys, 1)
        p = fabric.mul(sx, sy)
        inv = fabric.inverse(sy, defer_check=True)
        chk = fabric.mul(p, inv)  # == sx
        o1 = fabric.open_authenticated(p, defer=True)
        o2 = fabric.open_authenticated(chk, defer=True)
        fabric.verify_deferred()  # folded: a mesh is attached
        p = gather(p, fabric.mesh)
        return (gather(o1, fabric.mesh).to_ints(), gather(o2, fabric.mesh).to_ints(),
                limbs(p.share), limbs(p.mac))

    return prog


def corrupt_program(xs, cheater_rank=None, fold=None):
    """Party 1 adds 1 to its MAC shares (on every rank, or on
    `cheater_rank` alone); -> "abort" where the party raised
    `AuthenticationError`, else "pass"."""

    def prog(fabric):
        sx = share_in(fabric, xs, 0)
        if fabric.party_id == 1 and cheater_rank in (None, fabric.mesh.rank):
            sx = ScalarShare(sx.share, sx.mac + Scalar.ones(sx.shape, device=fabric.device))
        try:
            fabric.open_authenticated(sx, defer=True)
            fabric.verify_deferred(fold=fold)
        except AuthenticationError:
            return "abort"
        return "pass"

    return prog


def case_fabric(mesh, inp):
    xs, ys = inp["xs"], inp["ys"]
    return execute_mock_mpc_dealer(honest_program(xs, ys), mesh=mesh)


def case_corrupt(mesh, inp):
    return execute_mock_mpc_dealer(corrupt_program(inp["xs"]), mesh=mesh)


def case_cheat_one_rank_pair(mesh, inp):
    """Only the last rank's party 1 cheats; the check is unfolded, so only
    that rank pair's own zero test fails."""
    return execute_mock_mpc_dealer(
        corrupt_program(inp["xs"], cheater_rank=mesh.size - 1, fold=False), mesh=mesh)


def case_coins(mesh, inp):
    """Each rank pair's public coin: -> both parties' first 16 bytes."""
    return execute_mock_mpc_dealer(lambda f: f.public_coin_rng().bytes(16), mesh=mesh)


def raised(prog, mesh):
    """-> "TypeName: message" of what `prog` raised through the simulator."""
    try:
        execute_mock_mpc_dealer(prog, mesh=mesh)
    except Exception as err:  # noqa: BLE001 - the test reads the type and text
        return f"{type(err).__name__}: {err}"
    return "no error"


def case_unaligned(mesh, inp):
    xs = inp["xs"]
    return raised(lambda f: share_in(f, xs + [1], 0), mesh)


def case_fold_default(mesh, inp):
    """Rounds of `verify_deferred()` and of `verify_deferred(fold=False)`."""
    xs = inp["xs"]

    def prog(fabric):
        rounds = []
        for fold in (None, False):
            sx = share_in(fabric, xs, 0)
            fabric.open_authenticated(sx, defer=True)
            before = fabric.n_rounds
            fabric.verify_deferred(fold=fold)
            rounds.append(fabric.n_rounds - before)
        return rounds

    return execute_mock_mpc_dealer(prog, mesh=mesh)


def case_batch_rule(mesh, inp):
    """A batch of one element a rank works; a batch that is no multiple of
    the mesh size, or a single value, raises."""
    vals = list(range(2, 2 + mesh.size))

    def aligned(fabric):
        x = share_in(fabric, vals, 0)
        z = fabric.mul(x, x)
        return gather(fabric.open_authenticated(z), fabric.mesh).to_ints()

    return {
        "aligned": execute_mock_mpc_dealer(aligned, mesh=mesh),
        "odd_sizes": raised(lambda f: share_in(f, vals + [1], 1), mesh),
        "single_value": raised(
            lambda f: f.share_values(Scalar.from_ints(5, device=f.device)
                                     if f.party_id == 0 else None, sender=0, n=1), mesh),
        "passthrough": raised(lambda f: f.random_shared_scalars(mesh.size + 1), mesh),
    }


def case_refusals(mesh, inp):
    """Each batch-axis reduction, after a shared batch of 2 a rank: ->
    {name: "TypeName: message"} in party 0."""
    n = 2 * mesh.size

    def prog(fabric):
        x = share_in(fabric, list(range(1, n + 1)), 0)
        tr = fabric.tracer()
        attempts = {
            "ScalarShare.sum": lambda: x.sum(),
            "inner_product": lambda: inner_product(fabric, x, x),
            "shared_matmul": lambda: shared_matmul(fabric, x.reshape(2, -1),
                                                   x.reshape(-1, 2)),
            "poly_eval": lambda: poly_eval(fabric, x, Scalar.from_ints(3, device=fabric.device)),
            "prefix_product": lambda: prefix_product(fabric, x),
            "shared_polynomial": lambda: AuthenticatedDensePoly(x),
            "mul_generator": lambda: fabric.mul_generator(x),
            "traced_sum": lambda: tr.run(outputs=[tr.wrap(x).sum()]),
        }
        out = {}
        for name, attempt in attempts.items():
            try:
                attempt()
                out[name] = "no error"
            except Exception as err:  # noqa: BLE001 - the test reads the type and text
                out[name] = f"{type(err).__name__}: {err}"
        return out

    return execute_mock_mpc_dealer(prog, mesh=mesh)[0]


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def run_cases(mesh, inp):
    out = {}
    for name, fn in CASES.items():
        try:
            out[name] = ("ok", fn(mesh, inp))
        except Exception:  # noqa: BLE001 - reported by name to the test
            out[name] = ("error", traceback.format_exc())
    return out


def one_rank_step(mesh, inp):
    """The card test's body: the sharded step on a one-rank NCCL mesh
    against the unsharded step, bit for bit; -> the backend and the result."""
    import torch.distributed as dist

    (x, y, a, b, c), (d, e, key, cf) = step_inputs(inp, mesh.device)
    z, folded = sharded_mul_mac_step(
        mesh, 0, *(shard_share(s, mesh) for s in (x, y, a, b, c)),
        shard(d, mesh), shard(e, mesh), replicate(key, mesh), shard(cf, mesh))
    want = beaver_mul_step(0, x, y, a, b, c, d, e, key)
    want_fold = mac_check_fold(key, want.share, want.mac, cf)
    same = (torch.equal(z.share.limbs, want.share.limbs)
            and torch.equal(z.mac.limbs, want.mac.limbs)
            and torch.equal(folded.limbs, want_fold.limbs))
    return dist.get_backend(mesh.group), same


def raise_on_rank_one(mesh):
    """A rank body that fails on rank 1 while rank 0 waits in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier(group=mesh.group)


if __name__ == "__main__":
    n_ranks, in_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    with open(in_path, "rb") as fh:
        inputs = pickle.load(fh)
    results = launch(run_cases, n_ranks, inputs, device="cpu", timeout=600)
    with open(out_path, "wb") as fh:
        pickle.dump(results, fh)
    print(f"MESH_PROG_OK {n_ranks}")
