"""Subprocess body for the port's mesh tests: torch and the port only.

    python tests/_torch_mesh_prog.py N IN.pkl OUT.pkl

spawns N gloo CPU ranks (`ark_mpc_tpu_torch.parallel.launch`) and runs every
case below on each rank; each case's result, or its traceback, is kept by
name, and the list of the ranks' results is written to OUT.pkl.  IN.pkl
holds the inputs the test made from numpy seeds: the sharded step's limb
arrays, the mesh-fabric program's values (`tests/_mesh_fabric_prog.py`),
and the values of the scalar operations' and point protocols' programs
(`ops_program`, `points_program`; `tests/_jax_mesh_ref.py` mirrors them
call for call).  `test_torch_parallel.py` holds the results against the
JAX package and against the port's unsharded fabric.
"""

import os
import pickle
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ark_mpc_tpu_torch import (  # noqa: E402
    G1,
    AuthenticationError,
    CurvePoint,
    Fr,
    PointShare,
    Scalar,
    ScalarShare,
    TrustedDealerSource,
    execute_mock_mpc,
)
from ark_mpc_tpu_torch.algebra import poly  # noqa: E402
from ark_mpc_tpu_torch.fabric.points import mul_public_point, msm_public_points  # noqa: E402
from ark_mpc_tpu_torch.fabric.simulator import execute_mock_mpc_dealer  # noqa: E402
from ark_mpc_tpu_torch.gadgets import prefix_product  # noqa: E402
from ark_mpc_tpu_torch.models.circuits import inner_product, poly_eval, shared_matmul  # noqa: E402
from ark_mpc_tpu_torch.parallel import launch  # noqa: E402
from ark_mpc_tpu_torch.parallel.step import (  # noqa: E402
    batch_sharding,
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
MAT_DIMS = (8, 8, 3)  # shared_matmul: (8, 8) @ (8, 3), rows a multiple of every mesh size
MAX_RANKS = 8
POLY_N = 8  # shared polynomials' coefficients (a multiple of every mesh size)
POLY_T = 8  # poly_inverse_mod_t's precision (likewise)


def op_inputs(rng: np.random.Generator, n: int) -> dict:
    """Values for `ops_program` and `points_program` besides the batches
    xs and ys: the matrices (2 MAX_RANKS^2 and 3 MAX_RANKS entries, of which
    the program takes the leading ones), polynomials (f(0) != 0), a point
    x, and n points' discrete logs gs and scalars ks."""

    def ints(k, low=0):
        return [int(v) for v in rng.integers(low, 1 << 62, size=k)]

    return dict(mat_a=ints(2 * MAX_RANKS * MAX_RANKS), mat_b=ints(MAX_RANKS * 3),
                poly_f=ints(POLY_N, 1), poly_g=ints(POLY_N), poly_h=ints(3, 1),
                x_eval=ints(1)[0], gs=ints(n, 1), ks=ints(n))


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


def whole(x, fabric):
    """x gathered over the party's ranks (as it is without a mesh)."""
    return x if fabric.mesh is None else gather(x, fabric.mesh)


def ops_program(inp):
    """The scalar operations a mesh fabric gained (sum, a one-element sum
    times and plus the opened batch, inner product, a traced circuit whose
    levels open a sum beside a sharded product, shared matmul, poly_eval,
    poly_mul, poly_inverse_mod_t, poly_div, and the port's own
    share_public of the opened batch and x^0), then one deferred open of
    each result and one folded check; -> {name: (opened ints, share limbs,
    MAC limbs)}, gathered, plus the traced circuit's opens.  No shape
    depends on the mesh size, so the record is the same on every mesh.
    `_jax_mesh_ref.ops_program` makes the same calls in the same order, but
    the last two."""

    def prog(fabric):
        dev = fabric.device
        x, y = share_in(fabric, inp["xs"], 0), share_in(fabric, inp["ys"], 1)
        res = {"sum": x.sum()}
        x_open = fabric.open(x)  # a shard: the sum's products with it are shards
        res["sum_times_open"] = fabric.mul_public(res["sum"], x_open)
        res["sum_plus_open"] = fabric.add_public(res["sum"], x_open)
        res["inner_product"] = inner_product(fabric, x, y)
        tr = fabric.tracer()
        tx, ty = tr.wrap(x), tr.wrap(y)
        prod = tx * ty
        tsum = prod.sum()
        # level 2 opens the sum beside the sharded product, and so does the
        # terminal flush
        w = tx * prod.open().as_public() + tsum.open().as_public()
        handles = [tsum.open(), prod.open(), w.open()]
        res["traced_sum"], res["traced_w"] = tr.run(outputs=[tsum, w])
        m, k, n = MAT_DIMS
        a = share_in(fabric, inp["mat_a"][:m * k], 0).reshape(-1, k)
        b = share_in(fabric, inp["mat_b"][:k * n], 1).reshape(-1, n)
        res["shared_matmul"] = shared_matmul(fabric, a, b)
        f, g = share_in(fabric, inp["poly_f"], 0), share_in(fabric, inp["poly_g"], 1)
        res["poly_eval"] = poly_eval(fabric, f, Scalar.from_ints(inp["x_eval"], device=dev))
        pf, pg = poly.AuthenticatedDensePoly(f), poly.AuthenticatedDensePoly(g)
        res["poly_mul"] = poly.poly_mul(fabric, pf, pg).coeffs
        res["poly_inverse_mod_t"] = poly.poly_inverse_mod_t(fabric, pf, POLY_T).coeffs
        res["poly_div"] = poly.poly_div(
            fabric, pf, poly.DensePoly.from_ints(inp["poly_h"], device=dev)).coeffs
        # the port's alone (no draw, no exchange): public values made from a
        # shard are shards, not cut again
        res["share_public_of_open"] = fabric.share_public(x_open)
        res["pow_zero"] = fabric.pow(x, 0)
        opened = {name: fabric.open_authenticated(v, defer=True) for name, v in res.items()}
        fabric.verify_deferred()
        out = {}
        for name, v in res.items():
            v = whole(v, fabric)
            out[name] = (whole(opened[name], fabric).to_ints(), limbs(v.share), limbs(v.mac))
        out["traced_opens"] = [whole(h.value, fabric).to_ints() for h in handles]
        return out

    return prog


def case_ops(mesh, inp):
    return execute_mock_mpc_dealer(ops_program(inp), mesh=mesh)


def case_traced_mixed_levels(mesh, inp):
    """A level whose muls mix placements (two sums' product beside a
    sharded product) and whose inversions do too: -> both parties' opens."""
    xs, ys = inp["xs"], inp["ys"]

    def prog(fabric):
        tr = fabric.tracer()
        tx, ty = tr.wrap(share_in(fabric, xs, 0)), tr.wrap(share_in(fabric, ys, 1))
        sums = tx.sum() * ty.sum()
        handles = [h.open() for h in (tx * ty, sums, sums.inverse(), tx.inverse())]
        tr.run()
        return [whole(h.value, fabric).to_ints() for h in handles]

    return execute_mock_mpc_dealer(prog, mesh=mesh)


def point_batch(points, fabric):
    """The rank's slice of a public point batch held whole."""
    if fabric.mesh is None:
        return points
    return points[batch_sharding(fabric.mesh, points.size)]


def point_limbs(pt) -> np.ndarray:
    return np.stack([limbs(c) for c in pt._coords()])


def affine_ints(pt) -> list:
    x, y = pt.to_affine()
    return [x.to_ints(), y.to_ints()]


def points_program(inp):
    """The point protocols: share_points, mul_generator, mul_public_point,
    the Beaver scalar x point product, the authenticated MSM and the MSM
    with public points (`_jax_mesh_ref.points_program`'s), then the port's
    own share_public_points of the opened shared batch, each opened
    (deferred) and checked; -> {name: (opened affine ints, share coordinate
    limbs, MAC coordinate limbs)}, gathered.  Runs with or without a mesh."""
    gs, ks = inp["gs"], inp["ks"]

    def prog(fabric):
        dev, n = fabric.device, len(gs)
        pub = CurvePoint.generator((n,), device=dev).mul(Scalar.from_ints(gs, device=dev))
        sp = fabric.share_points(pub if fabric.party_id == 0 else None, sender=0, n=n)
        sk = share_in(fabric, ks, 1)
        mine = point_batch(pub, fabric)
        res = {"share_points": sp, "mul_generator": fabric.mul_generator(sk),
               "mul_public_point": mul_public_point(sk, mine),
               "beaver_mul_points": fabric.mul_points(sk, sp),
               "msm_authenticated": fabric.msm(sk, sp).reshape(1),
               "msm_public_points": msm_public_points(sk, mine).reshape(1)}
        # the port's alone: the opened shard, shared as public points
        res["share_public_points"] = fabric.share_public_points(fabric.open_points(sp))
        opened = {k: fabric.open_authenticated_points(v, defer=True) for k, v in res.items()}
        fabric.verify_deferred()
        out = {}
        for name, v in res.items():
            v = whole(v, fabric)
            out[name] = (affine_ints(whole(opened[name], fabric)), point_limbs(v.share),
                         point_limbs(v.mac))
        return out

    return prog


def g1_program(gs, ks):
    """The Beaver scalar x point product and the authenticated MSM at
    BN254's G1 over Fr (the same code as Ed25519's), opened and checked;
    -> the `points_program` record."""

    def prog(fabric):
        dev, n = fabric.device, len(gs)
        pub = G1.generator((n,), device=dev).mul(Fr.from_ints(gs, device=dev))
        sp = fabric.share_points(pub if fabric.party_id == 0 else None, sender=0, n=n)
        sk = fabric.share_values(Fr.from_ints(ks, device=dev) if fabric.party_id == 1
                                 else None, sender=1, n=n)
        res = {"beaver_mul_points": fabric.mul_points(sk, sp),
               "msm_authenticated": fabric.msm(sk, sp).reshape(1)}
        opened = {k: fabric.open_authenticated_points(v, defer=True) for k, v in res.items()}
        fabric.verify_deferred()
        out = {}
        for name, v in res.items():
            v = whole(v, fabric)
            out[name] = (affine_ints(whole(opened[name], fabric)), point_limbs(v.share),
                         point_limbs(v.mac))
        return out

    return prog


def run_g1(gs, ks, mesh=None, device="cpu"):
    """`g1_program` under a dealer at Fr, on `mesh` or unsharded."""
    device = mesh.device if mesh is not None else device
    return execute_mock_mpc(
        g1_program(gs, ks), mesh=mesh, device=device,
        offline_factory=lambda pid: TrustedDealerSource(pid, seed=11, field=Fr, device=device))


def g1_rank(mesh, gs, ks):
    return run_g1(gs, ks, mesh)


def case_points(mesh, inp):
    return execute_mock_mpc_dealer(points_program(inp), mesh=mesh)


def case_point_cheat_one_rank_pair(mesh, inp):
    """Party 1 of the last rank alone adds G to its point MAC shares: that
    rank pair's point check fails, and every rank of both parties aborts."""
    n = 2 * mesh.size

    def prog(fabric):
        gen = CurvePoint.generator((n,), device=fabric.device)
        sp = fabric.share_points(gen if fabric.party_id == 0 else None, sender=0, n=n)
        if fabric.party_id == 1 and fabric.mesh.rank == fabric.mesh.size - 1:
            sp = PointShare(sp.share, sp.mac + gen[:sp.size])
        try:
            fabric.open_authenticated_points(sp)
        except AuthenticationError:
            return "abort"
        return "pass"

    return execute_mock_mpc_dealer(prog, mesh=mesh)


def case_mixing(mesh, inp):
    """Each way a shard (2 elements a rank) can meet a replicated batch of 2
    elements (a shared polynomial's first coefficients, their opened
    value), and the replicated share with the shard's opened value:
    -> {name: "TypeName: message"} in party 0."""
    n = 2 * mesh.size

    def prog(fabric):
        x = share_in(fabric, list(range(1, n + 1)), 0)
        rep = poly.AuthenticatedDensePoly(x).coeffs[:2]
        rep_open, x_open = fabric.open(rep), fabric.open(x)
        attempts = {
            "add": lambda: x + rep,
            "mul_public": lambda: x.mul_public(rep_open),
            "add_public": lambda: fabric.add_public(x, rep_open),
            "mul_public_of_an_opened_shard": lambda: rep.mul_public(x_open),
            "add_public_of_an_opened_shard": lambda: fabric.add_public(rep, x_open),
            "beaver_mul": lambda: fabric.mul(x, rep),
            "concatenate": lambda: ScalarShare.concatenate([x, rep]),
            "point_product": lambda: fabric.mul_points(rep, fabric.mul_generator(x)),
        }
        out = {}
        for name, attempt in attempts.items():
            try:
                attempt()
                out[name] = "no error"
            except Exception as err:  # noqa: BLE001 - the test reads the type and text
                out[name] = f"{type(err).__name__}: {err}"
        # what a replicated value gives: once, however many ranks
        out["gathered_sum"] = gather(fabric.open(x.sum()), fabric.mesh).to_ints()
        out["gathered_coeffs"] = gather(rep_open, fabric.mesh).to_ints()
        return out

    return execute_mock_mpc_dealer(prog, mesh=mesh)[0]


def case_prefix_product_refuses(mesh, inp):
    """prefix_product after a shared batch of 2 a rank, eager and traced:
    -> the messages, in party 0."""
    n = 2 * mesh.size

    def prog(fabric):
        x = share_in(fabric, list(range(1, n + 1)), 0)
        out = []
        for arg in (x, fabric.tracer().wrap(x)):
            try:
                prefix_product(fabric, arg)
                out.append("no error")
            except Exception as err:  # noqa: BLE001 - the test reads the type and text
                out.append(f"{type(err).__name__}: {err}")
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


def one_rank_ops(mesh, inp):
    """The card test's body for slice G: the scalar operations' and point
    protocols' programs on the one-rank mesh and on the unsharded fabric on
    the same card; -> the backend and the four records."""
    import torch.distributed as dist

    dev = mesh.device
    return (dist.get_backend(mesh.group),
            execute_mock_mpc_dealer(ops_program(inp), mesh=mesh),
            execute_mock_mpc_dealer(ops_program(inp), device=dev),
            execute_mock_mpc_dealer(points_program(inp), mesh=mesh),
            execute_mock_mpc_dealer(points_program(inp), device=dev))


def raise_on_rank_one(mesh):
    """A rank body that fails on rank 1 while rank 0 waits in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier(group=mesh.group)


if __name__ == "__main__":
    n_ranks, in_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    with open(in_path, "rb") as fh:
        inputs = pickle.load(fh)
    results = launch(run_cases, n_ranks, inputs, device="cpu", timeout=180)
    with open(out_path, "wb") as fh:
        pickle.dump(results, fh)
    print(f"MESH_PROG_OK {n_ranks}")
