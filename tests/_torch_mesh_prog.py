"""Subprocess body for the port's mesh tests: torch and the port only.

    python tests/_torch_mesh_prog.py N IN.pkl OUT.pkl

spawns N gloo CPU ranks (`ark_mpc_tpu_torch.parallel.launch`, one
intra-op thread a rank) and runs every case below on each rank, in a few
launches (`GROUPS`), each within `LAUNCH_TIMEOUT` and all within
`SIDE_TIMEOUT`; each rank notes the case it is in, so a launch that times
out names it.  Each case's result,
or its traceback, is kept by name (a launch that fails or times out
records its message for each of its cases), and the list of the ranks'
results is written to OUT.pkl.  IN.pkl holds the inputs the test made
from numpy seeds: the sharded step's limb arrays, the mesh-fabric
program's values (`tests/_mesh_fabric_prog.py`), and the values of the
scalar operations', point protocols' and global view's programs
(`ops_program`, `points_program`, `index_program`, `matmul_program`,
`index_types_program`, `prefix_selection_program`, `mixed_program`;
`tests/_jax_mesh_ref.py` mirrors them call for call).
`test_torch_parallel.py` holds the results against the JAX package and
against the port's unsharded fabric.
"""

import os
import pickle
import sys
import time
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
from ark_mpc_tpu_torch.parallel.launch import note  # noqa: E402
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


def single_value(fabric):
    """Party 0 shares the single value 5 (0-d; party 1 passes n = 1), and
    both open it as a one-element batch: -> (the opened ints, share limbs,
    MAC limbs), which on a mesh are replicated."""
    x = fabric.share_values(Scalar.from_ints(5, device=fabric.device)
                            if fabric.party_id == 0 else None, sender=0, n=1)
    opened = fabric.open_authenticated(x.reshape(1))
    return opened.to_ints(), limbs(x.share), limbs(x.mac)


def case_batch_rule(mesh, inp):
    """A batch of one element a rank works, and so does a single value
    (replicated, as the reference keeps it); a batch larger than the mesh
    that is no multiple of its size raises, as does an offline draw of
    such a size."""
    vals = list(range(2, 2 + mesh.size))

    def aligned(fabric):
        x = share_in(fabric, vals, 0)
        z = fabric.mul(x, x)
        return gather(fabric.open_authenticated(z), fabric.mesh).to_ints()

    return {
        "aligned": execute_mock_mpc_dealer(aligned, mesh=mesh),
        "odd_sizes": raised(lambda f: share_in(f, vals + [1], 1), mesh),
        "single_value": execute_mock_mpc_dealer(single_value, mesh=mesh),
        "passthrough": raised(lambda f: f.random_shared_scalars(mesh.size + 1), mesh),
    }


def whole(x, fabric):
    """x gathered over the party's ranks (as it is without a mesh)."""
    return x if fabric.mesh is None else gather(x, fabric.mesh)


OPS_PARTS = ("ops", "poly")  # `ops_program`'s two parts, each a program of its own


def ops_program(inp, part=None):
    """The scalar operations a mesh fabric gained, then one deferred open
    of each result and one folded check; -> {name: (opened ints, share
    limbs, MAC limbs)}, gathered.  `part` "ops": sum, a one-element sum
    times and plus the opened batch, inner product, a traced circuit whose
    levels open a sum beside a sharded product (its opens too), shared
    matmul, x^7 (its square-and-multiply steps pair two products in one
    call), and the port's own share_public of the opened batch and x^0;
    "poly": poly_eval, poly_mul, poly_inverse_mod_t, poly_div (their own
    dealer stream); None: both in one program.  No shape depends on the
    mesh size, so the record is the same on every mesh.
    `_jax_mesh_ref.ops_program` makes the same calls in the same order, but
    the port's own."""

    def prog(fabric):
        dev = fabric.device
        x, y = share_in(fabric, inp["xs"], 0), share_in(fabric, inp["ys"], 1)
        res = {} if part in (None, "ops") else poly_ops(fabric, inp, x, y)
        if part == "poly":
            return finish_ops(fabric, res, [])
        res["sum"] = x.sum()
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
        res["pow"] = fabric.pow(x, 7)
        if part is None:
            res.update(poly_ops(fabric, inp, x, y))
        # the port's alone (no draw, no exchange): public values made from a
        # shard are shards, not cut again
        res["share_public_of_open"] = fabric.share_public(x_open)
        res["pow_zero"] = fabric.pow(x, 0)
        return finish_ops(fabric, res, handles)

    return prog


def poly_ops(fabric, inp, x, y) -> dict:
    """`ops_program`'s shared polynomials (f, g shared after x, y)."""
    dev = fabric.device
    f, g = share_in(fabric, inp["poly_f"], 0), share_in(fabric, inp["poly_g"], 1)
    res = {"poly_eval": poly_eval(fabric, f, Scalar.from_ints(inp["x_eval"], device=dev))}
    pf, pg = poly.AuthenticatedDensePoly(f), poly.AuthenticatedDensePoly(g)
    res["poly_mul"] = poly.poly_mul(fabric, pf, pg).coeffs
    res["poly_inverse_mod_t"] = poly.poly_inverse_mod_t(fabric, pf, POLY_T).coeffs
    res["poly_div"] = poly.poly_div(
        fabric, pf, poly.DensePoly.from_ints(inp["poly_h"], device=dev)).coeffs
    return res


def finish_ops(fabric, res: dict, handles: list) -> dict:
    """One deferred open of each result and one folded check; -> the record."""
    opened = {name: fabric.open_authenticated(v, defer=True) for name, v in res.items()}
    fabric.verify_deferred()
    out = {}
    for name, v in res.items():
        v = whole(v, fabric)
        out[name] = (whole(opened[name], fabric).to_ints(), limbs(v.share), limbs(v.mac))
    if handles:
        out["traced_opens"] = [whole(h.value, fabric).to_ints() for h in handles]
    return out


def case_ops(mesh, inp):
    """`ops_program`'s two parts: -> {part: both parties' records}."""
    return {part: execute_mock_mpc_dealer(ops_program(inp, part), mesh=mesh)
            for part in OPS_PARTS}


MIXED_SHIFTS = (1, 2, 3)  # the level-2 inversions of sums + k beside the product's
MIXED_NAMES = ("prod", "sums", "x_inverse", "prod_inverse", "sums_inverse") + tuple(
    f"(sums + {k})_inverse" for k in MIXED_SHIFTS)


def mixed_program(inp):
    """A traced circuit whose first level's muls mix placements (two sums'
    product beside a sharded product) and whose second level's inversions
    do too (the product's inverse beside four of the sums': 8 + 4
    elements, a batch every mesh size here divides, as the reference's
    inversion needs), each result opened:
    -> ({name: (opened ints, share limbs, MAC limbs)}, the circuit's
    rounds), gathered.  `_jax_mesh_ref.mixed_program` makes the same
    calls."""

    def prog(fabric):
        tr = fabric.tracer()
        tx, ty = tr.wrap(share_in(fabric, inp["xs"], 0)), tr.wrap(share_in(fabric, inp["ys"], 1))
        sums = tx.sum() * ty.sum()
        prod = tx * ty
        outs = [prod, sums, tx.inverse(), prod.inverse(), sums.inverse()]
        outs += [(sums + Scalar.from_ints(k, device=fabric.device)).inverse()
                 for k in MIXED_SHIFTS]
        handles = [v.open() for v in outs]
        before = fabric.n_rounds
        res = tr.run(outputs=outs)
        rounds = fabric.n_rounds - before
        out = {}
        for name, h, v in zip(MIXED_NAMES, handles, res):
            v = whole(v, fabric)
            out[name] = (whole(h.value, fabric).to_ints(), limbs(v.share), limbs(v.mac))
        return out, rounds

    return prog


def case_traced_mixed_levels(mesh, inp):
    return execute_mock_mpc_dealer(mixed_program(inp), mesh=mesh)


def mixed_points_program(inp):
    """A traced level whose point products mix placements: each shared
    point times its shared scalar (a shard) beside the points' sum times
    the scalars' sum (replicated), each opened: -> ({name: (affine ints,
    share coordinate limbs, MAC coordinate limbs)}, the circuit's rounds),
    gathered.  Runs with or without a mesh."""

    def prog(fabric):
        dev, n = fabric.device, len(inp["gs"])
        pub = (CurvePoint.generator((n,), device=dev).mul(Scalar.from_ints(inp["gs"], device=dev))
               if fabric.party_id == 0 else None)
        tr = fabric.tracer()
        tp = tr.wrap_points(fabric.share_points(pub, sender=0, n=n))
        tk = tr.wrap(share_in(fabric, inp["ks"], 1))
        outs = {"products": tp.mul(tk), "sums": tp.sum().mul(tk.sum())}
        handles = [v.open() for v in outs.values()]
        before = fabric.n_rounds
        res = tr.run(outputs=list(outs.values()))
        rounds = fabric.n_rounds - before
        out = {}
        for name, h, v in zip(outs, handles, res):
            v = whole(v, fabric)
            out[name] = (affine_ints(whole(h.value, fabric).reshape(v.size)),
                         point_limbs(v.share), point_limbs(v.mac))
        return out, rounds

    return prog


def case_traced_mixed_points(mesh, inp):
    return execute_mock_mpc_dealer(mixed_points_program(inp), mesh=mesh)


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


POINT_PARTS = ("elementwise", "sums")  # `points_program`'s two halves


def points_program(inp, part=None):
    """The point protocols: share_points, mul_generator, mul_public_point,
    the Beaver scalar x point product, the authenticated MSM and the MSM
    with public points (`_jax_mesh_ref.points_program`'s), then the port's
    own share_public_points of the opened shared batch, each opened
    (deferred) and checked; -> {name: (opened affine ints, share coordinate
    limbs, MAC coordinate limbs)}, gathered.  Runs with or without a mesh.
    `part` "elementwise" keeps the first four after the sharing, "sums"
    the rest (each half a case of its own on a mesh: the curve arithmetic
    of a whole program is the longest launch)."""
    gs, ks = inp["gs"], inp["ks"]

    def prog(fabric):
        dev, n = fabric.device, len(gs)
        pub = CurvePoint.generator((n,), device=dev).mul(Scalar.from_ints(gs, device=dev))
        sp = fabric.share_points(pub if fabric.party_id == 0 else None, sender=0, n=n)
        sk = share_in(fabric, ks, 1)
        mine = point_batch(pub, fabric)
        res = {}
        if part in (None, "elementwise"):
            res.update(share_points=sp, mul_generator=fabric.mul_generator(sk),
                       mul_public_point=mul_public_point(sk, mine),
                       beaver_mul_points=fabric.mul_points(sk, sp))
        if part in (None, "sums"):
            res.update(msm_authenticated=fabric.msm(sk, sp).reshape(1),
                       msm_public_points=msm_public_points(sk, mine).reshape(1))
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


def case_points_elementwise(mesh, inp):
    return execute_mock_mpc_dealer(points_program(inp, "elementwise"), mesh=mesh)


def case_points_sums(mesh, inp):
    return execute_mock_mpc_dealer(points_program(inp, "sums"), mesh=mesh)


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
    """prefix_product of a shared batch of 2 a rank (2 size + 1 inverse
    pairs, which no mesh of 2 ranks or more divides), eager and traced:
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


def small_program(inp, n: int):
    """A batch of n elements, smaller than a mesh of more than n ranks and
    so replicated on it: both parties share n values, multiply them, sum
    one and take their inner product, each opened (deferred) and checked;
    with n = 1 also a one-point batch shared and opened.  -> {name:
    (opened ints, share limbs, MAC limbs)} (points: (affine ints, share
    coordinate limbs, MAC coordinate limbs)), gathered.
    `_jax_mesh_ref.small_program` makes the same calls in the same order."""

    def prog(fabric):
        dev = fabric.device
        x = share_in(fabric, inp["small_xs"][:n], 0)
        y = share_in(fabric, inp["small_ys"][:n], 1)
        res = {"share": x, "mul": fabric.mul(x, y), "sum": x.sum(),
               "inner_product": inner_product(fabric, x, y)}
        opened = {name: fabric.open_authenticated(v, defer=True) for name, v in res.items()}
        if n == 1:
            pub = CurvePoint.generator((1,), device=dev).mul(
                Scalar.from_ints(inp["gs"][:1], device=dev))
            sp = fabric.share_points(pub if fabric.party_id == 0 else None, sender=0, n=1)
            sp_open = fabric.open_authenticated_points(sp, defer=True)
        fabric.verify_deferred()
        out = {}
        for name, v in res.items():
            v = whole(v, fabric)
            out[name] = (whole(opened[name], fabric).to_ints(), limbs(v.share), limbs(v.mac))
        if n == 1:
            sp = whole(sp, fabric)
            out["share_points"] = (affine_ints(whole(sp_open, fabric)), point_limbs(sp.share),
                                   point_limbs(sp.mac))
        return out

    return prog


def prefix_program(inp, n: int):
    """prefix_product of a shared batch of n, eager and then traced, each
    opened: -> {"eager" | "traced": (opened ints, share limbs, MAC limbs),
    "traced_rounds": the traced circuit's rounds}, gathered.  On a mesh it
    runs where n + 1 <= the mesh size.  `_jax_mesh_ref.prefix_program`
    makes the same calls."""

    def prog(fabric):
        x = share_in(fabric, inp["small_xs"][:n], 0)
        out = {}
        eager = prefix_product(fabric, x)
        out["eager"] = eager
        opened = {"eager": fabric.open_authenticated(eager)}
        before = fabric.n_rounds
        tr = fabric.tracer()
        handle = prefix_product(fabric, tr.wrap(x)).open()
        (traced,) = tr.run(outputs=[handle.source])
        out["traced_rounds"] = fabric.n_rounds - before
        out["traced"], opened["traced"] = traced, handle.value
        for name in ("eager", "traced"):
            v = whole(out[name], fabric)
            out[name] = (whole(opened[name], fabric).to_ints(), limbs(v.share), limbs(v.mac))
        return out

    return prog


def case_small_one(mesh, inp):
    """`small_program` at n = 1: replicated on every mesh."""
    return execute_mock_mpc_dealer(small_program(inp, 1), mesh=mesh)


def case_small_three(mesh, inp):
    """`small_program` at n = 3: replicated on a mesh of more than 3 ranks;
    on a smaller one, a batch that does not divide it: the error's
    "TypeName: message" in both parties."""
    if mesh.size > 3:
        return execute_mock_mpc_dealer(small_program(inp, 3), mesh=mesh)
    return raised(small_program(inp, 3), mesh)


def prefix_sizes(size: int) -> tuple:
    """The n `case_prefix_small` runs on a mesh of `size` ranks: 1 on two
    ranks (held to Python ints), else 2 and 3 (held to the JAX package's
    4-device mesh), where n + 1 <= size."""
    return (1,) if size == 2 else tuple(n for n in (2, 3) if n < size)


def case_prefix_small(mesh, inp):
    """`prefix_program` at each of `prefix_sizes`: -> {n: both parties'
    records}."""
    return {n: execute_mock_mpc_dealer(prefix_program(inp, n), mesh=mesh)
            for n in prefix_sizes(mesh.size)}


# the global view's selections of an 8-element batch (`index_program`):
# four indices and a reshape whose -1 is the global batch's
SELECTIONS = (("0", lambda v: v[0]), ("-1", lambda v: v[-1]), ("1:3", lambda v: v[1:3]),
              ("::2", lambda v: v[::2]), ("reshape(2, -1)", lambda v: v.reshape(2, -1)))
# shared_matmul's (m, k, n) beside MAT_DIMS: rows and whole operands below
# the mesh size, shards holding part of a row; (1, 3, 1) only where the
# mesh size is above 3 (on 2 ranks both packages refuse its 3-element
# operands)
MATMUL_SHAPES = ((1, 2, 1), (2, 2, 4), (1, 3, 1))


def matmul_shapes(size: int) -> tuple:
    return tuple(s for s in MATMUL_SHAPES if size > 3 or s != (1, 3, 1))


def split_affine(opened, sizes) -> list:
    """The affine ints of a concatenation's consecutive parts of `sizes`."""
    xs, ys = affine_ints(opened)
    out, at = [], 0
    for k in sizes:
        out.append([xs[at:at + k], ys[at:at + k]])
        at += k
    return out


def index_program(inp):
    """`SELECTIONS` of an 8-element shared batch, of its opened value and of an
    8-point shared batch; each scalar selection opened (deferred), the
    point selections gathered and opened together (one deferred open: each
    point open costs curve arithmetic on every rank), and checked; ->
    {"share" | "points": {name: (opened ints or affine ints, share limbs,
    MAC limbs)}, "open": {name: ints}, "placement": {name: each
    selection's replicated mark (None off a mesh)}, "refused": {name:
    "TypeName: message"}}, gathered.  `_jax_mesh_ref.index_program` makes
    the same calls in the same order but the placements and refusals."""

    def prog(fabric):
        dev, n = fabric.device, len(inp["xs"])
        x = share_in(fabric, inp["xs"], 0)
        x_open = fabric.open(x)
        pub = (CurvePoint.generator((n,), device=dev).mul(Scalar.from_ints(inp["gs"], device=dev))
               if fabric.party_id == 0 else None)
        sp = fabric.share_points(pub, sender=0, n=n)
        shares = {name: sel(x) for name, sel in SELECTIONS}
        points = {name: sel(sp) for name, sel in SELECTIONS}
        opens = {name: sel(x_open) for name, sel in SELECTIONS}
        opened = {name: fabric.open_authenticated(v, defer=True) for name, v in shares.items()}
        flat = [w.reshape(w.size) for w in (whole(v, fabric) for v in points.values())]
        p_opened = fabric.open_authenticated_points(PointShare.concatenate(flat), defer=True)
        fabric.verify_deferred()
        out = {"share": {}, "points": {}, "open": {}, "placement": {}, "refused": {}}
        for (name, v), affine in zip(shares.items(),
                                     split_affine(p_opened, [p.size for p in flat])):
            out["placement"][name] = (v.replicated, points[name].replicated,
                                      opens[name].replicated)
            v = whole(v, fabric)
            out["share"][name] = (whole(opened[name], fabric).to_ints(), limbs(v.share),
                                  limbs(v.mac))
            p = whole(points[name], fabric)
            out["points"][name] = (affine, point_limbs(p.share), point_limbs(p.mac))
            out["open"][name] = whole(opens[name], fabric).to_ints()
        for name, idx in (("list", [0, 2]), ("tuple", (slice(None),))):
            for kind, v in (("share", x), ("open", x_open), ("points", sp)):
                try:
                    v[idx]
                    got = "no error"
                except Exception as err:  # noqa: BLE001 - the test reads the type and text
                    got = f"{type(err).__name__}: {err}"
                out["refused"][f"{kind} {name}"] = got
        return out

    return prog


def matmul_program(inp, shape):
    """shared_matmul of `shape` = (m, k, n): A the first m k of "mat_a"
    shared by party 0, B the first k n of "mat_b" by party 1, each reshaped
    to its global shape, the product opened (deferred) and checked; ->
    (opened ints, share limbs, MAC limbs, the product's replicated mark),
    gathered.  `_jax_mesh_ref.matmul_program` makes the same calls."""
    m, k, n = shape

    def prog(fabric):
        a = share_in(fabric, inp["mat_a"][:m * k], 0).reshape(m, k)
        b = share_in(fabric, inp["mat_b"][:k * n], 1).reshape(k, n)
        c = shared_matmul(fabric, a, b)
        opened = fabric.open_authenticated(c, defer=True)
        fabric.verify_deferred()
        rep = c.replicated
        c = whole(c, fabric)
        return whole(opened, fabric).to_ints(), limbs(c.share), limbs(c.mac), rep

    return prog


# every other index type the reference takes, on the 8-element batch, its
# opened value and its points (`index_types_program`): lists, integer
# arrays, a boolean mask, a selection whose size neither is below the mesh
# size nor divides it, and tuples of the (4, 2) global reshape
MASK = (True, False, True, True, False, True, False, False)
INDEX_TYPES = (("[0, 2, 5]", lambda v: v[[0, 2, 5]]),
               ("np.array([1, 6])", lambda v: v[np.array([1, 6])]),
               ("torch.tensor([7, 0])", lambda v: v[torch.tensor([7, 0])]),
               ("mask", lambda v: v[np.array(MASK)]),
               (":7", lambda v: v[:7]),
               ("(4, 2)[1, 0]", lambda v: v.reshape(4, 2)[1, 0]),
               ("(4, 2)[:, 1]", lambda v: v.reshape(4, 2)[:, 1]),
               ("(4, 2)[[0, 3]]", lambda v: v.reshape(4, 2)[[0, 3]]))


def index_types_program(inp):
    """`INDEX_TYPES` of an 8-element shared batch, of its opened value and of
    an 8-point shared batch, opened (deferred) and checked as in
    `index_program`; -> {"share" | "points": {name: (opened ints or affine
    ints, share limbs, MAC limbs)}, "open": {name: ints}, "placement":
    {name: the three selections' replicated marks}, "refused": {kind: what
    a float index raised}}, gathered.  `_jax_mesh_ref.index_types_program`
    makes the same scalar calls in the same order."""

    def prog(fabric):
        dev, n = fabric.device, len(inp["xs"])
        x = share_in(fabric, inp["xs"], 0)
        x_open = fabric.open(x)
        pub = (CurvePoint.generator((n,), device=dev).mul(Scalar.from_ints(inp["gs"], device=dev))
               if fabric.party_id == 0 else None)
        sp = fabric.share_points(pub, sender=0, n=n)
        shares = {name: sel(x) for name, sel in INDEX_TYPES}
        points = {name: sel(sp) for name, sel in INDEX_TYPES}
        opens = {name: sel(x_open) for name, sel in INDEX_TYPES}
        opened = fabric.open_authenticated_many(list(shares.values()), defer=True)
        flat = [w.reshape(w.size) for w in (whole(v, fabric) for v in points.values())]
        p_opened = fabric.open_authenticated_points(PointShare.concatenate(flat), defer=True)
        fabric.verify_deferred()
        out = {"share": {}, "points": {}, "open": {}, "placement": {}, "refused": {}}
        for (name, v), o, affine in zip(shares.items(), opened,
                                        split_affine(p_opened, [p.size for p in flat])):
            out["placement"][name] = (v.replicated, points[name].replicated,
                                      opens[name].replicated)
            v, p = whole(v, fabric), whole(points[name], fabric)
            out["share"][name] = (whole(o, fabric).to_ints(), limbs(v.share), limbs(v.mac))
            out["points"][name] = (affine, point_limbs(p.share), point_limbs(p.mac))
            out["open"][name] = whole(opens[name], fabric).to_ints()
        for kind, v in (("share", x), ("open", x_open), ("points", sp)):
            out["refused"][kind] = raised_by(lambda: v[1.5])
        return out

    return prog


def raised_by(fn) -> str:
    """-> "TypeName: message" of what `fn()` raised, or "no error"."""
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - the test reads the type and text
        return f"{type(err).__name__}: {err}"
    return "no error"


def case_index_types(mesh, inp):
    return execute_mock_mpc_dealer(index_types_program(inp), mesh=mesh)


# prefix_product of x[:n] for the 8-element shared batch x: n + 1 = 4 and 8
# runs on 2 and 4 ranks, 6 on 2 ranks only, 9 on none
PREFIX_SELECTIONS = (3, 5, 7, 8)


def prefix_selection_program(inp, n: int):
    """prefix_product of x[:n], x the 8-element shared batch, eager and
    then traced, each opened: -> `prefix_program`'s record, gathered.
    `_jax_mesh_ref.prefix_selection_program` makes the same calls."""

    def prog(fabric):
        x = share_in(fabric, inp["xs"], 0)[:n]
        eager = prefix_product(fabric, x)
        opened = {"eager": fabric.open_authenticated(eager)}
        before = fabric.n_rounds
        tr = fabric.tracer()
        handle = prefix_product(fabric, tr.wrap(x)).open()
        (traced,) = tr.run(outputs=[handle.source])
        out = {"traced_rounds": fabric.n_rounds - before}
        opened["traced"] = handle.value
        for name, v in (("eager", eager), ("traced", traced)):
            v = whole(v, fabric)
            out[name] = (whole(opened[name], fabric).to_ints(), limbs(v.share), limbs(v.mac))
        return out

    return prog


def case_prefix_selections(mesh, inp):
    """`prefix_selection_program` at each of `PREFIX_SELECTIONS`: -> {n:
    both parties' records, or the error's "TypeName: message"}."""
    out = {}
    for n in PREFIX_SELECTIONS:
        try:
            out[n] = execute_mock_mpc_dealer(prefix_selection_program(inp, n), mesh=mesh)
        except Exception as err:  # noqa: BLE001 - the test reads the type and text
            out[n] = f"{type(err).__name__}: {err}"
    return out


def case_index_values(mesh, inp):
    """[10, 20, 30, 40] shared by party 0, x[0] and x[1:3] opened: -> both
    parties' gathered opens."""

    def prog(fabric):
        x = share_in(fabric, [10, 20, 30, 40], 0)
        return [whole(fabric.open(v), fabric).to_ints() for v in (x[0], x[1:3])]

    return execute_mock_mpc_dealer(prog, mesh=mesh)


def case_index(mesh, inp):
    return execute_mock_mpc_dealer(index_program(inp), mesh=mesh)


def case_matmul_shapes(mesh, inp):
    """`matmul_program` at each of `matmul_shapes`, and (1, 3, 1) on a mesh
    of 3 ranks or fewer, where its 3-element operand does not divide it:
    the error's "TypeName: message"."""
    out = {s: execute_mock_mpc_dealer(matmul_program(inp, s), mesh=mesh)
           for s in matmul_shapes(mesh.size)}
    if mesh.size <= 3:
        out["refused"] = raised(matmul_program(inp, (1, 3, 1)), mesh)
    return out


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}
# the cases by launch, each launch with its own time limit and at most ~30
# s of work a rank alone (1 thread, an idle 8-core host; six copies of the
# test module at once stretch that ~6x): the point cases take most of it
# (their curve arithmetic is plain torch on every rank, each scalar
# multiplication ~0.4 s whatever the batch), so they have launches of their
# own.  Every case is in exactly one group.
GROUPS = (("step", "fabric", "corrupt", "cheat_one_rank_pair", "coins", "unaligned",
           "fold_default", "batch_rule", "ops"),
          ("mixing", "prefix_product_refuses", "small_three", "prefix_small", "index_values",
           "matmul_shapes"),
          ("points_elementwise",), ("points_sums",),
          ("point_cheat_one_rank_pair", "small_one", "index"),
          ("index_types", "traced_mixed_points", "traced_mixed_levels", "prefix_selections"))
assert sorted(sum(GROUPS, ())) == sorted(CASES), "every case in exactly one group"
# seconds a launch (and a collective) may take, and a side's launches
# together: six copies of the test module at once, each from an empty
# cache (8 cores, ~1,475 s a copy), took launches of up to 413 s and sides
# of up to 1,360 s; these leave a sixth and a fifth more
LAUNCH_TIMEOUT = 480
SIDE_TIMEOUT = 1680
STOP_MARGIN = 20  # seconds a launch may take past its limit to stop its ranks


def run_cases(mesh, inp, names=tuple(CASES)):
    out = {}
    for name in names:
        note(f"case {name!r}")
        try:
            out[name] = ("ok", CASES[name](mesh, inp))
        except Exception:  # noqa: BLE001 - reported by name to the test
            out[name] = ("error", traceback.format_exc())
    note(f"done with {len(names)} cases")
    return out


def run_groups(n_ranks: int, inp) -> list:
    """Every case on `n_ranks` gloo ranks, one launch a group of `GROUPS`;
    -> each rank's {case: result}.  A launch that fails or times out costs
    only its own cases: each is recorded on every rank as ("error", the
    launch's message, which names each rank's case), and the next group
    still runs.  The launches end within `SIDE_TIMEOUT` together: each
    may take what is left of it (stopping its ranks included), at most
    `LAUNCH_TIMEOUT`, and a group that finds nothing left records that
    as its cases' error."""
    ranks = [{} for _ in range(n_ranks)]
    deadline = time.monotonic() + SIDE_TIMEOUT
    for k, names in enumerate(GROUPS):
        t0 = time.monotonic()
        limit = min(LAUNCH_TIMEOUT, deadline - t0 - STOP_MARGIN)
        try:
            if limit < 1:
                raise TimeoutError(f"not started: the side's {SIDE_TIMEOUT} s were spent")
            results = launch(run_cases, n_ranks, inp, names, device="cpu", timeout=limit)
            status = "done"
        except (RuntimeError, TimeoutError) as err:
            failed = ("error", f"launch {k + 1} of {len(GROUPS)} stopped: "
                               f"{type(err).__name__}: {err}")
            results = [dict.fromkeys(names, failed)] * n_ranks
            status = "STOPPED"
        for got, res in zip(ranks, results):
            got.update(res)
        print(f"launch {k + 1} of {len(GROUPS)} ({len(names)} cases) {status}: "
              f"{time.monotonic() - t0:.1f} s of {limit:.0f}", flush=True)
    return ranks


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
    """A rank body that fails on rank 1 while rank 0 waits in a collective
    (each rank notes its case first)."""
    note(f"case 'raise_on_rank_one' on rank {mesh.rank}")
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier(group=mesh.group)


def stall(mesh):
    """A rank body that notes its case and never finishes."""
    note(f"case 'stall' on rank {mesh.rank}")
    time.sleep(3600)


if __name__ == "__main__":
    n_ranks, in_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    with open(in_path, "rb") as fh:
        inputs = pickle.load(fh)
    results = run_groups(n_ranks, inputs)
    with open(out_path, "wb") as fh:
        pickle.dump(results, fh)
    print(f"MESH_PROG_OK {n_ranks}")
