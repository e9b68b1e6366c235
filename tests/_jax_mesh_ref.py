"""Subprocess body for the JAX side of the port's mesh tests.

    python tests/_jax_mesh_ref.py N IN.pkl OUT.pkl [MODE [AT]]

reads the inputs `test_torch_parallel.py` made (`_torch_mesh_prog.py`'s
IN.pkl) and writes what the JAX package computes from them on an N-device
virtual CPU mesh (`jax_num_cpu_devices` = N, fixed when the backend
starts, hence a fresh interpreter), each program through
`execute_mock_mpc_dealer(..., mesh=)` and each mirroring the calls of its
`_torch_mesh_prog.py` namesake.  The MODE picks the programs
(`programs`), each mode a process of its own so that none waits for
another's compilations:

  - main (the default): `sharded_mul_mac_step` for both parties beside
    the unsharded `beaver_mul_step` + `mac_check_fold` and
    `sharded_rlc_fold` beside the plain fold ("step"),
    `tests/_mesh_fabric_prog.py`'s honest program ("fabric") and the
    shared polynomials' part of the scalar operations ("poly");
  - ops: the scalar operations' other part ("ops");
  - view: the global view's programs ("view": indexing a shard with
    every index type and `shared_matmul` at the reference's shapes, whose
    products share four matmul compilations, `padded_mont_matmul`);
  - small: the small-batch programs (batches smaller than the mesh);
  - uneven: on a mesh of AT devices (default 2, which runs every such
    selection; the records do not depend on the mesh size, and one mesh
    shares its compilations), prefix_product of selections that a mesh
    size neither exceeds nor divides, and what meshes of AT and N devices
    refuse ("prefix"), and a traced circuit whose levels mix placements
    ("mixed");
  - points: the point protocols' program and the index program with its
    point batch (minutes of XLA compilation; the slow test's).

OUT.pkl is written again after each program, with the records so far, so
a process cut short leaves the records it finished.  A process of its own
also keeps the XLA compilations (a few GiB) out of the test worker.
"""

import functools
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DEV = int(sys.argv[1])

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", N_DEV)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import ark_mpc_tpu as ref  # noqa: E402
import ark_mpc_tpu.ops.matmul as ref_matmul  # noqa: E402
from ark_mpc_tpu.algebra import poly  # noqa: E402
from ark_mpc_tpu.algebra.curve import CurvePoint  # noqa: E402
from ark_mpc_tpu.algebra.point_share import PointShare  # noqa: E402
from ark_mpc_tpu.fabric import points  # noqa: E402
from ark_mpc_tpu.fabric.simulator import execute_mock_mpc_dealer  # noqa: E402
from ark_mpc_tpu.gadgets import prefix_product  # noqa: E402
from ark_mpc_tpu.models.circuits import inner_product, poly_eval, shared_matmul  # noqa: E402
from ark_mpc_tpu.parallel import step  # noqa: E402

ARRAYS = ("x", "y", "a", "b", "c")
MAT_DIMS = (8, 8, 3)  # as `_torch_mesh_prog.py`'s
POLY_T = 8


def scalar(arr):
    return ref.Scalar(jnp.asarray(np.asarray(arr).astype(np.uint32)))


def limbs(x) -> np.ndarray:
    return np.asarray(x.limbs).astype(np.uint32)


def step_refs(inp, mesh):
    x, y, a, b, c = (ref.ScalarShare(scalar(inp[k + "_s"]), scalar(inp[k + "_m"]))
                     for k in ARRAYS)
    d, e, key, cf = (scalar(inp[k]) for k in ("d", "e", "key", "coeffs"))
    out = {}
    for pid in (0, 1):
        z, folded = step.sharded_mul_mac_step(mesh, pid, x, y, a, b, c, d, e, key, cf)
        zu = step.beaver_mul_step(pid, x, y, a, b, c, d, e, key)
        fu = step.mac_check_fold(key, zu.share, zu.mac, cf)
        out[pid] = {"sharded": (limbs(z.share), limbs(z.mac), limbs(folded)),
                    "unsharded": (limbs(zu.share), limbs(zu.mac), limbs(fu))}
    t = scalar(inp["t"])
    out["rlc"] = (limbs(step.sharded_rlc_fold(mesh, t.limbs, cf.limbs)),
                  limbs((t * cf).sum()))
    return out


def honest_program(xs, ys):
    """`tests/_mesh_fabric_prog.py`'s honest program, returning what the
    port's gathers return."""
    n = len(xs)

    def prog(fabric):
        sx = fabric.share_values(ref.Scalar.from_ints(xs) if fabric.party_id == 0
                                 else None, sender=0, n=n)
        sy = fabric.share_values(ref.Scalar.from_ints(ys) if fabric.party_id == 1
                                 else None, sender=1, n=n)
        p = fabric.mul(sx, sy)
        inv = fabric.inverse(sy, defer_check=True)
        chk = fabric.mul(p, inv)
        o1 = fabric.open_authenticated(p, defer=True)
        o2 = fabric.open_authenticated(chk, defer=True)
        fabric.verify_deferred()
        return o1.to_ints(), o2.to_ints(), limbs(p.share), limbs(p.mac)

    return prog


def share_in(fabric, vals, sender):
    values = ref.Scalar.from_ints(vals) if fabric.party_id == sender else None
    return fabric.share_values(values, sender=sender, n=len(vals))


def ops_program(inp, part):
    """`_torch_mesh_prog.ops_program`'s calls for `part` ("ops" or "poly")
    in the same order, on global arrays; -> the same record."""

    def prog(fabric):
        x, y = share_in(fabric, inp["xs"], 0), share_in(fabric, inp["ys"], 1)
        if part == "poly":
            return finish_ops(fabric, poly_ops(fabric, inp), [])
        res = {"sum": x.sum()}
        x_open = fabric.open(x)
        res["sum_times_open"] = fabric.mul_public(res["sum"], x_open)
        res["sum_plus_open"] = fabric.add_public(res["sum"], x_open)
        res["inner_product"] = inner_product(fabric, x, y)
        tr = fabric.tracer()
        tx, ty = tr.wrap(x), tr.wrap(y)
        prod = tx * ty
        tsum = prod.sum()
        w = tx * prod.open().as_public() + tsum.open().as_public()
        handles = [tsum.open(), prod.open(), w.open()]
        res["traced_sum"], res["traced_w"] = tr.run(outputs=[tsum, w])
        m, k, n = MAT_DIMS
        a = share_in(fabric, inp["mat_a"][:m * k], 0).reshape(m, k)
        b = share_in(fabric, inp["mat_b"][:k * n], 1).reshape(k, n)
        res["shared_matmul"] = shared_matmul(fabric, a, b)
        res["pow"] = fabric.pow(x, 7)
        return finish_ops(fabric, res, handles)

    return prog


def poly_ops(fabric, inp) -> dict:
    """`_torch_mesh_prog.poly_ops`."""
    f, g = share_in(fabric, inp["poly_f"], 0), share_in(fabric, inp["poly_g"], 1)
    res = {"poly_eval": poly_eval(fabric, f, ref.Scalar.from_ints(inp["x_eval"]))}
    pf, pg = poly.AuthenticatedDensePoly(f), poly.AuthenticatedDensePoly(g)
    res["poly_mul"] = poly.poly_mul(fabric, pf, pg).coeffs
    res["poly_inverse_mod_t"] = poly.poly_inverse_mod_t(fabric, pf, POLY_T).coeffs
    res["poly_div"] = poly.poly_div(
        fabric, pf, poly.DensePoly.from_ints(inp["poly_h"])).coeffs
    return res


def finish_ops(fabric, res: dict, handles: list) -> dict:
    """`_torch_mesh_prog.finish_ops`."""
    opened = {name: fabric.open_authenticated(v, defer=True) for name, v in res.items()}
    fabric.verify_deferred()
    out = {name: (opened[name].to_ints(), limbs(v.share), limbs(v.mac))
           for name, v in res.items()}
    if handles:
        out["traced_opens"] = [h.value.to_ints() for h in handles]
    return out


def small_program(inp, n):
    """`_torch_mesh_prog.small_program`'s calls in the same order."""

    def prog(fabric):
        x, y = share_in(fabric, inp["small_xs"][:n], 0), share_in(fabric, inp["small_ys"][:n], 1)
        res = {"share": x, "mul": fabric.mul(x, y), "sum": x.sum(),
               "inner_product": inner_product(fabric, x, y)}
        opened = {name: fabric.open_authenticated(v, defer=True) for name, v in res.items()}
        if n == 1:
            pub = CurvePoint.generator((1,)).mul(ref.Scalar.from_ints(inp["gs"][:1]))
            sp = fabric.share_points(pub if fabric.party_id == 0 else None, sender=0, n=1)
            sp_open = fabric.open_authenticated_points(sp, defer=True)
        fabric.verify_deferred()
        out = {name: (opened[name].to_ints(), limbs(v.share), limbs(v.mac))
               for name, v in res.items()}
        if n == 1:
            x_aff, y_aff = sp_open.to_affine()
            out["share_points"] = ([x_aff.to_ints(), y_aff.to_ints()], point_limbs(sp.share),
                                   point_limbs(sp.mac))
        return out

    return prog


def prefix_program(inp, n):
    """`_torch_mesh_prog.prefix_program`'s calls in the same order."""

    def prog(fabric):
        x = share_in(fabric, inp["small_xs"][:n], 0)
        out = {}
        eager = prefix_product(fabric, x)
        opened = {"eager": fabric.open_authenticated(eager)}
        before = fabric.n_rounds
        tr = fabric.tracer()
        handle = prefix_product(fabric, tr.wrap(x)).open()
        (traced,) = tr.run(outputs=[handle.source])
        out["traced_rounds"] = fabric.n_rounds - before
        opened["traced"] = handle.value
        for name, v in (("eager", eager), ("traced", traced)):
            out[name] = (opened[name].to_ints(), limbs(v.share), limbs(v.mac))
        return out

    return prog


# as `_torch_mesh_prog.py`'s
SELECTIONS = (("0", lambda v: v[0]), ("-1", lambda v: v[-1]), ("1:3", lambda v: v[1:3]),
              ("::2", lambda v: v[::2]), ("reshape(2, -1)", lambda v: v.reshape(2, -1)))
MATMUL_SHAPES = ((1, 2, 1), (2, 2, 4), (1, 3, 1))
MASK = (True, False, True, True, False, True, False, False)
INDEX_TYPES = (("[0, 2, 5]", lambda v: v[[0, 2, 5]]),
               ("np.array([1, 6])", lambda v: v[np.array([1, 6])]),
               ("torch.tensor([7, 0])", lambda v: v[np.array([7, 0])]),
               ("mask", lambda v: v[np.array(MASK)]),
               (":7", lambda v: v[:7]),
               ("(4, 2)[1, 0]", lambda v: v.reshape(4, 2)[1, 0]),
               ("(4, 2)[:, 1]", lambda v: v.reshape(4, 2)[:, 1]),
               ("(4, 2)[[0, 3]]", lambda v: v.reshape(4, 2)[[0, 3]]))


def affine_ints(pt) -> list:
    x, y = pt.to_affine()
    return [x.to_ints(), y.to_ints()]


def index_program(inp, with_points: bool = False, types: bool = False):
    """`_torch_mesh_prog.index_program`'s calls in the same order, on
    global arrays (the placements and refusals are the port's alone), but
    the selections of the shared batch open as one concatenation (opens
    draw nothing, so the limbs are the same; fewer XLA compilations); the
    point batch's only `with_points` (minutes of XLA compilation: the
    `points` mode's).  With `types`, also "types": {name: (share limbs,
    MAC limbs)} of each of `INDEX_TYPES` (not opened: their values are the
    inputs' selections) and "refused": {kind: what a float index raised},
    from the same shared batch, which `_torch_mesh_prog.index_types_program`
    shares first too: the same limbs."""

    def prog(fabric):
        n = len(inp["xs"])
        x = share_in(fabric, inp["xs"], 0)
        x_open = fabric.open(x)
        shares = {name: sel(x) for name, sel in SELECTIONS}
        opens = {name: sel(x_open) for name, sel in SELECTIONS}
        cat = ref.ScalarShare.concatenate([v.reshape(v.size) for v in shares.values()])
        opened_cat = fabric.open_authenticated(cat, defer=True)
        if with_points:
            pub = CurvePoint.generator((n,)).mul(ref.Scalar.from_ints(inp["gs"]))
            sp = fabric.share_points(pub if fabric.party_id == 0 else None, sender=0, n=n)
            points = {name: sel(sp) for name, sel in SELECTIONS}
            flat = [v.reshape(v.size) for v in points.values()]
            p_opened = fabric.open_authenticated_points(PointShare.concatenate(flat),
                                                        defer=True)
        fabric.verify_deferred()
        out = {"share": {}, "points": {}, "open": {}}
        if types:
            out["types"] = {name: (limbs(v.share), limbs(v.mac))
                            for name, v in ((name, sel(x)) for name, sel in INDEX_TYPES)}
            out["refused"] = {kind: raised_by(lambda: v[1.5])
                              for kind, v in (("share", x), ("open", x_open))}
        xs, ys = affine_ints(p_opened) if with_points else ([], [])
        values, at = opened_cat.to_ints(), 0
        for name, v in shares.items():
            k = v.size
            out["share"][name] = (values[at:at + k], limbs(v.share), limbs(v.mac))
            out["open"][name] = opens[name].to_ints()
            if with_points:
                p = points[name]
                out["points"][name] = ([xs[at:at + k], ys[at:at + k]], point_limbs(p.share),
                                       point_limbs(p.mac))
            at += k
        return out

    return prog


def matmul_program(inp, shape):
    """`_torch_mesh_prog.matmul_program`'s calls (but the placement)."""
    m, k, n = shape

    def prog(fabric):
        a = share_in(fabric, inp["mat_a"][:m * k], 0).reshape(m, k)
        b = share_in(fabric, inp["mat_b"][:k * n], 1).reshape(k, n)
        c = shared_matmul(fabric, a, b)
        opened = fabric.open_authenticated(c, defer=True)
        fabric.verify_deferred()
        return opened.to_ints(), limbs(c.share), limbs(c.mac)

    return prog


def raised_by(fn) -> str:
    """-> "TypeName: message" of what `fn()` raised, or "no error"."""
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - the test reads the type and text
        return f"{type(err).__name__}: {err}"
    return "no error"


def raised(prog, mesh) -> str:
    """-> "TypeName: message" of what `prog` raised on `mesh`."""
    return raised_by(lambda: execute_mock_mpc_dealer(prog, mesh=mesh))


def padded_mont_matmul(spec, a, b, shape=MAT_DIMS):
    """The JAX package's `mont_matmul` of a (16, m, k) @ (16, k, n) with m
    and k at most `shape`'s: its operands zero-padded to `shape`, in blocks
    of its n columns, so that every product reuses `ops_program`'s four
    compilations of that shape (one an argument sharding).  Each entry's
    limbs are the same: every step after the integer contraction is
    element-wise over (m, n), and the padding adds zero terms."""
    (big_m, big_k, big_n), (m, k, n) = shape, (a.shape[1], a.shape[2], b.shape[2])
    if m > big_m or k > big_k or (m, k, n) == shape:
        return _MONT_MATMUL(spec, a, b)
    a = jnp.pad(a, ((0, 0), (0, big_m - m), (0, big_k - k)))
    blocks = []
    for j in range(0, n, big_n):
        bj = b[:, :, j:j + big_n]
        bj = jnp.pad(bj, ((0, 0), (0, big_k - k), (0, big_n - bj.shape[2])))
        blocks.append(_MONT_MATMUL(spec, a, bj)[:, :m, :min(big_n, n - j)])
    return blocks[0] if len(blocks) == 1 else jnp.concatenate(blocks, axis=2)


_MONT_MATMUL = ref_matmul.mont_matmul


def global_view_records(inputs, mesh) -> dict:
    """The global view's programs on `mesh` (`_torch_mesh_prog`'s
    `case_index` with `case_index_types`' selections, and
    `case_matmul_shapes`: each shape the mesh takes, its
    products through `padded_mont_matmul`, onto the compilations of the
    ops program's shape), and what a 2-device mesh makes
    of (1, 3) @ (3, 1): the error's "TypeName: message"."""
    shapes = [s for s in MATMUL_SHAPES if mesh.size > 3 or s != (1, 3, 1)]
    ref_matmul.mont_matmul = padded_mont_matmul
    try:
        matmul = {s: execute_mock_mpc_dealer(matmul_program(inputs, s), mesh=mesh)
                  for s in shapes}
    finally:
        ref_matmul.mont_matmul = _MONT_MATMUL
    index = execute_mock_mpc_dealer(index_program(inputs, types=True), mesh=mesh)
    types = [{key: rec.pop(key) for key in ("types", "refused")} for rec in index]
    return {"index": index, "index_types": types, "matmul": matmul,
            "matmul_131_on_2": raised(matmul_program(inputs, (1, 3, 1)), step.make_mesh(2))}


def single_value(fabric):
    """`_torch_mesh_prog.single_value`."""
    x = fabric.share_values(ref.Scalar.from_ints(5) if fabric.party_id == 0 else None,
                            sender=0, n=1)
    opened = fabric.open_authenticated(x.reshape(1))
    return opened.to_ints(), limbs(x.share), limbs(x.mac)


def small_records(inputs, mesh) -> dict:
    """The small-batch programs on `mesh` (`_torch_mesh_prog`'s
    `case_small_one`, `case_small_three`, `case_prefix_small` and
    `single_value`), and what a 2-device mesh makes of the 3-element
    batch: the error's "TypeName: message"."""
    out = {"one": execute_mock_mpc_dealer(small_program(inputs, 1), mesh=mesh),
           "three": execute_mock_mpc_dealer(small_program(inputs, 3), mesh=mesh),
           "prefix": {n: execute_mock_mpc_dealer(prefix_program(inputs, n), mesh=mesh)
                      for n in (2, 3)},
           "single_value": execute_mock_mpc_dealer(single_value, mesh=mesh)}
    out["three_on_2"] = raised(small_program(inputs, 3), step.make_mesh(2))
    return out


MIXED_SHIFTS = (1, 2, 3)  # as the port's
MIXED_NAMES = ("prod", "sums", "x_inverse", "prod_inverse", "sums_inverse") + tuple(
    f"(sums + {k})_inverse" for k in MIXED_SHIFTS)


def mixed_program(inp):
    """`_torch_mesh_prog.mixed_program`'s calls."""

    def prog(fabric):
        tr = fabric.tracer()
        tx, ty = tr.wrap(share_in(fabric, inp["xs"], 0)), tr.wrap(share_in(fabric, inp["ys"], 1))
        sums = tx.sum() * ty.sum()
        prod = tx * ty
        outs = [prod, sums, tx.inverse(), prod.inverse(), sums.inverse()]
        outs += [(sums + ref.Scalar.from_ints(k)).inverse() for k in MIXED_SHIFTS]
        handles = [v.open() for v in outs]
        before = fabric.n_rounds
        res = tr.run(outputs=outs)
        rounds = fabric.n_rounds - before
        return {name: (h.value.to_ints(), limbs(v.share), limbs(v.mac))
                for name, h, v in zip(MIXED_NAMES, handles, res)}, rounds

    return prog


PREFIX_SELECTIONS = (3, 5, 7, 8)


def prefix_selection_program(inp, n):
    """`_torch_mesh_prog.prefix_selection_program`'s calls."""

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
            out[name] = (opened[name].to_ints(), limbs(v.share), limbs(v.mac))
        return out

    return prog


def prefix_records(inputs, at, mesh) -> dict:
    """`prefix_selection_program` at each n of `PREFIX_SELECTIONS` that the
    mesh `at` runs, there, and what the meshes `at` and `mesh` make of
    each n they refuse and of an input batch of 9: -> {"records": {n: both
    parties' records}, "refused": {(size, n or "share 9"): "TypeName:
    message"}}."""
    out = {"records": {}, "refused": {}}
    for m in {at.size: at, mesh.size: mesh}.values():
        for n in PREFIX_SELECTIONS:
            if n + 1 >= m.size and (n + 1) % m.size:  # `_place` refuses its pairs
                out["refused"][(m.size, n)] = raised(prefix_selection_program(inputs, n), m)
            elif n not in out["records"]:
                out["records"][n] = execute_mock_mpc_dealer(
                    prefix_selection_program(inputs, n), mesh=m)
        out["refused"][(m.size, "share 9")] = raised(
            lambda f: share_in(f, inputs["xs"] + [1], 0), m)
    return out


def point_limbs(pt) -> np.ndarray:
    return np.stack([limbs(c) for c in (pt.X, pt.Y, pt.Z, pt.T)])


def points_program(inp, part=None):
    """`_torch_mesh_prog.points_program`'s calls in the same order (but the
    port's own share_public_points)."""
    gs, ks = inp["gs"], inp["ks"]

    def prog(fabric):
        n = len(gs)
        pub = CurvePoint.generator((n,)).mul(ref.Scalar.from_ints(gs))
        sp = fabric.share_points(pub if fabric.party_id == 0 else None, sender=0, n=n)
        sk = share_in(fabric, ks, 1)
        res = {}
        if part in (None, "elementwise"):
            res.update(share_points=sp, mul_generator=fabric.mul_generator(sk),
                       mul_public_point=points.mul_public_point(sk, pub),
                       beaver_mul_points=fabric.mul_points(sk, sp))
        if part in (None, "sums"):
            res.update(msm_authenticated=fabric.msm(sk, sp).reshape(1),
                       msm_public_points=points.msm_public_points(sk, pub).reshape(1))
        opened = {k: fabric.open_authenticated_points(v, defer=True) for k, v in res.items()}
        fabric.verify_deferred()
        out = {}
        for name, v in res.items():
            x, y = opened[name].to_affine()
            out[name] = ([x.to_ints(), y.to_ints()], point_limbs(v.share), point_limbs(v.mac))
        return out

    return prog


def programs(mode: str, inputs, mesh, at) -> dict:
    """{key: a function computing its record} of `mode`, in order (the
    modes and keys of `test_torch_parallel.JAX_MODES`); the uneven
    programs run on the mesh `at`."""
    run = functools.partial(execute_mock_mpc_dealer, mesh=mesh)
    if mode == "points":
        return {"points": lambda: {part: run(points_program(inputs, part))
                                   for part in ("elementwise", "sums")},
                "index": lambda: run(index_program(inputs, with_points=True))}
    return {
        "main": {"step": lambda: step_refs(inputs, mesh),
                 "fabric": lambda: run(honest_program(inputs["xs"], inputs["ys"])),
                 "poly": lambda: run(ops_program(inputs, "poly"))},
        "ops": {"ops": lambda: run(ops_program(inputs, "ops"))},
        "view": {"view": lambda: global_view_records(inputs, mesh)},
        "small": {"small": lambda: small_records(inputs, mesh)},
        "uneven": {"prefix": lambda: prefix_records(inputs, at, mesh),
                   "mixed": lambda: run(mixed_program(inputs), mesh=at)},
    }[mode]


def write(record: dict, path: str) -> None:
    """`record` to `path` whole or not at all (a reader never sees half a
    file)."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(record, fh)
    os.replace(tmp, path)


if __name__ == "__main__":
    with open(sys.argv[2], "rb") as fh:
        inputs = pickle.load(fh)
    assert len(jax.devices()) == N_DEV, jax.devices()
    mesh = step.make_mesh(N_DEV)
    at = step.make_mesh(int(sys.argv[5]) if sys.argv[5:] else 2)
    out = {}
    for key, compute in programs(sys.argv[4] if sys.argv[4:] else "main", inputs, mesh,
                                 at).items():
        out[key] = compute()
        write(out, sys.argv[3])  # each key as soon as it is known
        print(f"JAX_MESH_REF_KEY {key}", flush=True)
    print(f"JAX_MESH_REF_OK {N_DEV}")
