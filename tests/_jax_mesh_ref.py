"""Subprocess body for the JAX side of the port's mesh tests.

    python tests/_jax_mesh_ref.py N IN.pkl OUT.pkl [points]

reads the inputs `test_torch_parallel.py` made (`_torch_mesh_prog.py`'s
IN.pkl) and writes what the JAX package computes from them on an N-device
virtual CPU mesh (`jax_num_cpu_devices` = N, fixed when the backend
starts, hence a fresh interpreter): `sharded_mul_mac_step` for both parties
beside the unsharded `beaver_mul_step` + `mac_check_fold`,
`sharded_rlc_fold` beside the plain fold, `tests/_mesh_fabric_prog.py`'s
honest program and the scalar operations' program (`ops_program`, the
calls of `_torch_mesh_prog.ops_program` in the same order), each through
`execute_mock_mpc_dealer(..., mesh=)`.  With `points` it runs the point
protocols' program (`_torch_mesh_prog.points_program`) alone.  It runs in
a process of its own so that the XLA compilations (a few GiB) do not stay
in the test worker.
"""

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
from ark_mpc_tpu.algebra import poly  # noqa: E402
from ark_mpc_tpu.algebra.curve import CurvePoint  # noqa: E402
from ark_mpc_tpu.fabric import points  # noqa: E402
from ark_mpc_tpu.fabric.simulator import execute_mock_mpc_dealer  # noqa: E402
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


def ops_program(inp):
    """`_torch_mesh_prog.ops_program`'s calls in the same order, on global
    arrays; -> the same record."""

    def prog(fabric):
        x, y = share_in(fabric, inp["xs"], 0), share_in(fabric, inp["ys"], 1)
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
        f, g = share_in(fabric, inp["poly_f"], 0), share_in(fabric, inp["poly_g"], 1)
        res["poly_eval"] = poly_eval(fabric, f, ref.Scalar.from_ints(inp["x_eval"]))
        pf, pg = poly.AuthenticatedDensePoly(f), poly.AuthenticatedDensePoly(g)
        res["poly_mul"] = poly.poly_mul(fabric, pf, pg).coeffs
        res["poly_inverse_mod_t"] = poly.poly_inverse_mod_t(fabric, pf, POLY_T).coeffs
        res["poly_div"] = poly.poly_div(
            fabric, pf, poly.DensePoly.from_ints(inp["poly_h"])).coeffs
        opened = {name: fabric.open_authenticated(v, defer=True) for name, v in res.items()}
        fabric.verify_deferred()
        out = {name: (opened[name].to_ints(), limbs(v.share), limbs(v.mac))
               for name, v in res.items()}
        out["traced_opens"] = [h.value.to_ints() for h in handles]
        return out

    return prog


def point_limbs(pt) -> np.ndarray:
    return np.stack([limbs(c) for c in (pt.X, pt.Y, pt.Z, pt.T)])


def points_program(inp):
    """`_torch_mesh_prog.points_program`'s calls in the same order."""
    gs, ks = inp["gs"], inp["ks"]

    def prog(fabric):
        n = len(gs)
        pub = CurvePoint.generator((n,)).mul(ref.Scalar.from_ints(gs))
        sp = fabric.share_points(pub if fabric.party_id == 0 else None, sender=0, n=n)
        sk = share_in(fabric, ks, 1)
        res = {"share_points": sp, "mul_generator": fabric.mul_generator(sk),
               "mul_public_point": points.mul_public_point(sk, pub),
               "beaver_mul_points": fabric.mul_points(sk, sp),
               "msm_authenticated": fabric.msm(sk, sp).reshape(1),
               "msm_public_points": points.msm_public_points(sk, pub).reshape(1)}
        opened = {k: fabric.open_authenticated_points(v, defer=True) for k, v in res.items()}
        fabric.verify_deferred()
        out = {}
        for name, v in res.items():
            x, y = opened[name].to_affine()
            out[name] = ([x.to_ints(), y.to_ints()], point_limbs(v.share), point_limbs(v.mac))
        return out

    return prog


if __name__ == "__main__":
    with open(sys.argv[2], "rb") as fh:
        inputs = pickle.load(fh)
    assert len(jax.devices()) == N_DEV, jax.devices()
    mesh = step.make_mesh(N_DEV)
    if sys.argv[4:] == ["points"]:
        out = {"points": execute_mock_mpc_dealer(points_program(inputs), mesh=mesh)}
    else:
        out = {"step": step_refs(inputs, mesh),
               "fabric": execute_mock_mpc_dealer(
                   honest_program(inputs["xs"], inputs["ys"]), mesh=mesh),
               "ops": execute_mock_mpc_dealer(ops_program(inputs), mesh=mesh)}
    with open(sys.argv[3], "wb") as fh:
        pickle.dump(out, fh)
    print(f"JAX_MESH_REF_OK {N_DEV}")
