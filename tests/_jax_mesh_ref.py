"""Subprocess body for the JAX side of the port's mesh tests.

    python tests/_jax_mesh_ref.py IN.pkl OUT.pkl

reads the inputs `test_torch_parallel.py` made (`_torch_mesh_prog.py`'s
IN.pkl) and writes what the JAX package computes from them on a one-device
CPU mesh: `sharded_mul_mac_step` for both parties beside the unsharded
`beaver_mul_step` + `mac_check_fold`, `sharded_rlc_fold` beside the plain
fold, and `tests/_mesh_fabric_prog.py`'s honest program through
`execute_mock_mpc_dealer(..., mesh=)`.  It runs in a process of its own so
that the XLA compilations (about 2 GiB) do not stay in the test worker.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import ark_mpc_tpu as ref  # noqa: E402
from ark_mpc_tpu.fabric.simulator import execute_mock_mpc_dealer  # noqa: E402
from ark_mpc_tpu.parallel import step  # noqa: E402

ARRAYS = ("x", "y", "a", "b", "c")


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


if __name__ == "__main__":
    with open(sys.argv[1], "rb") as fh:
        inputs = pickle.load(fh)
    mesh = step.make_mesh(1)
    out = {"step": step_refs(inputs, mesh),
           "fabric": execute_mock_mpc_dealer(honest_program(inputs["xs"], inputs["ys"]),
                                             mesh=mesh)}
    with open(sys.argv[2], "wb") as fh:
        pickle.dump(out, fh)
    print("JAX_MESH_REF_OK")
