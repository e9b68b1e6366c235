"""Multi-rank dry run: the counterpart of `__graft_entry__.dryrun_multichip`.

    python -m ark_mpc_tpu_torch.parallel --dryrun 4

spawns N gloo ranks on the CPU (the reference runs a virtual N-device CPU
mesh) and runs, on each:

  1. the sharded step at batch 8 N: `sharded_mul_mac_step` on the rank's
     shard of party 0's example batch; the gathered product and the fold
     must equal the unsharded `beaver_mul_step` + `mac_check_fold`;
  2. the mesh-attached fabric's traced program: input sharing, a traced
     circuit (x*y and (x*y + x)*y in fused levels), the folded deferred
     check; the gathered opens must equal Python ints;
  3. the sharded offline stage: U = N ciphertexts of BGV over l at the
     default ring, split over the ranks along U, a ct x pt product each,
     decrypted and decoded; every slot product must equal Python ints.

Prints one line `dryrun_multichip OK: N ranks ...` and exits 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..algebra.fields import SCALAR_FIELD
from ..algebra.scalar import Scalar
from ..fabric.simulator import execute_mock_mpc_dealer
from ..offline import bgv
from ..offline.base import TrustedDealerSource
from .launch import launch
from .step import (
    batch_sharding,
    beaver_mul_step,
    gather,
    mac_check_fold,
    replicate,
    shard,
    shard_share,
    sharded_mul_mac_step,
)

L = SCALAR_FIELD.modulus


def example_batch(n: int, seed: int = 0, device="cpu"):
    """Party 0's inputs for a batch of n Beaver products, drawn as
    `__graft_entry__._example_batch` draws them (the same values)."""
    src = TrustedDealerSource(0, seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    x = src._mine(src._deal(Scalar.random(n, rng, device=device)))
    y = src._mine(src._deal(Scalar.random(n, rng, device=device)))
    a, b, c = src.next_triplet_batch(n)
    d = Scalar.random(n, rng, device=device)
    e = Scalar.random(n, rng, device=device)
    coeffs = Scalar.random(n, rng, device=device)
    return x, y, a, b, c, d, e, src.get_mac_key_share(), coeffs


def sharded_step(mesh, n: int):
    """-> (gathered z, fold) of the sharded step, checked against the
    unsharded one on the same inputs."""
    x, y, a, b, c, d, e, key, coeffs = example_batch(n, device=mesh.device)
    shards = [shard_share(s, mesh) for s in (x, y, a, b, c)]
    z, folded = sharded_mul_mac_step(mesh, 0, *shards, shard(d, mesh), shard(e, mesh),
                                     replicate(key, mesh), shard(coeffs, mesh))
    z = gather(z, mesh)
    want = beaver_mul_step(0, x, y, a, b, c, d, e, key)
    want_fold = mac_check_fold(key, want.share, want.mac, coeffs)
    if not (torch.equal(z.share.limbs, want.share.limbs)
            and torch.equal(z.mac.limbs, want.mac.limbs)
            and torch.equal(folded.limbs, want_fold.limbs)):
        raise RuntimeError("sharded step differs from the unsharded one")
    return z, folded


def traced_program(xs: list, ys: list):
    n = len(xs)

    def prog(fabric):
        dev = fabric.device
        sx = fabric.share_values(Scalar.from_ints(xs, device=dev)
                                 if fabric.party_id == 0 else None, sender=0, n=n)
        sy = fabric.share_values(Scalar.from_ints(ys, device=dev)
                                 if fabric.party_id == 1 else None, sender=1, n=n)
        tr = fabric.tracer()
        xv, yv = tr.wrap(sx), tr.wrap(sy)
        p = xv * yv
        q = (p + xv) * yv
        op, oq = p.open(), q.open()
        tr.run()  # verify_deferred: folded by default on a mesh
        return (gather(op.value, fabric.mesh).to_ints(),
                gather(oq.value, fabric.mesh).to_ints())

    return prog


def sharded_ct_x_pt(mesh, ring, u: int, seed: int = 5) -> int:
    """U ciphertexts split over the ranks along U: each rank encrypts its
    slot batches, multiplies by its plaintexts, decrypts and decodes; every
    slot must equal x*y mod l.  One key pair (the same seed on every rank).
    -> the ciphertexts this rank multiplied."""
    dev = mesh.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kp = bgv.keygen_l(ring, gen)
    rng = np.random.default_rng(seed)
    a = shard(Scalar.random((u, ring.slots), rng, device=dev), mesh)
    b = shard(Scalar.random((u, ring.slots), rng, device=dev), mesh)
    gen.manual_seed(1 + mesh.rank)  # encryption randomness of this rank
    ct = bgv.encrypt_l(ring, kp.pk_a, kp.pk_b, bgv.encode_slots_l(ring, a), gen)
    prod = bgv.mul_pt_l(ring, ct, bgv.encode_slots_l(ring, b))
    got = bgv.decode_slots_l(ring, bgv.decrypt_l(ring, kp.sk, prod)).to_ints()
    want = [(x * y) % L for x, y in zip(a.to_ints(), b.to_ints())]
    if got != want:
        raise RuntimeError(f"rank {mesh.rank}: sharded ct x pt slot products differ")
    return a.shape[0]


def _rank(mesh, n_ranks: int) -> str:
    n = 8 * n_ranks
    z, folded = sharded_step(mesh, n)

    rng = np.random.default_rng(3)
    xs = [int(v) for v in rng.integers(1, 1 << 62, n)]
    ys = [int(v) for v in rng.integers(1, 1 << 62, n)]
    (p0, q0), (p1, q1) = execute_mock_mpc_dealer(traced_program(xs, ys), mesh=mesh)
    want_p = [(a * b) % L for a, b in zip(xs, ys)]
    want_q = [((p + a) * b) % L for p, a, b in zip(want_p, xs, ys)]
    if not (p0 == p1 == want_p and q0 == q1 == want_q):
        raise RuntimeError("mesh fabric program differs from Python ints")

    held = torch.tensor([sharded_ct_x_pt(mesh, bgv.default_ring(device=mesh.device),
                                         n_ranks)])
    counts = [torch.zeros_like(held) for _ in range(mesh.size)]
    dist.all_gather(counts, held, group=mesh.group)
    n_shards = sum(int(c.item() > 0) for c in counts)
    cols = batch_sharding(mesh, n)
    return (f"dryrun_multichip OK: {n_ranks} ranks ({dist.get_backend(mesh.group)}), "
            f"batch {n} (rank {mesh.rank} holds {cols.start}:{cols.stop}), "
            f"z shape {tuple(z.shape)}, fold shape {tuple(folded.shape)}, "
            f"fabric program (share -> traced circuit -> folded deferred check) OK, "
            f"offline ct*pt stack sharded over {n_shards} ranks OK")


def dryrun_multichip(n_ranks: int, timeout: float = 600.0) -> str:
    """Run the dry run on `n_ranks` gloo CPU ranks; -> rank 0's line."""
    return launch(_rank, n_ranks, n_ranks, device="cpu", timeout=timeout)[0]
