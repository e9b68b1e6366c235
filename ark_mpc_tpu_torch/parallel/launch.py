"""Start the ranks of a mesh: one process per device.

`launch(fn, n, *args)` spawns n processes; rank r joins an n-rank process
group (NCCL on cuda:r, or gloo with `device="cpu"`), builds the mesh with
`make_mesh` and returns `fn(mesh, *args)` to the caller.  The ranks meet
through a file store in a fresh temporary directory, not a fixed port, so
concurrent launches (parallel test workers) never collide.  `run_rank` is
one rank's whole life, for a caller that is itself rank 0 of a one-rank
mesh.  A rank says what it is doing with `note` (a case's name, say): a
launch that times out or loses a rank names each rank's last note and how
long ago it was made.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import resolve_device
from .step import make_mesh

_NOTE_PATH = None  # this rank's note file, where `launch` started the process


def note(text: str) -> None:
    """Record what this rank is doing now; a launch that times out or
    loses a rank reports each rank's last note.  A no-op in a process
    `launch` did not start."""
    if _NOTE_PATH is None:
        return
    tmp = _NOTE_PATH + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, _NOTE_PATH)


def _notes(store_path: str, n_ranks: int) -> str:
    """Each rank's last note and its age, one line a rank."""
    now, lines = time.time(), []
    for r in range(n_ranks):
        path = f"{store_path}.note{r}"
        try:
            with open(path) as fh:
                text = fh.read()
            age = f" ({now - os.path.getmtime(path):.0f} s ago)"
        except OSError:
            text, age = "no note (not started, or no case begun)", ""
        lines.append(f"  rank {r}: {text}{age}")
    return "\n".join(lines)


def run_rank(fn, rank: int, n_ranks: int, store_path: str, device_type: str,
             args: tuple = (), timeout: float = 600.0):
    """Join the process group as `rank`, run `fn(mesh, *args)`, wait for
    every rank to finish it, leave the group; -> fn's result.  A collective
    that waits longer than `timeout` seconds raises.  A gloo rank computes
    with one intra-op thread: its work is a stream of small operations,
    which more threads slow down wherever other work loads the host."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        backend, device = "nccl", torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        backend, device = "gloo", torch.device("cpu")
    dist.init_process_group(backend, store=dist.FileStore(store_path, n_ranks),
                            rank=rank, world_size=n_ranks,
                            timeout=timedelta(seconds=timeout),
                            device_id=device if backend == "nccl" else None)
    try:
        mesh = make_mesh(n_ranks, device=device)
        result = fn(mesh, *args)
        dist.barrier()
        return result
    finally:
        dist.destroy_process_group()


def _rank_main(fn, rank, n_ranks, store_path, device_type, args, timeout, results):
    global _NOTE_PATH
    _NOTE_PATH = f"{store_path}.note{rank}"
    try:
        out = run_rank(fn, rank, n_ranks, store_path, device_type, args, timeout)
    except BaseException:  # noqa: BLE001 - reported to the parent, then exit 1
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def launch(fn, n_ranks: int, *args, device=None, timeout: float = 600.0) -> list:
    """Run `fn(mesh, *args)` on `n_ranks` spawned ranks; -> their results by
    rank.  `device` (default: the CUDA cards, rank r on cuda:r) or "cpu" for
    gloo ranks.  `fn` must be importable by name and its arguments and
    result picklable.  If a rank raises or dies, the others are terminated
    and `RuntimeError` carries its traceback; if the ranks are not done
    within `timeout` seconds, `TimeoutError`; either names each rank's
    last `note`.  Every process is stopped before this returns."""
    device_type = resolve_device(device).type
    if device_type == "cuda" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"{n_ranks} ranks need {n_ranks} CUDA cards (NCCL takes "
                         f"one rank a card); this host has {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="ark-mesh-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n_ranks, store, device_type, args,
                                   timeout, results))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n_ranks:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if not dead:
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"the {n_ranks}-rank mesh did not finish within "
                                f"{timeout:.0f} s; each rank's last note:\n"
                                f"{_notes(store, n_ranks)}") from None
                        continue
                    try:  # a failing rank reports before it exits
                        rank, ok, payload = results.get(timeout=2)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"mesh rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result; each "
                            f"rank's last note:\n{_notes(store, n_ranks)}") from None
                if not ok:
                    raise RuntimeError(f"mesh rank {rank} failed; each rank's last "
                                       f"note:\n{_notes(store, n_ranks)}\n{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10 if len(out) == n_ranks else 0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(n_ranks)]
