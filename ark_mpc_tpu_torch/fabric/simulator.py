"""In-process two-party MPC simulator.

Counterpart of `ark_mpc_tpu/fabric/simulator.py`: run the same closure for
both parties over an in-memory lockstep transport with mock preprocessing,
return both results.  Parties run on two OS threads, one at a time.  On a
mesh every rank calls it: each rank runs both parties over its own
transport, and each party's fabric gets its own party group's mesh.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from ..device import resolve_device
from ..offline.base import PartyIDBeaverSource, TrustedDealerSource
from .context import MpcFabric
from .transport import LockstepTransport


def execute_mock_mpc(f, offline_factory=None, seed: int | None = None,
                     device=None, mesh=None):
    """Run `f(fabric)` for both parties in-process; return (res0, res1).

    `offline_factory(party_id) -> PreprocessingPhase` defaults to
    `PartyIDBeaverSource` on `device`.  `device` (default: the CUDA card)
    is where both fabrics keep their shares (default on a mesh: the mesh's).
    `mesh` (`parallel.step.make_mesh`) attaches party p's fabric to
    `mesh.party(p)`.  Exceptions from either party propagate (first one
    raised wins)."""
    device = resolve_device(mesh.device if device is None and mesh is not None
                            else device)
    if offline_factory is None:
        def offline_factory(pid):
            return PartyIDBeaverSource(pid, device=device)
    t0, t1 = LockstepTransport.pair()
    transports = [t0, t1]
    sched = t0._sched
    results = [None, None]
    errors = [None, None]

    def run(pid):
        failed = False
        try:
            sched.acquire(pid)  # lockstep: party 1 waits for the baton
            base = 1000 + pid if seed is None else seed + pid
            # each rank pair's coins and blinders must be its own
            rng = np.random.default_rng(base if mesh is None else (base, mesh.rank))
            fabric = MpcFabric(pid, transports[pid], offline_factory(pid),
                               rng=rng, device=device,
                               mesh=None if mesh is None else mesh.party(pid))
            results[pid] = f(fabric)
        except BaseException as e:  # noqa: BLE001 - surfaced to caller below
            errors[pid] = e
            failed = True
        finally:
            sched.finish(pid, failed=failed)

    threads = [threading.Thread(target=run, args=(pid,), daemon=True)
               for pid in (0, 1)]
    for t in threads:
        t.start()
    timeout = float(os.environ.get("ARK_MPC_MOCK_TIMEOUT", "900"))
    for t in threads:
        t.join(timeout=timeout)
    if any(t.is_alive() for t in threads):
        raise TimeoutError(
            f"mock MPC did not finish within {timeout:.0f}s "
            "(raise ARK_MPC_MOCK_TIMEOUT for long runs)")
    # Prefer the root-cause error: a party that died mid-protocol makes the
    # peer fail with a secondary ConnectionError.
    real = [e for e in errors if e is not None and not isinstance(e, ConnectionError)]
    secondary = [e for e in errors if isinstance(e, ConnectionError)]
    if real:
        raise real[0]
    if secondary:
        raise secondary[0]
    return results[0], results[1]


def execute_mock_mpc_dealer(f, seed: int = 7, device=None, mesh=None):
    """Mock MPC with randomized honest-dealer preprocessing on `device`; on
    a mesh every rank holds the same dealer and draws its slice of it."""
    device = resolve_device(mesh.device if device is None and mesh is not None
                            else device)
    return execute_mock_mpc(
        f, offline_factory=lambda pid: TrustedDealerSource(pid, seed=seed,
                                                           device=device),
        device=device, mesh=mesh,
    )
