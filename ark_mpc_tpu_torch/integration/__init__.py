"""Registered two-party integration cases over a real transport.

Counterpart of `ark_mpc_tpu/integration/`: each case registers with the
`@integration_test` decorator and receives a live `MpcFabric`; one driver
process pair (`python -m ark_mpc_tpu_torch.integration`) runs the whole
registry, one case after another, over a single TCP connection, the
malicious-abort cases included (both parties must see
`AuthenticationError`).  The fabric carries nothing from one case to the
next but the deferred-check accumulators, which every case drains.
"""

from __future__ import annotations

import traceback
from typing import Callable

REGISTRY: dict[str, Callable] = {}


def integration_test(fn: Callable | None = None, *, name: str | None = None):
    """Register a two-party case `f(fabric) -> None`, raising on failure.
    Both parties run the same body; inputs that depend on the party come
    from `fabric.party_id`."""

    def deco(f):
        REGISTRY[name or f.__name__] = f
        return f

    return deco(fn) if fn is not None else deco


def slow_integration_test(fn: Callable):
    """Register a case that runs only when named in `only` (`--tests`)."""
    fn.__slow__ = True
    return integration_test(fn)


def run_registry(fabric, only: list[str] | None = None,
                 log=None) -> dict[str, str]:
    """Run every registered case against `fabric` in sorted-name order (both
    parties iterate alike).  -> {name: "ok" | "FAIL: ..."}; a transport
    failure ends the run (the wire is dead)."""
    from . import cases  # noqa: F401  (importing it fills REGISTRY)

    results: dict[str, str] = {}
    for name in sorted(REGISTRY):
        if only and name not in only:
            continue
        if not only and getattr(REGISTRY[name], "__slow__", False):
            continue
        if log:
            log(f"[party {fabric.party_id}] {name} ...")
        try:
            REGISTRY[name](fabric)
            results[name] = "ok"
        except ConnectionError:
            results[name] = "FAIL: transport died"
            raise
        except Exception:  # noqa: BLE001 - the case's failure is its result
            results[name] = "FAIL: " + traceback.format_exc(limit=3)
        # a failed case may leave deferred checks behind; both parties saw
        # the same failure, so both drop them and stay in step
        fabric._deferred.clear()
        fabric._deferred_points.clear()
    return results
