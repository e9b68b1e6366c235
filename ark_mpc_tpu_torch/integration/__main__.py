"""Run the registered two-party cases over one TCP connection.

    python -m ark_mpc_tpu_torch.integration --party 1 --port 9600 &
    python -m ark_mpc_tpu_torch.integration --party 0 --port 9600

Party 1 listens, party 0 dials.  Shares live on `--device` (default: the
CUDA card; `--device cpu` runs without one).  TLS 1.3 is on unless
`--no-tls` is given.  Prints one JSON line {case: "ok" | "FAIL: ..."} and
exits non-zero if any case failed.
"""

from __future__ import annotations

import argparse
import json
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--party", type=int, required=True, choices=[0, 1])
    ap.add_argument("--port", type=int, default=9600)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--tests", default="", help="comma-separated subset of case names")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", default=None,
                    help="where shares live (default: the CUDA card)")
    ap.add_argument("--no-tls", action="store_true", help="plaintext TCP")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args()

    from ark_mpc_tpu_torch import MpcFabric, TcpTransport, TrustedDealerSource
    from ark_mpc_tpu_torch.device import resolve_device
    from ark_mpc_tpu_torch.integration import run_registry

    def log(*a):
        if not args.quiet:
            print(*a, file=sys.stderr, flush=True)

    device = resolve_device(args.device)
    transport = TcpTransport(args.party, args.host, args.port,
                             timeout=args.timeout, tls=not args.no_tls)
    try:
        fabric = MpcFabric(args.party, transport,
                           TrustedDealerSource(args.party, seed=2026, device=device),
                           device=device)
        only = [t for t in args.tests.split(",") if t] or None
        results = run_registry(fabric, only=only, log=log)
    finally:
        transport.close()

    print(json.dumps(results), flush=True)
    failed = [k for k, v in results.items() if v != "ok"]
    if failed:
        log(f"party {args.party}: {len(failed)} FAILED: {failed}")
        return 1
    log(f"party {args.party}: all {len(results)} integration cases ok "
        f"on {device} (io {transport.io}, tls {transport.tls})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
