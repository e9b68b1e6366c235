"""python -m ark_mpc_tpu_torch.parallel --dryrun N: the multi-rank dry run
on N gloo CPU ranks (`parallel/dryrun.py`)."""

from __future__ import annotations

import argparse
import sys

from .dryrun import dryrun_multichip


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(prog="python -m ark_mpc_tpu_torch.parallel")
    ap.add_argument("--dryrun", type=int, metavar="N", required=True,
                    help="run the dry run on N gloo CPU ranks")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.dryrun, args.timeout), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
