"""python -m lidog_tpu_torch.probes {gather,bisect,lanegather,all}
[--device cpu]: run the probes; exits 1 if a check fails."""

import argparse
import sys

from lidog_tpu_torch.probes import PROBES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lidog_tpu_torch.probes")
    ap.add_argument("which", choices=(*PROBES, "all"))
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    from lidog_tpu_torch.probes import (micro_bisect, micro_gather,
                                        micro_lanegather)

    mains = {"gather": micro_gather.main, "bisect": micro_bisect.main,
             "lanegather": micro_lanegather.main}
    failed = []
    for name in PROBES if args.which == "all" else (args.which,):
        checks = mains[name](device=args.device)["checks"]
        failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
    if failed:
        print(f"failed checks: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
