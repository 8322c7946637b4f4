"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/limits.py --workload <name> --seeds 12 \\
        --controls control[,drop_half] --control-seeds 3 --seconds 3 \\
        --out <file.jsonl>

For each of ``--seeds`` fresh seeds, a whole run of the cell (set-up, a
short window at the cell's own load, the check) gives the program's
readings, the lower ones; for each control or planted fault the driver
knows and each of ``--control-seeds`` seeds, the same run judges that
in the program's place, giving the upper readings.  One JSON line per
run: the seed, what was judged and every number compared.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", default="control")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--base-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != os.path.dirname(
                                os.path.abspath(__file__))]
    from benchmark import harness

    class EveryNumber(dict):
        """The configuration's limits, and no limit for every other number
        a check reads, so that the record holds them all."""

        def __contains__(self, key):
            return True

        def __getitem__(self, key):
            return self.get(key, float("inf"))
    cell = harness.resolve(args.workload)
    cell.config = dict(cell.config,
                       limits=EveryNumber(cell.config["limits"]))
    runs = [(None, args.base_seed + i) for i in range(args.seeds)]
    for c in filter(None, args.controls.split(",")):
        runs += [(c, args.base_seed + 1000 + i)
                 for i in range(args.control_seeds)]
    with open(args.out, "a") as out:
        for judged, seed in runs:
            t = time.perf_counter()
            line = harness.execute(cell, seed, args.seconds, False,
                                   control=judged)
            rec = {"workload": cell.name, "seed": seed,
                   "judged": judged or "program",
                   "correct": line["correct"],
                   "checks": {k: v["value"]
                              for k, v in line["checks"].items()},
                   "seconds": time.perf_counter() - t}
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
