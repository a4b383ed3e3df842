"""Run one cell of the port's benchmark once, on the card this process
finds, from the root of a checkout:

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the numbers the
check compared, each beside its limit, are the last lines of standard
error.  Without a CUDA device, or with fewer than the cell asks for, it
exits with 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from gpubench.lib import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    common.set_cache_env()
    bench = common.load_json(ROOT / "BENCHMARK.json")
    from gpubench.lib import harness
    cell = harness.find_cell(bench, args.workload)

    import torch
    if not torch.cuda.is_available():
        print("gpubench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"gpubench: {args.workload} needs {cell['chips']} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.cuda.init()
    print(f"gpubench: torch {torch.__version__} and the card ready "
          f"{time.perf_counter() - T_START:.3f} s after start",
          file=sys.stderr)
    result = harness.run_cell(bench, args.workload, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              device="cuda:0", t_start=T_START)
    found = common.forbidden_loaded(sys.modules)
    if found:
        print("gpubench: forbidden modules loaded in the run's process: "
              + ", ".join(found), file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
