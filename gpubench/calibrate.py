"""The readings a cell's limits are set from, on the card: the program's
numbers over many seeds (short windows, one process) and the control's,
each a whole run of the cell through ``harness.run_cell``, the control
put in the program's place by its driver's ``control_hook``.

    python3 gpubench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --seconds 3 [--control-seeds 1,2,3]

Prints one JSON line a seed and run, then the largest program reading
(the lower end of each limit) and the smallest control reading (the upper
end).  The benchmark's own runs do not run it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from gpubench.lib import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="key=value (JSON) set in the configuration, for "
                         "a witness run (e.g. torch_dtype=\"float32\")")
    args = ap.parse_args(argv)
    common.set_cache_env()
    bench = common.load_json(ROOT / "BENCHMARK.json")
    from gpubench.lib import harness

    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    cell = harness.find_cell(bench, args.workload)
    files = harness.cell_files(cell)
    for item in args.set:
        key, value = item.split("=", 1)
        files["config"][key] = json.loads(value)
    driver = common.load_module(common.BENCH / "drivers"
                                / f"{files['traffic']['driver']}.py")
    program, control = {}, {}
    for side, seed in [("program", s) for s in seeds] \
            + [("control", s) for s in cseeds]:
        t0 = time.perf_counter()
        r = harness.run_cell(
            bench, args.workload, seed=seed, seconds=args.seconds,
            trace=False, device="cuda:0", t_start=t0, files=files,
            driver_hook=driver.control_hook if side == "control" else None)
        row = {k: c["value"] for k, c in r["checks"].items()}
        keep, pick = (program, max) if side == "program" else (control, min)
        for k, v in row.items():
            keep[k] = pick(keep.get(k, v), v)
        print(json.dumps({"seed": seed, "side": side,
                          "correct": r["correct"], "readings": row,
                          "seconds": time.perf_counter() - t0,
                          "metrics": {k: m["value"] for k, m
                                      in r["metrics"].items()}}),
              flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload,
                      "program_max": program, "control_min": control,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
