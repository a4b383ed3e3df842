"""Each rank's collective traffic in one granite-moe-3b-a800m prefill wave
of ``chip_smoke.py`` phase 21 (b) (4 x 2048 tokens, full width and depth,
mesh data 1 x model 4), counted on the host: the dry run's fake world of
4 ranks and fake tensors, so no card is used and nothing is allocated.

    PYTHONPATH=src python3 tools/moe_wire_bytes.py [--modes auto,gspmd]

Prints one JSON object, {mode: {kind: {"count", "operand_bytes",
"wire_bytes"}}}, with ``record_traffic``'s kinds and ring convention, for
phase 21 (b)'s modes as ``chip_smoke.mp_mode_config`` configures them
(default: auto, gspmd and gspmd capshard; the dry run's cache specs
build a ``Model`` with no mesh, which refuses an explicit ``cap`` or
``ffn``).  With ``PYTHONPATH`` set to another checkout's ``src``, it
counts that commit's port on the same modes.
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(1, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs import ShapeDef, get_config  # noqa: E402
from repro_torch.launch.dryrun import run_cell  # noqa: E402


def main() -> None:
    serve = chip_smoke.MP_SERVE
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="auto,gspmd,gspmd capshard")
    args = ap.parse_args()
    shape = ShapeDef("phase 21 (b) wave", serve["prompt_len"], serve["rows"],
                     "prefill")
    mesh = ((1, chip_smoke.MP_WORLD), ("data", "model"))
    out = {}
    for mode in args.modes.split(","):
        cfg = chip_smoke.mp_mode_config(get_config(serve["arch"]), mode)
        rec = run_cell(serve["arch"], shape.name, False, cfg=cfg,
                       shape=shape, mesh=mesh)
        out[mode] = rec["collectives"]["by_op"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
