"""The benchmark's CPU tests: ``python -m pytest gpubench/tests -q`` from
the root of the checkout (the repository's ``pytest`` run collects only
``tests/``)."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
