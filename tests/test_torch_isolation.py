"""Boundaries of the PyTorch port (repro_torch): it imports neither JAX nor
the JAX package, its entry points default to the card, its kernel wrappers
never fall back silently, and ``chip_smoke.py`` refuses to run without a
card.  The CUDA kernels themselves are tested by the ``cuda``-marked test,
which skips on a machine without a card and ``nvcc``."""
import ast
import inspect
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import extents_from_arrays
from repro_torch.core import intervals
from repro_torch.core.errors import ValidationError
from repro_torch.core.incremental import IncrementalIndex
from repro_torch.core.service import DDMService
from repro_torch.data import ddm_workload
from repro_torch.kernels import bitmatch as tbitmatch
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sbm_sweep as tkernels

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path.name} imports {bad}"


def test_entry_points_default_to_the_card():
    for fn in (DDMService, IncrementalIndex, intervals.make_uniform_workload,
               intervals.make_clustered_workload,
               intervals.make_tall_thin_workload, ddm_workload,
               extents_from_arrays):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn
    assert DDMService().device == torch.device("cuda")


def test_no_silent_cpu_path_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    svc = DDMService()
    svc.register("sub", np.zeros(3, np.float32), np.ones(3, np.float32))
    svc.register("upd", np.zeros(2, np.float32), np.ones(2, np.float32))
    with pytest.raises((RuntimeError, AssertionError)):
        svc.match_count()
    with pytest.raises((RuntimeError, AssertionError)):
        intervals.make_uniform_workload(4, 4, 1.0)


def test_wrappers_validate_and_do_not_count_plain_runs():
    deltas = torch.zeros((4, 64), dtype=torch.int32)
    before = tkernels.block_sums.launches
    assert torch.equal(tkernels.block_sums(deltas, block_size=32),
                       torch.zeros((2, 4), dtype=torch.int32))
    assert tkernels.block_sums.launches == before
    with pytest.raises(ValidationError):
        tkernels.block_sums(deltas, block_size=48)          # ragged segment
    with pytest.raises(ValidationError):
        tkernels.block_sums(deltas.to(torch.int64), block_size=32)
    with pytest.raises(ValidationError):
        tkernels.block_sums(deltas.t().contiguous().t(), block_size=32)
    with pytest.raises(ValidationError):                    # no meta kernel
        tkernels.block_sums(deltas.to("meta"), block_size=32)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Each CUDA kernel against its plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    from repro_torch.core import prefix
    from repro_torch.core.sweep import (_indicator_deltas, _pad_stream,
                                        encode_endpoints)

    g = torch.Generator().manual_seed(0)
    subs, upds = intervals.make_uniform_workload(3000, 2500, 20.0,
                                                 generator=g)
    for bs in (256, 2048):
        ep = _pad_stream(encode_endpoints(subs, upds), bs)
        deltas = torch.stack(_indicator_deltas(ep))
        sums = tkernels.block_sums(deltas, block_size=bs)
        assert torch.equal(sums, tref.ref_block_sums(deltas, block_size=bs))
        offsets = torch.cumsum(sums, dim=0, dtype=torch.int32) - sums
        for g_, w in zip(tkernels.emission(deltas, offsets, block_size=bs),
                         tref.ref_emission(deltas, offsets, block_size=bs)):
            assert torch.equal(g_, w)
        up = ep.is_upper.to(torch.int32)
        real = ep.owner >= 0
        masks = []
        for valid, count in (((ep.is_sub & real), 3000),
                             ((~ep.is_sub & real), 2500)):
            args = (ep.owner, up, valid.to(torch.int32))
            got = tkernels.delta_bitmasks(*args, num_words=-(-count // 32),
                                          block_size=bs)
            want = tref.ref_delta_bitmasks(*args, num_words=-(-count // 32),
                                           block_size=bs)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            masks.append(prefix.delta_scan_exclusive(*got))
        _, seg, _ = tkernels.sweep_count(deltas, block_size=bs)
        cap = max(int(seg.max()), 1)
        c_args = (ep.owner.clamp(min=0), up, ep.is_sub.to(torch.int32),
                  real.to(torch.int32), *masks)
        got = tkernels.emit_pairs(*c_args, block_size=bs, cap=cap)
        want = tref.ref_emit_pairs(*c_args, block_size=bs, cap=cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the bit-matrix AND, d = 1..4, ragged rows and words
    for d, n, m in ((1, 33, 40), (2, 37, 130), (3, 300, 257), (4, 65, 1000)):
        g = torch.Generator().manual_seed(d)
        subs, upds = intervals.make_uniform_workload(n, m, 50.0, d=d,
                                                     generator=g)
        rows = [x if x.ndim == 2 else x[None] for x in
                (subs.lo, subs.hi, upds.lo, upds.hi)]
        got = tbitmatch.bitmatch(*(x.contiguous() for x in rows))
        want = tref.ref_bitmatrix(*(x.contiguous() for x in rows))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
