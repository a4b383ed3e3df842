"""The plain references agree with the port on the CPU at tiny sizes, and
their controls come out not correct there."""
import copy
import time

import numpy as np
import pytest
import torch

import tiny
from gpubench.lib import decoder, harness
from gpubench.lib.common import BENCH, ROOT, load_json, load_module
from gpubench.reference import interval_sweep, moe_decoder


def _decoder_cfg(layers=2, factor=1.25, dtype="float32"):
    cfg = copy.deepcopy(load_json(BENCH / "configs"
                                  / "granite-moe-3b-a800m.json"))
    cfg.update(tiny.TINY_DECODER, num_hidden_layers=layers,
               torch_dtype=dtype)
    cfg["assumed"].update(tiny.TINY_DECODER_ASSUMED,
                          moe_capacity_factor=factor)
    return tiny.run_multipliers(cfg)


@pytest.mark.parametrize("rows,seq", [(4, 64), (16, 32), (3, 40)])
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_decoder_equals_the_port_in_float32(rows, seq, factor):
    """Logits and every layer's K/V, capacity drops included (a factor of
    0.5 drops about half the records)."""
    from repro_torch.models.transformer import Model

    cfg = _decoder_cfg(layers=3, factor=factor)
    w = decoder.make_weights(cfg, 5, "cpu", torch)
    model = Model(decoder.model_config(cfg), device="cpu")
    params = decoder.port_params(w, model)
    tokens = torch.randint(0, cfg["vocab_size"], (rows, seq),
                           generator=torch.Generator().manual_seed(rows))
    cache, logits = model.prefill(params, {"tokens": tokens},
                                  model.init_cache(rows, seq + 1))
    got_kv = {}

    def on_kv(li, row, k, v):
        got_kv[li, row] = (k, v)

    ref = moe_decoder.last_logits(w, tokens, moe_decoder.spec_of(cfg),
                                  on_kv=on_kv)
    vocab = cfg["vocab_size"]
    torch.testing.assert_close(logits[:, 0, :vocab], ref, rtol=1e-4,
                               atol=1e-4)
    kv = cache["layer0"]
    for (li, row), (k, v) in got_kv.items():
        torch.testing.assert_close(kv.k[li, row, :, :seq].transpose(0, 1), k,
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(kv.v[li, row, :, :seq].transpose(0, 1), v,
                                   rtol=1e-4, atol=1e-4)


def test_moe_capacity_matches_the_port():
    from repro_torch.models import moe

    cfg = decoder.model_config(_decoder_cfg())
    spec = moe_decoder.spec_of(_decoder_cfg())
    for tokens in (8, 64, 100, 16384):
        assert moe_decoder.capacity(tokens, spec) \
            == moe._capacity(tokens, cfg)


def _grid_extents(rng, n, m):
    """Integer-grid bounds: many ties, shared endpoints, zero lengths."""
    s_lo = rng.integers(0, 50, n).astype(np.float32)
    u_lo = rng.integers(0, 50, m).astype(np.float32)
    return (s_lo, s_lo + rng.integers(0, 4, n), u_lo,
            u_lo + rng.integers(0, 4, m))


@pytest.mark.parametrize("seed", range(5))
def test_interval_sweep_equals_brute_force(seed):
    from repro_torch.core.intervals import Extents, brute_force_pairs_numpy

    rng = np.random.default_rng(seed)
    s_lo, s_hi, u_lo, u_hi = _grid_extents(rng, 300, 200)
    want = brute_force_pairs_numpy(
        Extents(torch.from_numpy(s_lo), torch.from_numpy(s_hi)),
        Extents(torch.from_numpy(u_lo), torch.from_numpy(u_hi)))
    keys = interval_sweep.pair_keys(s_lo, s_hi, u_lo, u_hi)
    assert len(keys) == len(set(keys.tolist()))
    assert {(int(k) // 200, int(k) % 200) for k in keys} == want
    assert interval_sweep.count(s_lo, s_hi, u_lo, u_hi) == len(want)


def test_interval_sweep_equals_the_port_on_the_papers_draw():
    from repro_torch.core import sbm_count
    from repro_torch.core.intervals import Extents, brute_force_pairs_numpy

    from gpubench.gen.extents import uniform_placement

    gen = torch.Generator().manual_seed(3)
    pl = uniform_placement(2000, 1500, 100.0, 1.0e6, gen, torch)
    host = [t.numpy() for t in pl]
    subs, upds = Extents(pl[0], pl[1]), Extents(pl[2], pl[3])
    assert interval_sweep.count(*host) == int(sbm_count(subs, upds))
    want = brute_force_pairs_numpy(subs, upds)
    got = {(int(k) // 1500, int(k) % 1500)
           for k in interval_sweep.pair_keys(*host)}
    assert got == want


def _eight_layers(cell):
    """A cell's files at a size a CPU holds that still separates the
    control: 8 layers of width 128, 4 rows of 64 tokens."""
    files = tiny.decoder_files(cell)
    files["config"].update(num_hidden_layers=8, hidden_size=128)
    files["config"]["assumed"].update(head_dim=32)
    tiny.run_multipliers(files["config"])
    # at this width (8 experts, top-2) one row's routing flips swing its
    # deeper layers past the full size's limit: the worst row is read
    # over the first two layers here
    files["limits"]["kv_worst_row"]["layers"] = [0, 1]
    return files


def _run(cell, files, hook=None):
    bench = load_json(ROOT / "BENCHMARK.json")
    driver = load_module(BENCH / "drivers" / f"{files['traffic']['driver']}"
                         ".py")
    return harness.run_cell(
        bench, cell, seed=2**31 + 5, seconds=0.2, trace=False, device="cpu",
        t_start=time.perf_counter(), files=files,
        driver_hook=driver.control_hook if hook == "control" else None)


@pytest.mark.parametrize("cell", ["granite-moe-3b.prefill-2k",
                                  "granite-moe-3b.prefill-512"])
def test_the_serving_control_is_not_correct(cell):
    """The reference with fp8 operands, put in the program's place, comes
    out not correct through the whole run."""
    r = _run(cell, _eight_layers(cell), hook="control")
    assert r["correct"] is False, r["checks"]
    assert r["failed"] == 0


def test_the_matching_control_is_not_correct():
    """The reference on bfloat16 bounds, put in the program's place,
    fails both numbers through the whole run."""
    r = _run("ddm-paper.match-a100", tiny.ddm_files(), hook="control")
    assert r["correct"] is False
    checks = r["checks"]
    assert checks["k_wrong"]["value"] > checks["k_wrong"]["limit"]
    assert checks["pairs_wrong"]["value"] > checks["pairs_wrong"]["limit"]


@pytest.mark.parametrize("cell", ["granite-moe-3b.prefill-2k",
                                  "granite-moe-3b.prefill-512"])
def test_the_program_at_that_size_is_correct(cell):
    """The same tiny 8-layer size with the program in its place reads
    inside the limits (so the control's failure is the precision's)."""
    r = _run(cell, _eight_layers(cell))
    assert r["correct"], r["checks"]
