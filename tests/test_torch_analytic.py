"""The port's analytic cost model and the paper's configuration against
the JAX package's (``repro.perf.analytic``, ``repro.configs.ddm_paper``),
and the analytic forward count against the flops that
``torch.utils.flop_counter.FlopCounterMode`` counts on the port's reduced
forward (the counterpart of ``test_analytic_forward_flops_match_hlo``)."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import ddm_paper as jddm
from repro.configs import get_config as jget_config
from repro.perf import analytic as janalytic
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeDef, ddm_paper,
                                 get_config, make_batch, reduce_config)
from repro_torch.core.errors import ValidationError
from repro_torch.data.synthetic import DDM_WORKLOADS
from repro_torch.models import Model
from repro_torch.perf import analytic


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1.0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flops_bytes_and_reference_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert list(SHAPES) == list(JSHAPES)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        for fn in ("flops_model", "bytes_model"):
            got = getattr(analytic, fn)(cfg, shape)
            want = getattr(janalytic, fn)(jcfg, jshape)
            assert got.keys() == want.keys()
            for key in got:
                assert _close(got[key], want[key]), (name, fn, key)
        for shards in (1, 2, 16, 32):
            got = analytic.flops_model(cfg, shape, batch_shards=shards)
            want = janalytic.flops_model(jcfg, jshape, batch_shards=shards)
            assert all(_close(got[k], want[k]) for k in got), (name, shards)
        assert _close(analytic.model_flops_reference(cfg, shape),
                      janalytic.model_flops_reference(jcfg, jshape))


def test_churn_cost_model_equals_jax():
    for n in (2.0, 100.0, 4096.0, 1.0e5, 2.0e6):
        for b in (0.0, 1.0, 7.0, 100.0, 5.0e4, 1.0e6):
            for impl in ("flat", "blocked"):
                for block in (None, 32, 512):
                    assert _close(
                        analytic.churn_splice_cost(n, b, impl=impl,
                                                   block=block),
                        janalytic.churn_splice_cost(n, b, impl=impl,
                                                    block=block)), \
                        (n, b, impl, block)
        for block in (None, 64, 4096):
            assert analytic.churn_flush_crossover(n, block) \
                == janalytic.churn_flush_crossover(n, block)
    with pytest.raises(ValidationError):
        analytic.churn_splice_cost(100.0, 1.0, impl="tree")


def test_ddm_paper_constants_equal_jax():
    for name in ("ALPHAS", "SIZES", "DIMS", "WORKLOADS", "DDIM_CELLS"):
        assert getattr(ddm_paper, name) == getattr(jddm, name), name
    assert dataclasses.asdict(ddm_paper.CONFIG) \
        == dataclasses.asdict(jddm.CONFIG)
    assert ddm_paper.WORKLOADS == DDM_WORKLOADS


@pytest.mark.parametrize("arch", [
    "smollm-360m",            # dense GQA
    "gemma2-2b",              # local/global + softcaps
    "granite-moe-3b-a800m",   # MoE capacity dispatch
    "mamba2-2.7b",            # SSD
    "jamba-1.5-large-398b",   # hybrid pattern
    "phi-3-vision-4.2b",      # prefix embeds
    "seamless-m4t-medium",    # enc-dec + cross attention
])
def test_analytic_forward_flops_match_flop_counter(arch):
    cfg = dataclasses.replace(
        reduce_config(get_config(arch)),
        attn_block_q=1024, attn_block_k=1024)   # force dense attention
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    shape = ShapeDef("probe", 64, 2, "train")
    batch = make_batch(torch.Generator().manual_seed(1), cfg, shape)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        logits = model.forward(params, batch)
    assert np.isfinite(logits.float().numpy()).all()
    counted = float(counter.get_total_flops())
    want = analytic.flops_model(cfg, shape)["fwd_flops"]
    # matmul-only model vs the counted products: ±20 %
    assert abs(counted - want) / counted < 0.20, \
        f"{arch}: counted {counted:.3e} vs analytic {want:.3e} " \
        f"({abs(counted - want) / counted:.1%})"
