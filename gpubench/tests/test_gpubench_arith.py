"""The frozen arithmetic against the port's own counts, which it was
copied from (the tests may import the port; the benchmark does not)."""
import pytest

from gpubench.lib import arith
from gpubench.lib.common import BENCH, load_json

GRANITE = load_json(BENCH / "configs" / "granite-moe-3b-a800m.json")


def test_live_pairs_equal_chip_smoke_on_granites_schedule():
    import chip_smoke
    from repro_torch.kernels.ops import build_block_structure

    for seq in (512, 1024, 2048, 4096):
        kv_index, kv_count, _ = build_block_structure(seq, seq, block_q=512,
                                                      block_k=512)
        want = chip_smoke.live_pairs(kv_index, kv_count, 512, seq, seq)
        assert arith.causal_live_pairs(seq) == want


def test_flash_bound_is_row_6g():
    # row 6g of PERF.md: B = 4, H = 24 / 8, S = 2048, D = 64, bf16:
    # 0.0521 ms of operations, 0.0200 ms of bytes
    ops, nbytes = arith.flash_work(4, 24, 8, 2048, 64)
    assert ops / 989e12 * 1e3 == pytest.approx(0.0521, abs=5e-5)
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.0200, abs=5e-5)
    q = 4 * 24 * 2048 * 64 * 2
    kv = 4 * 8 * 2048 * 64 * 2
    assert nbytes == 2 * q + 2 * kv


def test_pass_c_bytes_count_each_record_once_and_8_bytes_a_pair():
    import torch

    from repro_torch.core.intervals import Extents, make_uniform_workload
    from repro_torch.core.sweep import encode_endpoints

    n, m = 300, 200
    subs, upds = make_uniform_workload(
        n, m, 10.0, generator=torch.Generator().manual_seed(0),
        device="cpu")
    ep = encode_endpoints(Extents(subs.lo, subs.hi), Extents(upds.lo,
                                                              upds.hi))
    records = ep.owner.numel()
    assert records == 2 * (n + m)
    # owner, upper, side and valid words, int32 each; two int32 a pair
    assert arith.pass_c_bytes(n, m, 1000) == 4 * 4 * records + 8 * 1000


def test_matmul_params_follow_the_ports_active_count():
    """The weights a token multiplies by are the port's active parameters
    less the (padded, tied) embedding, the final norm and two norms a
    layer, plus the router's E - k columns the port does not count (all E
    router logits are computed)."""
    from repro_torch.configs import get_config

    x = arith.decoder_dims(GRANITE)
    d, layers = x["d"], x["layers"]
    active = get_config("granite-moe-3b-a800m").active_param_count()
    assert arith.matmul_params_per_token(GRANITE) == (
        active - x["padded_vocab"] * d - d - layers * 2 * d
        + layers * d * (x["experts"] - x["top_k"]))


def test_the_config_file_is_the_ports_granite():
    import dataclasses

    from gpubench.lib import decoder
    from repro_torch.configs import get_config

    mine = dataclasses.asdict(decoder.model_config(GRANITE))
    port = dataclasses.asdict(get_config("granite-moe-3b-a800m"))
    assert mine == port


def test_prefill_flops_follow_the_shapes():
    x = arith.decoder_dims(GRANITE)
    per_token = x["layers"] * (
        1536 * 24 * 64 * 2 + 2 * 1536 * 8 * 64 + 1536 * 40
        + 3 * 8 * 1536 * 512)
    assert arith.matmul_params_per_token(GRANITE) == per_token
    flops = arith.prefill_model_flops(GRANITE, 8, 2048)
    attn = 4 * 64 * (2048 * 2049 // 2) * 8 * 24 * 32
    assert flops == 2 * per_token * 8 * 2048 + attn + 2 * 1536 * 49155 * 8
    assert 2.9e13 < flops < 3.0e13
