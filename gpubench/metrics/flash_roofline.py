"""The flash kernel's share of its roofline: the bound of one launch
(``lib.arith.flash_work`` at the wave's shapes: operations over the live
causal pairs at the bf16 peak, or q, k, v and o once at the HBM rate,
the larger) over the device time a launch, in %.  Nothing where the
trace holds no flash launch (prompts at or below the attention block take
the dense path)."""
from gpubench.lib.arith import decoder_dims, flash_work, roofline_seconds
from gpubench.lib.names import FLASH_NAME


def read(run):
    def is_flash(name):
        return FLASH_NAME in name

    launches = run.trace.device_count(is_flash)
    if run.peaks is None or launches == 0:
        return None
    shapes = set(run.record["waves"])
    if len(shapes) != 1:
        return None
    rows, seq = shapes.pop()
    x = decoder_dims(run.config)
    ops, nbytes = flash_work(rows, x["heads"], x["kv_heads"], seq,
                             x["head_dim"])
    bound = roofline_seconds(ops, nbytes, run.peaks["bf16_flops_per_s"],
                             run.peaks["hbm_bytes_per_s"])
    return 100.0 * bound * launches / run.trace.device_seconds(is_flash)
