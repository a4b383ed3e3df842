"""The hybrid model step's share of the card's bf16 peak: the model's
operations of every prefill in the traced window
(``lib.hybrid_arith.prefill_flops``: 2 a weight a token, the attention
layers' live causal pairs, the SSD's recurrence at 4·N·P a token and
head, one position's unembedding a row) over the window's seconds and
the peak, in %."""
from gpubench.lib.hybrid_arith import prefill_flops


def read(run):
    if run.peaks is None or not run.record["waves"]:
        return None
    flops = sum(prefill_flops(run.config, rows, seq)
                for rows, seq in run.record["waves"])
    return 100.0 * flops / (run.trace.window_s
                            * run.peaks["bf16_flops_per_s"])
