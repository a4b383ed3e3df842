"""The model step's share of the card's bf16 peak: the model's operations
of every prefill in the traced window (``lib.arith.prefill_model_flops``:
2 a weight a token, causal attention over the live (q, k) pairs, one
position's unembedding a row) over the window's seconds and the peak, in
%."""
from gpubench.lib.arith import prefill_model_flops


def read(run):
    if run.peaks is None or not run.record["waves"]:
        return None
    flops = sum(prefill_model_flops(run.config, rows, seq)
                for rows, seq in run.record["waves"])
    return 100.0 * flops / (run.trace.window_s
                            * run.peaks["bf16_flops_per_s"])
