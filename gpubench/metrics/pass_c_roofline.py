"""Pass C's share of its roofline: ``lib.arith.pass_c_bytes`` of every
match in the traced window (each endpoint record read once, 8 B a pair
written) at the HBM rate, over the device time of ``emit_pairs_kernel``,
in %."""
from gpubench.lib.arith import pass_c_bytes
from gpubench.lib.names import PASS_C_NAME


def read(run):
    def is_pass_c(name):
        return PASS_C_NAME in name

    t = run.trace.device_seconds(is_pass_c)
    if run.peaks is None or t == 0.0:
        return None
    rec = run.record
    nbytes = sum(pass_c_bytes(rec["n"], rec["m"], k)
                 for _, k in rec["matches"])
    return 100.0 * nbytes / run.peaks["hbm_bytes_per_s"] / t
