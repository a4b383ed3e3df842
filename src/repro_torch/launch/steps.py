"""Step builders shared by the training and serving launchers.

The port of ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` of the JAX package's ``repro/launch/steps.py``.  Its
``sds_*`` helpers (sharded dry-run specs) have no counterpart yet: they
belong to the dry run.  ``make_train_step`` is the training loop's own
(:func:`repro_torch.train.loop.make_train_step`, with a ``microbatches``
argument): it writes the new parameters and moments into the given
tensors (the JAX step returns new arrays).
"""
from __future__ import annotations

from repro_torch.models.transformer import Model
from repro_torch.train.loop import make_train_step

__all__ = ["make_decode_step", "make_prefill_step", "make_train_step"]


def make_prefill_step(model: Model):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(model: Model, enc_dec: bool):
    if enc_dec:
        def decode_step(params, token, cache, pos, enc_out):
            return model.decode_step(params, token, cache, pos, enc_out)
    else:
        def decode_step(params, token, cache, pos):
            return model.decode_step(params, token, cache, pos)
    return decode_step
