"""The port's ``SyntheticLM`` against the JAX package's.

The port draws with a ``torch.Generator``, the JAX package with
``jax.random``, so the draws differ by design; the composition of a batch
from its draws is the same function.  Here the JAX draws of a step are
rebuilt with ``jax.random`` and the same key splits as
``repro.data.synthetic.SyntheticLM.batch`` makes them, handed to the
port's :func:`compose_batch`, and the result must equal the JAX batch
exactly.  Also: determinism per (seed, step), ``host_batch`` partitioning
the global batch, and the packing invariants.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro_torch.data.synthetic import (SyntheticConfig, SyntheticLM,
                                        compose_batch)


def jax_draws(cfg, step):
    """(first, signal, noise, bound) as the JAX ``batch(step)`` draws them."""
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), step)
    k_first, k_sig, k_noise, k_doc = jax.random.split(key, 4)
    b, s = cfg.global_batch, cfg.seq_len
    first = jax.random.randint(k_first, (b, 1), 0, cfg.vocab_size)
    signal = jax.random.bernoulli(k_sig, cfg.p_signal, (b, s))
    noise = jax.random.randint(k_noise, (b, s), 0, cfg.vocab_size)
    bound = jax.random.bernoulli(k_doc, 1.0 / max(cfg.mean_doc_len, 2),
                                 (b, s)).at[:, 0].set(False)
    return [torch.from_numpy(np.array(a)) for a in (first, signal, noise,
                                                    bound)]


@pytest.mark.parametrize("vocab,seq,batch,doc,seed,step", [
    (97, 64, 4, 16, 0, 7),
    (515, 256, 3, 32, 3, 5),
    (49_152, 4_096, 2, 512, 1, 0),
    (256_206, 1_024, 2, 64, 2, 11),
])
def test_composition_equals_jax(vocab, seq, batch, doc, seed, step):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch,
              mean_doc_len=doc, seed=seed)
    jcfg = JaxSyntheticConfig(**kw)
    want = JaxSyntheticLM(jcfg).batch(step)
    got = compose_batch(SyntheticConfig(**kw), *jax_draws(jcfg, step))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == torch.int32, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def test_batches_are_a_function_of_seed_and_step():
    cfg = SyntheticConfig(vocab_size=97, seq_len=64, global_batch=4)
    a, b = SyntheticLM(cfg, device="cpu"), SyntheticLM(cfg, device="cpu")
    b.batch(3)                                    # no state carried over
    for key, val in a.batch(7).items():
        assert torch.equal(val, b.batch(7)[key]), key
    assert not torch.equal(a.batch(7)["tokens"], a.batch(8)["tokens"])
    other = SyntheticLM(SyntheticConfig(vocab_size=97, seq_len=64,
                                        global_batch=4, seed=1), device="cpu")
    assert not torch.equal(a.batch(7)["tokens"], other.batch(7)["tokens"])


def test_host_slices_partition_the_global_batch():
    d = SyntheticLM(SyntheticConfig(vocab_size=97, seq_len=32,
                                    global_batch=8), device="cpu")
    full = d.batch(3)
    parts = [d.host_batch(3, h, 4) for h in range(4)]
    for key in full:
        assert torch.equal(torch.cat([p[key] for p in parts]), full[key])


def test_packing_invariants():
    d = SyntheticLM(SyntheticConfig(vocab_size=97, seq_len=256,
                                    global_batch=2, mean_doc_len=32),
                    device="cpu")
    b = {k: v.numpy() for k, v in d.batch(0).items()}
    seg, pos, lab, tok = b["segments"], b["positions"], b["labels"], \
        b["tokens"]
    assert (np.diff(seg, axis=1) >= 0).all() and seg.max() > 0
    boundary = np.diff(seg, axis=1) > 0
    assert (pos[:, 1:][boundary] == 0).all() and (pos[:, 0] == 0).all()
    assert ((pos[:, 1:] == pos[:, :-1] + 1) | boundary).all()
    m = lab[:, :-1] >= 0
    np.testing.assert_array_equal(lab[:, :-1][m], tok[:, 1:][m])
    assert (lab[:, :-1][boundary] == -1).all() and (lab[:, -1] == -1).all()
    assert ((tok >= 0) & (tok < 97)).all()
    # the chain: mostly (31 x + 17) mod 97 inside a document
    follows = (tok[:, 1:] == (31 * tok[:, :-1] + 17) % 97) & ~boundary
    assert follows.mean() > 0.8
