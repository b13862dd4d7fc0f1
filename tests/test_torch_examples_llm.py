"""The port's LLM drivers (``examples_torch/serve_batched.py``,
``train_bhfl_llm.py``) on the CPU's plain path, against the reference.

  * ``serve_batched`` at smoke width for an SSD model (mamba2-130m), a
    multi-head latent attention model (minicpm3-4b, whose smoke width
    attends at head dim 24: on the card the flash kernels run it
    zero-padded to 32) and an encoder-decoder (seamless-m4t-large-v2),
    with a short prompt: the tokens' and logits' shapes, every token id
    in the vocabulary, finite logits, and each sampled token one the
    logits it was drawn from allow.  The draws themselves are not
    compared: ``jax.random`` is not reproduced here, and
    ``tests/test_torch_serve.py`` holds the logits.
  * ``train_bhfl_llm`` for 2 global rounds against the reference's
    ``train.run`` at the driver's sizes: the simulated clock equal, the
    blocks and the chain's validity equal, every loss finite.
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jtrain  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402

from _torch_examples import CPU, _one_torch_thread, driver  # noqa: E402, F401
from _torch_threads import one_thread  # noqa: E402,F401

SERVED = ("mamba2-130m", "minicpm3-4b", "seamless-m4t-large-v2")
PROMPT, GEN, BATCH = 8, 4, 2


@pytest.mark.parametrize("arch", SERVED)
def test_serve_batched_generates_tokens_in_the_vocabulary(arch):
    cfg = get_smoke(arch)
    out = driver("serve_batched").main(arch, batch=BATCH, prompt_len=PROMPT,
                                       gen=GEN, **CPU)
    tokens, logits = out["tokens"], out["logits"]
    assert tokens.shape == (BATCH, GEN) and tokens.dtype == np.int32
    assert logits.shape == (BATCH, GEN, cfg.vocab)
    assert ((tokens >= 0) & (tokens < cfg.vocab)).all()
    assert np.isfinite(logits).all()
    picked = np.take_along_axis(logits, tokens[..., None].astype(np.int64),
                                -1)[..., 0]
    assert (picked > -np.inf).all()


def test_train_bhfl_llm_matches_the_reference():
    kw = dict(steps=2, k_edge=2, n_clients=4, batch=4, seq=64,
              straggler_frac=0.25)
    with tempfile.TemporaryDirectory() as ckpt:
        want = jtrain.run("h2o-danube-1.8b", smoke=True, normalize=True,
                          ckpt_dir=ckpt, progress=False, **kw)
    got = driver("train_bhfl_llm").main(**kw, **CPU)
    np.testing.assert_array_equal(got["sim_clock"], want["sim_clock"])
    assert (got["blocks"], got["chain_valid"]) == (want["blocks"],
                                                   want["chain_valid"])
    assert len(got["losses"]) == len(want["losses"]) == kw["steps"]
    assert np.isfinite(got["losses"]).all()
