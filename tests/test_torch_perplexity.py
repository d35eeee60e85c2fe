"""The port's perplexity (`gguf_tpu_torch.eval`) held against the JAX
package's `gguf_tpu.eval.perplexity`: the same windows, the same
second-half accounting, and NLL within a stated bound, with bf16 and with
Q8_1 (act_quant) activations, on 2-layer Q4_K_M and Q5_K_M checkpoints."""

import numpy as np
import pytest

from gguf_tpu.eval import perplexity_of_gguf as jax_perplexity_of_gguf
from gguf_tpu.eval import sequence_nll as jax_sequence_nll
from gguf_tpu.gguf import GGMLType
from gguf_tpu.models import MMOpts as JaxMMOpts
from gguf_tpu.models import fuse_llama_params as jax_fuse
from gguf_tpu.models import load_llama as jax_load_llama
from gguf_tpu_torch.eval import perplexity, perplexity_of_gguf, sequence_nll
from gguf_tpu_torch.models import (LlamaConfig, MMOpts, fuse_llama_params,
                                   load_llama, write_random_llama_gguf)

CFG = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                  n_kv_heads=2, ffn_dim=512, max_seq_len=256)
WINDOW, BATCH = 128, 2
# 3 full windows and a 100-token tail: two batches of two windows
N_TOKENS = 3 * WINDOW + 100
# mean NLL (nats): the logits agree within 1e-2 (bf16) and 3e-2
# (act_quant) of max|logit| (tests/test_torch_model.py); averaged over
# hundreds of scored tokens that leaves well under 1e-2 nats
TOL_NATS = 1e-2
FORMATS = {"q4_k_m": GGMLType.Q4_K, "q5_k_m": GGMLType.Q5_K}


@pytest.fixture(scope="module", params=list(FORMATS))
def checkpoint(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_ppl") / f"{request.param}.gguf")
    write_random_llama_gguf(path, CFG, fmt=FORMATS[request.param], seed=4)
    jcfg, jparams = jax_load_llama(path)
    cfg, params = load_llama(path, "cpu")
    return path, (jcfg, jax_fuse(jparams)), (cfg, fuse_llama_params(params))


def _ids(seed=0, n=N_TOKENS):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, n)


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("full_window", [False, True])
def test_sequence_nll_matches_jax(checkpoint, act_quant, full_window):
    _, (jcfg, jparams), (cfg, params) = checkpoint
    ids = _ids()
    kw = dict(window=WINDOW, batch=BATCH, full_window=full_window)
    ref_total, ref_count = jax_sequence_nll(
        jparams, jcfg, ids, opts=JaxMMOpts(act_quant=act_quant), **kw)
    total, count = sequence_nll(params, cfg, ids,
                                opts=MMOpts(act_quant=act_quant), **kw)
    assert count == ref_count
    first = 1 if full_window else WINDOW // 2
    assert count == 3 * (WINDOW - first) + (100 - first)
    assert abs(total / count - ref_total / ref_count) <= TOL_NATS, (
        total / count, ref_total / ref_count)


def test_perplexity_of_gguf_matches_jax(checkpoint):
    """The file-level entry point under act_quant, with the JAX defaults
    for everything else (window 512 capped to max_seq_len, batch 8)."""
    path = checkpoint[0]
    ids = _ids(seed=1, n=600)
    ref = jax_perplexity_of_gguf(path, ids, act_quant=True)
    got = perplexity_of_gguf(path, ids, device="cpu", act_quant=True)
    assert np.isfinite(got) and got > 1.0
    assert abs(np.log(got) - np.log(ref)) <= TOL_NATS, (got, ref)


def test_window_accounting_edges(checkpoint):
    _, _, (cfg, params) = checkpoint
    # a 1-token tail is no window; 2 tokens are one scored pair
    _, count = sequence_nll(params, cfg, _ids(n=WINDOW + 1), window=WINDOW,
                            full_window=True)
    assert count == WINDOW - 1
    _, count = sequence_nll(params, cfg, _ids(n=2), window=WINDOW,
                            full_window=True)
    assert count == 1
    with pytest.raises(ValueError, match="at least 2 tokens"):
        sequence_nll(params, cfg, [5], window=WINDOW)
    # the window is capped to the context length
    total, count = sequence_nll(params, cfg, _ids(n=2 * CFG.max_seq_len),
                                window=4 * CFG.max_seq_len)
    assert count == 2 * (CFG.max_seq_len - CFG.max_seq_len // 2)
    assert np.isclose(perplexity(params, cfg, _ids(n=2 * CFG.max_seq_len),
                                 window=4 * CFG.max_seq_len),
                      np.exp(total / count))
