"""Long-context routing of the port's Llama attention, held against the
JAX package: a one-layer MHA model (8 heads of 128, the head geometry of
Llama-2-7B) steps over a seeded 4,096-row INT8 cache, and each step must
take the route the reference takes and give its logits.

The reference routes on `PALLAS_ATTN_MAX_ELEMS` (2^21 cache elements per
batch element): within it, t <= 8 goes to the insert + single-tile kernel;
past it, t = 1 goes to the insert + tiled flash-decoding kernel and every
other t to the insert (or the plain cache update) + the f32 einsum arm.
The port's model makes both t = 1 routes one `decode_attention_update`
call (one launch on the card); on the CPU that call inserts, then
attends through the route's own function.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gguf_tpu.models import forward as jax_forward
from gguf_tpu.models import fuse_llama_params as jax_fuse
from gguf_tpu.models import load_llama as jax_load_llama
from gguf_tpu.models import MMOpts as JaxMMOpts
from gguf_tpu_torch.models import (LlamaConfig, MMOpts, forward,
                                   fuse_llama_params, load_llama,
                                   write_random_llama_gguf)
from gguf_tpu_torch.models import llama as port_llama
from gguf_tpu_torch.ops import attention as port_attention

CFG = LlamaConfig(vocab_size=256, dim=1024, n_layers=1, n_heads=8,
                  n_kv_heads=8, ffn_dim=512, max_seq_len=4096)
B, S = 2, 4096
TOL = 1e-2          # tests/test_torch_model.py: logits vs max|ref|
# (t, positions, span) -> the port's attention functions the step calls
# (those `attention` calls, then, prefixed "ops.", those the update calls)
STEPS = {
    "t1_span4096": (1, (3000, 2990), 4096,
                    ["decode_attention_update", "ops.kv_cache_insert",
                     "ops.decode_attention_tiled"]),
    "t8_span4096": (8, (3000, 2990), 4096, ["kv_cache_insert"]),
    "t1_span512": (1, (300, 290), 512,
                   ["decode_attention_update", "ops.kv_cache_insert"]),
}
ROUTED = ("decode_attention_update", "kv_cache_insert", "_cache_update")
OPS_ROUTED = ("kv_cache_insert", "decode_attention_tiled")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_long") / "mha.gguf")
    write_random_llama_gguf(path, CFG, seed=3)
    jcfg, jparams = jax_load_llama(path)
    cfg, params = load_llama(path, "cpu")
    fwd = jax.jit(jax_forward, static_argnames=("cfg", "opts", "span"))
    return (fwd, jcfg, jax_fuse(jparams)), (cfg, fuse_llama_params(params))


def _seeded_cache(seed):
    """Every row of a (B, 8, S, 128) cache filled: codes in +-127 and the
    scales of rope'd K/V rows of this model's size."""
    rng = np.random.default_rng(seed)
    shape = (B, CFG.n_kv_heads, S, CFG.head_dim)
    return {"k": rng.integers(-127, 128, shape).astype(np.int8),
            "v": rng.integers(-127, 128, shape).astype(np.int8),
            "k_scale": rng.uniform(0.002, 0.02, shape[:-1]).astype(np.float32),
            "v_scale": rng.uniform(0.002, 0.02, shape[:-1]).astype(np.float32)}


@pytest.fixture
def routes(monkeypatch):
    """The port's attention functions that `attention` calls, and those
    that `decode_attention_update` calls, in order."""
    calls = []
    for module, names, tag in ((port_llama, ROUTED, ""),
                               (port_attention, OPS_ROUTED, "ops.")):
        for name in names:
            real = getattr(module, name)

            def spy(*args, _real=real, _name=tag + name, **kwargs):
                calls.append(_name)
                return _real(*args, **kwargs)

            monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("step", list(STEPS))
def test_long_context_step_routes_and_logits_match_jax(model, routes, step):
    t, pos, span, route = STEPS[step]
    (fwd, jcfg, jparams), (cfg, params) = model
    cache = _seeded_cache(seed=t + span)
    tokens = np.random.default_rng(span + t).integers(0, CFG.vocab_size,
                                                      (B, t))
    pos = np.array(pos, np.int32)
    ref, _ = fwd(jparams, jcfg, jnp.asarray(tokens, jnp.int32),
                 jnp.asarray(pos), [{n: jnp.asarray(a) for n, a in
                                     cache.items()}],
                 opts=JaxMMOpts(), span=span)
    tcache = [{n: torch.from_numpy(a.copy()) for n, a in cache.items()}]
    got, _ = forward(params, cfg, torch.from_numpy(tokens),
                     torch.from_numpy(pos), tcache, MMOpts(), span=span)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got.numpy()).all()
    err = np.max(np.abs(got.numpy() - ref))
    assert err <= TOL * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))
    assert routes == route
