"""The port's `load_llama` refuses llama-schema files its forward would not
compute: a config field off its default that `forward` ignores, or a
tensor outside the port's list, each named in a NotImplementedError before
any weight is loaded. A default file loads and its logits match the JAX
forward."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gguf_tpu.models import forward as jax_forward
from gguf_tpu.models import fuse_llama_params as jax_fuse
from gguf_tpu.models import init_kv_cache as jax_init_cache
from gguf_tpu.models import load_llama as jax_load_llama
from gguf_tpu.models import MMOpts as JaxMMOpts
from gguf_tpu_torch.gguf import GGMLType
from gguf_tpu_torch.models import (LlamaConfig, MMOpts, forward,
                                   fuse_llama_params, init_kv_cache,
                                   load_llama, write_random_llama_gguf)
from gguf_tpu_torch.models import loader as loader_mod
from gguf_tpu_torch.models.loader import (check_device_computes,
                                           check_forward_computes)

CFG = LlamaConfig(vocab_size=64, dim=256, n_layers=1, n_heads=4,
                  n_kv_heads=2, ffn_dim=256, max_seq_len=64)
TOL = 1e-2          # tests/test_torch_model.py: logits vs max|ref|

# (extra llama.* metadata, the LlamaConfig field the error must name)
REFUSED_METADATA = [
    ({"llama.embedding_scale": 2.0}, "embed_scale"),
    ({"llama.residual_scale": 0.25}, "residual_scale"),
    ({"llama.attention.scale": 0.1}, "attn_scale"),
    ({"llama.logit_scale": 3.0}, "logit_scale"),
    ({"llama.attn_logit_softcapping": 50.0}, "attn_softcap"),
    ({"llama.final_logit_softcapping": 0.5}, "final_softcap"),
    ({"llama.attention.sliding_window": 32}, "sliding_window"),
    ({"llama.expert_count": 4}, "n_experts"),
    ({"llama.expert_used_count": 2}, "n_experts_used"),
    ({"llama.expert_feed_forward_length": 128}, "expert_ffn_dim"),
    ({"llama.expert_shared_count": 1}, "n_shared_experts"),
    ({"llama.expert_weights_scale": 2.0}, "routed_scale"),
    ({"llama.expert_gating_func": 2}, "moe_gating"),
    ({"llama.leading_dense_block_count": 1}, "leading_dense_layers"),
    ({"llama.rope.dimension_count": 32}, "rope_dim"),
    ({"llama.rope.scaling.type": "yarn", "llama.rope.scaling.factor": 4.0},
     "rope_scaling_kind"),
    ({"llama.rope.scaling.yarn_log_multiplier": 0.1}, "rope_yarn_log_mul"),
    ({"llama.attention.causal": False}, "causal"),
    ({"llama.pooling_type": 1}, "pooling"),
    ({"llama.attention.q_lora_rank": 32}, "q_lora_rank"),
    ({"llama.attention.kv_lora_rank": 64}, "kv_lora_rank"),
    ({"llama.ssm.inner_size": 512}, "ssm_inner"),
    ({"llama.ssm.state_size": 16}, "ssm_state"),
    ({"llama.ssm.conv_kernel": 4}, "ssm_conv"),
    ({"llama.ssm.time_step_rank": 16}, "ssm_dt_rank"),
]

# fields no llama.* key sets (other architectures set them), refused all
# the same should a config carry them
REFUSED_FIELDS = [
    ("norm_type", "layer"), ("parallel_residual", True),
    ("learned_pos", True), ("swa_pattern", 2), ("rope_theta_swa", 1e4),
    ("moe_renorm", False), ("qk_rope_dim", 64), ("v_head_dim", 128),
    ("rope_orig_ctx", 4096), ("rope_attn_factor", 0.5),
    ("rope_scaling_kind", "longrope"),
]

# tensors of the llama schema (and of others) the port's loader does not load
REFUSED_TENSORS = [
    "blk.0.attn_q.bias", "blk.0.attn_output.bias", "blk.0.attn_qkv.weight",
    "blk.0.attn_q_norm.weight", "blk.0.ffn_gate_inp.weight",
    "blk.0.ffn_up.bias", "position_embd.weight", "output_norm.bias",
    "blk.1.attn_norm.weight",
]


@pytest.mark.parametrize("extra,field", REFUSED_METADATA,
                         ids=[f for _, f in REFUSED_METADATA])
def test_load_refuses_a_field_the_forward_ignores(tmp_path, extra, field):
    path = str(tmp_path / "m.gguf")
    write_random_llama_gguf(path, CFG, fmt=GGMLType.Q8_0, seed=1,
                            extra_metadata=extra)
    with pytest.raises(NotImplementedError, match=rf"^{field} = "):
        load_llama(path, "cpu")


@pytest.mark.parametrize("field,value", REFUSED_FIELDS,
                         ids=[f for f, _ in REFUSED_FIELDS])
def test_config_check_refuses_every_other_field(field, value):
    cfg = dataclasses.replace(CFG, **{field: value})
    with pytest.raises(NotImplementedError, match=rf"^{field} = "):
        check_forward_computes(cfg)


@pytest.mark.parametrize("name", REFUSED_TENSORS)
def test_load_refuses_a_tensor_it_does_not_load(tmp_path, monkeypatch, name):
    write = loader_mod.write_gguf

    def with_extra(path, md, tensors):
        n = CFG.dim
        tensors[name] = (GGMLType.F32, (n,), np.ones(n, np.float32))
        write(path, md, tensors)

    monkeypatch.setattr(loader_mod, "write_gguf", with_extra)
    path = str(tmp_path / "m.gguf")
    write_random_llama_gguf(path, CFG, fmt=GGMLType.Q8_0, seed=1)
    with pytest.raises(NotImplementedError, match=rf"^tensor {name}: "):
        load_llama(path, "cpu")


@pytest.mark.parametrize("extra", [
    {},
    {"llama.rope.scaling.type": "linear", "llama.rope.scaling.factor": 2.0},
    {"llama.rope.scaling.type": "none"}], ids=["default", "linear", "none"])
def test_default_file_loads_and_matches_jax(tmp_path, extra):
    """A file whose every field the forward applies loads, and its logits
    (one layer, an 8-token prefill) match the JAX forward's."""
    path = str(tmp_path / "m.gguf")
    write_random_llama_gguf(path, CFG, seed=3, extra_metadata=extra)
    cfg, params = load_llama(path, "cpu")
    jcfg, jparams = jax_load_llama(path)
    tokens = np.random.default_rng(4).integers(0, CFG.vocab_size, (1, 8))
    ref, _ = jax.jit(jax_forward, static_argnames=("cfg", "opts", "span"))(
        jax_fuse(jparams), jcfg, jnp.asarray(tokens, jnp.int32),
        jnp.zeros(1, jnp.int32), jax_init_cache(jcfg, 1, 64),
        opts=JaxMMOpts(), span=64)
    got, _ = forward(fuse_llama_params(params), cfg, torch.from_numpy(tokens),
                     torch.zeros(1, dtype=torch.int32),
                     init_kv_cache(cfg, 1, 64, "cpu"), MMOpts(), span=64)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got.numpy()).all()
    assert np.max(np.abs(got.numpy() - ref)) <= TOL * np.max(np.abs(ref))


# head dims the card's attention kernels (K3, K4, K9: 64 and 128) do not
# take: Llama-shaped dim 3200 over 32 heads, and an explicit key_length
DEVICE_REFUSED = {
    "hd100": LlamaConfig(vocab_size=64, dim=3200, n_layers=2, n_heads=32,
                         n_kv_heads=4, ffn_dim=256, max_seq_len=64),
    "key_length256": dataclasses.replace(CFG, head_dim_override=256),
}


@pytest.mark.parametrize("name", sorted(DEVICE_REFUSED))
def test_device_check_refuses_a_head_dim_the_card_lacks(name):
    cfg = DEVICE_REFUSED[name]
    with pytest.raises(NotImplementedError,
                       match=rf"^head_dim = {cfg.head_dim}: "):
        check_device_computes(cfg, "cuda")
    check_device_computes(cfg, "cpu")     # the plain path computes any


@pytest.mark.parametrize("name", sorted(DEVICE_REFUSED))
def test_load_refuses_on_cuda_before_any_weight(tmp_path, monkeypatch, name):
    """`load_llama` for the card raises before it reads any weight (the
    loaders fail if called); for the CPU the same file loads."""
    cfg = DEVICE_REFUSED[name]
    path = str(tmp_path / "m.gguf")
    write_random_llama_gguf(path, cfg, fmt=GGMLType.Q8_0, seed=1)
    real = (loader_mod._load_weight, loader_mod._load_f32)

    def no_weight(*args):
        raise AssertionError("a weight was loaded")

    monkeypatch.setattr(loader_mod, "_load_weight", no_weight)
    monkeypatch.setattr(loader_mod, "_load_f32", no_weight)
    with pytest.raises(NotImplementedError,
                       match=rf"^head_dim = {cfg.head_dim}: "):
        load_llama(path, "cuda")
    monkeypatch.setattr(loader_mod, "_load_weight", real[0])
    monkeypatch.setattr(loader_mod, "_load_f32", real[1])
    got, _ = load_llama(path, "cpu")
    assert got.head_dim == cfg.head_dim


def test_hd100_file_matches_jax_on_the_cpu(tmp_path):
    """The hd-100 file the card refuses still runs on the CPU: 2 layers,
    an 8-token prefill, logits within TOL of the JAX forward's."""
    cfg = DEVICE_REFUSED["hd100"]
    path = str(tmp_path / "m.gguf")
    write_random_llama_gguf(path, cfg, fmt=GGMLType.Q8_0, seed=5)
    pcfg, params = load_llama(path, "cpu")
    jcfg, jparams = jax_load_llama(path)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 8))
    ref, _ = jax.jit(jax_forward, static_argnames=("cfg", "opts", "span"))(
        jax_fuse(jparams), jcfg, jnp.asarray(tokens, jnp.int32),
        jnp.zeros(1, jnp.int32), jax_init_cache(jcfg, 1, 64),
        opts=JaxMMOpts(), span=64)
    got, _ = forward(fuse_llama_params(params), pcfg,
                     torch.from_numpy(tokens), torch.zeros(1, dtype=torch.int32),
                     init_kv_cache(pcfg, 1, 64, "cpu"), MMOpts(), span=64)
    ref = np.asarray(ref)
    assert pcfg.head_dim == 100
    assert got.shape == ref.shape and np.isfinite(got.numpy()).all()
    assert np.max(np.abs(got.numpy() - ref)) <= TOL * np.max(np.abs(ref))
