"""Model configuration, derived from GGUF metadata (llama.cpp key schema).

The port's own copy of `gguf_tpu/models/config.py` (`LlamaConfig` with
`from_gguf_metadata` and `to_gguf_metadata`), kept field for field equal
to it so that checkpoints written by either package carry the same
metadata. The port runs the llama architecture only; the other fields
are parsed so that every GGUF the reference reads parses here too."""

from __future__ import annotations

from dataclasses import dataclass


def _rope_scaling(g) -> tuple:
    """-> (kind, factor, orig_ctx, attn_factor). Supported kinds: "none",
    "linear" (position interpolation), "yarn" (per-dimension NTK-by-parts
    interpolation with attention-magnitude scaling — the llama.cpp
    rope_yarn contract). Unknown schemes would silently produce wrong
    long-context logits, so refuse them loudly."""
    kind = str(g("rope.scaling.type", "linear") or "linear")
    factor = float(g("rope.scaling.factor", 1.0) or 1.0)
    if kind == "none" or factor == 1.0 and kind == "linear":
        return ("none", 1.0, 0, 1.0)
    if kind == "linear":
        return ("linear", factor, 0, 1.0)
    if kind == "yarn":
        return ("yarn", factor,
                int(g("rope.scaling.original_context_length", 0) or 0),
                float(g("rope.scaling.attn_factor", 1.0) or 1.0))
    if kind in ("longrope", "su"):
        # phi3-family LongRoPE: per-dim factors live in the
        # rope_factors_long/short tensors (loader picks by context); the
        # attention-magnitude factor is precomputed by the converter
        return ("longrope", factor,
                int(g("rope.scaling.original_context_length", 0) or 0),
                float(g("rope.scaling.attn_factor", 1.0) or 1.0))
    raise ValueError(
        f"unsupported rope scaling type {kind!r} (factor {factor}); "
        "supported: none, linear, yarn, longrope (+ rope_freqs.weight "
        "factors)")


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scale: float = 1.0    # position scaling factor (rope.scaling.factor);
                               # interpretation depends on rope_scaling_kind
    rope_scaling_kind: str = "none"   # none | linear | yarn
    rope_orig_ctx: int = 0            # yarn: original_context_length
    rope_attn_factor: float = 1.0     # yarn: attention magnitude scale
    # per-dimension frequency divisors from a rope_freqs.weight tensor
    # (llama-3.1-style GGUFs); tuple so the config stays hashable/static
    rope_freq_factors: tuple | None = None
    max_seq_len: int = 2048
    head_dim_override: int | None = None  # set for tp-local configs and
                                          # archs with explicit head_dim (gemma)
    # gemma-family switches (general.architecture == "gemma"). The (1+w)
    # RMSNorm convention needs none: llama.cpp's converter bakes +1 into
    # the GGUF norm weights, so plain RMSNorm is the on-disk contract.
    act_fn: str = "silu"       # "silu" (llama/qwen2) | "gelu_tanh" (gemma/phi2)
    embed_scale: float = 1.0      # gemma multiplies embeddings by sqrt(dim)
    # phi2-family switches (general.architecture == "phi2"):
    norm_type: str = "rms"     # "rms" | "layer" (mean-subtracting, biased)
    parallel_residual: bool = False  # x + attn(norm(x)) + mlp(norm(x))
    rope_dim: int | None = None  # partial rotary: rotate only the first
                                 # rope_dim dims of each head (phi2: 32)
    # mixture-of-experts (mixtral-family: {arch}.expert_count/_used_count).
    # 0 = dense FFN; > 0 switches every layer's FFN to top-k routed experts.
    n_experts: int = 0
    n_experts_used: int = 0
    # routed experts' FFN width when it differs from the dense ffn_dim
    # ({arch}.expert_feed_forward_length — DeepSeek-V2, Qwen-MoE);
    # 0 = same as ffn_dim
    expert_ffn_dim: int = 0
    # gemma2-family switches:
    # sliding-window attention — layer i attends only the last
    # sliding_window positions when swa_pattern > 1 and
    # i % swa_pattern != swa_pattern - 1 (llama.cpp set_swa_pattern:
    # every swa_pattern-th layer stays global; gemma2 alternates 1:1)
    sliding_window: int = 0
    swa_pattern: int = 1
    # logit soft-capping: x -> cap * tanh(x / cap) on attention scores /
    # final logits (0 = disabled)
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # gemma3: sliding-window layers rotate with their own (short-context)
    # frequency base; 0 = same base as global layers
    rope_theta_swa: float = 0.0
    # rope style: False = interleaved pairs (llama.cpp ROPE_TYPE_NORM —
    # llama/mistral, whose converters PERMUTE q/k to this order);
    # True = NEOX rotate-half (qwen2/qwen3/phi2/phi3/gemma-family GGUFs,
    # which keep the HF dimension order)
    rope_neox: bool = False
    # DeepSeek-V2-family multi-head latent attention (arch deepseek2).
    # kv_lora_rank > 0 switches attention to the ABSORBED MLA form: the
    # KV cache stores one shared row per token — the compressed KV latent
    # (kv_lora_rank) plus the MQA rope key (qk_rope_dim) — instead of
    # per-head K/V, and the per-head up-projections are absorbed into the
    # query/output paths (cache bytes drop ~9x vs naive MLA).
    q_lora_rank: int = 0          # 0 = direct q projection (V2-Lite)
    kv_lora_rank: int = 0         # > 0 enables MLA
    qk_rope_dim: int = 0          # rotary sub-dim of each qk head (64)
    v_head_dim: int = 0           # per-head value width (128)
    # deepseek2 MoE shape: the first n layers keep a dense FFN, routed
    # layers add shared experts and scale the routed sum
    leading_dense_layers: int = 0
    n_shared_experts: int = 0
    routed_scale: float = 1.0     # expert_weights_scale
    moe_renorm: bool = True       # renormalize top-k weights
                                  # (mixtral/qwen3moe yes, deepseek2 no)
    moe_gating: str = "softmax"   # softmax | sigmoid (deepseek-V3)
    # deepseek2 YaRN: rope.scaling.yarn_log_multiplier (0.1 * HF
    # mscale_all_dim). Nonzero switches to DeepSeek's mscale convention:
    # cos/sin carry NO magnitude factor (llama.cpp cancels ggml's
    # internal yarn mscale via attn_factor_scaled) and the attention
    # score scale becomes mscale^2 / sqrt(qk_dim) with
    # mscale = 1 + yarn_log_mul * ln(rope_scale).
    rope_yarn_log_mul: float = 0.0
    # command-r / granite scalar multipliers. logit_scale multiplies the
    # final logits (command-r stores the multiplier; granite stores a
    # divisor, inverted at parse time); 0 = off. residual_scale
    # multiplies each branch output before its residual add (granite);
    # attn_scale replaces the default 1/sqrt(head_dim) score scale
    # (granite attention.scale); 0 = default.
    logit_scale: float = 0.0
    residual_scale: float = 1.0
    attn_scale: float = 0.0
    # mamba-family state-space blocks (arch mamba). ssm_inner > 0 swaps
    # every block's attention+FFN for a selective-SSM mixer; the "cache"
    # becomes per-layer recurrent state (conv tail + SSM state) instead
    # of KV rows, so sequence length no longer costs memory.
    ssm_inner: int = 0       # d_inner (2 * dim)
    ssm_state: int = 0       # d_state (16)
    ssm_conv: int = 0        # d_conv  (4)
    ssm_dt_rank: int = 0     # time-step rank (ceil(dim / 16))
    # bert-family encoders (arch bert / nomic-bert): bidirectional
    # attention, no KV cache/generation — embedding models only
    causal: bool = True
    # gpt2-family: learned absolute positions instead of rope (the
    # loader picks up position_embd.weight; attention skips rotation)
    learned_pos: bool = False
    pooling: str = "none"    # none | mean | cls | last | rank
                             # ({arch}.pooling_type; rank = reranker
                             # with a cls classification head)

    @property
    def head_dim(self) -> int:
        if self.n_heads == 0:   # mamba: no attention heads
            return self.head_dim_override or 0
        return self.head_dim_override or self.dim // self.n_heads

    @property
    def qk_nope_dim(self) -> int:
        """MLA: the non-rotary sub-dim of each qk head (head_dim holds
        the full qk width nope+rope, llama.cpp attention.key_length)."""
        return self.head_dim - self.qk_rope_dim

    @property
    def kv_cache_heads(self) -> int:
        return 1 if self.kv_lora_rank else self.n_kv_heads

    @property
    def kv_cache_dim(self) -> int:
        """Per-token per-head cache row width. MLA stores the latent +
        rope key in ONE row, padded to the 128-lane TPU tile."""
        if self.kv_lora_rank:
            return -(-(self.kv_lora_rank + self.qk_rope_dim) // 128) * 128
        return self.head_dim

    @classmethod
    def from_gguf_metadata(cls, md: dict) -> "LlamaConfig":
        arch = md.get("general.architecture", "llama")
        g = lambda key, default=None: md.get(f"{arch}.{key}", default)
        n_heads = int(g("attention.head_count") or 0)   # mamba writes 0
        vocab = md.get(f"{arch}.vocab_size")
        if vocab is None:
            vocab = len(md["tokenizer.ggml.tokens"])
        dim = int(g("embedding_length"))
        gemma = arch in ("gemma", "gemma2", "gemma3")
        gemma2 = arch == "gemma2"
        gemma3 = arch == "gemma3"
        # gemma's head_dim (attention.key_length) is decoupled from
        # dim / n_heads (e.g. 2B: dim 2048, 8 heads, head_dim 256)
        key_len = g("attention.key_length")
        head_dim = (int(key_len) if key_len is not None
                    and int(key_len) != dim // n_heads else None)
        phi2 = arch == "phi2"
        # archs whose norms are LayerNorm (mean-subtracting, usually
        # biased) rather than RMSNorm: command-r (parallel-residual +
        # logit multiplier), starcoder2/gpt2 (biased LN + gateless GELU
        # FFN), falcon (parallel residual), stablelm (biased LN + partial
        # rotary), gptneox (dual LN + parallel residual)
        layernorm_arch = arch in ("command-r", "starcoder2", "gpt2",
                                  "falcon", "stablelm", "gptneox")
        rs_kind, rs_factor, rs_orig, rs_attn = _rope_scaling(g)
        rope_dim = g("rope.dimension_count")
        eps = g("attention.layer_norm_rms_epsilon")
        if eps is None:   # phi2/command-r/starcoder2 store layer_norm_epsilon
            eps = g("attention.layer_norm_epsilon",
                    1e-6 if gemma else 1e-5)
        logit_scale = float(g("logit_scale", 0.0) or 0.0)
        if arch == "granite" and logit_scale:
            logit_scale = 1.0 / logit_scale   # granite stores a divisor
        return cls(
            vocab_size=int(vocab),
            dim=dim,
            n_layers=int(g("block_count")),
            n_heads=n_heads,
            n_kv_heads=int(g("attention.head_count_kv", n_heads) or 0),
            ffn_dim=int(g("feed_forward_length") or 0),
            causal=bool(g("attention.causal", True)),
            learned_pos=arch == "gpt2",
            pooling={0: "none", 1: "mean", 2: "cls", 3: "last",
                     4: "rank"}.get(int(g("pooling_type", 0) or 0),
                                    "none"),
            ssm_inner=int(g("ssm.inner_size", 0) or 0),
            ssm_state=int(g("ssm.state_size", 0) or 0),
            ssm_conv=int(g("ssm.conv_kernel", 0) or 0),
            ssm_dt_rank=int(g("ssm.time_step_rank", 0) or 0),
            norm_eps=float(eps),
            rope_theta=float(g("rope.freq_base", 10000.0)),
            rope_scale=rs_factor,
            rope_scaling_kind=rs_kind,
            rope_orig_ctx=rs_orig,
            rope_attn_factor=rs_attn,
            max_seq_len=int(g("context_length", 2048)),
            head_dim_override=head_dim,
            act_fn=("gelu_tanh"
                    if (gemma or phi2
                        or arch in ("starcoder2", "gpt2", "falcon",
                                    "gptneox"))
                    else "silu"),
            embed_scale=(float(dim) ** 0.5 if gemma
                         else float(g("embedding_scale", 1.0) or 1.0)),
            norm_type="layer" if (phi2 or layernorm_arch) else "rms",
            # gptneox (Pythia-family) makes parallel residual a per-
            # checkpoint flag (HF use_parallel_residual, default true);
            # pythia-70m..12b all ship true, neox-style finetunes vary
            parallel_residual=(phi2 or arch in ("command-r", "falcon")
                               or (arch == "gptneox"
                                   and bool(g("use_parallel_residual",
                                              True)))),
            logit_scale=logit_scale,
            residual_scale=float(g("residual_scale", 1.0) or 1.0),
            attn_scale=float(g("attention.scale", 0.0) or 0.0),
            rope_dim=(int(rope_dim) if rope_dim is not None
                      and int(rope_dim) != (head_dim or dim // n_heads)
                      else None),
            n_experts=int(g("expert_count", 0) or 0),
            n_experts_used=int(g("expert_used_count", 0) or 0),
            expert_ffn_dim=int(g("expert_feed_forward_length", 0) or 0),
            sliding_window=int(g("attention.sliding_window", 0) or 0),
            # llama.cpp set_swa_pattern: every nth layer stays global —
            # gemma2 alternates 1:1, gemma3 runs 5 local : 1 global
            swa_pattern=2 if gemma2 else (6 if gemma3 else 1),
            attn_softcap=float(g("attn_logit_softcapping", 0.0) or 0.0),
            final_softcap=float(g("final_logit_softcapping", 0.0) or 0.0),
            # gemma3 local layers keep the short-context base (10k) while
            # global layers use rope.freq_base (1M)
            rope_theta_swa=(float(g("rope.freq_base_swa", 10000.0) or 10000.0)
                            if gemma3 else 0.0),
            # deepseek2 is NOT here: llama.cpp serves it with
            # ROPE_TYPE_NORM (HF deepseek checkpoints store q_pe/k_pe in
            # interleaved order — modeling_deepseek un-interleaves before
            # its rotate-half, so the stored layout is llama-style)
            rope_neox=arch in ("qwen2", "qwen2moe", "qwen3", "qwen3moe",
                               "phi2", "phi3", "gemma", "gemma2", "gemma3",
                               "olmo2", "starcoder2", "falcon",
                               "stablelm", "gptneox"),
            rope_yarn_log_mul=float(
                g("rope.scaling.yarn_log_multiplier", 0.0) or 0.0),
            q_lora_rank=int(g("attention.q_lora_rank", 0) or 0),
            kv_lora_rank=int(g("attention.kv_lora_rank", 0) or 0),
            qk_rope_dim=(int(g("rope.dimension_count", 0) or 0)
                         if arch == "deepseek2" else 0),
            v_head_dim=(int(g("attention.value_length", 0) or 0)
                        if arch == "deepseek2" else 0),
            leading_dense_layers=int(g("leading_dense_block_count", 0) or 0),
            n_shared_experts=int(g("expert_shared_count", 0) or 0),
            routed_scale=float(g("expert_weights_scale", 1.0) or 1.0),
            # qwen2moe (qwen1.5/2-MoE) does NOT renormalize top-k
            # weights (llama.cpp build_qwen2moe norm_w=false)
            moe_renorm=(bool(g("expert_weights_norm", False))
                        if arch == "deepseek2"
                        else arch != "qwen2moe"),
            moe_gating=("sigmoid"
                        if int(g("expert_gating_func", 1) or 1) == 2
                        else "softmax"),
        )

    def to_gguf_metadata(self, arch: str = "llama") -> dict:
        # LayerNorm archs store eps under layer_norm_epsilon in real
        # llama.cpp GGUFs (it is a required read key there); RMSNorm archs
        # use layer_norm_rms_epsilon
        eps_key = ("attention.layer_norm_epsilon"
                   if arch in ("phi2", "command-r", "starcoder2", "gpt2",
                               "falcon", "stablelm", "gptneox")
                   else "attention.layer_norm_rms_epsilon")
        return {
            "general.architecture": arch,
            f"{arch}.vocab_size": self.vocab_size,
            f"{arch}.embedding_length": self.dim,
            f"{arch}.block_count": self.n_layers,
            f"{arch}.attention.head_count": self.n_heads,
            f"{arch}.attention.head_count_kv": self.n_kv_heads,
            f"{arch}.feed_forward_length": self.ffn_dim,
            f"{arch}.{eps_key}": self.norm_eps,
            **({f"{arch}.rope.dimension_count": self.rope_dim}
               if self.rope_dim is not None else {}),
            f"{arch}.rope.freq_base": self.rope_theta,
            **({f"{arch}.rope.scaling.type": self.rope_scaling_kind
                    if self.rope_scaling_kind != "none" else "linear",
                f"{arch}.rope.scaling.factor": self.rope_scale}
               if self.rope_scale != 1.0
               or self.rope_scaling_kind not in ("none", "linear") else {}),
            **({f"{arch}.rope.scaling.original_context_length":
                    self.rope_orig_ctx} if self.rope_orig_ctx else {}),
            **({f"{arch}.rope.scaling.attn_factor": self.rope_attn_factor}
               if self.rope_attn_factor != 1.0 else {}),
            **({f"{arch}.rope.scaling.yarn_log_multiplier":
                    self.rope_yarn_log_mul}
               if self.rope_yarn_log_mul else {}),
            **({f"{arch}.attention.key_length": self.head_dim,
                f"{arch}.attention.value_length": self.v_head_dim
                    or self.head_dim}
               if self.head_dim_override is not None else {}),
            **({f"{arch}.attention.q_lora_rank": self.q_lora_rank}
               if self.q_lora_rank else {}),
            **({f"{arch}.attention.kv_lora_rank": self.kv_lora_rank,
                f"{arch}.leading_dense_block_count":
                    self.leading_dense_layers,
                f"{arch}.expert_shared_count": self.n_shared_experts,
                f"{arch}.expert_weights_scale": self.routed_scale,
                f"{arch}.expert_weights_norm": self.moe_renorm,
                f"{arch}.expert_gating_func":
                    2 if self.moe_gating == "sigmoid" else 1}
               if self.kv_lora_rank else {}),
            **({f"{arch}.expert_count": self.n_experts,
                f"{arch}.expert_used_count": self.n_experts_used}
               if self.n_experts else {}),
            **({f"{arch}.expert_feed_forward_length": self.expert_ffn_dim}
               if self.expert_ffn_dim else {}),
            **({f"{arch}.attention.sliding_window": self.sliding_window}
               if self.sliding_window else {}),
            **({f"{arch}.rope.freq_base_swa": self.rope_theta_swa}
               if self.rope_theta_swa else {}),
            **({f"{arch}.attn_logit_softcapping": self.attn_softcap}
               if self.attn_softcap else {}),
            **({f"{arch}.final_logit_softcapping": self.final_softcap}
               if self.final_softcap else {}),
            **({f"{arch}.logit_scale":
                    (1.0 / self.logit_scale if arch == "granite"
                     else self.logit_scale)}
               if self.logit_scale else {}),
            **({f"{arch}.embedding_scale": self.embed_scale}
               if self.embed_scale != 1.0 and arch == "granite" else {}),
            **({f"{arch}.residual_scale": self.residual_scale}
               if self.residual_scale != 1.0 else {}),
            **({f"{arch}.attention.scale": self.attn_scale}
               if self.attn_scale else {}),
            **({f"{arch}.use_parallel_residual": self.parallel_residual}
               if arch == "gptneox" else {}),
            **({f"{arch}.attention.causal": False,
                f"{arch}.pooling_type":
                    {"none": 0, "mean": 1, "cls": 2, "last": 3,
                     "rank": 4}[self.pooling]}
               if not self.causal else {}),
            **({f"{arch}.ssm.inner_size": self.ssm_inner,
                f"{arch}.ssm.state_size": self.ssm_state,
                f"{arch}.ssm.conv_kernel": self.ssm_conv,
                f"{arch}.ssm.time_step_rank": self.ssm_dt_rank}
               if self.ssm_inner else {}),
            f"{arch}.context_length": self.max_seq_len,
        }
