"""GGUF checkpoint -> the port's model params, and the random-checkpoint
writer (llama architecture).

Counterpart of `gguf_tpu/models/loader.py`: `load_llama` (llama branch)
and `write_random_llama_gguf` (arch "llama"), on the port's own GGUF
reader and writer. The reference's `_pad_vocab_weights` and
`pad_ffn_for_tp` pad M and K for TPU tiles; the port's kernels take any M
and any K that is a multiple of the format's block (`QuantWeight`), so it
loads weights unpadded.

Params layout (same keys as the reference): {"token_embd", "output",
"output_norm", "layers": [{"attn_norm", "ffn_norm", "wq", "wk", "wv",
"wo", "gate", "up", "down"}, ...]}; quantized weights are `QuantWeight`s,
float tensors stay in their file dtype. A layer of a mixtral-family file
(`n_experts` > 0) has, in place of "gate", "up" and "down", its router
"gate_inp" (E, dim) in f32 and the expert stacks "gate_exps",
"up_exps", "down_exps": each 3-D `ffn_*_exps` tensor (E, M, K) as one
`QuantWeight` of E*M rows, expert e its rows e*M..(e+1)*M
(`QuantWeight.row_block`, a view).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from ..gguf import (GGML_TO_FMT, GGMLType, GGUFReader, quantize_tensor,
                    write_gguf)
from ..ops.attention import HEAD_DIMS
from ..quant.layouts import QuantWeight
from .config import LlamaConfig

_FLOAT_TYPES = (GGMLType.F32, GGMLType.F16, GGMLType.BF16)


def _load_weight(reader: GGUFReader, name: str, device):
    ti = reader.tensors[name]
    if ti.ggml_type in _FLOAT_TYPES:
        return torch.from_numpy(np.array(reader.load_array(name))).to(device)
    fmt = GGML_TO_FMT.get(ti.ggml_type)
    if fmt is None:
        raise ValueError(f"{name}: unsupported tensor type {ti.ggml_type}")
    *lead, k = ti.shape
    m = int(np.prod(lead)) if lead else 1
    return QuantWeight.from_blocks(fmt, reader.tensor_bytes(name), (m, k),
                                   device)


def _load_f32(reader: GGUFReader, name: str, device) -> torch.Tensor:
    arr = np.asarray(reader.load_array(name), np.float32)
    return torch.from_numpy(arr.copy()).to(device)


_ATTN_TENSORS = ("attn_norm", "ffn_norm", "attn_q", "attn_k", "attn_v",
                 "attn_output")
_DENSE_FFN = ("ffn_gate", "ffn_up", "ffn_down")
# a mixtral-family layer's FFN: the router and the three expert stacks
_MOE_FFN = ("ffn_gate_inp", "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")
_EXPERT_PARAMS = (("gate_exps", "ffn_gate_exps"), ("up_exps", "ffn_up_exps"),
                  ("down_exps", "ffn_down_exps"))
# the LlamaConfig fields `forward` applies; every other field must keep its
# default (rope_scaling_kind: "none" or "linear" only)
_COMPUTED_FIELDS = frozenset((
    "vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "ffn_dim",
    "norm_eps", "rope_theta", "rope_scale", "rope_scaling_kind",
    "rope_freq_factors", "max_seq_len", "head_dim_override", "act_fn",
    "rope_neox"))
_NOT_PORTED = ("the port's forward does not compute it (ROADMAP.md, queue 1, "
               "item 3)")


def check_forward_computes(cfg: LlamaConfig) -> None:
    """Raise NotImplementedError naming the first config field that the
    port's `forward` would ignore: a field outside _COMPUTED_FIELDS that is
    not at its default, or a rope scaling other than none/linear.

    The mixtral form of routed experts is computed (`moe_mlp`):
    `n_experts` > 0 with 0 < `n_experts_used` <= `n_experts`, and
    `expert_ffn_dim` 0 or `ffn_dim`; every other MoE field (shared
    experts, a routed scale, sigmoid gating, no renormalisation, leading
    dense layers) must keep its default."""
    if cfg.rope_scaling_kind not in ("none", "linear"):
        raise NotImplementedError(
            f"rope_scaling_kind = {cfg.rope_scaling_kind!r}: {_NOT_PORTED}")
    computed = _COMPUTED_FIELDS
    if cfg.n_experts > 0:
        if not 0 < cfg.n_experts_used <= cfg.n_experts:
            raise NotImplementedError(
                f"n_experts = {cfg.n_experts} with n_experts_used = "
                f"{cfg.n_experts_used}: the port routes each token to "
                "0 < n_experts_used <= n_experts experts")
        computed = computed | {"n_experts", "n_experts_used"}
        if cfg.expert_ffn_dim == cfg.ffn_dim:
            computed = computed | {"expert_ffn_dim"}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if f.name not in computed and value != f.default:
            raise NotImplementedError(f"{f.name} = {value!r}: {_NOT_PORTED}")


def check_device_computes(cfg: LlamaConfig, device_type: str) -> None:
    """Raise NotImplementedError naming the head dim when the card's
    attention kernels (K3, K4, K9: hd in HEAD_DIMS) cannot compute it and
    the model is bound for `cuda`; the CPU's plain path computes any."""
    if device_type == "cuda" and cfg.head_dim not in HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim = {cfg.head_dim}: the port's CUDA attention kernels "
            f"take head dims {HEAD_DIMS} (ROADMAP.md, queue 1, items 3 and 8)")


def check_tensors_loaded(names, cfg: LlamaConfig) -> None:
    """Raise NotImplementedError naming the first tensor `load_llama` would
    not load (biases, fused qkv, q/k norms, a router or expert stacks in a
    dense file, dense FFN weights in an expert file, the pre-2024
    per-expert 2-D tensors, position_embd, ...), or the first that an
    expert file lacks."""
    ffn = _MOE_FFN if cfg.n_experts else _DENSE_FFN
    layer_names = [f"blk.{i}.{t}.weight" for i in range(cfg.n_layers)
                   for t in _ATTN_TENSORS + ffn]
    known = {"token_embd.weight", "output.weight", "output_norm.weight",
             "rope_freqs.weight", *layer_names}
    for name in names:
        if name in known:
            continue
        if cfg.n_experts and re.fullmatch(
                r"blk\.\d+\.ffn_(gate|up|down)\.\d+\.weight", name):
            raise NotImplementedError(
                f"tensor {name}: per-expert 2-D tensors (the pre-2024 "
                "schema) are not read; the port loads the 3-D "
                "ffn_*_exps stacks")
        raise NotImplementedError(f"tensor {name}: {_NOT_PORTED}")
    if cfg.n_experts:
        missing = next((n for n in layer_names if n not in names), None)
        if missing is not None:
            raise NotImplementedError(
                f"tensor {missing}: missing from an expert file")


def load_llama(path: str, device="cuda"):
    """Load a llama-architecture GGUF onto `device` (the card unless the
    caller asks for the CPU): (cfg, params). A file whose config or
    tensors the port's forward would ignore is refused with
    NotImplementedError before any weight is loaded, and so is one whose
    head dim the card's attention kernels do not take when `device` is
    cuda. Asking for cuda where torch sees no CUDA device raises
    RuntimeError after those checks, before any weight is loaded: nothing
    runs on the CPU unasked."""
    device = torch.device(device)
    with GGUFReader(path) as reader:
        arch = reader.metadata.get("general.architecture", "llama")
        if arch != "llama":
            raise NotImplementedError(
                f"architecture {arch!r} is not ported yet (ROADMAP.md, "
                "queue 1: remaining model families)")
        cfg = LlamaConfig.from_gguf_metadata(reader.metadata)
        check_forward_computes(cfg)
        check_device_computes(cfg, device.type)
        check_tensors_loaded(reader.tensors, cfg)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{path}: no CUDA device visible to torch; the port runs "
                "on the card unless the caller passes device='cpu'")
        if "rope_freqs.weight" in reader.tensors:
            cfg = dataclasses.replace(cfg, rope_freq_factors=tuple(
                float(x) for x in reader.load_array("rope_freqs.weight")))
        params = {
            "token_embd": _load_weight(reader, "token_embd.weight", device),
            "output_norm": _load_f32(reader, "output_norm.weight", device),
            "layers": [],
        }
        params["output"] = (_load_weight(reader, "output.weight", device)
                            if "output.weight" in reader.tensors
                            else params["token_embd"])
        for i in range(cfg.n_layers):
            p = f"blk.{i}."
            layer = {nk: _load_f32(reader, p + tk, device)
                     for nk, tk in (("attn_norm", "attn_norm.weight"),
                                    ("ffn_norm", "ffn_norm.weight"))}
            ffn = ((("gate", "ffn_gate"), ("up", "ffn_up"),
                    ("down", "ffn_down")) if not cfg.n_experts
                   else _EXPERT_PARAMS)
            for nk, tk in (("wq", "attn_q"), ("wk", "attn_k"),
                           ("wv", "attn_v"), ("wo", "attn_output"), *ffn):
                layer[nk] = _load_weight(reader, p + tk + ".weight", device)
            if cfg.n_experts:
                layer["gate_inp"] = _load_f32(
                    reader, p + "ffn_gate_inp.weight", device)
            params["layers"].append(layer)
    return cfg, params


def write_random_llama_gguf(path: str, cfg: LlamaConfig,
                            fmt: GGMLType = GGMLType.Q4_K, seed: int = 0,
                            extra_metadata: dict | None = None) -> None:
    """Write a random llama-architecture GGUF (tests, smoke runs); `fmt`
    is a `GGMLType` (re-exported by `gguf_tpu_torch.models`).

    Byte-identical to `gguf_tpu.models.write_random_llama_gguf(path, cfg,
    fmt, seed, extra_metadata)` with arch "llama": the same generator
    draws in the same order. Projections and the embedding are quantized
    to `fmt`; the output head is Q6_K for Q4_K, Q5_K and Q6_K `fmt`
    (llama.cpp's Q4_K_M recipe) and `fmt` otherwise (Q2_K, Q3_K, Q8_0,
    Q4_0, IQ4_XS, ...); norms are F32 ones. With `cfg.n_experts` > 0 each
    layer's FFN is a mixtral-family one: an F32 router `ffn_gate_inp`
    (E, dim) and the 3-D `ffn_{gate,up,down}_exps` stacks in `fmt`."""
    rng = np.random.default_rng(seed)
    d, f, v = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    q_d = cfg.n_heads * cfg.head_dim
    kv_d = cfg.n_kv_heads * cfg.head_dim
    scale = 0.5 / np.sqrt(d)

    def w(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def quant(shape, t=fmt):
        return (t, shape, quantize_tensor(w(shape), t))

    def ones(n):
        return (GGMLType.F32, (n,), np.ones(n, np.float32))

    head_fmt = (GGMLType.Q6_K if fmt in (GGMLType.Q4_K, GGMLType.Q5_K,
                                         GGMLType.Q6_K) else fmt)
    tensors = {
        "token_embd.weight": quant((v, d)),
        "output.weight": quant((v, d), head_fmt),
        "output_norm.weight": ones(d),
    }
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        tensors[p + "attn_norm.weight"] = ones(d)
        tensors[p + "ffn_norm.weight"] = ones(d)
        for name, shape in (("attn_q.weight", (q_d, d)),
                            ("attn_k.weight", (kv_d, d)),
                            ("attn_v.weight", (kv_d, d)),
                            ("attn_output.weight", (d, q_d))):
            tensors[p + name] = quant(shape)
        if cfg.n_experts:
            e, ef = cfg.n_experts, cfg.expert_ffn_dim or f
            # the router at std 0.15: margins wide enough that a bf16
            # rounding seldom flips a token's top-k
            tensors[p + "ffn_gate_inp.weight"] = (
                GGMLType.F32, (e, d),
                (rng.standard_normal((e, d)) * 0.15).astype(np.float32))
            ffn = (("ffn_gate_exps.weight", (e, ef, d)),
                   ("ffn_up_exps.weight", (e, ef, d)),
                   ("ffn_down_exps.weight", (e, d, ef)))
        else:
            ffn = (("ffn_gate.weight", (f, d)), ("ffn_up.weight", (f, d)),
                   ("ffn_down.weight", (d, f)))
        for name, shape in ffn:
            tensors[p + name] = quant(shape)
    if cfg.rope_freq_factors is not None:
        rd = cfg.rope_dim or cfg.head_dim
        tensors["rope_freqs.weight"] = (
            GGMLType.F32, (rd // 2,),
            np.asarray(cfg.rope_freq_factors, np.float32))
    md = cfg.to_gguf_metadata("llama")
    md.update(extra_metadata or {})
    write_gguf(path, md, tensors)
