"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

Builds the port's GGUF quantizer core (gcc) and then, while child
processes write (or reuse, under the temp dir) the random checkpoints
below, its fifteen hand-written CUDA kernels from gguf_tpu_torch/csrc (one
nvcc per source, all at once). Checkpoints, each at full width with
random weights from a seed: TinyLlama-1.1B (22 layers) as Q4_K_M (Q4_K
projections and embedding, Q6_K head), Q5_K_M (Q5_K, Q6_K head), Q8_0
and Q4_0 (every matrix in the format, head and embedding included), and
in llama.cpp's Q2_K mix (`q2k_mix_type`); 2-layer TinyLlama-width Q4_1,
Q5_0, Q5_1, Q2_K, Q3_K, IQ4_NL and IQ4_XS (every matrix in the format);
and Llama-2-7B as Q4_K_M. It then runs the main paths below, each with
every kernel's launch counter reset just before it and read just after:

Q4_K_M with bf16 activations (kernels K1-K4):
1. holds K1-K4 against their plain PyTorch versions on the card, at the
   shapes the serving path gives them, timing both with CUDA events;
2. serves 24 token-id prompts (5..300 tokens, 32 new tokens each, greedy)
   through `LLM(max_batch=16, max_seq=2048).generate`;
3. checks every logit of that run finite, and the card's logits for a
   16-token prompt against the CPU run of the same port (plain versions):
   within 1e-2 * max|ref| through 2 layers, 5e-2 through all 22.

Q5_K_M under llama.cpp's Q8_1 numerics, `MMOpts(act_quant=True,
precision="high")` (kernels K2-K8):
4. holds K5 (Q8_1 codes) and K6 (fake-quant) bit-equal to their plain
   versions, K7 (the integer MMQ contract) within 1e-5 at every width it
   is built for, K8 (Q5_K MMQ) within 1e-3 of max|ref| under "fast" and
   1e-5 under "high", on bf16 activations and on K6's f32 output, and K2
   on K6's output under "high" within 1e-5;
5. serves the same 24 prompts and requires launches of K2-K8 on that run;
6. checks its logits as in 3: through 2 layers within 1e-2 with bf16
   activations and within 3e-2 under act_quant (where one code moved by
   a last-ulp difference upstream shifts the output by a whole quantum),
   all 22 layers finite; then feeds every projection of a 16- and a
   64-token prefill (2 layers) the CPU run's input on the card and
   requires the route the JAX package takes (K5+K7, K6+K8, K6+K2) and
   the CPU port's output within 1e-5;
7. scores 2,048 seeded token ids with `perplexity_of_gguf(act_quant=True,
   window=512)` and holds the card's mean NLL over one 256-token window,
   2 layers, within 1e-2 nats of the CPU run's.

The 32-element-block formats (kernels K10 `mmq_q8_0` and K11
`mmq_legacy`, with K3, K4 and, under act_quant, K6):
8. holds K10 against its plain version at every TinyLlama projection and
   the head and K11 for Q4_0, Q4_1, Q5_0 and Q5_1 at gate_up and down,
   n = 1, 16, 64, 65, 512, "fast" (1e-3 of max|ref|) and "high" (1e-5),
   on bf16 activations and fed K6's output (K11 with its fp16 block
   sums), and K10 through `compat.mmq_q8_0` at M, N in {1, 4, 16} and
   K = 32, 64, 96, 128;
9. serves the 24 prompts through the 22-layer Q8_0 and then the Q4_0
   checkpoint (bf16 activations), requiring launches of K10 (then K11),
   K3 and K4 and none of K1, K2, K7 or K8, then splits a 16-slot decode
   step of each at span 256 (host clock and `torch.profiler`);
10. checks 2 layers of each of the five formats against the CPU run
   (logits within 1e-2), and for Q8_0 and Q5_1 every projection of a
   16- and a 64-token act_quant prefill as in 6 (routes K6+K10, K6+K11).

The low-bit formats (kernels K12 `mmq_q2_k`, K13 `mmq_q3_k`, K14
`mmq_iq4`, with K1-K4 in the Q2_K mix; K15 `rms_norm`):
a. holds K12 and K13 against their plain versions at every projection of
   the 2-layer Q2_K / Q3_K files, the head and the mix's unfused wq and
   wk, n = 1, 16, 64, 65, 512 (both sides of K12's n_pad <= 64 arm),
   "fast" (1e-3 of max|ref|) and "high" (1e-5), on bf16 activations and
   fed K6's output, and through `compat.mmq_q2_k` / `compat.mmq_q3_k` at
   M, N in {1, 4, 16}; K15 against its plain version at n = 1, 16, 64,
   d = 2048 and 4096, f32 and bf16 input (1e-6);
b. serves the 24 prompts through the 22-layer Q2_K mix, requiring
   launches of K12, K13, K1, K2, K3 and K4 and none of the other MMQ
   kernels, then splits a 16-slot decode step at span 256 (host clock,
   launches per step and `torch.profiler`) and recomputes every RMSNorm
   of one such step with K15 beside the model's own (1e-6);
c. checks 2 layers of the mix and of the Q2_K and Q3_K files against the
   CPU run (logits within 1e-2), with the act_quant projection check of
   6 for Q2_K and Q3_K (routes K6+K12, K6+K13);
d. after the 7B phases, K14 as in a. on the IQ4_NL and IQ4_XS files,
   the 24 prompts served through the IQ4_XS one (K14 launched), and the
   checks of c. for both (projection check for IQ4_XS: K6+K14).

Llama-2-7B Q4_K_M with bf16 activations at its 4,096-token context
(kernels K1-K4 and K9, flash-decoding):
11. holds K9 against its plain version ("fast" and "high", 1e-3 of
   max|ref|) at the 7B geometry (16 slots, 32 heads of 128, spans 1024,
   2048 and 4096, positions 0, 255, 256, random ones and an inactive slot
   at pos = 4096), with a sliding window and softcap, and at the
   TinyLlama geometry (8 query heads per KV head, hd 64, span 2048); then
   K3/K4 at hd 128 with one query head per KV head and K1/K2 at every 7B
   projection and the head, against their plain versions;
12. serves two rounds of 16 requests through `LLM(max_batch=16,
   max_seq=4096)`, 32 greedy tokens each: round A (prompts of 5..440
   tokens, every decode step at span <= 512: K1-K4) and round B (600..3,900
   tokens: prefill crosses every span bucket, decode runs at span 4096 on
   K3 + K9), every logit finite;
13. times a 16-slot decode step at span 512 and at span 4096 (host clock
   and `torch.profiler`: device time, K9 per layer beside its bound) and
   a 512-token prefill chunk;
14. checks 2 layers against the CPU run of the same port: the logits of a
   16-token prefill, then a 2,100-token prefill on the card whose cache
   is copied to the CPU, and one t = 1 and one t = 8 step at span 4096 on
   both (1e-2 of max|ref|); the card's t = 1 step must launch K9 and no
   K4, its t = 8 step neither (the f32 arm).

`--profile` instead splits a 16-slot decode step of the Q5_K_M
checkpoint with bf16 activations and under act_quant (host clock and
`torch.profiler`), and checks nothing.

Prints the card's name and power limit, a per-shape table, seconds per
phase and in total, one JSON line {"kernels": [...]} (per kernel its
headline shape's times, its bound from this run's inputs and, where one
PyTorch call computes the same function, that call's time) and, last,
{"ok": true, "device": {...}}. Any failed check raises and the script
exits nonzero. Needs one CUDA device, nvcc and gcc.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from gguf_tpu_torch import compat
from gguf_tpu_torch.engine import LLM, SamplerConfig
from gguf_tpu_torch.engine import engine as engine_mod
from gguf_tpu_torch.eval import perplexity_of_gguf, sequence_nll
from gguf_tpu_torch.gguf import quantize_tensor, write_gguf
from gguf_tpu_torch.models import (GGMLType, LlamaConfig, MMOpts, forward,
                                   fuse_llama_params, init_kv_cache,
                                   load_llama, write_random_llama_gguf)
from gguf_tpu_torch.models import llama as llama_mod
from gguf_tpu_torch.ops import MMQ, build
from gguf_tpu_torch.ops.activation import (fake_quantize_q8_1,
                                           fake_quantize_q8_1_plain,
                                           quantize_q8_1_codes,
                                           quantize_q8_1_codes_plain,
                                           rms_norm, rms_norm_plain)
from gguf_tpu_torch.ops.attention import (_attend_cuda, decode_attention,
                                          decode_attention_plain,
                                          decode_attention_tiled,
                                          decode_attention_tiled_plain,
                                          decode_attention_update,
                                          kv_cache_insert,
                                          kv_cache_insert_plain)
from gguf_tpu_torch.ops.mmq_iq4 import mmq_iq4, mmq_iq4_plain
from gguf_tpu_torch.ops.mmq_legacy import mmq_legacy, mmq_legacy_plain
from gguf_tpu_torch.ops.mmq_q2_k import mmq_q2_k, mmq_q2_k_plain
from gguf_tpu_torch.ops.mmq_q3_k import mmq_q3_k, mmq_q3_k_plain
from gguf_tpu_torch.ops.mmq_q4_k import (mmq_i8, mmq_i8_plain, mmq_q4_k,
                                         mmq_q4_k_plain)
from gguf_tpu_torch.ops.mmq_q5_k import mmq_q5_k, mmq_q5_k_plain
from gguf_tpu_torch.ops.mmq_q6_k import mmq_q6_k, mmq_q6_k_plain
from gguf_tpu_torch.ops.mmq_q8_0 import mmq_q8_0, mmq_q8_0_plain
from gguf_tpu_torch.quant import QUANTIZERS, QuantWeight
from gguf_tpu_torch.quant.layouts import q2_k_parts

# TinyLlama-1.1B (benchmarks/suite.py): vocab 32000, dim 2048, 22 layers,
# 32 heads, 4 KV heads (head_dim 64), ffn 5632
CFG = LlamaConfig(vocab_size=32000, dim=2048, n_layers=22, n_heads=32,
                  n_kv_heads=4, ffn_dim=5632, max_seq_len=2048)
CFG2 = dataclasses.replace(CFG, n_layers=2)    # the 2-layer reference files
MAX_BATCH, MAX_SEQ, NEW_TOKENS = 16, 2048, 32
DEVICE = "cuda"
PROMPT_LENS = (5, 7, 8, 12, 16, 24, 33, 48, 60, 64, 80, 100, 128, 150, 175,
               200, 225, 250, 260, 270, 280, 290, 295, 300)
# Llama-2-7B (meta-llama/Llama-2-7b-hf config.json; benchmarks/suite.py
# "7b"): vocab 32000, dim 4096, 32 layers, 32 heads, 32 KV heads (head_dim
# 128), ffn 11008, rope theta 10000, RMS eps 1e-5, context 4096
CFG7B = LlamaConfig(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                    n_kv_heads=32, ffn_dim=11008, max_seq_len=4096)
SEQ7B = 4096
# round A: every decode step at span <= 512; round B: decode at span 4096
ROUND_A = (5, 12, 24, 40, 64, 90, 128, 160, 200, 240, 280, 320, 360, 400,
           420, 440)
ROUND_B = (600, 800, 1000, 1200, 1400, 1700, 2000, 2100, 2300, 2600, 2900,
           3100, 3300, 3500, 3700, 3900)
LONG_PROMPT = 2100             # the long-span reference check's prefill
TILED_SPANS = (1024, 2048, 4096)
MMQ_NS = (1, 16, 512)
BLOCK32_NS = (1, 16, 64, 65, 512)  # both sides of the reference's n <= 64 arm
COMPAT_MNS, COMPAT_KS = (1, 4, 16), (32, 64, 96, 128)
KQUANT_COMPAT_KS = (256, 512)   # Q2_K/Q3_K: K a multiple of the superblock
NORM_NS, NORM_DS = (1, 16, 64), (2048, 4096)
ATTN_TS, ATTN_SPANS = (1, 8), (128, 512, 2048)
ATTN_SPANS_7B = (128, 512)
Q81_NS, Q81_KS = (1, 16, 64, 512), (2048, 5632)
I8_NS = (1, 4, 8, 16)           # the JAX package's integer route: n <= 16
# K6's f32 output feeds K8 above n = 16 (prefill chunks, perplexity) and
# K2 (the head) at every n; the engine pads prefill tails to 8 and 16
FQ_NS, HEAD_NS = (24, 512), (1, 16, 512)
ROUTE_TS = (16, 64)             # prefills on the integer and the float route
ACT_QUANT = MMOpts(act_quant=True, precision="high")
PPL_TOKENS, PPL_WINDOW, NLL_WINDOW = 2048, 512, 256
TOL_MMQ = 1e-3        # bf16 operands, f32 sums in another order
TOL_ATTN = 1e-3
TOL_I8 = 1e-5         # exact int32 partials, f32 scale sums in another order
TOL_HIGH = 1e-5       # "high": f32 operands, f32 sums in another order
# one projection, card vs CPU port on the same input under act_quant: the
# codes are bit-equal, so only the f32 sums' order differs; a projection
# fed unquantized activations differs by ~1e-3 (logged by the check)
TOL_ROUTE = 1e-5
TOL_LOGITS = 1e-2     # logits after 2 layers of bf16 residual stream
# after 22 random-weight layers two correct implementations drift apart:
# the JAX package and this port's CPU path differ by 2.2-2.4% of max|logit|
# on 22-layer checkpoints (dim 256 and 512, the same 16-token prefill)
TOL_LOGITS_22 = 5e-2
# under act_quant a last-ulp difference in a layer's input (rms_norm, rope,
# silu run as different torch kernels on the card and the CPU) can move a
# Q8_1 code by a whole quantum (1/127 of its block's max): the 2-layer
# logits then differ by 2-4 bf16 ulps of max|logit| instead of 1 (the
# JAX package vs the port on the CPU: 1.5-1.9%, tests/test_torch_model.py);
# `projection_check` holds each projection's route to 1e-5 on its own input
TOL_LOGITS_ACT_QUANT = 3e-2
TOL_NATS = 1e-2       # mean NLL, card vs CPU, 2 layers
# RMSNorm in f32: the sum of squares in another order, and rsqrtf within an
# ulp or two of torch's rsqrt
TOL_NORM = 1e-6
KERNELS = {   # name -> (CUDA source, the TPU kernel it replaces)
    "mmq_q4_k": ("gguf_tpu_torch/csrc/mmq_q4_k.cu",
                 "gguf_tpu/ops/mmq_q4_k.py:223"),
    "mmq_q6_k": ("gguf_tpu_torch/csrc/mmq_q6_k.cu",
                 "gguf_tpu/ops/mmq_q6_k.py:116"),
    "kv_cache_insert": ("gguf_tpu_torch/csrc/attention.cu",
                        "gguf_tpu/ops/attention.py:61"),
    "decode_attention": ("gguf_tpu_torch/csrc/attention.cu",
                         "gguf_tpu/ops/attention.py:208"),
    "quantize_q8_1_codes": ("gguf_tpu_torch/csrc/activation.cu",
                            "gguf_tpu/ops/activation.py:93"),
    "fake_quantize_q8_1": ("gguf_tpu_torch/csrc/activation.cu",
                           "gguf_tpu/ops/activation.py:158"),
    "mmq_i8": ("gguf_tpu_torch/csrc/mmq_i8.cu",
               "gguf_tpu/ops/mmq_q4_k.py:268"),
    "mmq_q5_k": ("gguf_tpu_torch/csrc/mmq_q5_k.cu",
                 "gguf_tpu/ops/mmq_q5_k.py:65"),
    "decode_attention_tiled": ("gguf_tpu_torch/csrc/attention.cu",
                               "gguf_tpu/ops/attention.py:369"),
    "mmq_q8_0": ("gguf_tpu_torch/csrc/mmq_q8_0.cu",
                 "gguf_tpu/ops/mmq_q8_0.py:64"),
    "mmq_legacy": ("gguf_tpu_torch/csrc/mmq_legacy.cu",
                   "gguf_tpu/ops/mmq_legacy.py:41"),
    "mmq_q2_k": ("gguf_tpu_torch/csrc/mmq_q2_k.cu",
                 "gguf_tpu/ops/mmq_q2_k.py:131"),
    "mmq_q3_k": ("gguf_tpu_torch/csrc/mmq_q3_k.cu",
                 "gguf_tpu/ops/mmq_q3_k.py:47"),
    "mmq_iq4": ("gguf_tpu_torch/csrc/mmq_iq4.cu",
                "gguf_tpu/ops/mmq_iq4.py:39"),
    "rms_norm": ("gguf_tpu_torch/csrc/activation.cu",
                 "gguf_tpu/ops/activation.py:128"),
}
SOURCES = sorted({os.path.basename(src)[:-3] for src, _ in KERNELS.values()})
WRAPPERS = {"mmq_q4_k": mmq_q4_k, "mmq_q6_k": mmq_q6_k,
            "kv_cache_insert": kv_cache_insert,
            "decode_attention": decode_attention,
            "quantize_q8_1_codes": quantize_q8_1_codes,
            "fake_quantize_q8_1": fake_quantize_q8_1,
            "mmq_i8": mmq_i8, "mmq_q5_k": mmq_q5_k,
            "decode_attention_tiled": decode_attention_tiled,
            "mmq_q8_0": mmq_q8_0, "mmq_legacy": mmq_legacy,
            "mmq_q2_k": mmq_q2_k, "mmq_q3_k": mmq_q3_k, "mmq_iq4": mmq_iq4,
            "rms_norm": rms_norm}
# the MMQ kernels (wrapper, plain version) of the low-bit formats
LOWBIT = {"mmq_q2_k": (mmq_q2_k, mmq_q2_k_plain),
          "mmq_q3_k": (mmq_q3_k, mmq_q3_k_plain),
          "mmq_iq4": (mmq_iq4, mmq_iq4_plain)}
# the kernels each main path must launch; a kernel's "launches" in the
# {"kernels": ...} line come from the last path that requires it
Q4KM_KERNELS = ("mmq_q4_k", "mmq_q6_k", "kv_cache_insert", "decode_attention")
Q5KM_KERNELS = ("mmq_q6_k", "kv_cache_insert", "decode_attention",
                "quantize_q8_1_codes", "fake_quantize_q8_1", "mmq_i8",
                "mmq_q5_k")
Q8_0_KERNELS = ("mmq_q8_0", "kv_cache_insert", "decode_attention")
Q4_0_KERNELS = ("mmq_legacy", "kv_cache_insert", "decode_attention")
Q2K_MIX_KERNELS = ("mmq_q2_k", "mmq_q3_k", "mmq_q4_k", "mmq_q6_k",
                   "kv_cache_insert", "decode_attention")
IQ4_XS_KERNELS = ("mmq_iq4", "kv_cache_insert", "decode_attention")
# every MMQ kernel: a serving path with bf16 activations must launch none
# but those of its own formats
MMQ_KERNELS = ("mmq_q4_k", "mmq_q6_k", "mmq_i8", "mmq_q5_k", "mmq_q8_0",
               "mmq_legacy", "mmq_q2_k", "mmq_q3_k", "mmq_iq4")
ROUND_A_KERNELS = Q4KM_KERNELS
ROUND_B_KERNELS = ("mmq_q4_k", "mmq_q6_k", "kv_cache_insert",
                   "decode_attention_tiled")
# the (decode-width) shape whose times stand in the {"kernels": ...} line
HEADLINE = {"mmq_q4_k": "gate_up 11264x2048 n=16",
            "mmq_q6_k": "head 32000x2048 n=16",
            "kv_cache_insert": "b16 t=1",
            "decode_attention": "b16 t=1 span=512 insert",
            "quantize_q8_1_codes": "n=16 K=2048 bf16",
            "fake_quantize_q8_1": "n=16 K=2048 bf16",
            "mmq_i8": "q5_k gate_up 11264x2048 n=16",
            "mmq_q5_k": "gate_up 11264x2048 n=16 fast",
            "decode_attention_tiled": "b16 h32 hd128 span=4096 fast",
            "mmq_q8_0": "gate_up 11264x2048 n=16 fast",
            "mmq_legacy": "q4_0 gate_up 11264x2048 n=16 fast",
            "mmq_q2_k": "gate_up 11264x2048 n=16 fast",
            "mmq_q3_k": "gate_up 11264x2048 n=16 fast",
            "mmq_iq4": "iq4_xs gate_up 11264x2048 n=16 fast",
            "rms_norm": "n=16 d=2048 bf16"}
# peak rates of one H100 SXM (NVIDIA's data sheet, dense): a kernel's bound
# is the larger of its bytes over HBM_BPS and its operations over the peak
# of their type
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms: CUDA events around `iters` calls
    after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10, tries: int = 3) -> float | None:
    """Device time of fn() in ms from torch.profiler: the summed time of
    the kernels (and copies) it runs, per call, without the host's time
    between launches that CUDA events around back-to-back calls include
    when the wrapper's host work outlasts its kernel. On the H100 the
    profiler has dropped every event of a kernel in one of ~16 such
    windows, so the reading of the window with the most device events is
    kept; None (not measured) if no window saw any."""
    fn()
    torch.cuda.synchronize()
    best = (0, None)
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        count = sum(e.count for e in kern)
        if count > best[0]:
            best = (count, sum(e.self_device_time_total for e in kern)
                    / iters / 1e3)
    return best[1]


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def nbytes(*objs) -> int:
    """Bytes of tensors and quantized weights (every field)."""
    return sum(sum(f.numel() * f.element_size() for f in o.fields.values())
               if hasattr(o, "fields") else o.numel() * o.element_size()
               for o in objs)


def bound_ms(n_bytes: float, ops: float, kind: str) -> tuple:
    """The least time the card could take: (ms, "bytes" or "operations")."""
    tb, to = n_bytes / HBM_BPS, ops / PEAK_OPS[kind]
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def live_rows(pos: torch.Tensor, span: int) -> int:
    """Cache rows per KV head, summed over the batch, that attention at
    t = 1 must read: the columns c < span with c <= pos."""
    return int(torch.clamp(pos.long() + 1, min=0, max=span).sum())


class Report:
    """Per-kernel worst error; the headline shape's times, bound and
    library yardstick."""

    def __init__(self):
        self.err = {k: 0.0 for k in KERNELS}
        self.times = {}
        self.bound = {}
        self.library = {}

    def add(self, kernel, shape, err, rel, tol, fn=None, plain_fn=None,
            work=None, library=None):
        """Record one check; time fn (the kernel) and plain_fn with CUDA
        events, and at the headline shape also by profiler device time,
        with the bound from `work` = (bytes, operations, their type) and
        the time of the call that `library()` returns, one PyTorch call
        computing the same function (or None)."""
        ok = rel <= tol
        times = "not timed"
        if ok and fn is not None:
            ms, pms = cuda_ms(fn), cuda_ms(plain_fn, iters=5)
            times = f"{ms:.4f} ms vs plain {pms:.4f} ms"
            if shape == HEADLINE[kernel]:
                dms, pdms = device_ms(fn), device_ms(plain_fn)
                self.times[kernel] = (ms, pms, dms, pdms)
                self.bound[kernel] = bound_ms(*work)
                self.library[kernel] = None if library is None else cuda_ms(
                    library())
                dev = ["not measured" if v is None else f"{v:.4f} ms"
                       for v in (dms, pdms)]
                lib = ("none" if library is None
                       else f"{self.library[kernel]:.4f} ms")
                times += (f" (device {dev[0]} vs plain {dev[1]}; bound "
                          f"{self.bound[kernel][0]:.4f} ms by "
                          f"{self.bound[kernel][1]}; library {lib})")
        log(f"  {kernel:19s} {shape:38s} max|d|={err:.3e} rel={rel:.2e} "
            f"(tol {tol:g}) {times}{'' if ok else '  FAILED'}")
        if not ok:
            raise AssertionError(f"{kernel} {shape}: rel err {rel} > {tol}")
        self.err[kernel] = max(self.err[kernel], err)


def matmul_library(w, x: torch.Tensor):
    """The yardstick of an MMQ kernel: torch.matmul on the weight
    dequantized to bf16 beforehand (bf16 activations)."""
    wd = w.dequantize().to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    return lambda: torch.matmul(xb, wd.T)


def sdpa_library(q, cache, pos, span: int, precision: str):
    """The yardstick of K4/K9 at t = 1: F.scaled_dot_product_attention over
    the first `span` rows of the cache dequantized beforehand (bf16 under
    "fast", else f32), KV heads repeated for GQA, with the causal mask."""
    dt = torch.bfloat16 if precision == "fast" else torch.float32
    k, ks, v, vs = cache
    g = q.shape[1] // k.shape[1]
    kd, vd = ((c[:, :, :span].float() * sc[:, :, :span, None]).to(dt)
              .repeat_interleave(g, dim=1) for c, sc in ((k, ks), (v, vs)))
    mask = (torch.arange(span, device=q.device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qd = q.to(dt)
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)


def check_toolchain() -> None:
    log(f"nvcc {build.find_nvcc()}, gcc {build.find_gcc()}")


def build_kernels() -> None:
    """One nvcc per CUDA source, all started together."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = dict(zip(SOURCES, pool.map(build.build, SOURCES)))
    for name, path in paths.items():
        with open(path[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")


def q2k_mix_type(name: str, cfg: LlamaConfig) -> GGMLType:
    """The tensor type of a matrix in llama.cpp's Q2_K files
    (LLAMA_FTYPE_MOSTLY_Q2_K in `llama_tensor_get_type`, llama.cpp's
    src/llama-quant.cpp): attn_v Q4_K when n_heads / n_kv_heads >= 4, else
    Q3_K; attn_output and ffn_down Q3_K; output.weight Q6_K; every other
    matrix, token_embd included, Q2_K."""
    if name == "output.weight":
        return GGMLType.Q6_K
    if name.endswith("attn_v.weight"):
        return (GGMLType.Q4_K if cfg.n_heads // cfg.n_kv_heads >= 4
                else GGMLType.Q3_K)
    if name.endswith(("attn_output.weight", "ffn_down.weight")):
        return GGMLType.Q3_K
    return GGMLType.Q2_K


def write_q2k_mix(path: str, cfg: LlamaConfig, seed: int = 0) -> None:
    """A random llama checkpoint in the Q2_K mix (`q2k_mix_type`): the
    draws of `write_random_llama_gguf` in its order (N(0, 1) * 0.5 /
    sqrt(dim) per matrix, F32 norms of ones), each matrix quantized to its
    type with the port's `quantize_tensor`, written by `write_gguf`."""
    rng = np.random.default_rng(seed)
    d, f, v = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    q_d, kv_d = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {"token_embd.weight": (v, d), "output.weight": (v, d)}
    for i in range(cfg.n_layers):
        for name, shape in (("attn_q", (q_d, d)), ("attn_k", (kv_d, d)),
                            ("attn_v", (kv_d, d)), ("attn_output", (d, q_d)),
                            ("ffn_gate", (f, d)), ("ffn_up", (f, d)),
                            ("ffn_down", (d, f))):
            shapes[f"blk.{i}.{name}.weight"] = shape
    tensors = {}
    for name, shape in shapes.items():
        t = q2k_mix_type(name, cfg)
        w = (rng.standard_normal(shape) * (0.5 / np.sqrt(d))).astype(np.float32)
        tensors[name] = (t, shape, quantize_tensor(w, t))
    ones = (GGMLType.F32, (d,), np.ones(d, np.float32))
    tensors["output_norm.weight"] = ones
    for i in range(cfg.n_layers):
        tensors[f"blk.{i}.attn_norm.weight"] = ones
        tensors[f"blk.{i}.ffn_norm.weight"] = ones
    write_gguf(path, cfg.to_gguf_metadata("llama"), tensors)


def _uniform(fmt: GGMLType):
    """The writer of a checkpoint whose matrices are all `fmt` (the head
    Q6_K for the K-quant formats Q4_K to Q6_K)."""
    return functools.partial(write_random_llama_gguf, fmt=fmt)


# tag -> (config, writer(path, cfg, seed=), model name in the file name)
CHECKPOINTS = {"q4km": (CFG, _uniform(GGMLType.Q4_K), "tinyllama"),
               "q5km": (CFG, _uniform(GGMLType.Q5_K), "tinyllama"),
               "q8_0": (CFG, _uniform(GGMLType.Q8_0), "tinyllama"),
               "q4_0": (CFG, _uniform(GGMLType.Q4_0), "tinyllama"),
               "q4_1_2l": (CFG2, _uniform(GGMLType.Q4_1), "tinyllama"),
               "q5_0_2l": (CFG2, _uniform(GGMLType.Q5_0), "tinyllama"),
               "q5_1_2l": (CFG2, _uniform(GGMLType.Q5_1), "tinyllama"),
               "q2k_mix": (CFG, write_q2k_mix, "tinyllama"),
               "q2_k_2l": (CFG2, _uniform(GGMLType.Q2_K), "tinyllama"),
               "q3_k_2l": (CFG2, _uniform(GGMLType.Q3_K), "tinyllama"),
               "iq4_nl_2l": (CFG2, _uniform(GGMLType.IQ4_NL), "tinyllama"),
               "iq4_xs_2l": (CFG2, _uniform(GGMLType.IQ4_XS), "tinyllama"),
               "q4km_7b": (CFG7B, _uniform(GGMLType.Q4_K), "llama2_7b")}


def checkpoint_path(seed: int, tag: str) -> str:
    model = CHECKPOINTS[tag][2]
    return os.path.join(tempfile.gettempdir(),
                        f"gguf_tpu_torch_{model}_{tag}_seed{seed}.gguf")


def write_checkpoint(seed: int, tag: str) -> None:
    """Write one random checkpoint (the child process's whole work)."""
    cfg, writer, _ = CHECKPOINTS[tag]
    path = checkpoint_path(seed, tag)
    tmp = path + f".{os.getpid()}.tmp"
    t0 = time.perf_counter()
    writer(tmp, cfg, seed=seed)
    os.replace(tmp, path)
    log(f"wrote {path} in {time.perf_counter() - t0:.1f} s")


class Writers:
    """Checkpoints missing under the temp dir, each written by a child
    process (`--write TAG`), all started at once; `stop` ends any still
    running."""

    def __init__(self, seed: int, tags: tuple):
        self.procs = {}
        env = dict(os.environ, OMP_WAIT_POLICY="PASSIVE")
        for tag in tags:
            path = checkpoint_path(seed, tag)
            proc = None if os.path.exists(path) else subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--seed",
                 str(seed), "--write", tag], env=env)
            self.procs[tag] = (path, proc)

    def wait(self, tag: str) -> str:
        path, proc = self.procs[tag]
        if proc is not None and proc.wait() != 0:
            raise RuntimeError(f"step 'checkpoint {tag}': the writer exited "
                               f"with {proc.returncode}")
        return path

    def stop(self) -> None:
        for _, proc in self.procs.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def _mmq_work(w, x, out, kind: str = "bf16") -> tuple:
    """An MMQ call's bytes (weight, activations, output) and operations."""
    n, m = out.shape
    return nbytes(w, x, out), 2.0 * n * m * w.shape[1], kind


def compare_mmq(params: dict, gen: torch.Generator, rep: Report) -> None:
    """K1 on the Q4_K_M projections, K2 on the head (bf16, "fast")."""
    layer = params["layers"][0]
    for n in MMQ_NS:
        for name, key, glu in (("wqkv", "wqkv", None), ("wo", "wo", None),
                               ("gate_up", "gate_up", None),
                               ("down+glu", "down", "silu")):
            w = layer[key]
            k = w.shape[1] * (2 if glu else 1)
            x = torch.randn((n, k), generator=gen, device=DEVICE).bfloat16()
            got = mmq_q4_k(w, x, precision="fast", glu=glu)
            ref = mmq_q4_k_plain(w, x, precision="fast", glu=glu)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            rep.add("mmq_q4_k", f"{name} {w.shape[0]}x{w.shape[1]} n={n}",
                    err, rel, TOL_MMQ,
                    lambda: mmq_q4_k(w, x, precision="fast", glu=glu),
                    lambda: mmq_q4_k_plain(w, x, precision="fast", glu=glu),
                    work=_mmq_work(w, x, got),
                    library=lambda: matmul_library(w, x))
        w = params["output"]
        x = torch.randn((n, w.shape[1]), generator=gen, device=DEVICE).bfloat16()
        got = mmq_q6_k(w, x, precision="fast")
        ref = mmq_q6_k_plain(w, x, precision="fast")
        err, rel = rel_err(got, ref)
        rep.add("mmq_q6_k", f"head {w.shape[0]}x{w.shape[1]} n={n}",
                err, rel, TOL_MMQ, lambda: mmq_q6_k(w, x, precision="fast"),
                lambda: mmq_q6_k_plain(w, x, precision="fast"),
                work=_mmq_work(w, x, got),
                library=lambda: matmul_library(w, x))


def _random_cache(gen: torch.Generator, b: int, kvh: int, s: int, hd: int):
    def codes():
        return torch.randint(-127, 128, (b, kvh, s, hd), generator=gen,
                             device=DEVICE, dtype=torch.int8)

    def scales():
        return torch.rand((b, kvh, s), generator=gen, device=DEVICE) * 0.02

    return [codes(), scales(), codes(), scales()]


def _attn_work(q, kn, cache, pos, span: int, t: int, insert: bool) -> tuple:
    """Bytes and operations attention needs: q, the live K/V rows and
    scales of the span (every query token sees at most pos + t rows),
    the output, and with the insert the new rows read and written."""
    b, h, _, hd = q.shape
    kvh = cache[0].shape[1]
    rows = live_rows(pos + t - 1, span)
    n = 2 * q.numel() * 4 + rows * kvh * 2 * (hd + 4)
    if insert:
        n += 2 * kn.numel() * (4 + 1) + 2 * b * kvh * t * 4
    return n, 4.0 * rows * (h // kvh) * kvh * t * hd, "bf16"


def compare_attention(gen: torch.Generator, rep: Report, *, h: int,
                      kvh: int, hd: int, s: int, spans: tuple,
                      tag: str = "") -> None:
    """K3 bit-equal to its plain version and K4 (read-only, window +
    softcap, and with the fused t = 1 insert) within TOL_ATTN, at 16
    slots over an (s)-row cache; `tag` prefixes the shape names."""
    b = MAX_BATCH
    for t in ATTN_TS:
        cache = _random_cache(gen, b, kvh, s, hd)
        kn = torch.randn((b, kvh, t, hd), generator=gen, device=DEVICE) * 2
        vn = torch.randn((b, kvh, t, hd), generator=gen, device=DEVICE)
        pos = torch.randint(0, s - t, (b,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
        pos[-1] = s                       # an inactive slot writes nothing
        got = [c.clone() for c in cache]
        ref = [c.clone() for c in cache]
        kv_cache_insert(kn, vn, *got, pos)
        kv_cache_insert_plain(kn, vn, *ref, pos)
        for g, r in zip(got, ref):
            if not torch.equal(g, r):
                raise AssertionError(f"kv_cache_insert t={t}: cache differs")
        written = 2 * b * kvh * t * (hd + 4)     # the last slot writes none
        rep.add("kv_cache_insert", f"{tag}b{b} t={t}", 0.0, 0.0, 0.0,
                lambda: kv_cache_insert(kn, vn, *got, pos),
                lambda: kv_cache_insert_plain(kn, vn, *ref, pos),
                work=(nbytes(kn, vn, pos) + written, 0.0, "f32"))

        for span in spans:
            q = torch.randn((b, h, t, hd), generator=gen, device=DEVICE).bfloat16()
            p = torch.randint(0, span - t + 1, (b,), generator=gen,
                              device=DEVICE, dtype=torch.int32)
            kw = dict(t=t, precision="fast", span=span)
            out = decode_attention(q, *cache, p, **kw)
            ref_out = decode_attention_plain(q, *cache, p, **kw)
            err, rel = rel_err(out, ref_out)
            rep.add("decode_attention", f"{tag}b{b} t={t} span={span}", err,
                    rel, TOL_ATTN, lambda: decode_attention(q, *cache, p, **kw),
                    lambda: decode_attention_plain(q, *cache, p, **kw),
                    work=_attn_work(q, kn, cache, p, span, t, False))
            if span == 512:
                # sliding window and softcap: no ported family uses them
                # yet, so they are checked here and not timed
                wkw = dict(kw, window=64, softcap=2.0)
                err, rel = rel_err(decode_attention(q, *cache, p, **wkw),
                                   decode_attention_plain(q, *cache, p, **wkw))
                rep.add("decode_attention",
                        f"{tag}b{b} t={t} span={span} window+softcap", err,
                        rel, TOL_ATTN)
            if t != 1:
                continue
            # the fused t = 1 insert + attend, as every decode step runs it
            kn1, vn1 = kn[:, :, :1], vn[:, :, :1]
            got = [c.clone() for c in cache]
            ref = [c.clone() for c in cache]
            out = decode_attention_update(q, kn1, vn1, *got, p, **kw)[0]
            kv_cache_insert_plain(kn1, vn1, *ref, p)
            ref_out = decode_attention_plain(q, *ref, p, **kw)
            for g, r in zip(got, ref):
                if not torch.equal(g, r):
                    raise AssertionError("decode_attention insert: cache differs")
            err, rel = rel_err(out, ref_out)

            def plain_update():
                kv_cache_insert_plain(kn1, vn1, *ref, p)
                return decode_attention_plain(q, *ref, p, **kw)

            rep.add("decode_attention", f"{tag}b{b} t=1 span={span} insert",
                    err, rel, TOL_ATTN,
                    lambda: decode_attention_update(q, kn1, vn1, *got, p, **kw),
                    plain_update,
                    work=_attn_work(q, kn1, cache, p, span, 1, True),
                    library=lambda: sdpa_library(q, ref, p, span, "fast"))


def _tiled_positions(gen: torch.Generator, b: int, s: int) -> torch.Tensor:
    """Random positions with the first row, both sides of a tile edge and
    an inactive slot (pos = S: every column live)."""
    pos = torch.randint(0, s, (b,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    pos[:3] = torch.tensor([0, 255, 256], dtype=torch.int32)
    pos[-1] = s
    return pos


def compare_tiled(gen: torch.Generator, rep: Report) -> None:
    """K9 against its plain version within TOL_ATTN, "fast" and "high": at
    the 7B geometry (16 slots, 32 heads and 32 KV heads of 128, a 4096-row
    cache) for spans 1024, 2048, 4096, and with window 64 + softcap 8.0;
    at the TinyLlama geometry (32 heads over 4 KV heads of 64) at span
    2048. The 4096 "fast" case is the headline: its bound counts the
    live rows of these positions."""
    cases = [(CFG7B, SEQ7B, TILED_SPANS, "b16 h32 hd128"),
             (CFG, MAX_SEQ, (2048,), "b16 h32 kvh4 hd64")]
    b = MAX_BATCH
    for cfg, s, spans, label in cases:
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        cache = _random_cache(gen, b, kvh, s, hd)
        pos = _tiled_positions(gen, b, s)
        q = torch.randn((b, h, 1, hd), generator=gen, device=DEVICE)
        for span in spans:
            for prec in ("fast", "high"):
                kw = dict(precision=prec, span=span)
                err, rel = rel_err(
                    decode_attention_tiled(q, *cache, pos, **kw),
                    decode_attention_tiled_plain(q, *cache, pos, **kw))
                rows = live_rows(pos, span)
                work = (2 * q.numel() * 4 + rows * kvh * 2 * (hd + 4),
                        4.0 * rows * h * hd, "bf16" if prec == "fast" else "f32")
                rep.add("decode_attention_tiled", f"{label} span={span} {prec}",
                        err, rel, TOL_ATTN,
                        lambda: decode_attention_tiled(q, *cache, pos, **kw),
                        lambda: decode_attention_tiled_plain(q, *cache, pos,
                                                             **kw),
                        work=work,
                        library=lambda: sdpa_library(q, cache, pos, span, prec))
        if cfg is CFG7B:
            # K4's single-tile form on the same cache and positions at the
            # span where the routing takes K9 instead: what K9 replaces
            def k4():
                return _attend_cuda(q, None, None, *cache, pos, t=1,
                                    precision="fast", span=s, window=0,
                                    softcap=0.0)

            rel = rel_err(k4(), decode_attention_plain(
                q, *cache, pos, t=1, precision="fast", span=s))[1]
            log(f"  K4 single-tile form, {label} span={s} fast: "
                f"{cuda_ms(k4, iters=5):.4f} ms (rel err {rel:.2e} vs its "
                "plain version)")
            wkw = dict(precision="fast", span=s, window=64, softcap=8.0)
            err, rel = rel_err(decode_attention_tiled(q, *cache, pos, **wkw),
                               decode_attention_tiled_plain(q, *cache, pos,
                                                            **wkw))
            rep.add("decode_attention_tiled",
                    f"{label} span={s} window+softcap", err, rel, TOL_ATTN)


def _q8_1_input(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """Activations with a zero block in every row, a zero last row (n > 1)
    and, in row 0, a block of near-equal positive values whose codes sum
    to ~3,900 (> 2048, where fp16 cannot hold the sum exactly)."""
    x = torch.randn((n, k), generator=gen, device=DEVICE) * 3
    x[:, :32] = 0
    if n > 1:
        x[n - 1] = 0
    x[0, 32:64] = 2.7 + 0.3 * torch.rand(32, generator=gen, device=DEVICE)
    return x


def _bit_equal(kernel: str, shape: str, got, ref) -> None:
    for g, r in zip(got, ref):
        if not torch.equal(g, r):
            bad = int((g != r).sum())
            raise AssertionError(f"{kernel} {shape}: {bad} of {g.numel()} "
                                 "values differ from the plain version")


def compare_q8_1(gen: torch.Generator, rep: Report) -> None:
    """K5 and K6 bit-equal to their plain versions: f32 and bf16 inputs,
    and the fused GLU (silu) on a (16, 2 x 5632) gate_up."""
    for k in Q81_KS:
        for n in Q81_NS:
            x32 = _q8_1_input(gen, n, k)
            for x, dt in ((x32, "f32"), (x32.bfloat16(), "bf16")):
                shape = f"n={n} K={k} {dt}"
                q, d, s = quantize_q8_1_codes(x)
                if n > 1 and not (q[n - 1] == 0).all():
                    raise AssertionError(f"{shape}: the zero row has codes")
                if int(q[0, 32:64].int().sum()) <= 2048:
                    raise AssertionError(f"{shape}: no block with sum > 2048")
                _bit_equal("quantize_q8_1_codes", shape, (q, d, s),
                           quantize_q8_1_codes_plain(x))
                # element-wise work: the bytes bound it
                rep.add("quantize_q8_1_codes", shape, 0.0, 0.0, 0.0,
                        lambda: quantize_q8_1_codes(x),
                        lambda: quantize_q8_1_codes_plain(x),
                        work=(nbytes(x, q, d, s), 0.0, "f32"))
                fq = fake_quantize_q8_1(x)
                _bit_equal("fake_quantize_q8_1", shape, (fq,),
                           (fake_quantize_q8_1_plain(x),))
                rep.add("fake_quantize_q8_1", shape, 0.0, 0.0, 0.0,
                        lambda: fake_quantize_q8_1(x),
                        lambda: fake_quantize_q8_1_plain(x),
                        work=(nbytes(x, fq), 0.0, "f32"))
    gu = torch.randn((16, 2 * CFG.ffn_dim), generator=gen,
                     device=DEVICE).bfloat16()
    shape = f"n=16 K={CFG.ffn_dim} glu=silu bf16"
    _bit_equal("quantize_q8_1_codes", shape,
               quantize_q8_1_codes(gu, glu="silu"),
               quantize_q8_1_codes_plain(gu, glu="silu"))
    rep.add("quantize_q8_1_codes", shape, 0.0, 0.0, 0.0)
    _bit_equal("fake_quantize_q8_1", shape,
               (fake_quantize_q8_1(gu, glu="silu"),),
               (fake_quantize_q8_1_plain(gu, glu="silu"),))
    rep.add("fake_quantize_q8_1", shape, 0.0, 0.0, 0.0)


def compare_i8(layer5: dict, layer4: dict, gen: torch.Generator,
               rep: Report) -> None:
    """K7 on the Q5_K_M projections and the Q4_K_M gate_up, fed K5's
    codes of bf16 activations."""
    weights = [(f"q5_k {key}", layer5[key])
               for key in ("wqkv", "wo", "gate_up", "down")]
    weights.append(("q4_k gate_up", layer4["gate_up"]))
    for n in I8_NS:
        for name, w in weights:
            x = torch.randn((n, w.shape[1]), generator=gen,
                            device=DEVICE).bfloat16()
            q, d, s = quantize_q8_1_codes(x)
            got, ref = mmq_i8(w, q, d, s), mmq_i8_plain(w, q, d, s)
            err, rel = rel_err(got, ref)
            rep.add("mmq_i8", f"{name} {w.shape[0]}x{w.shape[1]} n={n}", err,
                    rel, TOL_I8, lambda: mmq_i8(w, q, d, s),
                    lambda: mmq_i8_plain(w, q, d, s),
                    work=(nbytes(w, q, d, s, got),
                          2.0 * n * w.shape[0] * w.shape[1], "int8"),
                    library=lambda: matmul_library(w, x))


def compare_q5_k(layer5: dict, gen: torch.Generator, rep: Report) -> None:
    """K8 on the four Q5_K_M projections, "fast" and "high": bf16
    activations, and K6's f32 output as the act_quant path feeds it."""
    for key in ("wqkv", "wo", "gate_up", "down"):
        w = layer5[key]
        cases = [(n, "bf16", torch.randn((n, w.shape[1]), generator=gen,
                                         device=DEVICE).bfloat16())
                 for n in MMQ_NS]
        cases += [(n, "q8_1 f32", fake_quantize_q8_1(
            torch.randn((n, w.shape[1]), generator=gen, device=DEVICE)))
            for n in FQ_NS]
        for n, dt, x in cases:
            for prec in ("fast", "high"):
                got = mmq_q5_k(w, x, precision=prec)
                ref = mmq_q5_k_plain(w, x, precision=prec)
                err, rel = rel_err(got, ref)
                shape = f"{key} {w.shape[0]}x{w.shape[1]} n={n} {prec}"
                rep.add("mmq_q5_k", shape if dt == "bf16" else f"{shape} {dt}",
                        err, rel, TOL_MMQ if prec == "fast" else TOL_HIGH,
                        lambda: mmq_q5_k(w, x, precision=prec),
                        lambda: mmq_q5_k_plain(w, x, precision=prec),
                        work=_mmq_work(w, x, got,
                                       "bf16" if prec == "fast" else "f32"),
                        library=lambda: matmul_library(w, x))


def compare_head_act_quant(params5: dict, gen: torch.Generator,
                           rep: Report) -> None:
    """K2 on the Q5_K_M head under "high", fed K6's f32 output as the
    act_quant path feeds it."""
    w = params5["output"]
    for n in HEAD_NS:
        x = fake_quantize_q8_1(torch.randn((n, w.shape[1]), generator=gen,
                                           device=DEVICE))
        err, rel = rel_err(mmq_q6_k(w, x, precision="high"),
                           mmq_q6_k_plain(w, x, precision="high"))
        rep.add("mmq_q6_k", f"head {w.shape[0]}x{w.shape[1]} n={n} high "
                "q8_1 f32", err, rel, TOL_HIGH,
                lambda: mmq_q6_k(w, x, precision="high"),
                lambda: mmq_q6_k_plain(w, x, precision="high"))


def compare_block32(layer8: dict, head8, legacy: dict,
                    gen: torch.Generator, rep: Report) -> None:
    """K10 at every TinyLlama projection and the head of the Q8_0
    checkpoint, and K11 at gate_up and down of each legacy format
    (`legacy`: format -> layer), against their plain versions: bf16
    activations at BLOCK32_NS, "fast" and "high", and fed K6's output
    (n = 16, 512, "high"; K11 then rounds its block sums through fp16)."""
    cases = [("mmq_q8_0", f"{key} ", layer8[key])
             for key in ("wqkv", "wo", "gate_up", "down")]
    cases.append(("mmq_q8_0", "head ", head8))
    cases += [("mmq_legacy", f"{fmt} {key} ", layer[key])
              for fmt, layer in legacy.items() for key in ("gate_up", "down")]
    for kernel, label, w in cases:
        fn = mmq_q8_0 if kernel == "mmq_q8_0" else mmq_legacy
        shape = f"{label}{w.shape[0]}x{w.shape[1]}"

        def plain(x, prec, act_quant=False):
            if act_quant:
                x = fake_quantize_q8_1_plain(x)
            if kernel == "mmq_q8_0":
                return mmq_q8_0_plain(w, x, precision=prec)
            return mmq_legacy_plain(w, x, precision=prec, fp16_bsum=act_quant)

        for n in BLOCK32_NS:
            x = torch.randn((n, w.shape[1]), generator=gen,
                            device=DEVICE).bfloat16()
            for prec in ("fast", "high"):
                got = fn(w, x, precision=prec)
                err, rel = rel_err(got, plain(x, prec))
                rep.add(kernel, f"{shape} n={n} {prec}", err, rel,
                        TOL_MMQ if prec == "fast" else TOL_HIGH,
                        lambda: fn(w, x, precision=prec),
                        lambda: plain(x, prec),
                        work=_mmq_work(w, x, got,
                                       "bf16" if prec == "fast" else "f32"),
                        library=lambda: matmul_library(w, x))
        for n in (16, 512):
            x = _q8_1_input(gen, n, w.shape[1])
            err, rel = rel_err(fn(w, x, precision="high", act_quant=True),
                               plain(x, "high", act_quant=True))
            rep.add(kernel, f"{shape} n={n} high act_quant", err, rel,
                    TOL_HIGH)


def compare_compat(seed: int, gen: torch.Generator, rep: Report,
                   fmt: str = "q8_0", ks: tuple = COMPAT_KS) -> None:
    """K10 (K12, K13) through the reference's calling convention,
    `compat.mmq_q8_0(A, B, M, N, K)` (`mmq_q2_k`, `mmq_q3_k`; act_quant and
    "high" by default), over the reference's sweep: M, N in COMPAT_MNS, K
    in `ks` (for Q8_0, K = 32 and 96 end on a half step of the kernel's K
    loop)."""
    rng = np.random.default_rng(seed)
    kernel = "mmq_" + fmt
    plain = {"q8_0": mmq_q8_0_plain, "q2_k": mmq_q2_k_plain,
             "q3_k": mmq_q3_k_plain}[fmt]
    for m in COMPAT_MNS:
        for k in ks:
            a = QUANTIZERS[fmt](rng.standard_normal((m, k)))
            w = QuantWeight.from_blocks(fmt, a, (m, k), DEVICE)
            for n in COMPAT_MNS:
                b = torch.randn((n, k), generator=gen, device=DEVICE)
                for act_quant in (True, False):
                    got = getattr(compat, kernel)(a, b, m, n, k, device=DEVICE,
                                                  act_quant=act_quant)
                    x = fake_quantize_q8_1_plain(b) if act_quant else b
                    err, rel = rel_err(got, plain(w, x))
                    if fmt != "q8_0":
                        # held to the scale of the f32 sums' own rounding
                        rel = err / _terms_max(w, x)
                    rep.add(kernel, f"compat M={m} N={n} K={k} "
                            f"act_quant={act_quant}", err, rel, TOL_HIGH)


def _terms_max(w: QuantWeight, x: torch.Tensor) -> float:
    """The largest sum of |terms| over the outputs of x . W^T, Q2_K's
    split arm counted as its main and its min term: the scale of an f32
    sum's own rounding error. At M = N = 1 one output may cancel to a
    small part of its terms (Q2_K's min term, a second positive sum, makes
    that common), where 1e-5 of max|ref| would hold the kernel to less
    than f32 can carry."""
    xa = x.float().abs()
    (m, k), n = w.shape, x.shape[0]
    if w.fmt != "q2_k":
        return float((xa @ w.dequantize().abs().T).max())
    scale16, min16, q = q2_k_parts(w)
    t = (xa @ (scale16[..., None] * q).view(m, k).T
         + xa.view(n, k // 16, 16).sum(-1) @ min16.view(m, k // 16).T)
    return float(t.max())


def compare_lowbit(cases: list, gen: torch.Generator, rep: Report) -> None:
    """K12, K13 and K14 against their plain versions, `cases` listing
    (kernel, label, weight): bf16 activations at BLOCK32_NS (both sides of
    K12's n_pad <= 64 arm), "fast" (TOL_MMQ) and "high" (TOL_HIGH), timed;
    and K6's f32 output, as the act_quant path feeds them, at n = 16 and
    512 in both precisions."""
    for kernel, label, w in cases:
        fn, plain = LOWBIT[kernel]
        shape = f"{label}{w.shape[0]}x{w.shape[1]}"
        for n in BLOCK32_NS:
            x = torch.randn((n, w.shape[1]), generator=gen,
                            device=DEVICE).bfloat16()
            for prec in ("fast", "high"):
                got = fn(w, x, precision=prec)
                err, rel = rel_err(got, plain(w, x, precision=prec))
                rep.add(kernel, f"{shape} n={n} {prec}", err, rel,
                        TOL_MMQ if prec == "fast" else TOL_HIGH,
                        lambda: fn(w, x, precision=prec),
                        lambda: plain(w, x, precision=prec),
                        work=_mmq_work(w, x, got,
                                       "bf16" if prec == "fast" else "f32"),
                        library=lambda: matmul_library(w, x))
        for n in (16, 512):
            x = fake_quantize_q8_1(torch.randn((n, w.shape[1]), generator=gen,
                                               device=DEVICE))
            for prec in ("fast", "high"):
                err, rel = rel_err(fn(w, x, precision=prec),
                                   plain(w, x, precision=prec))
                rep.add(kernel, f"{shape} n={n} {prec} q8_1 f32", err, rel,
                        TOL_MMQ if prec == "fast" else TOL_HIGH)


def compare_rms_norm(gen: torch.Generator, rep: Report) -> None:
    """K15 against its plain version (torch's eager form) within TOL_NORM:
    f32 and bf16 (n, d) input, a (d,) weight; timed beside F.rms_norm on
    the f32 input."""
    eps = CFG.norm_eps
    for d in NORM_DS:
        w = 1.0 + 0.5 * torch.randn(d, generator=gen, device=DEVICE)
        for n in NORM_NS:
            x32 = torch.randn((n, d), generator=gen, device=DEVICE) * 3
            for x, dt in ((x32, "f32"), (x32.bfloat16(), "bf16")):
                got = rms_norm(x, w, eps)
                err, rel = rel_err(got, rms_norm_plain(x, w, eps))
                xf = x.float()
                rep.add("rms_norm", f"n={n} d={d} {dt}", err, rel, TOL_NORM,
                        lambda: rms_norm(x, w, eps),
                        lambda: rms_norm_plain(x, w, eps),
                        work=(nbytes(x, w, got), 4.0 * n * d, "f32"),
                        library=lambda: (lambda: F.rms_norm(xf, (d,), w, eps)))


def other_mmq(required: tuple) -> tuple:
    """The MMQ kernels a serving path that requires `required` must not
    launch."""
    return tuple(k for k in MMQ_KERNELS if k not in required)


def serve(llm: LLM, seed: int, required: tuple,
          prompt_lens: tuple = PROMPT_LENS, forbidden: tuple = ()) -> dict:
    """A main path: continuous batching over seeded prompts of
    `prompt_lens` tokens, every logit checked finite on the device (no host
    sync per step), every kernel in `required` launched and none in
    `forbidden`."""
    rng = np.random.default_rng(seed)
    prompts = [[int(v) for v in rng.integers(0, llm.cfg.vocab_size, n)]
               for n in prompt_lens]
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    n_fwd = [0]
    plain_forward = engine_mod.forward

    def checked_forward(*args, **kwargs):
        logits, cache = plain_forward(*args, **kwargs)
        finite.logical_and_(torch.isfinite(logits).all())
        n_fwd[0] += 1
        return logits, cache

    for fn in WRAPPERS.values():
        fn.launches = 0
    engine_mod.forward = checked_forward
    try:
        res = llm.generate(prompts, max_new_tokens=NEW_TOKENS,
                           sampler=SamplerConfig(), seed=seed)
        torch.cuda.synchronize()
    finally:
        engine_mod.forward = plain_forward
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    if len(res) != len(prompts) or any(
            len(r.token_ids) != NEW_TOKENS or not r.finished for r in res):
        raise AssertionError("generate did not answer every request in full")
    if not bool(finite):
        raise AssertionError("non-finite logits in the serving run")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    stray = [k for k in forbidden if launches[k]]
    if stray:
        raise AssertionError(f"kernels launched off this path's route: {stray}")
    st = res[0].stats
    chunks = sum(-(-n // engine_mod.PREFILL_CHUNK) for n in prompt_lens)
    log(f"served {len(res)} requests x {NEW_TOKENS} tokens, {n_fwd[0]} "
        f"forwards, all logits finite: wall {st['wall_s']:.2f} s, prefill "
        f"{st['prefill_s']:.2f} s for {sum(prompt_lens)} prompt tokens in "
        f"{chunks} chunks, decode {st['decode_s']:.2f} s for "
        f"{st['decode_tokens']} tokens = "
        f"{st['decode_tokens'] / st['decode_s']:.1f} decode tok/s at batch "
        f"<= {MAX_BATCH}; end to end {st['tokens_per_s']:.1f} tok/s")
    log(f"launches on the main path: {json.dumps(launches)}")
    return launches


def _first_layers(params: dict, n_layers: int) -> dict:
    return {**params, "layers": params["layers"][:n_layers]}


def _prefill(params: dict, cfg: LlamaConfig, tokens: np.ndarray,
             n_layers: int, opts: MMOpts, dev: str) -> torch.Tensor:
    """Logits of one prompt through the first n_layers, on params' device."""
    out, _ = forward(_first_layers(params, n_layers), cfg,
                     torch.from_numpy(tokens).to(dev),
                     torch.zeros(1, dtype=torch.int32, device=dev),
                     init_kv_cache(cfg, 1, 256, dev)[:n_layers], opts,
                     span=128)
    return out.cpu()


def _prompt(seed: int, t: int) -> np.ndarray:
    return np.random.default_rng(seed + 1).integers(0, CFG.vocab_size, (1, t))


def reference_check(path: str, llm: LLM, seed: int, checks) -> tuple:
    """Card logits vs the CPU run of the same port (plain versions) for a
    16-token prefill. `checks` lists (layers, MMOpts, tolerance or None
    for finite only). Returns the CPU (cfg, params) and, per check, the
    (CPU, card) logits."""
    tokens = _prompt(seed, 16)
    cfg, params = load_llama(path, "cpu")
    params = fuse_llama_params(params)
    results = []
    for n_layers, opts, tol in checks:
        ref, got = (_prefill(prm, c, tokens, n_layers, opts, dev)
                    for prm, c, dev in ((params, cfg, "cpu"),
                                        (llm.params, llm.cfg, DEVICE)))
        results.append((ref, got))
        err, rel = rel_err(got, ref)
        log(f"reference check ({n_layers} layers, 16-token prefill, card vs "
            f"CPU plain port, {opts}): max|d|={err:.3e} rel={rel:.2e} "
            f"(tol {tol if tol is not None else 'none, finite only'})")
        if not torch.isfinite(got).all() or (tol is not None and rel > tol):
            raise AssertionError(f"card logits disagree with the CPU "
                                 f"reference at {n_layers} layers")
    return (cfg, params), results


@contextlib.contextmanager
def recorded_mmq(calls: list):
    """Record every MMQ call the model makes as (wrapper, weight, input,
    keywords, output)."""
    saved = dict(MMQ)

    def recorder(fn):
        def call(w, x, **kw):
            out = fn(w, x, **kw)
            calls.append((fn, w, x, kw, out))
            return out
        return call

    MMQ.update({fmt: recorder(fn) for fmt, fn in saved.items()})
    try:
        yield
    finally:
        MMQ.update(saved)


def _expected_route(fmt: str, n: int) -> set:
    """The kernels the JAX package's act_quant routing runs, "high": the
    integer route (K5 + K7) only for Q4_K and Q5_K at n <= 16, K6 then
    the format's float kernel otherwise."""
    if fmt in ("q2_k", "q3_k", "q6_k", "q8_0"):
        return {"fake_quantize_q8_1", "mmq_" + fmt}
    if fmt in ("q4_0", "q4_1", "q5_0", "q5_1"):
        return {"fake_quantize_q8_1", "mmq_legacy"}
    if fmt in ("iq4_nl", "iq4_xs"):
        return {"fake_quantize_q8_1", "mmq_iq4"}
    if n <= 16:
        return {"quantize_q8_1_codes", "mmq_i8"}
    return {"fake_quantize_q8_1", "mmq_" + fmt}


def projection_check(cpu: tuple, llm: LLM, seed: int, t: int) -> None:
    """Every MMQ call of a t-token prefill through 2 layers under act_quant,
    teacher-forced: the card's wrapper gets the CPU run's input and must
    launch the route the JAX package takes and return the CPU port's
    output within TOL_ROUTE. Unlike the logits this is free of last-ulp
    drift upstream. The same input without act_quant shows what a wrong
    route reads."""
    tokens = _prompt(seed, t)
    runs = []
    for (c, prm), dev in ((cpu, "cpu"), ((llm.cfg, llm.params), DEVICE)):
        calls = []
        with recorded_mmq(calls):
            _prefill(prm, c, tokens, 2, ACT_QUANT, dev)
        runs.append(calls)
    if [c[1].shape for c in runs[0]] != [c[1].shape for c in runs[1]]:
        raise AssertionError("the card and the CPU made different MMQ calls")
    worst = wrong = 0.0
    for (fn, _, x, kw, ref), (_, w, _, _, _) in zip(*runs):
        before = {name: f.launches for name, f in WRAPPERS.items()}
        got = fn(w, x.to(DEVICE), **kw)
        route = {name for name, f in WRAPPERS.items()
                 if f.launches != before[name]}
        err, rel = rel_err(got.cpu(), ref)
        alt = rel_err(fn(w, x.to(DEVICE), **{**kw, "act_quant": False}).cpu(),
                      ref)[1]
        log(f"  t={t} {w.fmt} {w.shape[0]}x{w.shape[1]} n={x.shape[0]}: "
            f"{'+'.join(sorted(route))} max|d|={err:.3e} rel={rel:.2e} (tol "
            f"{TOL_ROUTE:g}); without act_quant rel={alt:.2e}")
        if route != _expected_route(w.fmt, x.shape[0]):
            raise AssertionError(f"{w.fmt} n={x.shape[0]} took {route}")
        if rel > TOL_ROUTE:
            raise AssertionError(f"{w.fmt} n={x.shape[0]}: rel err {rel}")
        worst, wrong = max(worst, rel), max(wrong, alt)
    log(f"projection check, {len(runs[0])} calls of a {t}-token prefill "
        f"(2 layers, act_quant): worst rel {worst:.2e}; without act_quant "
        f"up to {wrong:.2e}")


def perplexity_check(path: str, llm: LLM, cpu: tuple, seed: int) -> None:
    """Perplexity of 2,048 seeded token ids under act_quant through the
    file-level entry point; then the scoring alone on the loaded params,
    timed; then the card's mean NLL over one window through 2 layers
    against the CPU run's."""
    ids = np.random.default_rng(seed + 2).integers(0, CFG.vocab_size,
                                                   PPL_TOKENS)
    opts = MMOpts(act_quant=True)
    ppl = perplexity_of_gguf(path, ids, device=DEVICE, act_quant=True,
                             window=PPL_WINDOW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total, count = sequence_nll(llm.params, llm.cfg, ids, window=PPL_WINDOW,
                                opts=opts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not (np.isfinite(ppl) and count == PPL_TOKENS // 2
            and abs(np.log(ppl) - total / count) <= 1e-3):
        raise AssertionError(f"perplexity {ppl} / sequence_nll {total}, "
                             f"{count} disagree or are not finite")
    log(f"perplexity (act_quant, window {PPL_WINDOW}, {PPL_TOKENS} tokens, "
        f"{count} scored): {ppl:.4f}; scoring {dt:.3f} s = "
        f"{PPL_TOKENS / dt:.1f} tokens/s through the model")
    cfg, params = cpu
    means = []
    for prm, c in ((params, cfg), (llm.params, llm.cfg)):
        tot, cnt = sequence_nll(_first_layers(prm, 2), c, ids[:NLL_WINDOW],
                                window=NLL_WINDOW, opts=opts)
        means.append(tot / cnt)
    diff = abs(means[1] - means[0])
    log(f"mean NLL, 2 layers, one {NLL_WINDOW}-token window: card "
        f"{means[1]:.6f} vs CPU {means[0]:.6f} nats, |d|={diff:.2e} "
        f"(tol {TOL_NATS:g})")
    if diff > TOL_NATS:
        raise AssertionError("card NLL disagrees with the CPU reference")


def profile_decode(path: str, seed: int, rounds: int = 3) -> None:
    """The decode step's split: 16 live slots after 128-token prompts, span
    256, Q5_K_M with bf16 activations and under act_quant ("high" both),
    alternating. Per step: the host clock until the step is issued and
    until it is done; in the last round `torch.profiler` over 4 steps,
    device time by kernel."""
    configs = (("bf16 high", MMOpts(precision="high")),
               ("act_quant high", ACT_QUANT))
    llm = LLM(path, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device=DEVICE)
    rng = np.random.default_rng(seed)
    last = [int(llm._prefill_chunks(
        [int(v) for v in rng.integers(0, CFG.vocab_size, 128)], slot).argmax())
        for slot in range(MAX_BATCH)]
    tok = torch.tensor(last, device=DEVICE)
    pos = torch.full((MAX_BATCH,), 128, dtype=torch.int32, device=DEVICE)
    sampler, gen = SamplerConfig(), torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    for rnd in range(rounds):
        for label, opts in configs:
            llm.opts = opts
            llm._decode(tok, pos, sampler, 2, 256, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            llm._decode(tok, pos, sampler, 8, 256, gen)
            issue = time.perf_counter() - t0
            torch.cuda.synchronize()
            done = time.perf_counter() - t0
            log(f"round {rnd} {label}: wall {done / 8 * 1e3:.2f} ms/step, "
                f"host issue {issue / 8 * 1e3:.2f} ms/step")
            if rnd < rounds - 1:
                continue
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                llm._decode(tok, pos, sampler, 4, 256, gen)
                torch.cuda.synchronize()
            kern = sorted((e for e in prof.key_averages()
                           if e.device_type.name == "CUDA"),
                          key=lambda e: -e.self_device_time_total)
            busy = sum(e.self_device_time_total for e in kern) / 4 / 1e3
            count = sum(e.count for e in kern) / 4
            log(f"  device busy {busy:.2f} ms/step over {count:.0f} "
                "kernels/step; the top 12 by device time:")
            for e in kern[:12]:
                log(f"  {e.self_device_time_total / 4 / 1e3:8.3f} ms/step "
                    f"{e.count / 4:6.1f}/step "
                    f"{e.self_device_time_total / e.count:8.1f} us/launch "
                    f"{e.key[:80]}")


def hbm_read_gbs() -> float:
    """The card's HBM read rate: x.sum() over 4 GiB of float32."""
    x = torch.ones(2 ** 30, device=DEVICE)
    ms = cuda_ms(lambda: x.sum(), iters=10)
    del x
    torch.cuda.empty_cache()
    return 4 * 2 ** 30 / ms / 1e6


def decode_split(llm: LLM, tok: torch.Tensor, pos: torch.Tensor, span: int,
                 label: str, gen: torch.Generator) -> list:
    """One 16-slot decode step's split at `pos` and `span`: the host clock
    over 8 steps ending in a sync (and the kernel wrappers' launches per
    step), then `torch.profiler` over 4 steps (device busy time, idle
    share, the top kernels). Returns the profiler's CUDA events."""
    sampler = SamplerConfig()
    llm._decode(tok, pos, sampler, 2, span, gen)
    torch.cuda.synchronize()
    for fn in WRAPPERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    llm._decode(tok, pos, sampler, 8, span, gen)
    issue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 8 * 1e3
    log(f"{label}: wrapper launches per step " + json.dumps(
        {k: f.launches / 8 for k, f in WRAPPERS.items() if f.launches}))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        llm._decode(tok, pos, sampler, 4, span, gen)
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kern) / 4 / 1e3
    log(f"{label}: wall {wall:.2f} ms/step, host issue "
        f"{issue / 8 * 1e3:.2f} ms/step, device busy {busy:.2f} ms/step "
        f"({100 * (1 - busy / wall):.0f}% idle) over "
        f"{sum(e.count for e in kern) / 4:.0f} kernels/step; top 8:")
    for e in kern[:8]:
        log(f"  {e.self_device_time_total / 4 / 1e3:8.3f} ms/step "
            f"{e.count / 4:6.1f}/step {e.key[:70]}")
    return kern


def profile_7b_decode(llm: LLM, seed: int, hbm_gbs: float) -> None:
    """Where the 7B decode step goes: 16 live slots at round A's and at
    round B's positions (spans 512 and 4096), split by `decode_split`;
    K9's device time per layer beside its bound (the live K/V rows and
    their scales over the HBM read measured in this run and over the
    published 3.35 TB/s). Then one 512-token prefill chunk at the start
    of a slot and one at span 4096."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    cfg, layers = llm.cfg, llm.cfg.n_layers
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, MAX_BATCH),
                          device=DEVICE)
    for lens, span in ((ROUND_A, 512), (ROUND_B, SEQ7B)):
        pos = torch.tensor([lens[i % len(lens)] for i in range(MAX_BATCH)],
                           dtype=torch.int32, device=DEVICE)
        kern = decode_split(llm, tok, pos, span,
                            f"7B decode step, 16 slots, span {span}", gen)
        tiled = sum(e.self_device_time_total for e in kern
                    if "tiled_" in e.key) / 4 / layers / 1e3
        if span == SEQ7B:
            # every step reads rows 0..pos of each slot (pos grows by one
            # per step; the first step's rows are counted)
            n = live_rows(pos, span) * cfg.n_kv_heads * 2 * (cfg.head_dim + 4)
            log(f"  K9 device time per layer {tiled:.4f} ms; its bound "
                f"{n / 1e6:.1f} MB of live K/V and scales = "
                f"{n / hbm_gbs / 1e6:.4f} ms at the measured {hbm_gbs:.0f} "
                f"GB/s, {n / HBM_BPS * 1e3:.4f} ms at 3,350 GB/s")
    toks = rng.integers(0, cfg.vocab_size, (1, engine_mod.PREFILL_CHUNK))
    for start in (0, SEQ7B - engine_mod.PREFILL_CHUNK):
        span = llm._span_bucket(start + engine_mod.PREFILL_CHUNK)
        llm._prefill(toks, 0, start, engine_mod.PREFILL_CHUNK - 1, span)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            llm._prefill(toks, 0, start, engine_mod.PREFILL_CHUNK - 1, span)
        torch.cuda.synchronize()
        log(f"7B prefill of a {engine_mod.PREFILL_CHUNK}-token chunk at "
            f"{start}, span {span}: "
            f"{(time.perf_counter() - t0) / 3 * 1e3:.1f} ms")


def long_span_check(cpu: tuple, llm: LLM, seed: int) -> None:
    """The t = 1 route past the envelope (K3 + K9) and the t = 8 f32 arm,
    2 layers, card vs the CPU port: the card prefills LONG_PROMPT tokens
    into a one-slot 4,096-row cache in 512-token chunks; the cache is
    copied to the CPU; one t = 1 and one t = 8 step at span 4096 run on
    both, logits within TOL_LOGITS. The card's t = 1 step must launch K9
    and no K4, its t = 8 step neither."""
    cfg, params = cpu
    card = _first_layers(llm.params, 2)
    host = _first_layers(params, 2)
    cache = init_kv_cache(llm.cfg, 1, SEQ7B, DEVICE)[:2]
    ids = _prompt(seed + 3, LONG_PROMPT)
    for off in range(0, LONG_PROMPT, engine_mod.PREFILL_CHUNK):
        toks = ids[:, off:off + engine_mod.PREFILL_CHUNK]
        forward(card, llm.cfg, torch.from_numpy(toks).to(DEVICE),
                torch.tensor([off], dtype=torch.int32, device=DEVICE), cache,
                MMOpts(), span=llm._span_bucket(off + toks.shape[1]))
    host_cache = [{n: c.cpu() for n, c in layer.items()} for layer in cache]
    p = LONG_PROMPT
    for t in (1, 8):
        toks = _prompt(seed + 4 + t, t)
        for fn in WRAPPERS.values():
            fn.launches = 0
        got, _ = forward(card, llm.cfg, torch.from_numpy(toks).to(DEVICE),
                         torch.tensor([p], dtype=torch.int32, device=DEVICE),
                         cache, MMOpts(), span=SEQ7B)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        ref, _ = forward(host, cfg, torch.from_numpy(toks),
                         torch.tensor([p], dtype=torch.int32), host_cache,
                         MMOpts(), span=SEQ7B)
        err, rel = rel_err(got.cpu(), ref)
        k4, k9 = launches["decode_attention"], launches["decode_attention_tiled"]
        log(f"long-span check, 2 layers, t={t} at pos {p}, span {SEQ7B}: "
            f"card vs CPU max|d|={err:.3e} rel={rel:.2e} (tol {TOL_LOGITS:g});"
            f" launches K3 {launches['kv_cache_insert']}, K4 {k4}, K9 {k9}")
        if not torch.isfinite(got).all() or rel > TOL_LOGITS:
            raise AssertionError(f"long-span t={t}: card disagrees with CPU")
        if k4 or (k9 > 0) != (t == 1):
            raise AssertionError(f"long-span t={t} took the wrong route: "
                                 f"K4 {k4}, K9 {k9}")
        p += t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="split a decode step instead of the smoke run")
    ap.add_argument("--write", choices=sorted(CHECKPOINTS),
                    help=argparse.SUPPRESS)   # a checkpoint writer's child
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if args.write:
        write_checkpoint(args.seed, args.write)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    check_toolchain()
    with phase("build the GGUF quantizer core"):
        build.build("gguf_kquant")     # before the writers that use it
    writers = Writers(args.seed, ("q5km",) if args.profile
                      else tuple(CHECKPOINTS))
    try:
        with phase("build kernels"):
            build_kernels()
        if args.profile:
            profile_decode(writers.wait("q5km"), args.seed)
            return 0
        kernels = smoke(args.seed, writers)
    finally:
        writers.stop()
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(smi)          # again, beside the numbers at the end of the output
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def block32_paths(seed: int, writers: Writers, gen: torch.Generator,
                  rep: Report) -> dict:
    """The 32-element-block formats: K10/K11 against their plain versions,
    TinyLlama Q8_0 and Q4_0 served at full width and depth, and the
    2-layer card-vs-CPU checks of all five formats. Returns the launches
    of K10 (Q8_0 run) and K11 (Q4_0 run)."""
    log("== Q8_0 and Q4_0/Q4_1/Q5_0/Q5_1, bf16 activations (K10, K11) ==")
    tags = {"q8_0": "q8_0", "q4_0": "q4_0", "q4_1": "q4_1_2l",
            "q5_0": "q5_0_2l", "q5_1": "q5_1_2l"}
    with phase("load Q8_0, Q4_0 and the 2-layer Q4_1/Q5_0/Q5_1"):
        paths = {fmt: writers.wait(tag) for fmt, tag in tags.items()}
        llms = {fmt: LLM(path, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                         device=DEVICE) for fmt, path in paths.items()}
    with phase("K10/K11 vs plain"):
        compare_block32(llms["q8_0"].params["layers"][0],
                        llms["q8_0"].params["output"],
                        {fmt: llms[fmt].params["layers"][0]
                         for fmt in ("q4_0", "q4_1", "q5_0", "q5_1")},
                        gen, rep)
        compare_compat(seed, gen, rep)
    launches = {}
    with phase("serve Q8_0"):
        launches["mmq_q8_0"] = serve(
            llms["q8_0"], seed, Q8_0_KERNELS,
            forbidden=other_mmq(Q8_0_KERNELS))["mmq_q8_0"]
    with phase("serve Q4_0"):
        launches["mmq_legacy"] = serve(
            llms["q4_0"], seed, Q4_0_KERNELS,
            forbidden=other_mmq(Q4_0_KERNELS))["mmq_legacy"]
    with phase("Q8_0 and Q4_0 decode step"):
        tok, pos, gen_step = _step_inputs(seed)
        for fmt in ("q8_0", "q4_0"):
            decode_split(llms[fmt], tok, pos, 256,
                         f"TinyLlama {fmt} decode step, 16 slots, span 256",
                         gen_step)
    with phase("reference checks of the five formats (2 layers)"):
        for fmt, llm in llms.items():
            log(f"-- {fmt}")
            cpu, _ = reference_check(paths[fmt], llm, seed,
                                     ((2, MMOpts(), TOL_LOGITS),))
            if fmt in ("q8_0", "q5_1"):
                for t in ROUTE_TS:
                    projection_check(cpu, llm, seed, t)
    del llms
    torch.cuda.empty_cache()
    return launches


def rms_norm_shadow(llm: LLM, tok: torch.Tensor, pos: torch.Tensor,
                    span: int, gen: torch.Generator) -> int:
    """K15 beside the model's RMSNorm over one 16-slot decode step: the
    model keeps its plain torch norm (the JAX package does not route its
    Pallas one either), and every norm the step computes (two per layer
    and the final one) is recomputed by K15 from the same input and
    weight and held against the plain version within TOL_NORM. Returns
    K15's launches in that step."""
    seen = []
    model_norm = llama_mod.rms_norm

    def shadow(x, weight, eps):
        x2 = x.reshape(-1, x.shape[-1])
        seen.append((x2, weight, eps, rms_norm(x2, weight, eps)))
        return model_norm(x, weight, eps)

    rms_norm.launches = 0
    llama_mod.rms_norm = shadow
    try:
        llm._decode(tok, pos, SamplerConfig(), 1, span, gen)
        torch.cuda.synchronize()
    finally:
        llama_mod.rms_norm = model_norm
    launches = rms_norm.launches
    worst = max(rel_err(got, rms_norm_plain(x, w, eps))[1]
                for x, w, eps, got in seen)
    log(f"K15 beside the model's {len(seen)} RMSNorms of one decode step "
        f"({tuple(seen[0][0].shape)} {seen[0][0].dtype}): {launches} "
        f"launches, worst rel {worst:.2e} (tol {TOL_NORM:g})")
    if worst > TOL_NORM or launches != len(seen):
        raise AssertionError("K15 disagrees with the model's RMSNorm")
    return launches


def _lowbit_cases(kernel: str, params: dict, prefix: str = "") -> list:
    """(kernel, label, weight) for every projection of layer 0 (fused as
    the loader fuses them) and the head."""
    layer = params["layers"][0]
    cases = [(kernel, f"{prefix}{key} ", layer[key])
             for key in ("wqkv", "wq", "wk", "wv", "wo", "gate_up", "down")
             if key in layer]
    return cases + [(kernel, f"{prefix}head ", params["output"])]


def _step_inputs(seed: int):
    """The decode-step split's inputs: 16 token ids, every slot at 128."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    tok = torch.as_tensor(np.random.default_rng(seed).integers(
        0, CFG.vocab_size, MAX_BATCH), device=DEVICE)
    return tok, torch.full((MAX_BATCH,), 128, dtype=torch.int32,
                           device=DEVICE), gen


def kquant_low_paths(seed: int, writers: Writers, gen: torch.Generator,
                     rep: Report) -> dict:
    """Q2_K and Q3_K: K12/K13 against their plain versions (the 2-layer
    uniform files and the mix's unfused wq, wk) and through compat, K15
    against its plain version, TinyLlama in llama.cpp's Q2_K mix served
    at full width and depth, its decode step split with K15 beside its
    norms, and the 2-layer card-vs-CPU checks of the mix and both uniform
    files. Returns the launches of K12, K13 (the mix's serving run) and
    K15 (its shadow step)."""
    log("== Q2_K mix, Q2_K and Q3_K, bf16 activations (K12, K13, K1-K4); "
        "K15 ==")
    tags = {"mix": "q2k_mix", "q2_k": "q2_k_2l", "q3_k": "q3_k_2l"}
    with phase("load the Q2_K mix and the 2-layer Q2_K/Q3_K"):
        paths = {key: writers.wait(tag) for key, tag in tags.items()}
        llms = {key: LLM(path, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                         device=DEVICE) for key, path in paths.items()}
    mix = llms["mix"].params
    layer = mix["layers"][0]
    types = {key: (w.fmt if isinstance(w, QuantWeight) else str(w.dtype))
             for key, w in layer.items()}
    log(f"mix layer 0: {json.dumps(types)}; head {mix['output'].fmt}, "
        f"token_embd resident as {mix['token_embd'].dtype}")
    if "wqkv" in layer or "gate_up" not in layer:
        raise AssertionError("the mix is not fused per format: "
                             f"{sorted(layer)}")
    with phase("K12/K13/K15 vs plain"):
        compare_lowbit(_lowbit_cases("mmq_q2_k", llms["q2_k"].params)
                       + [("mmq_q2_k", f"mix {key} ", layer[key])
                          for key in ("wq", "wk")]
                       + _lowbit_cases("mmq_q3_k", llms["q3_k"].params),
                       gen, rep)
        for fmt in ("q2_k", "q3_k"):
            compare_compat(seed, gen, rep, fmt, KQUANT_COMPAT_KS)
        compare_rms_norm(gen, rep)
    with phase("serve the Q2_K mix"):
        launches = serve(llms["mix"], seed, Q2K_MIX_KERNELS,
                         forbidden=other_mmq(Q2K_MIX_KERNELS))
    launches = {k: launches[k] for k in ("mmq_q2_k", "mmq_q3_k")}
    with phase("Q2_K mix decode step"):
        tok, pos, gen_step = _step_inputs(seed)
        decode_split(llms["mix"], tok, pos, 256,
                     "TinyLlama Q2_K mix decode step, 16 slots, span 256",
                     gen_step)
        launches["rms_norm"] = rms_norm_shadow(llms["mix"], tok, pos, 256,
                                               gen_step)
    with phase("reference checks of the mix, Q2_K and Q3_K (2 layers)"):
        for key, llm in llms.items():
            log(f"-- {key}")
            cpu, _ = reference_check(paths[key], llm, seed,
                                     ((2, MMOpts(), TOL_LOGITS),))
            if key != "mix":
                for t in ROUTE_TS:
                    projection_check(cpu, llm, seed, t)
    del llms, mix, layer
    torch.cuda.empty_cache()
    return launches


def iq4_paths(seed: int, writers: Writers, gen: torch.Generator,
              rep: Report) -> dict:
    """IQ4_NL and IQ4_XS (2-layer uniform files): K14 against its plain
    version, the 24 prompts served through the IQ4_XS file, and the
    card-vs-CPU checks of both. Returns K14's launches in that run."""
    log("== IQ4_NL and IQ4_XS, 2 layers, bf16 activations (K14) ==")
    tags = {"iq4_nl": "iq4_nl_2l", "iq4_xs": "iq4_xs_2l"}
    with phase("write or reuse the IQ4 checkpoints (wait), load"):
        paths = {fmt: writers.wait(tag) for fmt, tag in tags.items()}
        llms = {fmt: LLM(path, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                         device=DEVICE) for fmt, path in paths.items()}
    with phase("K14 vs plain"):
        compare_lowbit([c for fmt, llm in llms.items()
                        for c in _lowbit_cases("mmq_iq4", llm.params,
                                               f"{fmt} ")], gen, rep)
    with phase("serve IQ4_XS (2 layers)"):
        launches = serve(llms["iq4_xs"], seed, IQ4_XS_KERNELS,
                         forbidden=other_mmq(IQ4_XS_KERNELS))
    with phase("reference checks of IQ4_NL and IQ4_XS (2 layers)"):
        for fmt, llm in llms.items():
            log(f"-- {fmt}")
            cpu, _ = reference_check(paths[fmt], llm, seed,
                                     ((2, MMOpts(), TOL_LOGITS),))
            if fmt == "iq4_xs":
                for t in ROUTE_TS:
                    projection_check(cpu, llm, seed, t)
    del llms
    torch.cuda.empty_cache()
    return {"mmq_iq4": launches["mmq_iq4"]}


def smoke(seed: int, writers: Writers) -> list:
    """Every phase of the smoke run; returns the {"kernels": ...} list."""
    with phase("write or reuse the TinyLlama checkpoints"):
        path4, path5 = writers.wait("q4km"), writers.wait("q5km")
    rep = Report()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)

    log("== Q4_K_M, bf16 activations (K1-K4) ==")
    with phase("load Q4_K_M"):
        llm4 = LLM(path4, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device=DEVICE)
    with phase("K1-K4 vs plain"):
        log("kernel vs plain PyTorch version (bf16 operands, CUDA-event times):")
        compare_mmq(llm4.params, gen, rep)
        compare_attention(gen, rep, h=CFG.n_heads, kvh=CFG.n_kv_heads,
                          hd=CFG.head_dim, s=MAX_SEQ, spans=ATTN_SPANS)
    with phase("serve Q4_K_M"):
        launches = serve(llm4, seed, Q4KM_KERNELS)
    with phase("reference check Q4_K_M"):
        reference_check(path4, llm4, seed,
                        ((2, MMOpts(), TOL_LOGITS),
                         (CFG.n_layers, MMOpts(), TOL_LOGITS_22)))

    log("== Q5_K_M, MMOpts(act_quant=True, precision='high') (K2-K8) ==")
    with phase("load Q5_K_M"):
        llm5 = LLM(path5, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device=DEVICE,
                   opts=ACT_QUANT)
    with phase("K5-K8 vs plain"):
        compare_q8_1(gen, rep)
        compare_i8(llm5.params["layers"][0], llm4.params["layers"][0], gen, rep)
        compare_q5_k(llm5.params["layers"][0], gen, rep)
        compare_head_act_quant(llm5.params, gen, rep)
    del llm4
    torch.cuda.empty_cache()
    with phase("serve Q5_K_M under act_quant"):
        launches.update({k: v for k, v in serve(llm5, seed,
                                                Q5KM_KERNELS).items()
                         if k in Q5KM_KERNELS})
    with phase("reference check Q5_K_M under act_quant"):
        # the same weights with bf16 activations first: the act_quant
        # bound is wider than that path's by the quantization alone
        cpu5, logits = reference_check(
            path5, llm5, seed,
            ((2, MMOpts(precision="high"), TOL_LOGITS),
             (2, ACT_QUANT, TOL_LOGITS_ACT_QUANT),
             (CFG.n_layers, ACT_QUANT, None)))
        err, rel = rel_err(logits[0][1], logits[1][0])
        log(f"a wrong route at 2 layers (card without act_quant vs CPU "
            f"under it): max|d|={err:.3e} rel={rel:.2e}")
        for t in ROUTE_TS:
            projection_check(cpu5, llm5, seed, t)
    with phase("perplexity"):
        perplexity_check(path5, llm5, cpu5, seed)
    del llm5, cpu5
    torch.cuda.empty_cache()

    log("== Llama-2-7B Q4_K_M, bf16 activations, 4,096-token context "
        "(K1-K4, K9) ==")
    with phase("K9, and K3/K4 at hd 128, vs plain"):
        hbm = hbm_read_gbs()
        log(f"HBM read (x.sum() of 4 GiB f32): {hbm:.0f} GB/s")
        compare_tiled(gen, rep)
        compare_attention(gen, rep, h=CFG7B.n_heads, kvh=CFG7B.n_kv_heads,
                          hd=CFG7B.head_dim, s=SEQ7B, spans=ATTN_SPANS_7B,
                          tag="kvh32 hd128 ")
    launches.update(block32_paths(seed, writers, gen, rep))
    launches.update(kquant_low_paths(seed, writers, gen, rep))

    with phase("write or reuse the 7B checkpoint (wait)"):
        path7 = writers.wait("q4km_7b")
    with phase("load Llama-2-7B"):
        llm7 = LLM(path7, max_batch=MAX_BATCH, max_seq=SEQ7B, device=DEVICE)
        emb = llm7.params["token_embd"]
        kv = sum(nbytes(*layer.values()) for layer in llm7.cache)
        log(f"token_embd resident as {emb.dtype} {tuple(emb.shape)} "
            f"({nbytes(emb) / 2 ** 20:.0f} MiB); KV cache "
            f"{kv / 1e9:.2f} GB for {MAX_BATCH} slots x {SEQ7B} rows; "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        if not isinstance(emb, torch.Tensor):
            raise AssertionError("the 7B embedding is not kept dequantized")
    with phase("K1/K2 vs plain at the 7B shapes"):
        compare_mmq(llm7.params, gen, rep)
    with phase("serve 7B round A (spans <= 512)"):
        launches.update({k: v for k, v in serve(
            llm7, seed, ROUND_A_KERNELS, ROUND_A).items()
            if k in ROUND_A_KERNELS})
    with phase("serve 7B round B (decode at span 4096)"):
        launches.update({k: v for k, v in serve(
            llm7, seed + 1, ROUND_B_KERNELS, ROUND_B).items()
            if k in ROUND_B_KERNELS})
    with phase("7B decode step and prefill chunk"):
        profile_7b_decode(llm7, seed, hbm)
    with phase("reference check 7B (2 layers)"):
        cpu7, _ = reference_check(path7, llm7, seed,
                                  ((2, MMOpts(), TOL_LOGITS),))
        long_span_check(cpu7, llm7, seed)
    del llm7, cpu7
    torch.cuda.empty_cache()
    launches.update(iq4_paths(seed, writers, gen, rep))

    # "ms"/"plain_ms": CUDA events around back-to-back calls (host time
    # included where a wrapper's host work outlasts its kernels);
    # "device_ms"/"plain_device_ms": profiler kernel time per call (null
    # where the profiler recorded none); "bound_ms": the larger of the
    # bytes over 3.35 TB/s and the operations over their peak;
    # "library_ms": one PyTorch call computing the same function (null
    # where there is none)
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "shape": HEADLINE[name],
             "launches": launches[name], "max_abs_err": rep.err[name],
             "ms": rep.times[name][0], "plain_ms": rep.times[name][1],
             "bound_ms": rep.bound[name][0], "bound_by": rep.bound[name][1],
             "library_ms": rep.library[name],
             "device_ms": rep.times[name][2],
             "plain_device_ms": rep.times[name][3]}
            for name, (src, replaces) in KERNELS.items()]


if __name__ == "__main__":
    sys.exit(main())
