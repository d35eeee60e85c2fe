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
every kernel's launch counter reset just before it and read just after.

Every serving run below is two `generate` calls over the same prompts:
the first captures each decode chunk's bucket (steps, span, sampler) as
a CUDA graph, the second only replays them, is timed, and must give the
same ids; the launch counters move in eager runs and captures, never in
replays. Each served configuration also gets a graph phase (`graph_phase`:
TinyLlama Q4_K_M, Q5_K_M under act_quant and bf16, Q8_0, Q4_0, the Q2_K
mix, Llama-2-7B at spans 512 and 4096): 8 greedy steps from one saved
cache through the eager loop (`_decode_eager`) and through the graph
replay (`_decode`, twice: capture, then replay alone), ids equal step for
step and the cache bit-equal; then the decode step split through both
(wall, host issue, device busy, idle share, kernels per step), the eager
side's wrapper launches per step required, the graph side's kernels per
step by name (`torch.profiler` sees the kernels a replay runs) equal to
the eager side's.

Q4_K_M with bf16 activations (kernels K1-K4):
1. holds K1-K4 against their plain PyTorch versions on the card, at the
   shapes the serving path gives them, timing both with CUDA events (K4,
   one cluster launch per call, "fast" and "high", at random positions and
   at pos 0, pos = span - t and an inactive slot, read-only, with window
   and softcap, and with the fused t = 1 insert, the cache bit-equal; and
   where a CTA walks its keys in tiles, 192 query heads at span 8192): K1
   (tensor cores under "fast") at n = 1, 8, 9, 16, 17, 64, 65 and 512, both
   sides of each of its tile widths, on every projection and on 256- and
   1000-row slices of wqkv (M below one row block, M not a multiple of
   it), and under "high" (the SIMT tile) on bf16 and on K6's f32 output;
   K2 (tensor cores under "fast") at the same widths on the head and its
   first 1000 rows, and on K6's f32 output;
2. serves 24 token-id prompts (5..300 tokens, 32 new tokens each, greedy)
   through `LLM(max_batch=16, max_seq=2048).generate`, then its graph
   phase at span 256 (88 K1 and 22 K4 launches per eager step required)
   and a seeded sampling check through the graphs (temperature 0.8,
   top-k 40: one seed twice gives equal ids, another seed other ids);
3. checks every logit of that run finite, and the card's logits for a
   16-token prompt against the CPU run of the same port (plain versions):
   within 1e-2 * max|ref| through 2 layers, 5e-2 through all 22.

Q5_K_M under llama.cpp's Q8_1 numerics, `MMOpts(act_quant=True,
precision="high")` (kernels K2-K8):
4. holds K5 (Q8_1 codes) and K6 (fake-quant) bit-equal to their plain
   versions, K7 (the integer MMQ contract) within 1e-5 at every width it
   is built for (n = 1, 4, 8, 16, the 256-row wk among the weights), K8
   (Q5_K MMQ) within 1e-3 of max|ref| under "fast" (tensor cores, at the
   widths of 1., on every projection and on wqkv's first 256 and 1000
   rows) and 1e-5 under "high" (n = 1, 16, 512), on bf16 activations and
   on K6's f32 output, and K2 on K6's output under "high" within 1e-5;
5. serves the same 24 prompts and requires launches of K2-K8 on that run,
   then its graph phase (88 K7 and 22 K4 launches per eager step);
6. checks its logits as in 3: through 2 layers within 1e-2 with bf16
   activations and within 3e-2 under act_quant (where one code moved by
   a last-ulp difference upstream shifts the output by a whole quantum),
   all 22 layers finite; then feeds every projection of a 16- and a
   64-token prefill (2 layers) the CPU run's input on the card and
   requires the route the JAX package takes (K5+K7, K6+K8, K6+K2) and
   the CPU port's output within 1e-5;
7. scores 2,048 seeded token ids with `perplexity_of_gguf(act_quant=True,
   window=512)` and holds the card's mean NLL over one 256-token window,
   2 layers, within 1e-2 nats of the CPU run's;
7a. serves the 24 prompts through the same checkpoint with bf16
   activations (`MMOpts()`: K8 "fast" on tensor cores, K2-K4), requiring
   launches of K8, K2, K3 and K4 and none of the other MMQ kernels, then
   splits a 16-slot decode step at span 256 (88 K8 launches per step
   required) and times a 512-token prefill chunk; 6. holds the 2-layer
   logits of this route against the CPU run (1e-2).

The 32-element-block formats (kernels K10 `mmq_q8_0` and K11
`mmq_legacy`, with K3, K4 and, under act_quant, K6):
8. holds K10 against its plain version at every TinyLlama projection and
   the head: "fast" (tensor cores, 1e-3 of max|ref|) at the widths of 1.
   on bf16 activations and at n = 16, 512 on f32 ones as given and as K6's
   output; "high" (1e-5) at n = 1, 16, 64, 65, 512 and fed K6's output;
   K11 for Q4_0, Q4_1,
   Q5_0 and Q5_1 on wqkv, gate_up, down and the head's first 1000 rows:
   "fast" (tensor cores, 1e-3) at the widths of 1., and at n = 16 and 512
   on f32 activations as given and as K6's output with fp16 block sums;
   "high" (1e-5) on gate_up and down at n = 1, 16, 64, 65, 512 and fed
   K6's output; K10 through `compat.mmq_q8_0` at M, N in {1, 4, 16} and
   K = 32, 64, 96, 128, "high" and "fast" (a ragged tensor-core chunk);
9. serves the 24 prompts through the 22-layer Q8_0 and then the Q4_0
   checkpoint (bf16 activations), requiring launches of K10 (then K11),
   K3 and K4 and none of K1, K2, K7 or K8, then splits a 16-slot decode
   step of each at span 256 (host clock and `torch.profiler`; 89 K10 or
   K11 launches and 22 K4 launches per step required) and times a Q4_0
   512-token prefill chunk;
10. checks 2 layers of each of the five formats against the CPU run
   (logits within 1e-2), and for Q8_0 and Q5_1 every projection of a
   16- and a 64-token act_quant prefill as in 6 (routes K6+K10, K6+K11).

The low-bit formats (kernels K12 `mmq_q2_k`, K13 `mmq_q3_k`, K14
`mmq_iq4`, with K1-K4 in the Q2_K mix; K15 `rms_norm`):
a. holds K1 against its plain version on the mix's 256-row Q4_K wv at every
   width of 1., and K12 and K13 against theirs at every projection of
   the 2-layer Q2_K / Q3_K files and the head, K12 also on the mix's
   unfused wq and wk and the head's first 1000 rows, K13 on the mix's wo
   and down, both at the widths of 1. (both sides of K12's n_pad <= 64
   arm and of every tile of their tensor-core "fast" forms), "fast" (1e-3
   of max|ref|) and "high" (1e-5), on bf16 activations and fed K6's output,
   and through `compat.mmq_q2_k` / `compat.mmq_q3_k` at M, N in {1, 4,
   16}, K = 256 and 512; K15 against its plain version at n = 1, 16, 64,
   d = 2048 and 4096, f32 and bf16 input (1e-6);
b. serves the 24 prompts through the 22-layer Q2_K mix, requiring
   launches of K12, K13, K1, K2, K3 and K4 and none of the other MMQ
   kernels, then splits a 16-slot decode step at span 256 (host clock,
   launches per step and `torch.profiler`, device time by kernel),
   recomputes every RMSNorm of one such step with K15 beside the model's
   own (1e-6), and times a 512-token prefill chunk;
c. checks 2 layers of the mix and of the Q2_K and Q3_K files against the
   CPU run (logits within 1e-2), with the act_quant projection check of
   6 for Q2_K and Q3_K (routes K6+K12, K6+K13);
d. after the 7B phases, K14 as K12 in a. (tensor cores under "fast") on
   every projection and the head of the IQ4_NL and IQ4_XS files and the
   heads' first 1000 rows, the 24 prompts served through the IQ4_XS one
   (K14 launched), and the checks of c. for both (projection check for
   IQ4_XS: K6+K14).

Llama-2-7B Q4_K_M with bf16 activations at its 4,096-token context
(kernels K1-K4 and K9, flash-decoding):
11. holds K9 (one cluster launch per call) against its plain version
   ("fast" and "high", 1e-3 of max|ref|) at the 7B geometry (16 slots, 32
   heads of 128, spans 1024, 2048 and 4096, positions 0, 255, 256, random
   ones and an inactive slot at pos = 4096), with a sliding window and
   softcap, at one slot (32 clusters, fewer than the SMs), with the fused
   t = 1 insert (the cache bit-equal to K3's plain insert) and at the
   TinyLlama geometry (8 query heads per KV head, hd 64, span 2048); then
   K3/K4 at hd 128 with one query head per KV head, K4 at 16 query heads
   per KV head and t = 8, and K1/K2 at every 7B projection and the head,
   against their plain versions;
12. serves two rounds of 16 requests through `LLM(max_batch=16,
   max_seq=4096)`, 32 greedy tokens each: round A (prompts of 5..440
   tokens, every decode step at span <= 512: K1-K4) and round B (600..3,900
   tokens: prefill crosses every span bucket, decode runs at span 4096 on
   K9 with the insert fused in), every logit finite;
13. times a 16-slot decode step at span 512 and at span 4096 (host clock
   and `torch.profiler`: device time, K9 per layer beside its bound; 32
   K4 launches per step at span 512 required, 32 K9 and no K3 launches
   at span 4096) and a 512-token prefill chunk;
14. checks 2 layers against the CPU run of the same port: the logits of a
   16-token prefill, then a 2,100-token prefill on the card whose cache
   is copied to the CPU, and one t = 1 and one t = 8 step at span 4096 on
   both (1e-2 of max|ref|); the card's t = 1 step must launch K9 and
   neither K3 nor K4, its t = 8 step neither K4 nor K9 (the f32 arm).

`--profile` instead splits a 16-slot decode step of the Q5_K_M
checkpoint with bf16 activations and under act_quant (host clock and
`torch.profiler`), and checks nothing. `--mix-step [q2k_mix|q5km|
iq4_xs_2l|q4_0|q8_0|q4km]` instead splits that checkpoint's decode step
with bf16 activations (twice; the Q2_K mix by default) and times its
512-token prefill chunk, as b. does, and checks nothing; copied beside an
earlier tree of the port it measures that tree, so two trees compare in
one call. `--tiled-split` instead times K9 alone at its headline shape
and at long spans of Llama-3 geometries (CUDA events, and
`torch.profiler` device time by kernel name), and checks it against its
plain version; it too imports nothing an earlier tree lacks.

Prints the card's name and power limit, a per-shape table, seconds per
phase and in total, one JSON line {"kernels": [...]} (per kernel its
headline shape's times, its bound from this run's inputs and, where one
PyTorch call computes the same function, that call's time, and the same
at a second shape: n = 512 for the tensor-core MMQ kernels, the 7B
geometry for K4) and, last,
{"ok": true, "device": {...}}. Any failed check raises and the script
exits nonzero. Needs one CUDA device, nvcc and gcc.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib
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
from gguf_tpu_torch.ops.attention import (PALLAS_ATTN_MAX_ELEMS,
                                          _attend_cuda, decode_attention,
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

# the module (the package re-exports its functions), for K9's plan
attention_mod = importlib.import_module("gguf_tpu_torch.ops.attention")

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
# K9 at the long spans of Llama-3 geometries (meta-llama config.json: 8 KV
# heads; Llama-3.1-8B 32 heads of 128, Llama-3.1-70B 64 of 128,
# Llama-3.2-1B 32 of 64; context 131072), where a slice of 8 CTAs outgrows
# shared memory at G > 1 and K9 walks it in sub-slices: (label, KV heads,
# query heads per KV head, hd, span)
TILED_LONG = (("llama-3.1-8b", 8, 4, 128, 65536),
              ("llama-3.1-70b", 8, 8, 128, 131072),
              ("llama-3.2-1b", 8, 4, 64, 131072))
MMQ_NS = (1, 16, 512)
# the tensor-core tiles (K1, K2, K8 and K11-K14 "fast"): both sides of every
# tile width of their dispatch (8 | 16 | 64 | 128 activation rows, 64 then
# 128 weight rows per block; K12's split arm up to 64, folded above); K1
# "high" (the SIMT tile) at a decode and a prefill width
TC_NS = (1, 8, 9, 16, 17, 64, 65, 512)
K1_HIGH_NS = (16, 512)
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
    "decode_attention_tiled": ("gguf_tpu_torch/csrc/attention_tiled.cu",
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
Q5KM_BF16_KERNELS = ("mmq_q5_k", "mmq_q6_k", "kv_cache_insert",
                     "decode_attention")
# every MMQ kernel: a serving path with bf16 activations must launch none
# but those of its own formats
MMQ_KERNELS = ("mmq_q4_k", "mmq_q6_k", "mmq_i8", "mmq_q5_k", "mmq_q8_0",
               "mmq_legacy", "mmq_q2_k", "mmq_q3_k", "mmq_iq4")
ROUND_A_KERNELS = Q4KM_KERNELS
ROUND_B_KERNELS = ("mmq_q4_k", "mmq_q6_k", "decode_attention_tiled")
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
# a kernel's second shape, timed beside its bound and its library call as
# the headline is, under its key in the {"kernels": ...} line: the prefill
# width of each tensor-core MMQ kernel ("wide") and K4 at the 7B geometry
# ("7b")
WIDE = {"mmq_q4_k": "gate_up 11264x2048 n=512",
        "mmq_q6_k": "head 32000x2048 n=512",
        "mmq_q5_k": "gate_up 11264x2048 n=512 fast",
        "mmq_q8_0": "gate_up 11264x2048 n=512 fast",
        "mmq_legacy": "q4_0 gate_up 11264x2048 n=512 fast",
        "mmq_q2_k": "gate_up 11264x2048 n=512 fast",
        "mmq_q3_k": "gate_up 11264x2048 n=512 fast",
        "mmq_iq4": "iq4_xs gate_up 11264x2048 n=512 fast"}
SECOND = {**{k: ("wide", v) for k, v in WIDE.items()},
          "decode_attention": ("7b", "kvh32 hd128 b16 t=1 span=512 insert")}
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
    library yardstick, and those of the SECOND shape."""

    def __init__(self):
        self.err = {k: 0.0 for k in KERNELS}
        self.times = {}
        self.bound = {}
        self.library = {}
        self.second = {}

    def add(self, kernel, shape, err, rel, tol, fn=None, plain_fn=None,
            work=None, library=None):
        """Record one check; time fn (the kernel) and plain_fn with CUDA
        events, and at the headline and SECOND shapes also by profiler device
        time, with the bound from `work` = (bytes, operations, their type)
        and the time of the call that `library()` returns, one PyTorch call
        computing the same function (or None)."""
        ok = rel <= tol
        times = "not timed"
        if ok and fn is not None:
            ms, pms = cuda_ms(fn), cuda_ms(plain_fn, iters=5)
            times = f"{ms:.4f} ms vs plain {pms:.4f} ms"
            second = SECOND.get(kernel, (None, None))
            if shape in (HEADLINE[kernel], second[1]):
                dms, pdms = device_ms(fn), device_ms(plain_fn)
                bound = bound_ms(*work)
                lib_ms = None if library is None else cuda_ms(library())
                if shape == HEADLINE[kernel]:
                    self.times[kernel] = (ms, pms, dms, pdms)
                    self.bound[kernel], self.library[kernel] = bound, lib_ms
                else:
                    self.second[kernel] = second[0], {
                        "shape": shape, "ms": ms, "device_ms": dms,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": lib_ms}
                dev = ["not measured" if v is None else f"{v:.4f} ms"
                       for v in (dms, pdms)]
                lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
                times += (f" (device {dev[0]} vs plain {dev[1]}; bound "
                          f"{bound[0]:.4f} ms by {bound[1]}; library {lib})")
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
    """Write one random checkpoint (the child process's whole work). The
    IQ4 files, read last, are written at a lower CPU priority: the 7B
    writer beside them decides when the 7B phases can start."""
    if tag.startswith("iq4"):
        os.nice(10)
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


def compare_k1(label: str, w, gen: torch.Generator, rep: Report, ns=TC_NS,
               glu=None, precision: str = "fast", fq: bool = False) -> None:
    """K1 against its plain version on one weight at each n: bf16
    activations, or (fq) K6's f32 output as the act_quant path feeds the
    float kernel; "fast" within TOL_MMQ, "high" within TOL_HIGH."""
    for n in ns:
        k = w.shape[1] * (2 if glu else 1)
        x = torch.randn((n, k), generator=gen, device=DEVICE)
        x = fake_quantize_q8_1(x) if fq else x.bfloat16()
        got = mmq_q4_k(w, x, precision=precision, glu=glu)
        ref = mmq_q4_k_plain(w, x, precision=precision, glu=glu)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        shape = f"{label} {w.shape[0]}x{w.shape[1]} n={n}"
        if precision == "high":
            shape += " high q8_1 f32" if fq else " high"
        rep.add("mmq_q4_k", shape, err, rel,
                TOL_MMQ if precision == "fast" else TOL_HIGH,
                lambda: mmq_q4_k(w, x, precision=precision, glu=glu),
                lambda: mmq_q4_k_plain(w, x, precision=precision, glu=glu),
                work=_mmq_work(w, x, got,
                               "bf16" if precision == "fast" else "f32"),
                library=lambda: matmul_library(w, x))


def compare_k2(label: str, w, gen: torch.Generator, rep: Report, ns=TC_NS,
               fq: bool = False) -> None:
    """K2 "fast" (the tensor-core tile) against its plain version on one
    Q6_K weight at each n: bf16 activations, or (fq) K6's f32 output, which
    the wrapper rounds to bf16 in one pass first; within TOL_MMQ."""
    for n in ns:
        x = torch.randn((n, w.shape[1]), generator=gen, device=DEVICE)
        x = fake_quantize_q8_1(x) if fq else x.bfloat16()
        got = mmq_q6_k(w, x, precision="fast")
        err, rel = rel_err(got, mmq_q6_k_plain(w, x, precision="fast"))
        shape = f"{label} {w.shape[0]}x{w.shape[1]} n={n}"
        rep.add("mmq_q6_k", shape + (" q8_1 f32" if fq else ""), err, rel,
                TOL_MMQ, lambda: mmq_q6_k(w, x, precision="fast"),
                lambda: mmq_q6_k_plain(w, x, precision="fast"),
                work=_mmq_work(w, x, got),
                library=lambda: matmul_library(w, x))


def compare_mmq(params: dict, gen: torch.Generator, rep: Report) -> None:
    """K1 on the Q4_K_M projections at both sides of every tile width
    ("fast", bf16 activations), on wqkv's first 256 rows (M below one row
    block) and first 1000 (M not a multiple of it), and "high" (the SIMT
    tile) on bf16 and on K6's f32 output; K2 "fast" on the head and its
    first 1000 rows at the same widths, and on K6's f32 output."""
    layer = params["layers"][0]
    wqkv = layer["wqkv"]
    for name, key, glu in (("wqkv", "wqkv", None), ("wo", "wo", None),
                           ("gate_up", "gate_up", None),
                           ("down+glu", "down", "silu")):
        compare_k1(name, layer[key], gen, rep, glu=glu)
    for rows in (256, 1000):
        compare_k1(f"wqkv[:{rows}]", wqkv.take_rows(torch.arange(rows)), gen,
                   rep)
    compare_k1("wqkv", wqkv, gen, rep, K1_HIGH_NS, precision="high")
    compare_k1("down+glu", layer["down"], gen, rep, K1_HIGH_NS, glu="silu",
               precision="high")
    for name, key in (("wqkv", "wqkv"), ("down", "down")):
        compare_k1(name, layer[key], gen, rep, FQ_NS, precision="high",
                   fq=True)
    head = params["output"]
    compare_k2("head", head, gen, rep)
    compare_k2("head[:1000]", head.take_rows(torch.arange(1000)), gen, rep)
    compare_k2("head", head, gen, rep, HEAD_NS, fq=True)


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
    """K3 bit-equal to its plain version and K4 within TOL_ATTN, at 16 slots
    over an (s)-row cache: read-only and (t = 1) with the fused insert (the
    cache then bit-equal to K3's plain version), "fast" on bf16 queries and
    "high" on f32 ones, at random positions (timed) and at the edges (pos
    0, pos = span - t and an inactive slot at pos = s, which reads the whole
    span and writes nothing), with window + softcap at span 512; `tag`
    prefixes the shape names."""
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
            q16 = torch.randn((b, h, t, hd), generator=gen, device=DEVICE).bfloat16()
            p = torch.randint(0, span - t + 1, (b,), generator=gen,
                              device=DEVICE, dtype=torch.int32)
            q32 = torch.randn((b, h, t, hd), generator=gen, device=DEVICE)
            edges = p.clone()
            edges[0], edges[1], edges[-1] = 0, span - t, s
            for prec, q in (("fast", q16), ("high", q32)):
                for pp, where in ((p, ""), (edges, " edges")):
                    attention_case(rep, q, kn, vn, cache, pp, t, span, prec,
                                   f"{tag}b{b} t={t} span={span}{where}",
                                   timed=pp is p)


def attention_case(rep: Report, q, kn, vn, cache, p, t: int, span: int,
                   prec: str, shape: str, timed: bool) -> None:
    """One K4 case of `compare_attention`: read-only, with window 64 and
    softcap 2.0 at span 512 (no ported family uses them yet), and at t = 1
    with the fused insert; times the read-only and the insert form at
    random positions ("fast": the headline and its SDPA yardstick)."""
    kw = dict(t=t, precision=prec, span=span)
    suffix = "" if prec == "fast" else " high"
    err, rel = rel_err(decode_attention(q, *cache, p, **kw),
                       decode_attention_plain(q, *cache, p, **kw))
    rep.add("decode_attention", shape + suffix, err, rel, TOL_ATTN,
            *((lambda: decode_attention(q, *cache, p, **kw),
               lambda: decode_attention_plain(q, *cache, p, **kw))
              if timed else ()),
            work=_attn_work(q, kn, cache, p, span, t, False))
    if span == 512:
        wkw = dict(kw, window=64, softcap=2.0)
        err, rel = rel_err(decode_attention(q, *cache, p, **wkw),
                           decode_attention_plain(q, *cache, p, **wkw))
        rep.add("decode_attention", f"{shape} window+softcap{suffix}", err,
                rel, TOL_ATTN)
    if t != 1:
        return
    # the fused t = 1 insert + attend, as every decode step runs it
    kn1, vn1 = kn[:, :, :1], vn[:, :, :1]
    got = [c.clone() for c in cache]
    ref = [c.clone() for c in cache]
    out = decode_attention_update(q, kn1, vn1, *got, p, **kw)[0]
    kv_cache_insert_plain(kn1, vn1, *ref, p)
    ref_out = decode_attention_plain(q, *ref, p, **kw)
    for g, r in zip(got, ref):
        if not torch.equal(g, r):
            raise AssertionError(f"decode_attention {shape} insert: cache "
                                 "differs")
    err, rel = rel_err(out, ref_out)

    def plain_update():
        kv_cache_insert_plain(kn1, vn1, *ref, p)
        return decode_attention_plain(q, *ref, p, **kw)

    rep.add("decode_attention", f"{shape} insert{suffix}", err, rel, TOL_ATTN,
            *((lambda: decode_attention_update(q, kn1, vn1, *got, p, **kw),
               plain_update) if timed else ()),
            work=_attn_work(q, kn1, cache, p, span, 1, True),
            library=lambda: sdpa_library(q, ref, p, span, prec))


def compare_attention_tiles(gen: torch.Generator, rep: Report) -> None:
    """K4 where a CTA's scores outgrow its shared memory, so it walks its
    range in `k4_plan`'s tiles and scores each again in the later passes
    (never on the model's routes): 192 query heads of 64 over one KV head
    (the wrapper's 48 KiB query tile) at span 8192, within the single-tile
    envelope; a slot at pos 5000 and an inactive one; "fast" and "high"
    within TOL_ATTN."""
    b, h, hd, s = 2, 192, 64, 8192
    cache = _random_cache(gen, b, 1, s, hd)
    pos = torch.tensor([5000, s], dtype=torch.int32, device=DEVICE)
    for prec in ("fast", "high"):
        q = torch.randn((b, h, 1, hd), generator=gen, device=DEVICE)
        kw = dict(t=1, precision=prec, span=s)
        err, rel = rel_err(decode_attention(q, *cache, pos, **kw),
                           decode_attention_plain(q, *cache, pos, **kw))
        rep.add("decode_attention", f"b2 h192 kvh1 hd64 t=1 span={s} tiles "
                f"{prec}", err, rel, TOL_ATTN)


def _tiled_positions(gen: torch.Generator, b: int, s: int) -> torch.Tensor:
    """Random positions with the first row, both sides of a tile edge and
    an inactive slot (pos = S: every column live)."""
    pos = torch.randint(0, s, (b,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    pos[:3] = torch.tensor([0, 255, 256], dtype=torch.int32)
    pos[-1] = s
    return pos


def _tiled_work(q, cache, pos, span: int, prec: str) -> tuple:
    """Bytes and operations K9 needs: q and the output, the live K/V rows
    and their scales."""
    h, hd = q.shape[1], q.shape[3]
    kvh = cache[0].shape[1]
    rows = live_rows(pos, span)
    n = 2 * q.numel() * 4 + rows * kvh * 2 * (hd + 4)
    return n, 4.0 * rows * h * hd, "bf16" if prec == "fast" else "f32"


def _tiled_headline(seed: int) -> tuple:
    """K9's headline inputs (cache, pos, q) at the 7B geometry: 16 slots,
    32 heads of 128, a 4096-row cache, `_tiled_positions`; from a generator
    of their own, so that `compare_tiled` and `--tiled-split` time the same
    positions."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    b, h, kvh, hd = MAX_BATCH, CFG7B.n_heads, CFG7B.n_kv_heads, CFG7B.head_dim
    cache = _random_cache(gen, b, kvh, SEQ7B, hd)
    pos = _tiled_positions(gen, b, SEQ7B)
    q = torch.randn((b, h, 1, hd), generator=gen, device=DEVICE)
    return cache, pos, q


def compare_tiled(gen: torch.Generator, rep: Report, seed: int) -> None:
    """K9 against its plain version within TOL_ATTN, "fast" and "high": at
    the 7B geometry (16 slots, 32 heads and 32 KV heads of 128, a 4096-row
    cache, `_tiled_headline(seed)`) for spans 1024, 2048, 4096, with window
    64 + softcap 8.0, at one slot (32 clusters, fewer than the SMs) and
    with the fused t = 1 insert as a decode step runs it
    (`decode_attention_update`, the cache bit-equal to K3's plain insert,
    at spans 4096 and 1024); at the TinyLlama geometry (32 heads over 4 KV
    heads of 64) at span 2048, read only and with the insert. The 4096
    "fast" case is the headline: its bound counts the live rows of these
    positions. Then `compare_tiled_long`, and K4 at 16 query heads per KV
    head, t = 8, hd 128 (its query tile past 48 KB)."""
    cases = [(CFG7B, SEQ7B, TILED_SPANS, "b16 h32 hd128"),
             (CFG, MAX_SEQ, (2048,), "b16 h32 kvh4 hd64")]
    b = MAX_BATCH
    for cfg, s, spans, label in cases:
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if cfg is CFG7B:
            cache, pos, q = _tiled_headline(seed)
        else:
            cache = _random_cache(gen, b, kvh, s, hd)
            pos = _tiled_positions(gen, b, s)
            q = torch.randn((b, h, 1, hd), generator=gen, device=DEVICE)
        kn = torch.randn((b, kvh, 1, hd), generator=gen, device=DEVICE) * 2
        vn = torch.randn((b, kvh, 1, hd), generator=gen, device=DEVICE)
        for span in spans:
            for prec in ("fast", "high"):
                kw = dict(precision=prec, span=span)
                err, rel = rel_err(
                    decode_attention_tiled(q, *cache, pos, **kw),
                    decode_attention_tiled_plain(q, *cache, pos, **kw))
                rep.add("decode_attention_tiled", f"{label} span={span} {prec}",
                        err, rel, TOL_ATTN,
                        lambda: decode_attention_tiled(q, *cache, pos, **kw),
                        lambda: decode_attention_tiled_plain(q, *cache, pos,
                                                             **kw),
                        work=_tiled_work(q, cache, pos, span, prec),
                        library=lambda: sdpa_library(q, cache, pos, span, prec))
                if cfg is CFG7B and span in (1024, s) or cfg is CFG:
                    tiled_insert_case(rep, q, kn, vn, cache, pos, span, prec,
                                      f"{label} span={span} {prec} insert")
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
            # one slot: 32 (slot, head) clusters, fewer than the SMs
            one = [c[:1] for c in cache]
            for prec in ("fast", "high"):
                kw = dict(precision=prec, span=s)
                err, rel = rel_err(
                    decode_attention_tiled(q[:1], *one, pos[-2:-1], **kw),
                    decode_attention_tiled_plain(q[:1], *one, pos[-2:-1],
                                                 **kw))
                rep.add("decode_attention_tiled", f"b1 h32 hd128 span={s} "
                        f"{prec}", err, rel, TOL_ATTN,
                        lambda: decode_attention_tiled(q[:1], *one,
                                                       pos[-2:-1], **kw),
                        lambda: decode_attention_tiled_plain(
                            q[:1], *one, pos[-2:-1], **kw),
                        work=_tiled_work(q[:1], one, pos[-2:-1], s, prec))
            # the sub-slice walk at G = 1, with the insert: the plan's
            # clusters, 128 rows held (a span this model never reaches
            # would take it)
            real = attention_mod.k9_plan
            attention_mod.k9_plan = lambda *a: (real(*a)[0], 128)
            try:
                for prec in ("fast", "high"):
                    tiled_insert_case(rep, q, kn, vn, cache, pos, s, prec,
                                      f"{label} span={s} held=128 {prec} "
                                      "insert")
            finally:
                attention_mod.k9_plan = real
    compare_tiled_long(gen, rep)
    # K4 at G = 16, t = 8, hd 128: 128 query rows, a 186,640-byte block
    g, kvh, hd, s, t = 16, 8, 128, 512, 8
    cache = _random_cache(gen, b, kvh, s, hd)
    p = torch.randint(0, s - t + 1, (b,), generator=gen, device=DEVICE,
                      dtype=torch.int32)
    p[0], p[1], p[-1] = 0, s - t, s
    for prec in ("fast", "high"):
        q = torch.randn((b, g * kvh, t, hd), generator=gen, device=DEVICE)
        kw = dict(t=t, precision=prec, span=s)
        err, rel = rel_err(decode_attention(q, *cache, p, **kw),
                           decode_attention_plain(q, *cache, p, **kw))
        rep.add("decode_attention", f"b16 g16 kvh8 hd128 t={t} span={s} "
                f"{prec}", err, rel, TOL_ATTN)


def compare_tiled_long(gen: torch.Generator, rep: Report) -> None:
    """K9 at TILED_LONG's geometries, 4 slots at positions 5000 and 12000
    (within one sub-slice of a CTA's slice or across two), span - 1 and
    span (inactive: every row live), against its plain version within
    TOL_ATTN, "fast" and "high", timed against it; at Llama-3.1-8B's also
    with window 60000 + softcap 30 and with the fused insert (the cache
    bit-equal to K3's)."""
    b = 4
    for label, kvh, g, hd, span in TILED_LONG:
        cache = _random_cache(gen, b, kvh, span, hd)
        pos = torch.tensor([5000, 12000, span - 1, span], dtype=torch.int32,
                           device=DEVICE)
        q = torch.randn((b, kvh * g, 1, hd), generator=gen, device=DEVICE)
        clusters, held = attention_mod.k9_plan(
            b, kvh, g, span, hd, torch.cuda.get_device_properties(0)
            .multi_processor_count)
        shape = f"{label} b{b} g{g} hd{hd} span={span}"
        log(f"  K9 {shape}: {clusters} CTAs per cluster, slices of "
            f"{-(-span // clusters)} rows, {held} held")
        for prec in ("fast", "high"):
            kw = dict(precision=prec, span=span)
            err, rel = rel_err(decode_attention_tiled(q, *cache, pos, **kw),
                               decode_attention_tiled_plain(q, *cache, pos,
                                                            **kw))
            rep.add("decode_attention_tiled", f"{shape} {prec}", err, rel,
                    TOL_ATTN,
                    lambda: decode_attention_tiled(q, *cache, pos, **kw),
                    lambda: decode_attention_tiled_plain(q, *cache, pos,
                                                         **kw))
        if label == "llama-3.1-8b":
            wkw = dict(precision="fast", span=span, window=60000,
                       softcap=30.0)
            err, rel = rel_err(decode_attention_tiled(q, *cache, pos, **wkw),
                               decode_attention_tiled_plain(q, *cache, pos,
                                                            **wkw))
            rep.add("decode_attention_tiled", f"{shape} window+softcap", err,
                    rel, TOL_ATTN)
            kn = torch.randn((b, kvh, 1, hd), generator=gen,
                             device=DEVICE) * 2
            vn = torch.randn((b, kvh, 1, hd), generator=gen, device=DEVICE)
            for prec in ("fast", "high"):
                tiled_insert_case(rep, q, kn, vn, cache, pos, span, prec,
                                  f"{shape} {prec} insert")
        del cache
        torch.cuda.empty_cache()


def tiled_insert_case(rep: Report, q, kn, vn, cache, pos, span: int,
                      prec: str, shape: str) -> None:
    """K9 with the fused t = 1 insert against K3's plain insert followed by
    K9's plain version: the cache bit-equal, the output within TOL_ATTN.
    Where the routing takes K9 at t = 1 the call is
    `decode_attention_update`, as a decode step makes it; elsewhere (the
    TinyLlama geometry) the wrapper's launcher directly (imported here:
    `--tiled-split` runs on trees that lack it)."""
    from gguf_tpu_torch.ops.attention import _tiled_cuda

    kvh, hd = cache[0].shape[1], cache[0].shape[3]
    got = [c.clone() for c in cache]
    ref = [c.clone() for c in cache]
    kw = dict(precision=prec, span=span)
    if kvh * span * hd > PALLAS_ATTN_MAX_ELEMS:
        out = decode_attention_update(q, kn, vn, *got, pos, t=1, **kw)[0]
    else:
        out = _tiled_cuda(q, kn, vn, *got, pos, window=0, softcap=0.0, **kw)
    kv_cache_insert_plain(kn, vn, *ref, pos)
    for g, r in zip(got, ref):
        if not torch.equal(g, r):
            raise AssertionError(f"decode_attention_tiled {shape}: cache "
                                 "differs from K3's")
    err, rel = rel_err(out, decode_attention_tiled_plain(q, *ref, pos, **kw))
    rep.add("decode_attention_tiled", shape, err, rel, TOL_ATTN)


def _time_tiled(label: str, q, cache, pos, span: int, prec: str) -> None:
    """One K9 shape of `tiled_split`: checked against the plain version,
    CUDA-event time over 20 calls, and profiler device time per call (per
    kernel name its mean time per launch times its launches per call,
    from the window of three with the most device events: a window can
    miss a few events) beside the bound."""
    kw = dict(precision=prec, span=span)

    def fn():
        return decode_attention_tiled(q, *cache, pos, **kw)

    rel = rel_err(fn(), decode_attention_tiled_plain(q, *cache, pos, **kw))[1]
    if rel > TOL_ATTN:
        raise AssertionError(f"K9 {label} {prec}: rel err {rel} > {TOL_ATTN}")
    ms = cuda_ms(fn)
    best = []
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if sum(e.count for e in kern) > sum(e.count for e in best):
            best = kern
    per = [(e.self_device_time_total / e.count / 1e3, round(e.count / 20),
            e.key) for e in best]
    bound = bound_ms(*_tiled_work(q, cache, pos, span, prec))
    log(f"K9 {label} span={span} {prec}: rel err {rel:.2e}, events "
        f"{ms:.4f} ms, device {sum(t * n for t, n, _ in per):.4f} ms, bound "
        f"{bound[0]:.4f} ms by {bound[1]}; by kernel per call:")
    for t, n, key in sorted(per, key=lambda x: -x[0] * x[1]):
        log(f"  {t * n:.4f} ms {n}x {key[:90]}")


def tiled_split(seed: int) -> None:
    """K9 alone: at its headline shape and positions (`_tiled_headline`,
    as `compare_tiled` draws them), "fast" and "high"; then "fast" at
    TILED_LONG's geometries with `compare_tiled_long`'s positions, and at
    Llama-3.1-8B's with 16 slots at span 8192 (every row live), both
    seeded from `seed`. Imports nothing an earlier tree lacks, so it times
    an unpacked parent tree too."""
    cache, pos, q = _tiled_headline(seed)
    for prec in ("fast", "high"):
        _time_tiled(f"b{q.shape[0]} h{q.shape[1]} hd{q.shape[3]}", q, cache,
                    pos, SEQ7B, prec)
    del cache
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 1)
    for label, kvh, g, hd, span in TILED_LONG + (
            ("llama-3.1-8b b16", 8, 4, 128, 8192),):
        b = 16 if label.endswith("b16") else 4
        cache = _random_cache(gen, b, kvh, span, hd)
        pos = (torch.full((b,), span - 1, dtype=torch.int32, device=DEVICE)
               if b == 16 else torch.tensor([5000, 12000, span - 1, span],
                                            dtype=torch.int32, device=DEVICE))
        q = torch.randn((b, kvh * g, 1, hd), generator=gen, device=DEVICE)
        _time_tiled(f"{label} g{g} hd{hd}", q, cache, pos, span, "fast")
        del cache
        torch.cuda.empty_cache()


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
    """K7 on the Q5_K_M projections, its 256-row wk (M below one row
    block) and the Q4_K_M gate_up, fed K5's codes of bf16 activations."""
    weights = [(f"q5_k {key}", layer5[key])
               for key in ("wqkv", "wo", "gate_up", "down")]
    q_d, kv_d = CFG.n_heads * CFG.head_dim, CFG.n_kv_heads * CFG.head_dim
    weights.append(("q5_k wk", layer5["wqkv"].take_rows(
        torch.arange(q_d, q_d + kv_d))))
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
    """K8 on the four Q5_K_M projections: "fast" (the tensor-core tile) at
    every TC_NS width, "high" (the SIMT tile) at MMQ_NS, on bf16
    activations, and both on K6's f32 output as the act_quant path feeds
    it; "fast" also on wqkv's first 256 rows (M below one row block) and
    first 1000 (M not a multiple of it), as K1 is held."""
    wqkv = layer5["wqkv"]
    weights = [(key, layer5[key], True)
               for key in ("wqkv", "wo", "gate_up", "down")]
    weights += [(f"wqkv[:{rows}]", wqkv.take_rows(torch.arange(rows)), False)
                for rows in (256, 1000)]
    for key, w, whole in weights:
        def bf16(n):
            return torch.randn((n, w.shape[1]), generator=gen,
                               device=DEVICE).bfloat16()

        cases = [(n, "bf16", "fast", bf16(n)) for n in TC_NS]
        if whole:
            cases += [(n, "bf16", "high", bf16(n)) for n in MMQ_NS]
            cases += [(n, "q8_1 f32", prec, fake_quantize_q8_1(
                torch.randn((n, w.shape[1]), generator=gen, device=DEVICE)))
                for n in FQ_NS for prec in ("fast", "high")]
        for n, dt, prec, x in cases:
            got = mmq_q5_k(w, x, precision=prec)
            err, rel = rel_err(got, mmq_q5_k_plain(w, x, precision=prec))
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
    checkpoint against its plain version: "fast" (its tensor-core tile) at
    TC_NS on bf16 activations, and at n = 16 and 512 on f32 ones, as given
    and as K6's output; "high" (the SIMT tile) at BLOCK32_NS and fed K6's
    output (n = 16, 512). K11
    (`legacy`: format -> params) on wqkv, gate_up, down and the head's first
    1000 rows of each legacy format: "fast" (its tensor-core tile) at TC_NS
    on bf16 activations, and at n = 16 and 512 on f32 ones, as given and
    as K6's output with its block sums rounded through fp16 (the sums then
    come from the pass over the f32 operand, not from the staged bf16
    tile); "high" (the SIMT tile) on gate_up and down at BLOCK32_NS and fed
    K6's output at n = 16, 512."""
    def plain8(w, x, prec, act_quant=False):
        if act_quant:
            x = fake_quantize_q8_1_plain(x)
        return mmq_q8_0_plain(w, x, precision=prec)

    def plain11(w, x, prec, act_quant=False):
        if act_quant:
            x = fake_quantize_q8_1_plain(x)
        return mmq_legacy_plain(w, x, precision=prec, fp16_bsum=act_quant)

    def bf16_cases(kernel, fn, plain, w, shape, ns, precs):
        for n in ns:
            x = torch.randn((n, w.shape[1]), generator=gen,
                            device=DEVICE).bfloat16()
            for prec in precs:
                got = fn(w, x, precision=prec)
                err, rel = rel_err(got, plain(w, x, prec))
                rep.add(kernel, f"{shape} n={n} {prec}", err, rel,
                        TOL_MMQ if prec == "fast" else TOL_HIGH,
                        lambda: fn(w, x, precision=prec),
                        lambda: plain(w, x, prec),
                        work=_mmq_work(w, x, got,
                                       "bf16" if prec == "fast" else "f32"),
                        library=lambda: matmul_library(w, x))

    def q8_1_cases(kernel, fn, plain, w, shape, modes):
        for n in (16, 512):
            x = _q8_1_input(gen, n, w.shape[1])
            for prec, act_quant in modes:
                err, rel = rel_err(fn(w, x, precision=prec, act_quant=act_quant),
                                   plain(w, x, prec, act_quant))
                rep.add(kernel, f"{shape} n={n} {prec} "
                        f"{'act_quant' if act_quant else 'f32'}", err, rel,
                        TOL_MMQ if prec == "fast" else TOL_HIGH)

    for label, w in [(key, layer8[key]) for key in
                     ("wqkv", "wo", "gate_up", "down")] + [("head", head8)]:
        shape = f"{label} {w.shape[0]}x{w.shape[1]}"
        bf16_cases("mmq_q8_0", mmq_q8_0, plain8, w, shape, TC_NS, ("fast",))
        bf16_cases("mmq_q8_0", mmq_q8_0, plain8, w, shape, BLOCK32_NS,
                   ("high",))
        q8_1_cases("mmq_q8_0", mmq_q8_0, plain8, w, shape,
                   (("fast", False), ("fast", True), ("high", True)))
    for fmt, params in legacy.items():
        layer = params["layers"][0]
        for key, w in (("wqkv", layer["wqkv"]), ("gate_up", layer["gate_up"]),
                       ("down", layer["down"]),
                       ("head[:1000]",
                        params["output"].take_rows(torch.arange(1000)))):
            shape = f"{fmt} {key} {w.shape[0]}x{w.shape[1]}"
            bf16_cases("mmq_legacy", mmq_legacy, plain11, w, shape, TC_NS,
                       ("fast",))
            modes = [("fast", False), ("fast", True)]
            if key in ("gate_up", "down"):
                bf16_cases("mmq_legacy", mmq_legacy, plain11, w, shape,
                           BLOCK32_NS, ("high",))
                modes.append(("high", True))
            q8_1_cases("mmq_legacy", mmq_legacy, plain11, w, shape, modes)


def compare_compat(seed: int, gen: torch.Generator, rep: Report,
                   fmt: str = "q8_0", ks: tuple = COMPAT_KS) -> None:
    """K10 (K12, K13) through the reference's calling convention,
    `compat.mmq_q8_0(A, B, M, N, K)` (`mmq_q2_k`, `mmq_q3_k`; act_quant and
    "high" by default), over the reference's sweep: M, N in COMPAT_MNS, K
    in `ks`, with and without act_quant; Q8_0 also under "fast" (its
    tensor-core tile, whose one 128-element chunk is ragged at K = 32, 64
    and 96; the SIMT tile ends on a half step at K = 32 and 96)."""
    rng = np.random.default_rng(seed)
    kernel = "mmq_" + fmt
    plain = {"q8_0": mmq_q8_0_plain, "q2_k": mmq_q2_k_plain,
             "q3_k": mmq_q3_k_plain}[fmt]
    precs = ("high", "fast") if fmt == "q8_0" else ("high",)
    for m in COMPAT_MNS:
        for k in ks:
            a = QUANTIZERS[fmt](rng.standard_normal((m, k)))
            w = QuantWeight.from_blocks(fmt, a, (m, k), DEVICE)
            for n in COMPAT_MNS:
                b = torch.randn((n, k), generator=gen, device=DEVICE)
                for act_quant in (True, False):
                    x = fake_quantize_q8_1_plain(b) if act_quant else b
                    for prec in precs:
                        got = getattr(compat, kernel)(
                            a, b, m, n, k, device=DEVICE, act_quant=act_quant,
                            precision=prec)
                        err, rel = rel_err(got, plain(w, x, precision=prec))
                        if fmt != "q8_0":
                            # held to the scale of the f32 sums' own rounding
                            rel = err / _terms_max(w, x)
                        rep.add(kernel, f"compat M={m} N={n} K={k} "
                                f"act_quant={act_quant}"
                                + ("" if prec == "high" else " fast"), err,
                                rel, TOL_HIGH if prec == "high" else TOL_MMQ)


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
    (kernel, label, weight): bf16 activations at TC_NS (both sides of every
    width of their tensor-core tiles and of the n_pad <= 64 arm; K12's arm
    follows its width), "fast" (TOL_MMQ) and "high" (TOL_HIGH), timed; and
    K6's f32 output, as the act_quant path feeds them, at n = 16 and 512 in
    both precisions."""
    for kernel, label, w in cases:
        fn, plain = LOWBIT[kernel]
        shape = f"{label}{w.shape[0]}x{w.shape[1]}"
        for n in TC_NS:
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
    `prompt_lens` tokens, twice: a warm-up run that captures every decode
    bucket the run takes as a CUDA graph, then the timed run, which only
    replays them (its stats report no capture time) and must give the
    same ids. Every logit is checked finite on the device with no host
    sync per step: the prefill forwards' through a flag each one ANDs
    into, the decode chunks' through the flag each graph writes
    (`decode_finite`). Every kernel in `required` launched over both
    runs and none in `forbidden` (the counters move in eager runs and in
    captures, not in replays)."""
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
    runs = []
    try:
        for _ in range(2):
            runs.append(llm.generate(prompts, max_new_tokens=NEW_TOKENS,
                                     sampler=SamplerConfig(), seed=seed))
            torch.cuda.synchronize()
    finally:
        engine_mod.forward = plain_forward
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    warm, res = runs
    if any(len(r) != len(prompts) or any(
            len(x.token_ids) != NEW_TOKENS or not x.finished for x in r)
            for r in runs):
        raise AssertionError("generate did not answer every request in full")
    if not bool(finite) or not all(r[0].stats["decode_finite"]
                                   for r in runs):
        raise AssertionError("non-finite logits in the serving run")
    if [r.token_ids for r in warm] != [r.token_ids for r in res]:
        raise AssertionError("the replaying run gave other ids than the "
                             "capturing one")
    if res[0].stats["capture_s"]:
        raise AssertionError("the timed run captured a graph")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    stray = [k for k in forbidden if launches[k]]
    if stray:
        raise AssertionError(f"kernels launched off this path's route: {stray}")
    st = res[0].stats
    chunks = sum(-(-n // engine_mod.PREFILL_CHUNK) for n in prompt_lens)
    log(f"warm-up run: {warm[0].stats['wall_s']:.2f} s, of which "
        f"{warm[0].stats['capture_s']:.2f} s captured decode graphs; "
        f"{len(llm.graphs.keys())} graphs held, pool "
        f"{llm.graphs.pool_bytes()} bytes")
    log(f"served {len(res)} requests x {NEW_TOKENS} tokens (the timed run), "
        f"{n_fwd[0]} prefill forwards in both runs, all logits finite: wall "
        f"{st['wall_s']:.2f} s, prefill {st['prefill_s']:.2f} s for "
        f"{sum(prompt_lens)} prompt tokens in {chunks} chunks, decode "
        f"{st['decode_s']:.2f} s for {st['decode_tokens']} tokens = "
        f"{st['decode_tokens'] / st['decode_s']:.1f} decode tok/s at batch "
        f"<= {MAX_BATCH}; end to end {st['tokens_per_s']:.1f} tok/s")
    log(f"launches on the main path: {json.dumps(launches)}")
    return launches


def stochastic_check(llm: LLM, seed: int) -> None:
    """Temperature 0.8, top-k 40 through the graphs (each registers the
    engine's generator): two generate calls with one seed give equal ids,
    a third with another seed other ids."""
    rng = np.random.default_rng(seed + 5)
    prompts = [[int(v) for v in rng.integers(0, llm.cfg.vocab_size, n)]
               for n in (5, 40, 100, 200)]
    sampler = SamplerConfig(temperature=0.8, top_k=40)
    ids = [[r.token_ids for r in llm.generate(prompts, 16, sampler, seed=s)]
           for s in (seed, seed, seed + 1)]
    log(f"sampling (temperature 0.8, top-k 40), {len(prompts)} requests x "
        f"16 tokens: seed {seed} twice {'equal' if ids[0] == ids[1] else 'DIFFER'}"
        f", seed {seed + 1} {'differs' if ids[2] != ids[0] else 'EQUAL'}")
    if ids[0] != ids[1] or ids[0] == ids[2]:
        raise AssertionError("seeded sampling through the graphs does not "
                             "follow its seed")


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
            decode = eager_decode(llm)
            decode(tok, pos, sampler, 2, 256, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(tok, pos, sampler, 8, 256, gen)
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
                decode(tok, pos, sampler, 4, 256, gen)
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


def eager_decode(llm: LLM):
    """The eager decode loop: `_decode_eager` (`_decode` in trees before
    the decode chunk became a CUDA graph, so `--mix-step` still runs in
    an earlier tree)."""
    return getattr(llm, "_decode_eager", llm._decode)


def decode_split(llm: LLM, tok: torch.Tensor, pos: torch.Tensor, span: int,
                 label: str, gen: torch.Generator,
                 graph: bool = False) -> dict:
    """One 16-slot decode step's split at `pos` and `span`, through the
    eager loop or (`graph`) the CUDA graph replays of `_decode`: the host
    clock over 8 steps ending in a sync (host issue: until the 8 steps
    are issued; eager also the kernel wrappers' launches per step, which
    a replay does not count), then `torch.profiler` over 4 steps (device
    busy time, idle share, the top kernels, and the launches per step of
    each of KERNEL_GROUPS). The graph side captures its 2-, 4- and 8-step
    buckets before the clock starts. Returns the profiler's CUDA events,
    the wrappers' launches per step (None for the graph) and the
    numbers."""
    sampler = SamplerConfig()
    side = "graph" if graph else "eager"
    if graph:
        def run(steps):
            return llm.graphs.launch(llm, tok, pos, sampler, steps, span,
                                     llm.generator)

        for steps in (2, 4, 8):
            run(steps).read()
    else:
        def run(steps):
            return eager_decode(llm)(tok, pos, sampler, steps, span, gen)

        run(2)
    torch.cuda.synchronize()
    for fn in WRAPPERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = run(8)
    issue = time.perf_counter() - t0
    if graph:
        out.read()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 8 * 1e3
    per_step = None if graph else {k: f.launches / 8
                                   for k, f in WRAPPERS.items() if f.launches}
    if per_step is not None:
        log(f"{label}: wrapper launches per step " + json.dumps(per_step))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = run(4)
        if graph:
            out.read()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kern) / 4 / 1e3
    count = sum(e.count for e in kern) / 4
    log(f"{label} ({side}): wall {wall:.2f} ms/step, host issue "
        f"{issue / 8 * 1e3:.2f} ms/step, device busy {busy:.2f} ms/step "
        f"({100 * (1 - busy / wall):.0f}% idle) over {count:.0f} "
        "kernels/step; top 8:")
    for e in kern[:8]:
        log(f"  {e.self_device_time_total / 4 / 1e3:8.3f} ms/step "
            f"{e.count / 4:6.1f}/step {e.key[:70]}")
    groups = log_groups(kern, 4, "/step")
    return {"kern": kern, "per_step": per_step, "wall_ms": wall,
            "issue_ms": issue / 8 * 1e3, "busy_ms": busy, "kernels": count,
            "groups": groups}


def _snapshot(cache: list) -> list:
    return [{n: c.clone() for n, c in layer.items()} for layer in cache]


def _restore(cache: list, saved: list) -> None:
    for layer, old in zip(cache, saved):
        for n, c in layer.items():
            c.copy_(old[n])


def _cache_equal(cache: list, ref: list) -> bool:
    return all(torch.equal(c, r[n]) for layer, r in zip(cache, ref)
               for n, c in layer.items())


def graph_equality(llm: LLM, tok: torch.Tensor, pos: torch.Tensor,
                   span: int, label: str, steps: int = 8) -> None:
    """`steps` greedy steps from one saved cache through the eager loop,
    then, from the cache restored, through `_decode` twice (the first call
    captures the bucket if it is new, the second only replays): the ids
    equal step for step and the cache bit-equal to the eager loop's each
    time."""
    sampler = SamplerConfig()
    saved = _snapshot(llm.cache)
    ids = eager_decode(llm)(tok, pos, sampler, steps, span,
                            llm.generator).cpu().numpy()
    eager_cache = _snapshot(llm.cache)
    for call in ("first", "second"):
        _restore(llm.cache, saved)
        got = llm._decode(tok, pos, sampler, steps, span, llm.generator)
        same_ids = np.array_equal(got.ids, ids)
        same_cache = _cache_equal(llm.cache, eager_cache)
        log(f"{label}: {steps} greedy steps, graph ({call} call) vs eager "
            f"from one cache: ids {'equal' if same_ids else 'DIFFER'} step "
            f"for step, cache {'bit-equal' if same_cache else 'DIFFERS'}, "
            f"logits finite {got.finite}")
        if not (same_ids and same_cache and got.finite):
            raise AssertionError(f"{label}: the graph replay disagrees with "
                                 "the eager loop")
    del saved, eager_cache
    torch.cuda.empty_cache()


def graph_phase(llm: LLM, tok: torch.Tensor, pos: torch.Tensor, span: int,
                label: str, gen: torch.Generator, want: dict) -> dict:
    """A served configuration's decode chunk, graph against eager:
    `graph_equality`, then `decode_split` through both, side by side. The
    eager side's wrapper launches per step must equal `want`
    (`require_step`), and the graph side must launch per step as many
    kernels of each of KERNEL_GROUPS as the eager side, as the profiler
    counts them. Returns the eager split."""
    graph_equality(llm, tok, pos, span, label)
    for attempt in range(3):
        eager = decode_split(llm, tok, pos, span, label, gen)
        require_step(eager["per_step"], want)
        replay = decode_split(llm, tok, pos, span, label, gen, graph=True)
        if replay["groups"] == eager["groups"]:
            break
        # the profiler has dropped a kernel's events in a window before
        # (`device_ms`): measure both sides again before failing
        log(f"{label}: kernels per step by group differ, graph "
            f"{replay['groups']} vs eager {eager['groups']}; again")
    log(f"{label}, eager -> graph per step: wall {eager['wall_ms']:.2f} -> "
        f"{replay['wall_ms']:.2f} ms, host issue {eager['issue_ms']:.2f} -> "
        f"{replay['issue_ms']:.2f} ms, device busy {eager['busy_ms']:.2f} -> "
        f"{replay['busy_ms']:.2f} ms, kernels {eager['kernels']:.0f} -> "
        f"{replay['kernels']:.0f}")
    if replay["groups"] != eager["groups"]:
        raise AssertionError(f"{label}: the graph launches other kernels "
                             f"per step ({replay['groups']}) than the eager "
                             f"loop ({eager['groups']})")
    log(f"{label}: kernels per step by group equal on both sides "
        + json.dumps(eager["groups"]) + "; per replayed 8-step chunk "
        + json.dumps({k: 8 * v for k, v in replay["groups"].items()}))
    return eager


def require_step(per_step: dict, want: dict) -> None:
    """Fail unless a decode step launched each kernel in `want` exactly
    that many times (the wrappers' launches per step)."""
    bad = {k: per_step.get(k, 0) for k, n in want.items()
           if per_step.get(k, 0) != n}
    if bad:
        raise AssertionError(f"launches per decode step {bad}, want {want}")


# kernel-name pieces by which device time is summed per source
KERNEL_GROUPS = ("mmq_q2_k", "mmq_q3_k", "mmq_q4_k", "mmq_q5_k", "mmq_q6_k",
                 "mmq_iq4", "mmq_q8_0", "mmq_q4_0", "mmq_q4_1", "mmq_q5_0",
                 "mmq_q5_1", "mmq_i8", "quantize_q8_1", "add_splits",
                 "to_bf16", "kv_insert", "attn_kernel", "tiled_")


def log_groups(kern: list, runs: int, unit: str) -> dict:
    """Device time and launches of the profiler's CUDA events `kern` per
    run, summed over the kernels whose name holds each of KERNEL_GROUPS
    (a kernel's template instances and tiles together; add_splits is the
    split-K sum of every split-K kernel alike; quantize_q8_1 is K5 and K6
    together). Returns the launches per run by group."""
    parts, counts = [], {}
    for name in KERNEL_GROUPS:
        hit = [e for e in kern if name in e.key]
        if hit:
            ms = sum(e.self_device_time_total for e in hit) / runs / 1e3
            counts[name] = sum(e.count for e in hit) / runs
            parts.append(f"{name} {ms:.3f} ms ({counts[name]:.0f})")
    if parts:
        log(f"  by kernel{unit}: " + ", ".join(parts))
    return counts


def prefill_chunk(llm: LLM, toks: np.ndarray, start: int, label: str) -> None:
    """One PREFILL_CHUNK-token prefill chunk into slot 0 at `start`: the
    host clock over 3 calls ending in a sync, then `torch.profiler` over one
    (device busy time, the top kernels, the sums of KERNEL_GROUPS)."""
    chunk = engine_mod.PREFILL_CHUNK
    span = llm._span_bucket(start + chunk)

    def run():
        llm._prefill(toks, 0, start, chunk - 1, span)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"{label} prefill of a {chunk}-token chunk at {start}, span {span}: "
        f"{wall:.1f} ms, device busy {busy:.2f} ms; top 5:")
    for e in kern[:5]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
            f"{e.key[:70]}")
    log_groups(kern, 1, "")


def profile_7b_decode(llm: LLM, seed: int, hbm_gbs: float) -> None:
    """Where the 7B decode step goes: 16 live slots at round A's and at
    round B's positions (spans 512 and 4096), the graph replay against
    the eager loop at each (`graph_phase`: ids and cache equal, then both
    split by `decode_split`); K9's device time per layer beside its bound (the live K/V rows and
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
        # within the single-tile envelope K4 per layer; past it K9 per
        # layer, the insert fused in
        want = ({"decode_attention": layers} if span == 512 else
                {"decode_attention_tiled": layers, "kv_cache_insert": 0})
        kern = graph_phase(llm, tok, pos, span,
                           f"7B decode step, 16 slots, span {span}", gen,
                           want)["kern"]
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
        prefill_chunk(llm, toks, start, "7B")


def long_span_check(cpu: tuple, llm: LLM, seed: int) -> None:
    """The t = 1 route past the envelope (K9, the insert fused in) and the
    t = 8 f32 arm,
    2 layers, card vs the CPU port: the card prefills LONG_PROMPT tokens
    into a one-slot 4,096-row cache in 512-token chunks; the cache is
    copied to the CPU; one t = 1 and one t = 8 step at span 4096 run on
    both, logits within TOL_LOGITS. The card's t = 1 step must launch K9
    and neither K3 nor K4, its t = 8 step neither K4 nor K9."""
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
        k3 = launches["kv_cache_insert"]
        if k4 or (k9 > 0) != (t == 1) or (t == 1 and k3):
            raise AssertionError(f"long-span t={t} took the wrong route: "
                                 f"K3 {k3}, K4 {k4}, K9 {k9}")
        p += t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="split a decode step instead of the smoke run")
    ap.add_argument("--mix-step", nargs="?", const="q2k_mix",
                    choices=sorted(STEP_NAMES),
                    help="split a checkpoint's decode step and prefill chunk "
                    "(bf16 activations; default the Q2_K mix) instead of the "
                    "smoke run")
    ap.add_argument("--tiled-split", action="store_true",
                    help="time K9 alone at its headline shape and long "
                    "spans, by kernel, instead of the smoke run")
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
    if args.tiled_split:
        tiled_split(args.seed)
        return 0
    with phase("build the GGUF quantizer core"):
        build.build("gguf_kquant")     # before the writers that use it
    writers = Writers(args.seed, ("q5km",) if args.profile else
                      (args.mix_step,) if args.mix_step else
                      tuple(CHECKPOINTS))
    try:
        with phase("build kernels"):
            build_kernels()
        if args.profile:
            profile_decode(writers.wait("q5km"), args.seed)
            return 0
        if args.mix_step:
            mix_step(writers.wait(args.mix_step), args.seed,
                     STEP_NAMES[args.mix_step])
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
                        {fmt: llms[fmt].params
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
    with phase("Q8_0 and Q4_0 decode step, Q4_0 prefill chunk"):
        tok, pos, gen_step = _step_inputs(seed)
        for fmt in ("q8_0", "q4_0"):
            kernel = "mmq_q8_0" if fmt == "q8_0" else "mmq_legacy"
            graph_phase(llms[fmt], tok, pos, 256,
                        f"TinyLlama {fmt} decode step, 16 slots, span 256",
                        gen_step, {kernel: 4 * CFG.n_layers + 1,
                                   "decode_attention": CFG.n_layers})
        prefill_chunk(llms["q4_0"], _chunk_tokens(seed), 0, "TinyLlama Q4_0")
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
        eager_decode(llm)(tok, pos, SamplerConfig(), 1, span, gen)
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
    # whether routing K15 would pay now that a replay costs no host time:
    # the step's norms on the same inputs, device time of each form
    times = [device_ms(lambda f=f: [f(x, w, eps) for x, w, eps, _ in seen])
             for f in (model_norm, rms_norm)]
    log("the step's norms by profiler device time: the model's torch norm "
        + " ms, K15 ".join("not measured" if t is None else f"{t:.4f}"
                           for t in times) + " ms per step")
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


def _chunk_tokens(seed: int) -> np.ndarray:
    """A prefill chunk's (1, PREFILL_CHUNK) seeded token ids."""
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (1, engine_mod.PREFILL_CHUNK))


# `--mix-step` checkpoints: tag -> name in the log
STEP_NAMES = {"q2k_mix": "TinyLlama Q2_K mix", "q5km": "TinyLlama Q5_K_M bf16",
              "iq4_xs_2l": "TinyLlama IQ4_XS (2 layers)",
              "q4_0": "TinyLlama Q4_0", "q8_0": "TinyLlama Q8_0",
              "q4km": "TinyLlama Q4_K_M"}


def mix_step(path: str, seed: int, name: str) -> None:
    """`--mix-step [TAG]`: a checkpoint's 16-slot decode step at span 256
    with bf16 activations (`MMOpts()`), split as the smoke run splits it
    (twice; the eager loop, then where the tree has them the CUDA graph
    replays), and its 512-token prefill chunk; nothing is checked. It
    imports nothing the port's earlier trees lack, so a copy of this script
    beside an earlier tree measures that tree in the same call (earlier
    tree, this one, this one, earlier tree)."""
    llm = LLM(path, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device=DEVICE)
    tok, pos, gen = _step_inputs(seed)
    for r in range(2):
        for graph in (False, True) if hasattr(llm, "graphs") else (False,):
            decode_split(llm, tok, pos, 256, f"{name} decode step, 16 slots, "
                         f"span 256 (round {r})", gen, graph)
    prefill_chunk(llm, _chunk_tokens(seed), 0, name)


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
    with phase("K12/K13/K15 vs plain, K1 on the mix's wv"):
        compare_k1("mix wv", layer["wv"], gen, rep)
        head2 = llms["q2_k"].params["output"]
        compare_lowbit(_lowbit_cases("mmq_q2_k", llms["q2_k"].params)
                       + [("mmq_q2_k", "head[:1000] ",
                           head2.take_rows(torch.arange(1000)))]
                       + [("mmq_q2_k", f"mix {key} ", layer[key])
                          for key in ("wq", "wk")]
                       + _lowbit_cases("mmq_q3_k", llms["q3_k"].params)
                       + [("mmq_q3_k", f"mix {key} ", layer[key])
                          for key in ("wo", "down")],
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
        graph_phase(llms["mix"], tok, pos, 256,
                    "TinyLlama Q2_K mix decode step, 16 slots, span 256",
                    gen_step, {"decode_attention": CFG.n_layers})
        launches["rms_norm"] = rms_norm_shadow(llms["mix"], tok, pos, 256,
                                               gen_step)
    with phase("Q2_K mix prefill chunk"):
        prefill_chunk(llms["mix"], _chunk_tokens(seed), 0,
                      "TinyLlama Q2_K mix")
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
        cases = []
        for fmt, llm in llms.items():
            head = llm.params["output"]
            cases += _lowbit_cases("mmq_iq4", llm.params, f"{fmt} ")
            cases.append(("mmq_iq4", f"{fmt} head[:1000] ",
                          head.take_rows(torch.arange(1000))))
        compare_lowbit(cases, gen, rep)
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
        compare_attention_tiles(gen, rep)
    with phase("serve Q4_K_M"):
        launches = serve(llm4, seed, Q4KM_KERNELS)
    with phase("Q4_K_M decode chunk, graph vs eager; seeded sampling"):
        tok, pos, gen_step = _step_inputs(seed)
        graph_phase(llm4, tok, pos, 256, "TinyLlama Q4_K_M decode step, 16 "
                    "slots, span 256", gen_step,
                    {"mmq_q4_k": 4 * CFG.n_layers,
                     "decode_attention": CFG.n_layers})
        stochastic_check(llm4, seed)
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
    with phase("Q5_K_M act_quant decode chunk, graph vs eager"):
        tok, pos, gen_step = _step_inputs(seed)
        graph_phase(llm5, tok, pos, 256, "TinyLlama Q5_K_M act_quant decode "
                    "step, 16 slots, span 256", gen_step,
                    {"mmq_i8": 4 * CFG.n_layers,
                     "decode_attention": CFG.n_layers})
    with phase("reference check Q5_K_M under act_quant"):
        # the same weights with bf16 activations first: the act_quant
        # bound is wider than that path's by the quantization alone
        # and, last, the bf16 "fast" route the next phase serves
        cpu5, logits = reference_check(
            path5, llm5, seed,
            ((2, MMOpts(precision="high"), TOL_LOGITS),
             (2, ACT_QUANT, TOL_LOGITS_ACT_QUANT),
             (CFG.n_layers, ACT_QUANT, None),
             (2, MMOpts(), TOL_LOGITS)))
        err, rel = rel_err(logits[0][1], logits[1][0])
        log(f"a wrong route at 2 layers (card without act_quant vs CPU "
            f"under it): max|d|={err:.3e} rel={rel:.2e}")
        for t in ROUTE_TS:
            projection_check(cpu5, llm5, seed, t)
    with phase("perplexity"):
        perplexity_check(path5, llm5, cpu5, seed)

    log("== Q5_K_M, bf16 activations, MMOpts() (K8 'fast', K2-K4) ==")
    llm5.opts = MMOpts()
    with phase("serve Q5_K_M bf16"):
        launches.update({k: v for k, v in serve(
            llm5, seed, Q5KM_BF16_KERNELS,
            forbidden=other_mmq(Q5KM_BF16_KERNELS)).items()
            if k in Q5KM_BF16_KERNELS})
    with phase("Q5_K_M bf16 decode step and prefill chunk"):
        tok, pos, gen_step = _step_inputs(seed)
        graph_phase(llm5, tok, pos, 256, "TinyLlama Q5_K_M bf16 decode "
                    "step, 16 slots, span 256", gen_step,
                    {"mmq_q5_k": 4 * CFG.n_layers,
                     "decode_attention": CFG.n_layers})
        prefill_chunk(llm5, _chunk_tokens(seed), 0, "TinyLlama Q5_K_M bf16")
    del llm5, cpu5
    torch.cuda.empty_cache()

    log("== Llama-2-7B Q4_K_M, bf16 activations, 4,096-token context "
        "(K1-K4, K9) ==")
    with phase("K9, and K3/K4 at hd 128, vs plain"):
        hbm = hbm_read_gbs()
        log(f"HBM read (x.sum() of 4 GiB f32): {hbm:.0f} GB/s")
        compare_tiled(gen, rep, seed)
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
    # where there is none); "wide" or "7b": the same at the kernel's
    # SECOND shape
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "shape": HEADLINE[name],
             "launches": launches[name], "max_abs_err": rep.err[name],
             "ms": rep.times[name][0], "plain_ms": rep.times[name][1],
             "bound_ms": rep.bound[name][0], "bound_by": rep.bound[name][1],
             "library_ms": rep.library[name],
             "device_ms": rep.times[name][2],
             "plain_device_ms": rep.times[name][3],
             **dict([rep.second[name]] if name in rep.second else [])}
            for name, (src, replaces) in KERNELS.items()]


if __name__ == "__main__":
    sys.exit(main())
