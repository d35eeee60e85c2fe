"""Mixtral-8x7B-Instruct-v0.1 at Q4_K_M: the configuration's counts,
pinned against numbers worked out by hand (`perfbench/archs/mixtral.py`
computes them from the tensor plan).

32 layers, dim 4096, 32 query and 8 KV heads of 128, 8 experts of ffn
14336, 2 per token, vocab 32000, untied:
  per layer: q, o 4096*4096 = 16,777,216 each; k, v 1024*4096 =
  4,194,304 each -> attention 41,943,040; router 8*4096 = 32,768;
  one expert's gate, up, down 14336*4096 = 58,720,256 each.
  P_mm per token: 32 * (41,943,040 + 32,768 + 2 * 3 * 58,720,256)
  + head 131,072,000 = 32 * 394,297,344 + 131,072,000
  = 12,748,587,008.
Formats (llama.cpp's Q4_K_M with n_expert == 8): attn_q Q4_K (0.5625 B
a weight), attn_k and attn_v Q8_0 (34/32 = 1.0625), attn_output Q5_K
(176/256 = 0.6875), gate and up stacks Q4_K, down stacks Q6_K on the 16
`use_more_bits` layers (210/256 = 0.8203125) and Q4_K on the others,
router F32, token_embd Q4_K, output Q6_K:
  attention per layer 9,437,184 + 2 * 4,456,448 + 11,534,336
  = 29,884,416 B; router 131,072 B; a Q4_K stack 8 * 58,720,256 *
  0.5625 = 264,241,152 B, a Q6_K one 385,351,680 B.
  Tensor bytes: token_embd 73,728,000 + output 107,520,000
  + 32 * (29,884,416 + 131,072 + 2 * 264,241,152)
  + 16 * 264,241,152 + 16 * 385,351,680 + norms 4 * 4096 * 65
  = 28,447,727,616 B; the GGUF file, with its header and each tensor
  padded to 32 bytes, 28,447,748,800 B.
A decode step of 16 live slots reaches 8 (1 - (6/8)^16) = 7.92081 of 8
experts a layer: the attention, routers and head once (32 * 30,015,488
+ 107,520,000 = 1,068,015,616 B) and 7.92081/8 of the stacks
(27,304,919,040 B) -> 28,099,268,490 B.
KV row: 2 * 32 layers * 8 heads * (128 + 4) = 67,584 B.
Attention: 4 * 32 * 32 * 128 = 524,288 FLOPs per context row.

Run: python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import math
import os

import pytest

from perfbench import roofline as R
from perfbench.harness import ROOT
from perfbench.model import F32, Model, nbytes, tensor_plan, use_more_bits
from perfbench.weights import gguf_layout, metadata

NAME = "mixtral-8x7b-v0.1.q4_k_m"


def model() -> Model:
    return Model.from_file(NAME, os.path.join(ROOT, "perfbench", "configs",
                                              NAME + ".json"))


def test_counts_by_hand():
    m = model()
    assert R.matmul_params(m) == 12_748_587_008
    assert math.floor(R.step_weight_bytes(m, 16)) == 28_099_268_490
    assert R.step_weight_bytes(m, 16) - R.step_weight_bytes(m, 1) == \
        pytest.approx(27_304_919_040 * (8 * (1 - 0.75 ** 16) - 2) / 8)
    assert R.kv_row_bytes(m) == 67_584
    assert R.attn_flops_per_row(m) == 524_288
    assert R.head_params(m) == 131_072_000


def test_file_bytes_by_hand():
    m = model()
    plan = tensor_plan(m)
    assert sum(nbytes(t.fmt, t.shape) for t in plan) == 28_447_727_616
    head, _, end = gguf_layout(metadata(m), plan)
    assert len(head) + end == 28_447_748_800
    stacks = sum(nbytes(t.fmt, t.shape) for t in plan if "_exps" in t.name)
    assert stacks == 27_304_919_040
    assert round(100 * stacks / 28_447_727_616, 1) == 96.0


def test_formats_per_tensor():
    """The 8-expert arms of Q4_K_M, per tensor, and the stacks' shapes."""
    plan = {t.name: t for t in tensor_plan(model())}
    assert len(plan) == 2 + 32 * 8 + 1 + 64
    assert (plan["token_embd.weight"].fmt, plan["output.weight"].fmt) == \
        ("q4_k", "q6_k")
    for i in range(32):
        p = f"blk.{i}."
        got = {n: plan[f"{p}{n}.weight"].fmt for n in (
            "attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate_inp",
            "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")}
        assert got == {"attn_q": "q4_k", "attn_k": "q8_0",
                       "attn_v": "q8_0", "attn_output": "q5_k",
                       "ffn_gate_inp": F32, "ffn_gate_exps": "q4_k",
                       "ffn_up_exps": "q4_k",
                       "ffn_down_exps": ("q6_k" if use_more_bits(i, 32)
                                         else "q4_k")}
        assert plan[p + "ffn_gate_exps.weight"].shape == (8, 14336, 4096)
        assert plan[p + "ffn_down_exps.weight"].shape == (8, 4096, 14336)
        assert plan[p + "ffn_gate_inp.weight"].init == 2 / 64


def test_metadata_names_the_experts():
    md = metadata(model())
    assert md["general.architecture"] == "llama"
    assert (md["llama.expert_count"], md["llama.expert_used_count"]) == (8, 2)
    assert md["llama.context_length"] == 32768
    assert md["llama.rope.freq_base"] == 1e6
