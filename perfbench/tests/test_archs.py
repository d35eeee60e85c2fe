"""The architecture seam: a configuration names the module that gives its
tensors, keys, work counts and toy size (`perfbench.archs`).

Two parts. Pins: for both benchmarked configurations the plan, the GGUF
keys, the counts and a toy-width checkpoint from one seed equal what the
harness gave before the seam (digests below, taken from that harness on
the CPU). And the room: a llama-MoE architecture registered here, not
under `perfbench/archs/`, runs through the harness's own `make_bytes`,
`Checkpoint`, `views`, reference dequantizers, `roofline` and
`rehearse.toy`, and llama.cpp's 8-expert Q4_K_M rules hold at Mixtral's
sizes. No file under `perfbench/` is written.

Run: python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import types

import pytest
import torch

from perfbench import roofline as R
from perfbench.archs import llama
from perfbench.checks.rehearse import toy
from perfbench.harness import ROOT, load_cell
from perfbench.model import (F32, Model, Tensor, arch, nbytes, tensor_format,
                             tensor_plan, use_more_bits)
from perfbench.references import llama as ref
from perfbench.weights import Checkpoint, make_bytes, metadata, views

SEED = 2**31 + 12345


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


def model(name: str) -> Model:
    return Model.from_file(name, os.path.join(ROOT, "perfbench", "configs",
                                              name + ".json"))


def file_bytes(m: Model, buffers: dict) -> bytes:
    ckpt = Checkpoint(m, buffers, os.path.join(ROOT, "perfbench", ".cache",
                                               "checkpoint"))
    try:
        with open(ckpt.path, "rb") as f:
            return f.read()
    finally:
        ckpt.close()


# ------------------------------------------------------------- pins ---

# sha256 of json.dumps of [[name, format, [M, K]], ...] over the quantized
# tensors in file order, and of json.dumps(metadata); the counts; the toy
# checkpoint (`rehearse.toy`'s model) made from SEED on the CPU
PINS = {
    "mistral-7b-v0.2.q4_k_m": {
        "plan": (226, "dc88fd55635b3ea7c4491c17798fa275"
                      "9802132faa21c269b3311975fe9aaf77"),
        "metadata": "1b44a84b097a40f98a80981ecc84ea6e"
                    "c9fe0aeacfdc0ae3ced9fb0314c08439",
        "step_weight_bytes(16)": 4_292_911_104,
        "matmul_params": 7_110_393_856, "head_params": 131_072_000,
        "prefill_flops(512)": 7_215_941_419_008,
        "prefill_flops(1)": 14_221_312_000, "kv_row_bytes": 67_584,
        "attn_flops_per_row": 524_288,
        "toy_file": (852_768, "bf62dd14732383ef47f6f4eeb589ac67"
                              "fd575d9e691da7a9c0fa553bab1414bd"),
    },
    "smollm2-1.7b.q8_0": {
        "plan": (169, "9edebd47844e54f4e64e20adb106d89f"
                      "b4a972ca30e22d81141b142aba95c1cf"),
        "metadata": "0e45381b2bc4c35d0c96e095a808d5f4"
                    "88ee86988c048139d0a4d8600d3b517d",
        "step_weight_bytes(16)": 1_818_230_784,
        "matmul_params": 1_711_276_032, "head_params": 100_663_296,
        "prefill_flops(512)": 1_675_288_903_680,
        "prefill_flops(1)": 3_422_748_672, "kv_row_bytes": 104_448,
        "attn_flops_per_row": 196_608,
        "toy_file": (1_538_656, "957693145de24e0fe41668dda893e9c7"
                                "781555a5382cbe80469d784de52881ef"),
    },
}
CELL_OF = {"mistral-7b-v0.2.q4_k_m": "mistral7b_q4km.chat",
           "smollm2-1.7b.q8_0": "smollm2_q8_0.chat"}


@pytest.mark.parametrize("name", sorted(PINS))
def test_plan_and_keys_are_pinned(name):
    m, pin = model(name), PINS[name]
    quantized = [[t.name, t.fmt, list(t.shape)] for t in tensor_plan(m)
                 if t.fmt != F32]
    assert (len(quantized), digest(quantized)) == pin["plan"]
    assert digest(metadata(m)) == pin["metadata"]
    norms = [t for t in tensor_plan(m) if t.fmt == F32]
    assert len(norms) == 1 + 2 * m.layers
    assert all(t.init == "ones" and t.shape == (m.dim,) for t in norms)


@pytest.mark.parametrize("name", sorted(PINS))
def test_counts_are_pinned(name):
    m, pin = model(name), PINS[name]
    assert R.step_weight_bytes(m, 16) == pin["step_weight_bytes(16)"]
    assert R.step_weight_bytes(m, 1) == pin["step_weight_bytes(16)"]
    assert R.matmul_params(m) == pin["matmul_params"]
    assert R.head_params(m) == pin["head_params"]
    assert R.prefill_flops(m, 512) == pin["prefill_flops(512)"]
    assert R.prefill_flops(m, 1) == pin["prefill_flops(1)"]
    assert R.kv_row_bytes(m) == pin["kv_row_bytes"]
    assert R.attn_flops_per_row(m) == pin["attn_flops_per_row"]


@pytest.mark.parametrize("name", sorted(PINS))
def test_toy_checkpoint_is_byte_identical(name):
    m = toy(load_cell(CELL_OF[name])).model
    data = file_bytes(m, make_bytes(m, SEED, "cpu"))
    assert (len(data), hashlib.sha256(data).hexdigest()) == \
        PINS[name]["toy_file"]


# ------------------------------------------- a toy MoE architecture ---

def experts_hit(n_expert: int, used: int, tokens: int) -> float:
    """Expected number of a layer's `n_expert` experts that `tokens`
    tokens, each routed to `used` of them uniformly, reach at least once."""
    return n_expert * (1.0 - (1.0 - used / n_expert) ** tokens)


def moe_module() -> types.ModuleType:
    """A llama-MoE (Mixtral's schema): llama's attention, and in each
    layer a router `ffn_gate_inp` (E, dim) in F32 drawn with std
    0.5/sqrt(dim) and three (E, M, K) expert stacks; `num_local_experts`
    experts, `num_experts_per_tok` of them per token."""
    mod = types.ModuleType("perfbench.archs.toy_moe")

    def experts(m):
        return (int(m.config["num_local_experts"]),
                int(m.config["num_experts_per_tok"]))

    def tensor_plan(m):
        e, _ = experts(m)
        plan = [llama.matrix(m, "token_embd.weight", (m.vocab, m.dim), e),
                llama.matrix(m, "output.weight", (m.vocab, m.dim), e)]
        for i in range(m.layers):
            p = f"blk.{i}."
            plan += [llama.matrix(m, f"{p}{n}.weight",
                                  llama.projection_shape(m, n), e)
                     for n in ("attn_q", "attn_k", "attn_v", "attn_output")]
            plan.append(Tensor(f"{p}ffn_gate_inp.weight", F32, (e, m.dim),
                               0.5 / m.dim ** 0.5))
            plan += [llama.matrix(m, f"{p}ffn_{n}_exps.weight", (e, r, c), e)
                     for n, (r, c) in (("gate", (m.ffn, m.dim)),
                                       ("up", (m.ffn, m.dim)),
                                       ("down", (m.dim, m.ffn)))]
        return plan + llama.norms(m)

    def metadata(m):
        e, k = experts(m)
        return {**llama.metadata(m), "llama.expert_count": e,
                "llama.expert_used_count": k}

    def matmul_params(m):
        e, k = experts(m)
        attn = sum(r * c for r, c in (llama.projection_shape(m, n) for n in
                                      ("attn_q", "attn_k", "attn_v",
                                       "attn_output")))
        return (m.layers * (attn + e * m.dim + k * 3 * m.ffn * m.dim)
                + llama.head_params(m))

    def step_weight_bytes(m, live):
        e, k = experts(m)
        total = 0.0
        for t in tensor_plan(m):
            if t.name == "token_embd.weight" or t.init == "ones":
                continue
            share = experts_hit(e, k, live) / e if "_exps" in t.name else 1
            total += nbytes(t.fmt, t.shape) * share
        return total

    def toy_model(m):
        return dataclasses.replace(
            llama.toy(m), layers=2,
            config={**m.config, "num_local_experts": 4,
                    "num_experts_per_tok": 2})

    vars(mod).update(tensor_plan=tensor_plan, metadata=metadata,
                     matmul_params=matmul_params,
                     head_params=llama.head_params,
                     step_weight_bytes=step_weight_bytes,
                     attn_flops_per_row=llama.attn_flops_per_row,
                     kv_row_bytes=llama.kv_row_bytes, toy=toy_model)
    return mod


def moe_config(**sizes) -> dict:
    """Mixtral-8x7B-Instruct-v0.1's config.json keys, with `sizes` over
    them, and the harness's keys."""
    c = {"architecture": "toy_moe", "vocab_size": 32000, "hidden_size": 4096,
         "num_hidden_layers": 32, "num_attention_heads": 32,
         "num_key_value_heads": 8, "intermediate_size": 14336,
         "num_local_experts": 8, "num_experts_per_tok": 2,
         "rms_norm_eps": 1e-5, "rope_theta": 1e6,
         "tie_word_embeddings": False, "recipe": "q4_k_m",
         "max_seq": 32768, "max_batch": 16}
    return {**c, **sizes}


@pytest.fixture
def toy_moe(monkeypatch):
    """The MoE module registered under its name for this test only, and
    a 2-layer model of it: 4 experts, top 2, head dim 64."""
    monkeypatch.setitem(sys.modules, "perfbench.archs.toy_moe", moe_module())
    return Model.from_config("toy-moe", moe_config(
        vocab_size=512, hidden_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=512,
        num_local_experts=4, max_seq=256, max_batch=2))


def test_moe_checkpoint_reads_back(toy_moe):
    """(a) The port's GGUF reader finds every tensor with its name, type
    and shape, (E, M, K) for the stacks, and the expert keys; the file is
    the one the port's own writer makes of the same tensors."""
    from gguf_tpu_torch.gguf import GGMLType, GGUFReader, write_gguf

    m = toy_moe
    assert m.head_dim == 64
    buffers = make_bytes(m, SEED, "cpu")
    data = file_bytes(m, buffers)
    path = f"/proc/self/fd/{os.memfd_create('toy-moe')}"
    try:
        with open(path, "wb") as f:
            f.write(data)
        reader = GGUFReader(path)
        try:
            plan = tensor_plan(m)
            assert list(reader.tensors) == [t.name for t in plan]
            for t in plan:
                info = reader.tensors[t.name]
                assert info.shape == t.shape, t.name
                assert info.ggml_type == GGMLType[t.fmt.upper()], t.name
            stacks = [t for t in plan if t.name.endswith("_exps.weight")]
            assert len(stacks) == 6 and all(t.shape[0] == 4 for t in stacks)
            assert reader.metadata["llama.expert_count"] == 4
            assert reader.metadata["llama.expert_used_count"] == 2
            router = reader.load_array("blk.1.ffn_gate_inp.weight")
            assert router.shape == (4, 256)
            assert abs(router.std() / (0.5 / 16) - 1) < 0.1
        finally:
            reader.close()
        tensors = {name: (GGMLType[fmt.upper()], shape, view.numpy())
                   for name, (fmt, shape, view) in views(m, buffers).items()}
        write_gguf(path, metadata(m), tensors)
        with open(path, "rb") as f:
            assert f.read() == data
    finally:
        os.close(int(path.rsplit("/", 1)[1]))


def test_moe_weights_come_again_from_the_seed(toy_moe):
    """What the reference receives after the window: the same tensors
    again from the seed, the stacks dequantized whole as each expert's
    rows are, the router as drawn."""
    m = toy_moe
    first, again = views(m, make_bytes(m, SEED, "cpu")), \
        views(m, make_bytes(m, SEED, "cpu"))
    for name, (fmt, shape, view) in first.items():
        assert torch.equal(view, again[name][2]), name
    fmt, shape, raw = first["blk.0.ffn_down_exps.weight"]
    whole = ref.dequant(first["blk.0.ffn_down_exps.weight"])
    assert whole.shape == shape == (4, 256, 512)
    for e in range(4):
        assert torch.equal(whole[e], ref.dequant((fmt, shape[1:], raw[e])))
    assert torch.equal(ref.dequant(first["blk.0.ffn_down_exps.weight"],
                                   torch.tensor([2])), whole[2:3])
    router = ref.dequant(first["blk.0.ffn_gate_inp.weight"])
    assert router.dtype == torch.float32 and router.shape == (4, 256)


def test_moe_counts_reach_the_roofline(toy_moe):
    """(c) `roofline` delegates to the module: P_mm counts the experts a
    token uses, a step's bytes the experts its tokens reach."""
    m = toy_moe
    mod = arch(m)
    assert R.matmul_params(m) == mod.matmul_params(m)
    attn = 2 * (256 * 256 + 128 * 256)
    assert R.matmul_params(m) == 2 * (attn + 4 * 256 + 2 * 3 * 512 * 256) \
        + 512 * 256
    stack = nbytes("q4_k", (4, 512, 256))
    assert stack == 4 * 512 * 144
    one, sixteen = R.step_weight_bytes(m, 1), R.step_weight_bytes(m, 16)
    assert sixteen - one == pytest.approx(
        sum(nbytes(t.fmt, t.shape) for t in tensor_plan(m)
            if "_exps" in t.name) * (experts_hit(4, 2, 16) - 2) / 4)
    assert R.mmq_bound_s(m, 16) >= R.step_weight_bytes(m, 16) / \
        R.PEAK_HBM_BYTES_PER_S
    assert R.kv_row_bytes(m) == 2 * 2 * 2 * (64 + 4)


def test_moe_toy_shrinks(toy_moe):
    """(d) `rehearse.toy` takes the module's toy size."""
    full = Model.from_config("toy-moe", moe_config())
    cell = dataclasses.replace(load_cell("mistral7b_q4km.chat"), model=full)
    small = toy(cell).model
    assert (small.layers, small.dim, small.head_dim) == (2, 256, 64)
    assert small.config["num_local_experts"] == 4
    assert sum(nbytes(t.fmt, t.shape) for t in tensor_plan(small)) < 2**22


def test_eight_expert_q4_k_m_rules():
    """(e) llama.cpp's Q4_K_M at Mixtral's 32 layers and 8 experts:
    attn_k and attn_v Q8_0, attn_output Q5_K, the router F32, gate and up
    stacks Q4_K, ffn_down_exps Q6_K on the 16 `use_more_bits` layers."""
    def fmt(name):
        return tensor_format("q4_k_m", name, 32, n_expert=8, gqa=4)

    assert fmt("token_embd.weight") == "q4_k"
    assert fmt("output.weight") == "q6_k"
    down = []
    for i in range(32):
        p = f"blk.{i}."
        assert fmt(p + "attn_q.weight") == "q4_k"
        assert fmt(p + "attn_k.weight") == "q8_0"
        assert fmt(p + "attn_v.weight") == "q8_0"
        assert fmt(p + "attn_output.weight") == "q5_k"
        assert fmt(p + "ffn_gate_inp.weight") == F32
        assert fmt(p + "ffn_gate_exps.weight") == "q4_k"
        assert fmt(p + "ffn_up_exps.weight") == "q4_k"
        down.append(fmt(p + "ffn_down_exps.weight"))
        assert down[-1] == ("q6_k" if use_more_bits(i, 32) else "q4_k")
    assert down.count("q6_k") == 16


@pytest.mark.parametrize("recipe", ["q4_k_m", "q2_k", "q8_0"])
def test_dense_rules(recipe):
    """Dense files: Q4_K_M as before the seam (attn_v and ffn_down Q6_K on
    `use_more_bits` layers); Q2_K as `chip_smoke.q2k_mix_type` encodes it
    (attn_v Q4_K at 4 query heads per KV head, Q3_K below; attn_output and
    ffn_down Q3_K; output Q6_K; the rest Q2_K); Q8_0 everywhere. A tied
    head takes the output's rule."""
    def fmt(name, gqa=4, has_output=True):
        return tensor_format(recipe, name, 32, gqa=gqa,
                             has_output=has_output)

    want = {"q4_k_m": {"token_embd": "q4_k", "output": "q6_k",
                       "attn_q": "q4_k", "attn_k": "q4_k",
                       "attn_output": "q4_k", "ffn_gate": "q4_k"},
            "q2_k": {"token_embd": "q2_k", "output": "q6_k",
                     "attn_q": "q2_k", "attn_k": "q2_k",
                     "attn_output": "q3_k", "ffn_gate": "q2_k"},
            "q8_0": {"token_embd": "q8_0", "output": "q8_0",
                     "attn_q": "q8_0", "attn_k": "q8_0",
                     "attn_output": "q8_0", "ffn_gate": "q8_0"}}[recipe]
    assert fmt("token_embd.weight") == want["token_embd"]
    assert fmt("output.weight") == want["output"]
    assert fmt("token_embd.weight", has_output=False) == want["output"]
    for i in range(32):
        p = f"blk.{i}."
        for n in ("attn_q", "attn_k", "attn_output", "ffn_gate"):
            assert fmt(f"{p}{n}.weight") == want[n]
        more = use_more_bits(i, 32)
        assert fmt(p + "attn_v.weight") == {
            "q4_k_m": "q6_k" if more else "q4_k", "q2_k": "q4_k",
            "q8_0": "q8_0"}[recipe]
        assert fmt(p + "attn_v.weight", gqa=1) == {
            "q4_k_m": "q6_k" if more else "q4_k", "q2_k": "q3_k",
            "q8_0": "q8_0"}[recipe]
        assert fmt(p + "ffn_down.weight") == {
            "q4_k_m": "q6_k" if more else "q4_k", "q2_k": "q3_k",
            "q8_0": "q8_0"}[recipe]
