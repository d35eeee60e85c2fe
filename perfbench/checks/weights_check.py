"""Check the seeded checkpoint on the CPU.

Every block format the recipes use (`perfbench.model.BLOCK`: Q2_K, Q3_K,
Q4_K, Q5_K, Q6_K, Q8_0), drawn as `make_bytes` draws it for a 256 x 4096
matrix: the reference's own dequantizer agrees with the port's, and the
weights have mean about 0 and std 0.5/sqrt(4096) within 3%.

Each configuration at 2 layers of its published widths, and Mistral's in
the `q2_k` recipe too: the file loads through the port's `load_llama`;
every matrix's dequantized weights (by the reference's own dequantizers,
which must agree with the port's `dequantize`) have the recipe's spread,
mean about 0 and std 0.5/sqrt(hidden_size) within 3%; the norms are
ones; the same seed makes the same bytes twice; and the first logits of
the port's forward are finite and near the reference's.
Run: python -m perfbench.checks.weights_check
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from perfbench.model import BLOCK, F32, HERE, Model, nbytes
from perfbench.references import llama as ref
from perfbench.weights import (Checkpoint, make_bytes, seeded_blocks,
                               target_std, views)

SEED = 2**31 + 7


def check_block(fmt: str) -> None:
    """One format's seeded blocks: the reference's dequantizer against the
    port's, and the spread."""
    from gguf_tpu_torch.quant.layouts import QuantWeight

    shape, std = (256, 4096), 0.5 / 4096 ** 0.5
    gen = torch.Generator().manual_seed(SEED)
    raw = seeded_blocks(fmt, nbytes(fmt, shape), std, gen, "cpu").view(
        shape[0], -1)
    x = ref.dequant((fmt, shape, raw))
    y = QuantWeight.from_blocks(fmt, raw.numpy(), shape, "cpu").dequantize()
    err = float((x - y).abs().max() / x.abs().max())
    mean, got = float(x.mean()), float(x.std())
    print(f"{fmt} {shape}: std {got:.6g} (recipe {std:.6g}), mean "
          f"{mean:.3g}, reference vs port dequantize {err:.3g}")
    assert abs(got / std - 1) < 0.03 and abs(mean) < 0.03 * std, fmt
    assert err < 1e-6, (fmt, err)


def check(m: Model) -> None:
    from gguf_tpu_torch.models.llama import (forward, fuse_llama_params,
                                             init_kv_cache)
    from gguf_tpu_torch.models.loader import load_llama

    name = f"{m.name} ({m.recipe})"
    m = dataclasses.replace(m, layers=2, max_seq=64)
    buffers = make_bytes(m, SEED, "cpu")
    again = make_bytes(m, SEED, "cpu")
    assert all(torch.equal(buffers[f], again[f]) for f in buffers), \
        "the same seed made other bytes"
    del again
    ckpt = Checkpoint(m, buffers, os.path.join(HERE, ".cache", "checkpoint"))
    try:
        cfg, params = load_llama(ckpt.path, "cpu")
    finally:
        ckpt.close()
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim,
            cfg.vocab_size) == (m.dim, 2, m.heads, m.kv_heads, m.ffn, m.vocab)
    w = views(m, buffers)
    want = target_std(m)
    port = {"token_embd.weight": params["token_embd"]}
    if not m.tied:
        port["output.weight"] = params["output"]
    names = {"attn_q": "wq", "attn_k": "wk", "attn_v": "wv",
             "attn_output": "wo", "ffn_gate": "gate", "ffn_up": "up",
             "ffn_down": "down"}
    for i, layer in enumerate(params["layers"]):
        for gg, pk in names.items():
            port[f"blk.{i}.{gg}.weight"] = layer[pk]
    for tname, entry in w.items():
        if entry[0] == F32:
            assert torch.equal(entry[2], torch.ones(entry[1])), tname
            continue
        x = ref.dequant(entry)
        y = port[tname].dequantize()
        assert port[tname].fmt == entry[0], (tname, port[tname].fmt, entry[0])
        err = float((x - y).abs().max() / x.abs().max())
        std, mean = float(x.std()), float(x.mean())
        print(f"{name} {tname} {entry[0]} {tuple(x.shape)}: std {std:.6g} "
              f"(recipe {want:.6g}), mean {mean:.3g}, reference vs port "
              f"dequantize {err:.3g}")
        assert abs(std / want - 1) < 0.03 and abs(mean) < 0.03 * want, tname
        assert err < 1e-6, (tname, err)
    fused = fuse_llama_params(params)
    cache = init_kv_cache(cfg, 1, m.max_seq, "cpu")
    toks = torch.randint(0, m.vocab, (1, 12),
                         generator=torch.Generator().manual_seed(1))
    logits, _ = forward(fused, cfg, toks, torch.zeros(1, dtype=torch.int32),
                        cache)
    assert torch.isfinite(logits).all(), "port logits not finite"
    picks = (3, 7, 11)
    gaps = [float(ref.served_gaps(m, w, [(toks[0, :i + 1].tolist(),
                                          [int(logits[0, i].argmax())])],
                                  "cpu")[0][0]) for i in picks]
    scale = float(logits.abs().max())
    print(f"{name} 2 layers: port logits finite, max |logit| {scale:.4g}; "
          f"the port's greedy tokens at positions {picks} lie {gaps} below "
          "the reference's best")
    assert max(gaps) < 0.05 * scale


def main() -> None:
    for fmt in BLOCK:
        check_block(fmt)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    models = [Model.from_file(c["name"], os.path.join(os.path.dirname(HERE),
                                                      c["file"]))
              for c in configs]
    for m in models:
        check(m)
    # the Q2_K mix at Mistral's widths: Q2_K, Q3_K, Q4_K and Q6_K matrices
    check(dataclasses.replace(models[0], recipe="q2_k"))
    print("checkpoints OK")


if __name__ == "__main__":
    main()
