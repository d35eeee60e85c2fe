"""Pin the two configurations' per-step quantized bytes (at 16 live
slots) and per-token FLOPs against numbers worked out by hand.  Run: python -m
perfbench.checks.roofline_check (CPU only, no torch device needed).

Mistral-7B-v0.2 Q4_K_M (32 layers, dim 4096, 32/8 heads, hd 128, ffn
14336, vocab 32000):
  per layer: q 4096*4096 = 16,777,216; k, v 1024*4096 = 4,194,304 each;
  o 16,777,216; gate, up, down 14336*4096 = 58,720,256 each
  -> 218,103,808; 32 layers 6,979,321,856; head 131,072,000
  -> P_mm 7,110,393,856.
  Q4_K 144 B / 256 = 0.5625 B per weight, Q6_K 210 / 256 = 0.8203125.
  16 plain layers: 218,103,808 * 0.5625 = 122,683,392 B each;
  16 use_more_bits layers (0-3, 6, 9, ..., 27, 28-31): v + down
  62,914,560 * 0.8203125 = 51,609,600 plus the rest 155,189,248 * 0.5625
  = 87,293,952 -> 138,903,552 B each; head Q6_K 107,520,000
  -> 16 * (122,683,392 + 138,903,552) + 107,520,000 = 4,292,911,104 B.
  KV row: 2 * 32 layers * 8 heads * (128 + 4) = 67,584 B.
  attention: 4 * 32 * 32 * 128 = 524,288 FLOPs per context row.
  512-token prompt: 2 * 6,979,321,856 * 512 + 2 * 131,072,000
  + 524,288 * 512 * 513 / 2 = 7,215,941,419,008 FLOPs.

SmolLM2-1.7B Q8_0 (24 layers, dim 2048, 32/32 heads, hd 64, ffn 8192,
vocab 49152, tied):
  per layer: q, k, v, o 2048*2048 = 4,194,304 each; gate, up, down
  2048*8192 = 16,777,216 each -> 67,108,864; 24 layers 1,610,612,736;
  head 49152*2048 = 100,663,296 -> P_mm 1,711,276,032.
  Q8_0 34 B / 32 = 1.0625 -> 1,818,230,784 B (the head is token_embd).
  KV row: 2 * 24 * 32 * (64 + 4) = 104,448 B.
  attention: 4 * 24 * 32 * 64 = 196,608 FLOPs per context row.
"""

import os

from perfbench import roofline as R
from perfbench.model import HERE, Model

WANT = {
    "mistral-7b-v0.2.q4_k_m": {
        "matmul_params": 7_110_393_856, "step_weight_bytes": 4_292_911_104,
        "kv_row_bytes": 67_584, "attn_flops_per_row": 524_288,
        "decode_flops(1 token, 100 rows)": 2 * 7_110_393_856 + 52_428_800,
        "prefill_flops(512)": 7_215_941_419_008},
    "smollm2-1.7b.q8_0": {
        "matmul_params": 1_711_276_032, "step_weight_bytes": 1_818_230_784,
        "kv_row_bytes": 104_448, "attn_flops_per_row": 196_608},
}


def got(m: Model) -> dict:
    return {"matmul_params": R.matmul_params(m),
            "step_weight_bytes": R.step_weight_bytes(m, 16),
            "kv_row_bytes": R.kv_row_bytes(m),
            "attn_flops_per_row": R.attn_flops_per_row(m),
            "decode_flops(1 token, 100 rows)": R.decode_flops(m, 1, 100),
            "prefill_flops(512)": R.prefill_flops(m, 512)}


def main() -> None:
    bad = []
    for name, want in WANT.items():
        m = Model.from_file(name, os.path.join(HERE, "configs", name + ".json"))
        have = got(m)
        for key, value in want.items():
            ok = have[key] == value
            print(f"{name} {key}: {have[key]:,} (hand-worked {value:,})"
                  f"{'' if ok else '  MISMATCH'}")
            if not ok:
                bad.append((name, key))
    if bad:
        raise SystemExit(f"roofline counts differ from the hand-worked ones: {bad}")
    print("roofline counts OK")


if __name__ == "__main__":
    main()
