"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

Builds the port's eight hand-written CUDA kernels from gguf_tpu_torch/csrc
(one nvcc per source, all at once), writes (or reuses, under the temp dir)
two random TinyLlama-1.1B-shaped checkpoints at full width and all 22
layers — Q4_K_M (Q4_K projections, Q6_K head) and Q5_K_M (Q5_K projections
and embedding, Q6_K head) — and then runs two main paths, each with every
kernel's launch counter reset just before it and read just after:

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

`--profile` instead splits a 16-slot decode step of the Q5_K_M
checkpoint with bf16 activations and under act_quant (host clock and
`torch.profiler`), and checks nothing.

Prints the card's name and power limit, a per-shape table, seconds per
phase, one JSON line {"kernels": [...]} and, last, {"ok": true, "device":
{...}}. Any failed check raises and the script exits nonzero. Needs one
CUDA device, nvcc, gcc and make (the native GGUF quantizer is built with
make).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gguf_tpu_torch.engine import LLM, SamplerConfig
from gguf_tpu_torch.engine import engine as engine_mod
from gguf_tpu_torch.eval import perplexity_of_gguf, sequence_nll
from gguf_tpu_torch.models import (GGMLType, LlamaConfig, MMOpts, forward,
                                   fuse_llama_params, init_kv_cache,
                                   load_llama, write_random_llama_gguf)
from gguf_tpu_torch.ops import MMQ, build
from gguf_tpu_torch.ops.activation import (fake_quantize_q8_1,
                                           fake_quantize_q8_1_plain,
                                           quantize_q8_1_codes,
                                           quantize_q8_1_codes_plain)
from gguf_tpu_torch.ops.attention import (decode_attention,
                                          decode_attention_plain,
                                          decode_attention_update,
                                          kv_cache_insert,
                                          kv_cache_insert_plain)
from gguf_tpu_torch.ops.mmq_q4_k import (mmq_i8, mmq_i8_plain, mmq_q4_k,
                                         mmq_q4_k_plain)
from gguf_tpu_torch.ops.mmq_q5_k import mmq_q5_k, mmq_q5_k_plain
from gguf_tpu_torch.ops.mmq_q6_k import mmq_q6_k, mmq_q6_k_plain

# TinyLlama-1.1B (benchmarks/suite.py): vocab 32000, dim 2048, 22 layers,
# 32 heads, 4 KV heads (head_dim 64), ffn 5632
CFG = LlamaConfig(vocab_size=32000, dim=2048, n_layers=22, n_heads=32,
                  n_kv_heads=4, ffn_dim=5632, max_seq_len=2048)
MAX_BATCH, MAX_SEQ, NEW_TOKENS = 16, 2048, 32
DEVICE = "cuda"
PROMPT_LENS = (5, 7, 8, 12, 16, 24, 33, 48, 60, 64, 80, 100, 128, 150, 175,
               200, 225, 250, 260, 270, 280, 290, 295, 300)
MMQ_NS = (1, 16, 512)
ATTN_TS, ATTN_SPANS = (1, 8), (128, 512, 2048)
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
}
SOURCES = sorted({os.path.basename(src)[:-3] for src, _ in KERNELS.values()})
WRAPPERS = {"mmq_q4_k": mmq_q4_k, "mmq_q6_k": mmq_q6_k,
            "kv_cache_insert": kv_cache_insert,
            "decode_attention": decode_attention,
            "quantize_q8_1_codes": quantize_q8_1_codes,
            "fake_quantize_q8_1": fake_quantize_q8_1,
            "mmq_i8": mmq_i8, "mmq_q5_k": mmq_q5_k}
# the kernels each main path must launch; a kernel's "launches" in the
# {"kernels": ...} line come from the last path that requires it
Q4KM_KERNELS = ("mmq_q4_k", "mmq_q6_k", "kv_cache_insert", "decode_attention")
Q5KM_KERNELS = ("mmq_q6_k", "kv_cache_insert", "decode_attention",
                "quantize_q8_1_codes", "fake_quantize_q8_1", "mmq_i8",
                "mmq_q5_k")
# the (decode-width) shape whose times stand in the {"kernels": ...} line
HEADLINE = {"mmq_q4_k": "gate_up 11264x2048 n=16",
            "mmq_q6_k": "head 32000x2048 n=16",
            "kv_cache_insert": "b16 t=1",
            "decode_attention": "b16 t=1 span=512 insert",
            "quantize_q8_1_codes": "n=16 K=2048 bf16",
            "fake_quantize_q8_1": "n=16 K=2048 bf16",
            "mmq_i8": "q5_k gate_up 11264x2048 n=16",
            "mmq_q5_k": "gate_up 11264x2048 n=16 fast"}


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


class Report:
    """Per-kernel worst error, and the headline shape's times."""

    def __init__(self):
        self.err = {k: 0.0 for k in KERNELS}
        self.times = {}

    def add(self, kernel, shape, err, rel, tol, fn=None, plain_fn=None):
        """Record one check; time fn (the kernel) and plain_fn with CUDA
        events, and at the headline shape also by profiler device time."""
        ok = rel <= tol
        times = "not timed"
        if ok and fn is not None:
            ms, pms = cuda_ms(fn), cuda_ms(plain_fn, iters=5)
            times = f"{ms:.4f} ms vs plain {pms:.4f} ms"
            if shape == HEADLINE[kernel]:
                dms, pdms = device_ms(fn), device_ms(plain_fn)
                self.times[kernel] = (ms, pms, dms, pdms)
                dev = ["not measured" if v is None else f"{v:.4f} ms"
                       for v in (dms, pdms)]
                times += f" (device {dev[0]} vs plain {dev[1]})"
        log(f"  {kernel:19s} {shape:38s} max|d|={err:.3e} rel={rel:.2e} "
            f"(tol {tol:g}) {times}{'' if ok else '  FAILED'}")
        if not ok:
            raise AssertionError(f"{kernel} {shape}: rel err {rel} > {tol}")
        self.err[kernel] = max(self.err[kernel], err)


def check_toolchain() -> None:
    for tool in ("gcc", "make"):
        if shutil.which(tool) is None:
            raise RuntimeError(f"step 'toolchain': {tool} not found (the "
                               "native GGUF quantizer is built with make/gcc)")
    log(f"nvcc {build.find_nvcc()}, gcc {shutil.which('gcc')}, "
        f"cc {shutil.which('cc') or 'missing'}")


def build_native_codecs() -> None:
    """The checkpoint writer quantizes with gguf_tpu's C codec core
    (csrc/, built by make at first use). Build it here with `CC=gcc` on
    make's command line: csrc/Makefile's `CC ?= gcc` keeps a `CC` set in
    the environment, and that compiler may lack OpenMP (`-fopenmp` then
    fails on a missing libgomp.spec)."""
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
    proc = subprocess.run(["make", "-C", csrc, "CC=gcc"], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError("step 'native codecs': make -C csrc CC=gcc "
                           f"failed:\n{proc.stdout}{proc.stderr}")


def build_kernels() -> None:
    """One nvcc per CUDA source, all started together."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = dict(zip(SOURCES, pool.map(build.build, SOURCES)))
    for name, path in paths.items():
        with open(path[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")


def checkpoint(seed: int, fmt: GGMLType, tag: str) -> str:
    path = os.path.join(tempfile.gettempdir(),
                        f"gguf_tpu_torch_tinyllama_{tag}_seed{seed}.gguf")
    if not os.path.exists(path):
        tmp = path + f".{os.getpid()}.tmp"
        write_random_llama_gguf(tmp, CFG, fmt=fmt, seed=seed)
        os.replace(tmp, path)
        log(f"wrote {path}")
    return path


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
                    lambda: mmq_q4_k_plain(w, x, precision="fast", glu=glu))
        w = params["output"]
        x = torch.randn((n, w.shape[1]), generator=gen, device=DEVICE).bfloat16()
        got = mmq_q6_k(w, x, precision="fast")
        ref = mmq_q6_k_plain(w, x, precision="fast")
        err, rel = rel_err(got, ref)
        rep.add("mmq_q6_k", f"head {w.shape[0]}x{w.shape[1]} n={n}",
                err, rel, TOL_MMQ, lambda: mmq_q6_k(w, x, precision="fast"),
                lambda: mmq_q6_k_plain(w, x, precision="fast"))


def _random_cache(gen: torch.Generator, b: int, kvh: int, s: int, hd: int):
    def codes():
        return torch.randint(-127, 128, (b, kvh, s, hd), generator=gen,
                             device=DEVICE, dtype=torch.int8)

    def scales():
        return torch.rand((b, kvh, s), generator=gen, device=DEVICE) * 0.02

    return [codes(), scales(), codes(), scales()]


def compare_attention(gen: torch.Generator, rep: Report) -> None:
    b, h, kvh, hd, s = MAX_BATCH, CFG.n_heads, CFG.n_kv_heads, CFG.head_dim, MAX_SEQ
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
        rep.add("kv_cache_insert", f"b{b} t={t}", 0.0, 0.0, 0.0,
                lambda: kv_cache_insert(kn, vn, *got, pos),
                lambda: kv_cache_insert_plain(kn, vn, *ref, pos))

        for span in ATTN_SPANS:
            q = torch.randn((b, h, t, hd), generator=gen, device=DEVICE).bfloat16()
            p = torch.randint(0, span - t + 1, (b,), generator=gen,
                              device=DEVICE, dtype=torch.int32)
            kw = dict(t=t, precision="fast", span=span)
            out = decode_attention(q, *cache, p, **kw)
            ref_out = decode_attention_plain(q, *cache, p, **kw)
            err, rel = rel_err(out, ref_out)
            rep.add("decode_attention", f"b{b} t={t} span={span}", err, rel,
                    TOL_ATTN, lambda: decode_attention(q, *cache, p, **kw),
                    lambda: decode_attention_plain(q, *cache, p, **kw))
            if span == 512:
                # sliding window and softcap: no ported family uses them
                # yet, so they are checked here and not timed
                wkw = dict(kw, window=64, softcap=2.0)
                err, rel = rel_err(decode_attention(q, *cache, p, **wkw),
                                   decode_attention_plain(q, *cache, p, **wkw))
                rep.add("decode_attention",
                        f"b{b} t={t} span={span} window+softcap", err, rel,
                        TOL_ATTN)
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

            rep.add("decode_attention", f"b{b} t=1 span={span} insert", err,
                    rel, TOL_ATTN,
                    lambda: decode_attention_update(q, kn1, vn1, *got, p, **kw),
                    plain_update)


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
                rep.add("quantize_q8_1_codes", shape, 0.0, 0.0, 0.0,
                        lambda: quantize_q8_1_codes(x),
                        lambda: quantize_q8_1_codes_plain(x))
                _bit_equal("fake_quantize_q8_1", shape, (fake_quantize_q8_1(x),),
                           (fake_quantize_q8_1_plain(x),))
                rep.add("fake_quantize_q8_1", shape, 0.0, 0.0, 0.0,
                        lambda: fake_quantize_q8_1(x),
                        lambda: fake_quantize_q8_1_plain(x))
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
                    lambda: mmq_i8_plain(w, q, d, s))


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
                        lambda: mmq_q5_k_plain(w, x, precision=prec))


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


def serve(llm: LLM, seed: int, required: tuple) -> dict:
    """A main path: continuous batching over 24 prompts, every logit
    checked finite on the device (no host sync per step), and every
    kernel in `required` launched."""
    rng = np.random.default_rng(seed)
    prompts = [[int(v) for v in rng.integers(0, CFG.vocab_size, n)]
               for n in PROMPT_LENS]
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
    st = res[0].stats
    log(f"served {len(res)} requests x {NEW_TOKENS} tokens, {n_fwd[0]} "
        f"forwards, all logits finite: wall {st['wall_s']:.2f} s, prefill "
        f"{st['prefill_s']:.2f} s, decode {st['decode_s']:.2f} s for "
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
    """The kernels the JAX package's act_quant routing runs, "high"."""
    if fmt == "q6_k":
        return {"fake_quantize_q8_1", "mmq_q6_k"}
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="split a decode step instead of the smoke run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    check_toolchain()
    with phase("build native codecs and kernels"):
        build_native_codecs()
        build_kernels()
    if args.profile:
        profile_decode(checkpoint(args.seed, GGMLType.Q5_K, "q5km"),
                       args.seed)
        return 0
    with phase("write or reuse the checkpoints"):
        path4 = checkpoint(args.seed, GGMLType.Q4_K, "q4km")
        path5 = checkpoint(args.seed, GGMLType.Q5_K, "q5km")
    rep = Report()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(args.seed)

    log("== Q4_K_M, bf16 activations (K1-K4) ==")
    with phase("load Q4_K_M"):
        llm4 = LLM(path4, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device=DEVICE)
    with phase("K1-K4 vs plain"):
        log("kernel vs plain PyTorch version (bf16 operands, CUDA-event times):")
        compare_mmq(llm4.params, gen, rep)
        compare_attention(gen, rep)
    with phase("serve Q4_K_M"):
        launches = serve(llm4, args.seed, Q4KM_KERNELS)
    with phase("reference check Q4_K_M"):
        reference_check(path4, llm4, args.seed,
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
        launches.update({k: v for k, v in serve(llm5, args.seed,
                                                Q5KM_KERNELS).items()
                         if k in Q5KM_KERNELS})
    with phase("reference check Q5_K_M under act_quant"):
        # the same weights with bf16 activations first: the act_quant
        # bound is wider than that path's by the quantization alone
        cpu5, logits = reference_check(
            path5, llm5, args.seed,
            ((2, MMOpts(precision="high"), TOL_LOGITS),
             (2, ACT_QUANT, TOL_LOGITS_ACT_QUANT),
             (CFG.n_layers, ACT_QUANT, None)))
        err, rel = rel_err(logits[0][1], logits[1][0])
        log(f"a wrong route at 2 layers (card without act_quant vs CPU "
            f"under it): max|d|={err:.3e} rel={rel:.2e}")
        for t in ROUTE_TS:
            projection_check(cpu5, llm5, args.seed, t)
    with phase("perplexity"):
        perplexity_check(path5, llm5, cpu5, args.seed)

    # "ms"/"plain_ms": CUDA events around back-to-back calls (host time
    # included where a wrapper's host work outlasts its kernels);
    # "device_ms"/"plain_device_ms": profiler kernel time per call (null
    # where the profiler recorded none)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": rep.err[name], "ms": rep.times[name][0],
                "plain_ms": rep.times[name][1],
                "device_ms": rep.times[name][2],
                "plain_device_ms": rep.times[name][3]}
               for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
