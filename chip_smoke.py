"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

Builds the port's nine hand-written CUDA kernels from gguf_tpu_torch/csrc
(one nvcc per source, all at once) while child processes write (or
reuse, under the temp dir) three random checkpoints at full width and
depth: TinyLlama-1.1B as Q4_K_M (Q4_K projections and embedding, Q6_K
head) and as Q5_K_M (Q5_K projections and embedding, Q6_K head), and
Llama-2-7B as Q4_K_M. It then runs the main paths below, each with every
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

Llama-2-7B Q4_K_M with bf16 activations at its 4,096-token context
(kernels K1-K4 and K9, flash-decoding):
8. holds K9 against its plain version ("fast" and "high", 1e-3 of
   max|ref|) at the 7B geometry (16 slots, 32 heads of 128, spans 1024,
   2048 and 4096, positions 0, 255, 256, random ones and an inactive slot
   at pos = 4096), with a sliding window and softcap, and at the
   TinyLlama geometry (8 query heads per KV head, hd 64, span 2048); then
   K3/K4 at hd 128 with one query head per KV head and K1/K2 at every 7B
   projection and the head, against their plain versions;
9. serves two rounds of 16 requests through `LLM(max_batch=16,
   max_seq=4096)`, 32 greedy tokens each: round A (prompts of 5..440
   tokens, every decode step at span <= 512: K1-K4) and round B (600..3,900
   tokens: prefill crosses every span bucket, decode runs at span 4096 on
   K3 + K9), every logit finite;
10. times a 16-slot decode step at span 512 and at span 4096 (host clock
   and `torch.profiler`: device time, K9 per layer beside its bound) and
   a 512-token prefill chunk;
11. checks 2 layers against the CPU run of the same port: the logits of a
   16-token prefill, then a 2,100-token prefill on the card whose cache
   is copied to the CPU, and one t = 1 and one t = 8 step at span 4096 on
   both (1e-2 of max|ref|); the card's t = 1 step must launch K9 and no
   K4, its t = 8 step neither (the f32 arm).

`--profile` instead splits a 16-slot decode step of the Q5_K_M
checkpoint with bf16 activations and under act_quant (host clock and
`torch.profiler`), and checks nothing.

Prints the card's name and power limit, a per-shape table, seconds per
phase, one JSON line {"kernels": [...]} (per kernel its headline shape's
times, its bound from this run's inputs and, where one PyTorch call
computes the same function, that call's time) and, last, {"ok": true,
"device": {...}}. Any failed check raises and the script exits nonzero.
Needs one CUDA device, nvcc, gcc and make (the native GGUF quantizer is
built with make).
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
import torch.nn.functional as F

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
from gguf_tpu_torch.ops.attention import (_attend_cuda, decode_attention,
                                          decode_attention_plain,
                                          decode_attention_tiled,
                                          decode_attention_tiled_plain,
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
}
SOURCES = sorted({os.path.basename(src)[:-3] for src, _ in KERNELS.values()})
WRAPPERS = {"mmq_q4_k": mmq_q4_k, "mmq_q6_k": mmq_q6_k,
            "kv_cache_insert": kv_cache_insert,
            "decode_attention": decode_attention,
            "quantize_q8_1_codes": quantize_q8_1_codes,
            "fake_quantize_q8_1": fake_quantize_q8_1,
            "mmq_i8": mmq_i8, "mmq_q5_k": mmq_q5_k,
            "decode_attention_tiled": decode_attention_tiled}
# the kernels each main path must launch; a kernel's "launches" in the
# {"kernels": ...} line come from the last path that requires it
Q4KM_KERNELS = ("mmq_q4_k", "mmq_q6_k", "kv_cache_insert", "decode_attention")
Q5KM_KERNELS = ("mmq_q6_k", "kv_cache_insert", "decode_attention",
                "quantize_q8_1_codes", "fake_quantize_q8_1", "mmq_i8",
                "mmq_q5_k")
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
            "decode_attention_tiled": "b16 h32 hd128 span=4096 fast"}
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


# tag -> (config, projection format, model name in the file name)
CHECKPOINTS = {"q4km": (CFG, GGMLType.Q4_K, "tinyllama"),
               "q5km": (CFG, GGMLType.Q5_K, "tinyllama"),
               "q4km_7b": (CFG7B, GGMLType.Q4_K, "llama2_7b")}


def checkpoint_path(seed: int, tag: str) -> str:
    model = CHECKPOINTS[tag][2]
    return os.path.join(tempfile.gettempdir(),
                        f"gguf_tpu_torch_{model}_{tag}_seed{seed}.gguf")


def write_checkpoint(seed: int, tag: str) -> None:
    """Write one random checkpoint (the child process's whole work)."""
    cfg, fmt, _ = CHECKPOINTS[tag]
    path = checkpoint_path(seed, tag)
    tmp = path + f".{os.getpid()}.tmp"
    t0 = time.perf_counter()
    write_random_llama_gguf(tmp, cfg, fmt=fmt, seed=seed)
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


def serve(llm: LLM, seed: int, required: tuple,
          prompt_lens: tuple = PROMPT_LENS) -> dict:
    """A main path: continuous batching over seeded prompts of
    `prompt_lens` tokens, every logit checked finite on the device (no host
    sync per step), and every kernel in `required` launched."""
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


def hbm_read_gbs() -> float:
    """The card's HBM read rate: x.sum() over 4 GiB of float32."""
    x = torch.ones(2 ** 30, device=DEVICE)
    ms = cuda_ms(lambda: x.sum(), iters=10)
    del x
    torch.cuda.empty_cache()
    return 4 * 2 ** 30 / ms / 1e6


def profile_7b_decode(llm: LLM, seed: int, hbm_gbs: float) -> None:
    """Where the 7B decode step goes: 16 live slots at round A's and at
    round B's positions (spans 512 and 4096). Per step the host clock over
    8 steps ending in a sync, then `torch.profiler` over 4 steps: device
    busy time and the top kernels; K9's device time per layer beside its
    bound (the live K/V rows and their scales over the HBM read measured
    in this run and over the published 3.35 TB/s). Then one 512-token
    prefill chunk at the start of a slot and one at span 4096."""
    sampler, gen = SamplerConfig(), torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    cfg, layers = llm.cfg, llm.cfg.n_layers
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, MAX_BATCH),
                          device=DEVICE)
    for lens, span in ((ROUND_A, 512), (ROUND_B, SEQ7B)):
        pos = torch.tensor([lens[i % len(lens)] for i in range(MAX_BATCH)],
                           dtype=torch.int32, device=DEVICE)
        llm._decode(tok, pos, sampler, 2, span, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm._decode(tok, pos, sampler, 8, span, gen)
        issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 8 * 1e3
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            llm._decode(tok, pos, sampler, 4, span, gen)
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.key_averages()
                       if e.device_type.name == "CUDA"),
                      key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in kern) / 4 / 1e3
        log(f"7B decode step, 16 slots, span {span}: wall {wall:.2f} ms/step, "
            f"host issue {issue / 8 * 1e3:.2f} ms/step, device busy "
            f"{busy:.2f} ms/step ({100 * (1 - busy / wall):.0f}% idle) over "
            f"{sum(e.count for e in kern) / 4:.0f} kernels/step; top 8:")
        for e in kern[:8]:
            log(f"  {e.self_device_time_total / 4 / 1e3:8.3f} ms/step "
                f"{e.count / 4:6.1f}/step {e.key[:70]}")
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
    with phase("build native codecs"):
        build_native_codecs()
    writers = Writers(args.seed, ("q5km",) if args.profile
                      else ("q4km", "q5km", "q4km_7b"))
    try:
        with phase("build kernels"):
            build_kernels()
        if args.profile:
            profile_decode(writers.wait("q5km"), args.seed)
            return 0
        kernels = smoke(args.seed, writers)
    finally:
        writers.stop()
    log(smi)          # again, beside the numbers at the end of the output
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
