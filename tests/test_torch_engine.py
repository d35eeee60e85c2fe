"""The port's continuous-batching engine held against the JAX package's
`LLM.generate` (greedy tokens, with bf16 and with Q8_1 activations, on
Q4_K_M and Q8_0 checkpoints), its sampler, and the import boundary: the
port runs with jax and the JAX package made unimportable, loads nothing
from the JAX package's files or its C core, and its sources name neither."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gguf_tpu.engine import LLM as JaxLLM
from gguf_tpu.models import forward as jax_forward
from gguf_tpu.models import init_kv_cache as jax_init_cache
from gguf_tpu.models import MMOpts as JaxMMOpts
from gguf_tpu_torch.engine import LLM, SamplerConfig, sample
from gguf_tpu_torch.models import (GGMLType, LlamaConfig, MMOpts,
                                   write_random_llama_gguf)

CFG = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                  n_kv_heads=2, ffn_dim=512, max_seq_len=256)
PROMPT_LENS = (3, 8, 12, 20, 40, 70)
NEW = 16
FORWARD_TOL = 1e-2          # tests/test_torch_model.py: logits vs max|ref|
FORWARD_TOL_ACT_QUANT = 3e-2   # the same file's act_quant bound
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_engine") / "tiny.gguf")
    write_random_llama_gguf(path, CFG, seed=0)
    return path


@pytest.fixture(scope="module")
def checkpoint_q8_0(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_engine_q8") / "tiny_q8_0.gguf")
    write_random_llama_gguf(path, CFG, fmt=GGMLType.Q8_0, seed=4)
    return path


def _greedy_parity(checkpoint, jopts, opts, tol, prompt_lens, seed=0):
    """Greedy tokens of the port against the JAX LLM over 4 slots
    (continuous batching), NEW tokens per prompt. Tokens must agree up to
    the first step whose reference top-2 logit gap is inside the forward
    tolerance, where ties may break either way. Returns the number of
    steps compared."""
    rng = np.random.default_rng(seed)
    prompts = [[int(x) for x in rng.integers(0, CFG.vocab_size, n)]
               for n in prompt_lens]
    jllm = JaxLLM(checkpoint, max_batch=4, max_seq=256, prefix_cache=False,
                  opts=jopts)
    ref = jllm.generate(prompts, max_new_tokens=NEW, logprobs=2)
    logits, _ = jax_forward(jllm.params, jllm.cfg,
                            jnp.asarray([prompts[-1]], jnp.int32),
                            jnp.zeros(1, jnp.int32),
                            jax_init_cache(jllm.cfg, 1, 256))
    gap_tol = tol * float(jnp.abs(logits).max())

    got = LLM(checkpoint, max_batch=4, max_seq=256, device="cpu",
              opts=opts).generate(prompts, max_new_tokens=NEW)
    compared = 0
    for i, (r, g) in enumerate(zip(ref, got)):
        assert len(g.token_ids) == NEW and g.finished
        assert g.stop_reason == "length" and g.prompt_ids == prompts[i]
        gaps = [e["top"][0][1] - e["top"][1][1] for e in r.logprobs]
        n = next((j for j, gap in enumerate(gaps) if gap < gap_tol), NEW)
        if n < NEW:
            print(f"prompt {i}: reference top-2 gap {gaps[n]:.4f} < "
                  f"{gap_tol:.4f} at step {n}; comparing steps 0..{n - 1}")
        assert g.token_ids[:n] == r.token_ids[:n], (i, n)
        compared += n
    return compared


def test_greedy_generate_matches_jax(checkpoint):
    """6 prompts over 4 slots, 16 greedy tokens each, bf16 activations."""
    compared = _greedy_parity(checkpoint, JaxMMOpts(), MMOpts(), FORWARD_TOL,
                              PROMPT_LENS)
    assert compared >= 2 * NEW, compared


def test_greedy_generate_under_act_quant_matches_jax(checkpoint):
    """The same under Q8_1 activations with precision "high": decode runs
    the integer route (n = 4), prefill chunks the fake-quant one. Twice
    the prompts, since the wider act_quant bound ends more comparisons
    at near-ties."""
    compared = _greedy_parity(
        checkpoint, JaxMMOpts(act_quant=True, precision="high"),
        MMOpts(act_quant=True, precision="high"), FORWARD_TOL_ACT_QUANT,
        PROMPT_LENS * 2, seed=1)
    assert compared >= 2 * NEW, compared


def test_greedy_generate_q8_0_matches_jax(checkpoint_q8_0):
    """A Q8_0 checkpoint (every matrix Q8_0, head and embedding included):
    6 prompts over 4 slots, bf16 activations, the Q8_0 MMQ (K10's plain
    version) on every projection."""
    compared = _greedy_parity(checkpoint_q8_0, JaxMMOpts(), MMOpts(),
                              FORWARD_TOL, PROMPT_LENS, seed=2)
    assert compared >= 2 * NEW, compared


def test_generate_stats_and_admission(checkpoint):
    llm = LLM(checkpoint, max_batch=2, max_seq=256, device="cpu")
    res = llm.generate([[1, 2, 3], [4, 5], [6]], max_new_tokens=3)
    assert [len(r.token_ids) for r in res] == [3, 3, 3]
    st = res[0].stats
    assert st["new_tokens"] == 9 and st["decode_tokens"] == 6
    assert st["decode_s"] > 0 and st["prefill_s"] > 0
    with pytest.raises(NotImplementedError, match="tokenizers"):
        llm.generate(["hello"])


def test_entry_points_default_to_the_card(checkpoint, monkeypatch):
    """LLM, load_llama and perplexity_of_gguf run on the card unless the
    caller asks for the CPU: where torch sees no CUDA device (as on this
    CPU-only host) a call that names no device raises before any weight
    is read, rather than running on the CPU."""
    from gguf_tpu_torch.eval import perplexity_of_gguf
    from gguf_tpu_torch.models import load_llama
    from gguf_tpu_torch.models import loader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    read = []
    monkeypatch.setattr(loader, "_load_weight",
                        lambda *a, **k: read.append(a) or None)
    for call in (lambda: LLM(checkpoint), lambda: load_llama(checkpoint),
                 lambda: perplexity_of_gguf(checkpoint, list(range(40)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not read


def test_buckets():
    assert [LLM._bucket(n) for n in (1, 8, 9, 70, 300)] == [8, 8, 16, 128, 512]
    llm = LLM.__new__(LLM)
    llm.max_seq = 2048
    assert [llm._span_bucket(n) for n in (1, 128, 129, 600, 5000)] == \
        [128, 128, 256, 1024, 2048]
    llm.max_seq = 64
    assert llm._span_bucket(10) is None


def test_sampler_filters():
    logits = torch.tensor([[0.0, 5.0, 1.0, 2.0]] * 3)
    gen = torch.Generator().manual_seed(0)
    assert sample(logits, SamplerConfig()).tolist() == [1, 1, 1]
    for cfg in (SamplerConfig(temperature=1.0, top_k=1),
                SamplerConfig(temperature=1.0, top_p=0.01),
                SamplerConfig(temperature=1.0, min_p=0.9)):
        assert sample(logits, cfg, gen).tolist() == [1, 1, 1]
    cfg = SamplerConfig(temperature=1.0, top_k=2)
    draws = sample(logits.repeat(100, 1), cfg, gen)
    assert set(draws.tolist()) <= {1, 3}
    a = sample(logits, SamplerConfig(temperature=2.0),
               torch.Generator().manual_seed(5))
    b = sample(logits, SamplerConfig(temperature=2.0),
               torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


_NO_JAX = """
import os, sys
sys.modules["jax"] = None
sys.modules["gguf_tpu"] = None
sys.path.insert(0, {repo!r})
import gguf_tpu_torch, gguf_tpu_torch.ops, gguf_tpu_torch.quant
import gguf_tpu_torch.compat
from gguf_tpu_torch.engine import LLM
from gguf_tpu_torch.eval import perplexity_of_gguf
from gguf_tpu_torch.models import (GGMLType, LlamaConfig, MMOpts,
                                   write_random_llama_gguf)
cfg = LlamaConfig(vocab_size=64, dim=256, n_layers=1, n_heads=4,
                  n_kv_heads=2, ffn_dim=256, max_seq_len=64)
for fmt in ("Q4_K", "Q8_0", "Q4_0", "Q2_K", "Q3_K", "IQ4_NL", "IQ4_XS"):
    path = os.path.join({tmp!r}, fmt + ".gguf")
    write_random_llama_gguf(path, cfg, fmt=GGMLType[fmt], seed=2)
    for opts in (MMOpts(), MMOpts(act_quant=True, precision="high")):
        res = LLM(path, max_batch=2, device="cpu", opts=opts).generate(
            [[1, 2, 3]], max_new_tokens=2)
        assert len(res[0].token_ids) == 2, (fmt, opts, res)
assert perplexity_of_gguf(path, list(range(40)), device="cpu",
                          act_quant=True, window=16) > 1.0
import numpy as np, torch
from gguf_tpu_torch.quant import QUANTIZERS
for fmt in ("q2_k", "q3_k"):
    a = QUANTIZERS[fmt](np.ones((2, 256), np.float32))
    out = getattr(gguf_tpu_torch.compat, "mmq_" + fmt)(
        a, np.ones((3, 256), np.float32), 2, 3, 256, device="cpu")
    assert out.shape == (3, 2), out.shape
x = torch.ones(2, 8)
assert gguf_tpu_torch.ops.rms_norm(x, torch.ones(8), 1e-5).shape == (2, 8)
assert sys.modules["jax"] is None and sys.modules["gguf_tpu"] is None
# nothing loaded from the JAX package's files or its C core (csrc/)
banned = [os.path.join({repo!r}, d) + os.sep for d in ("gguf_tpu", "csrc")]
files = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values())
         if m is not None]
with open("/proc/self/maps") as f:
    files += [line.split()[-1] for line in f if "/" in line]
hit = [p for p in files if any(os.path.abspath(p).startswith(b) for b in banned)]
assert not hit, hit
print("ok")
"""


def test_port_runs_with_jax_unimportable(tmp_path):
    """The port writes, loads and serves Q4_K, Q8_0, Q4_0, Q2_K, Q3_K,
    IQ4_NL and IQ4_XS checkpoints on the CPU, with and without act_quant,
    scores perplexity, and runs compat's Q2_K/Q3_K entry points and the
    RMSNorm op, with `jax` and `gguf_tpu` unimportable; no module or
    shared library it loads lies under the JAX package or the root
    `csrc/`."""
    code = _NO_JAX.format(repo=REPO, tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


# an import of the JAX package (`gguf_tpu`, not `gguf_tpu_torch`), a
# module or path named by the string "gguf_tpu" ("gguf_tpu" as a path
# component, "gguf_tpu.x" for import_module), or a file loaded by path
_JAX_PACKAGE = re.compile(
    r"^\s*(import|from)\s+gguf_tpu\b|[\"']gguf_tpu[\"'.]"
    r"|spec_from_file_location", re.M)


def test_port_sources_never_import_jax():
    """No import statement of the port or chip_smoke.py names jax or the
    JAX package, no string of theirs names the JAX package as a module or
    path, and chip_smoke.py builds nothing with make (the root csrc/ is
    the JAX package's C core)."""
    jax_import = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    pkg = os.path.join(REPO, "gguf_tpu_torch")
    sources = [os.path.join(root, name) for root, _, files in os.walk(pkg)
               for name in files if name.endswith(".py")]
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    for path in sources:
        with open(path) as f:
            src = f.read()
        assert not jax_import.search(src), path
        hit = _JAX_PACKAGE.search(src)
        assert not hit, (path, hit.group(0))
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not re.search(r"[\"']make[\"']", f.read())


def test_boundary_scan_catches_the_forms_it_names():
    """The scan's pattern on lines that break the boundary and on lines
    that keep it."""
    for bad in ("import gguf_tpu.gguf", "from gguf_tpu.quant import x",
                "from gguf_tpu import compat", "import gguf_tpu",
                'os.path.join(root, "gguf_tpu", "models", "config.py")',
                "importlib.import_module('gguf_tpu.quant')",
                "spec = importlib.util.spec_from_file_location(n, p)"):
        assert _JAX_PACKAGE.search(bad), bad
    for good in ("import gguf_tpu_torch.ops", "from gguf_tpu_torch import x",
                 "from . import build", '"gguf_tpu/ops/mmq_q8_0.py:64"',
                 "`gguf_tpu.quant` is the reference"):
        assert not _JAX_PACKAGE.search(good), good
