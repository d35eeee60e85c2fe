"""The port's Q8_1 activation contract held against the JAX package: the
plain versions of K5 (`quantize_q8_1_codes`) and K6 (`fake_quantize_q8_1`)
bit-equal to the JAX functions (Pallas in interpret mode at n <= 64, the
XLA chain above), K7 (`mmq_i8`) against the byte-level goldens and the
JAX `act_quant=True, precision="high"` MMQ, and the act_quant routes of
the three MMQ wrappers against the JAX ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gguf_tpu.ops import mmq_q4_k as jax_mmq_q4_k
from gguf_tpu.ops import mmq_q5_k as jax_mmq_q5_k
from gguf_tpu.ops import mmq_q6_k as jax_mmq_q6_k
from gguf_tpu.ops.activation import fake_quantize_q8_1 as jax_fake_quantize
from gguf_tpu.ops.activation import quantize_q8_1_act as jax_quantize_act
from gguf_tpu.ops.activation import quantize_q8_1_codes as jax_codes
from gguf_tpu.quant import (mmq_q4_k_q8_1_golden, mmq_q5_k_q8_1_golden,
                            parse_q8_1, quantize_q4_k, quantize_q5_k,
                            quantize_q6_k, quantize_q8_1)
from gguf_tpu.quant.layouts import to_soa
from gguf_tpu_torch.ops import (fake_quantize_q8_1, mmq_i8, mmq_q4_k,
                                mmq_q5_k, mmq_q6_k, quantize_q8_1_codes)
from gguf_tpu_torch.ops.activation import (fake_quantize_q8_1_plain,
                                           quantize_q8_1_codes_plain)
from gguf_tpu_torch.ops.mmq_q4_k import mmq_i8_plain
from gguf_tpu_torch.quant import QuantWeight

K = 512
QUANTIZE = {"q4_k": quantize_q4_k, "q5_k": quantize_q5_k,
            "q6_k": quantize_q6_k}
GOLDEN = {"q4_k": mmq_q4_k_q8_1_golden, "q5_k": mmq_q5_k_q8_1_golden}
JAX_MMQ = {"q4_k": jax_mmq_q4_k, "q5_k": jax_mmq_q5_k, "q6_k": jax_mmq_q6_k}
PORT_MMQ = {"q4_k": mmq_q4_k, "q5_k": mmq_q5_k, "q6_k": mmq_q6_k}
# K7 and the golden sum exact int32 partials and differ only in the order
# of their f32 scale products and sums; the float routes follow
# tests/test_torch_mmq.py ("fast" rounds operands to bf16)
TOL_I8 = 1e-5
TOL = {"fast": 1e-3, "high": 1e-5}


def _acts(n, k, seed):
    """Activations with the awkward blocks: every row's first block is all
    zero, and row 0's second block is all positive near its maximum, so
    sum(q) ~ 3900 > 2048 (where fp16 cannot hold the sum exactly)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, k)) * rng.uniform(0.05, 20, (n, 1))
         ).astype(np.float32)
    x[:, :32] = 0.0
    x[0, 32:64] = rng.uniform(0.9, 1.0, 32).astype(np.float32) * 3.0
    return x


def _weight(fmt, m, k=K, seed=0):
    rng = np.random.default_rng(seed)
    raw = QUANTIZE[fmt](rng.standard_normal((m, k)).astype(np.float32))
    return raw, to_soa(fmt, raw, m, k), QuantWeight.from_blocks(
        fmt, raw, (m, k), "cpu")


def _assert_close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.max(np.abs(np.asarray(got) - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


@pytest.mark.parametrize("n", [1, 16, 64, 100])
def test_codes_bit_equal_to_jax(n):
    """K5's plain version against the JAX codes as the model runs them
    (jitted; Pallas at n <= 64, the XLA chain above) and run eagerly."""
    x = _acts(n, K, seed=n)
    q, d, s = quantize_q8_1_codes_plain(torch.from_numpy(x))
    assert q.dtype == torch.int8 and q.shape == (n, K)
    assert d.shape == s.shape == (n, K // 32)
    for ref in (jax.jit(jax_codes)(jnp.asarray(x)),
                jax_codes(jnp.asarray(x)), jax_quantize_act(jnp.asarray(x))):
        for got, want in zip((q, d, s), ref):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (q[:, :32] == 0).all() and (d[:, 0] == 0).all()
    assert int(q[0, 32:64].sum()) > 2048


@pytest.mark.parametrize("n", [1, 16, 64, 100])
def test_fake_quantize_bit_equal_to_jax(n):
    x = _acts(n, K, seed=10 + n)
    got = fake_quantize_q8_1_plain(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n, K)
    for ref in (jax.jit(jax_fake_quantize)(jnp.asarray(x)),
                jax_fake_quantize(jnp.asarray(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("glu", ["silu", "gelu"])
def test_glu_prologue_quantizes_unrounded_h(glu):
    """With glu the quantizers see h = act(gate) * up in f32, as the JAX
    mmq_q4_k computes it under act_quant; no bf16 rounding of h."""
    gu = torch.from_numpy(_acts(16, 2 * K, seed=20)).bfloat16()
    g, u = gu.float().chunk(2, dim=-1)
    act = torch.nn.functional.silu(g) if glu == "silu" else \
        torch.nn.functional.gelu(g, approximate="tanh")
    h = act * u
    for got, want in zip(quantize_q8_1_codes(gu, glu=glu),
                         quantize_q8_1_codes(h)):
        assert torch.equal(got, want)
    assert torch.equal(fake_quantize_q8_1(gu, glu=glu), fake_quantize_q8_1(h))


def test_s_field_follows_jax_not_the_numpy_codec():
    """The numpy codec rounds sum(q) to fp16 before its product with d; the
    JAX path (and the port) multiply the exact sum. They agree on codes and
    d everywhere, and on s wherever |sum(q)| <= 2048."""
    x = _acts(16, K, seed=3)
    q, d, s = quantize_q8_1_codes_plain(torch.from_numpy(x))
    cd, cs, cq = parse_q8_1(quantize_q8_1(x.astype(np.float16)))
    np.testing.assert_array_equal(q.numpy().reshape(-1, 32), cq)
    np.testing.assert_array_equal(d.numpy().reshape(-1), cd)
    big = np.abs(q.numpy().reshape(-1, 32).astype(np.int32).sum(axis=1)) > 2048
    assert big.any()
    np.testing.assert_array_equal(s.numpy().reshape(-1)[~big], cs[~big])
    exact = (d.numpy().reshape(-1) * q.numpy().reshape(-1, 32).sum(axis=1)
             ).astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(s.numpy().reshape(-1), exact)


@pytest.mark.parametrize("fmt", ["q4_k", "q5_k"])
@pytest.mark.parametrize("m", [16, 256])
@pytest.mark.parametrize("n", [1, 4, 16])
def test_mmq_i8_matches_golden(fmt, m, n):
    """K7's plain version fed the codes, d and s the golden parses from the
    Q8_1 codec's bytes."""
    rng = np.random.default_rng(m * 31 + n)
    a = rng.standard_normal((m, K)).astype(np.float16)
    b = rng.standard_normal((n, K)).astype(np.float16)
    raw, bq = QUANTIZE[fmt](a), quantize_q8_1(b)
    ref = GOLDEN[fmt](raw, bq, m, n, K)
    d, s, qs = parse_q8_1(bq)
    w = QuantWeight.from_blocks(fmt, raw, (m, K), "cpu")
    got = mmq_i8_plain(w, torch.from_numpy(qs.reshape(n, K).copy()),
                       torch.from_numpy(d.reshape(n, K // 32)),
                       torch.from_numpy(s.reshape(n, K // 32)))
    assert got.shape == (n, m) and got.dtype == torch.float32
    _assert_close(got.numpy(), ref, TOL_I8)


@pytest.mark.parametrize("fmt", ["q4_k", "q5_k"])
@pytest.mark.parametrize("m", [256, 512])
@pytest.mark.parametrize("n", [1, 4, 16])
def test_integer_route_matches_jax(fmt, m, n):
    """act_quant + "high" at n <= 16: codes (K5) into the integer contract
    (K7), against the JAX `_kernel_i8` route."""
    _, wj, wt = _weight(fmt, m, seed=m + n)
    x = _acts(n, K, seed=m - n)
    ref = JAX_MMQ[fmt](wj, jnp.asarray(x), act_quant=True, precision="high")
    got = PORT_MMQ[fmt](wt, torch.from_numpy(x), act_quant=True,
                        precision="high")
    _assert_close(got.numpy(), ref, TOL_I8)
    direct = mmq_i8(wt, *quantize_q8_1_codes(torch.from_numpy(x)))
    assert torch.equal(got, direct)


# (the JAX Q6_K MMQ under act_quant + "fast" at 2 <= n <= 64 does not run
# on the CPU: XLA's CPU dot has no bf16 x bf16 -> f32 form there)
FQ_CASES = [(fmt, p, n) for fmt in ("q4_k", "q5_k", "q6_k")
            for p, n in (("fast", 1), ("fast", 72), ("high", 17), ("high", 72))]
FQ_CASES += [("q4_k", "fast", 16), ("q5_k", "fast", 16)]


@pytest.mark.parametrize("fmt,precision,n", FQ_CASES)
def test_fake_quant_route_matches_jax(fmt, precision, n):
    """act_quant off the integer route (and every Q6_K call): fake-quant
    (K6), then the float kernel, against the JAX MMQ."""
    _, wj, wt = _weight(fmt, 256, seed=n)
    x = _acts(n, K, seed=n + 5)
    ref = JAX_MMQ[fmt](wj, jnp.asarray(x), act_quant=True, precision=precision)
    got = PORT_MMQ[fmt](wt, torch.from_numpy(x), act_quant=True,
                        precision=precision)
    _assert_close(got.numpy(), ref, TOL[precision])


@pytest.mark.parametrize("precision,n", [("high", 4), ("high", 16),
                                         ("high", 40), ("fast", 16)])
def test_glu_down_under_act_quant_matches_jax(precision, n):
    """The fused-GLU Q4_K down call under act_quant: h in f32, then the
    integer or the fake-quant route, against the JAX mmq_q4_k."""
    _, wj, wt = _weight("q4_k", 256, seed=40 + n)
    gu = _acts(n, 2 * K, seed=n)
    ref = jax_mmq_q4_k(wj, jnp.asarray(gu), act_quant=True,
                       precision=precision, glu="silu")
    got = mmq_q4_k(wt, torch.from_numpy(gu), act_quant=True,
                   precision=precision, glu="silu")
    # a code may flip by one where h lands within an ulp of a rounding
    # boundary (torch's and XLA's silu differ in the last bit), which
    # moves the output by about one activation quantum
    _assert_close(got.numpy(), ref, 1e-3)


def test_quantizer_operand_checks():
    with pytest.raises(ValueError):
        quantize_q8_1_codes(torch.zeros(2, 48))           # K % 32
    with pytest.raises(ValueError):
        fake_quantize_q8_1(torch.zeros(2, 96), glu="silu")
    with pytest.raises(TypeError):
        quantize_q8_1_codes(torch.zeros(2, 64, dtype=torch.float16))
    _, _, w = _weight("q6_k", 256)
    q, d, s = quantize_q8_1_codes(torch.zeros(2, K))
    with pytest.raises(ValueError, match="q4_k or q5_k"):
        mmq_i8(w, q, d, s)


def test_cpu_tensors_never_count_kernel_launches():
    counters = (quantize_q8_1_codes, fake_quantize_q8_1, mmq_i8, mmq_q5_k)
    before = [f.launches for f in counters]
    _, _, w = _weight("q5_k", 256)
    x = torch.from_numpy(_acts(4, K, seed=1))
    mmq_q5_k(w, x, act_quant=True, precision="high")
    mmq_q5_k(w, x, act_quant=True, precision="fast")
    assert [f.launches for f in counters] == before
