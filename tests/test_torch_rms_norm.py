"""The plain version of K15 (`gguf_tpu_torch.ops.rms_norm`, the one-block
RMSNorm) held against the JAX package's `rms_norm_pallas` (Pallas in
interpret mode on the CPU), and the model's own norm, which stays plain
torch as in the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gguf_tpu.ops.activation import rms_norm_pallas
from gguf_tpu_torch.models import llama
from gguf_tpu_torch.ops import rms_norm
from gguf_tpu_torch.ops.activation import rms_norm_plain

# f32 on both sides: the sum of squares in another order and rsqrt within
# an ulp; relative to max|ref|
TOL = 1e-6
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (np.float16, torch.float16)}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("n,d", [(1, 256), (16, 256), (64, 512), (3, 2048)])
def test_rms_norm_matches_rms_norm_pallas(n, d, dt):
    """(n, d) in f32, bf16 or fp16 and a (d,) f32 weight -> (n, d) f32."""
    rng = np.random.default_rng(n * d)
    x32 = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    w = (1.0 + 0.5 * rng.standard_normal(d)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    xj = jnp.asarray(x32).astype(jdt)
    ref = np.asarray(rms_norm_pallas(xj, jnp.asarray(w), 1e-5))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)
    got = rms_norm(xt, torch.from_numpy(w), 1e-5)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    err = np.max(np.abs(got.numpy() - ref))
    assert err <= TOL * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


def test_model_norm_is_k15_rounded_to_the_input_dtype():
    """The model's norm is not routed to K15 (nor is the JAX model's to its
    Pallas kernel): it computes the same f32 values and casts them back."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 256)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    before = rms_norm.launches
    ref = rms_norm(x.reshape(10, 256), w, 1e-6).to(torch.bfloat16)
    assert torch.equal(llama.rms_norm(x, w, 1e-6).reshape(10, 256), ref)
    assert rms_norm.launches == before


def test_operand_checks():
    x, w = torch.ones(4, 8), torch.ones(8)
    assert torch.equal(rms_norm(x, w, 0.0), rms_norm_plain(x, w, 0.0))
    with pytest.raises(ValueError):
        rms_norm(torch.ones(2, 4, 8), w, 1e-5)          # not (n, d)
    with pytest.raises(ValueError):
        rms_norm(x, torch.ones(4), 1e-5)                 # weight size
    with pytest.raises(ValueError):
        rms_norm(x.int(), w, 1e-5)                       # dtype
