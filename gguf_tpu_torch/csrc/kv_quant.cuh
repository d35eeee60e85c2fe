// The INT8 KV-cache row quantizer and the small warp helpers that K3, K4
// (csrc/attention.cu) and K9 (csrc/attention_tiled.cu) share, so that every
// kernel that writes the cache writes the same codes.
//
// Quantization is per (token, head) row and bit-identical to the reference
// as XLA compiles it (gguf_tpu/models/llama.py:_quantize_kv and the Pallas
// inserts under jit): scale = absmax * f32(1/127) (the product XLA turns the
// division by the constant 127 into), codes = clip(rintf(x / scale), +-127)
// with an IEEE division and round-half-to-even. The sources are built
// without --use_fast_math, so the division is exact.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -3.402823466e38f;  // finfo(float32).min, as the reference
constexpr float RECIP_127 = 1.0f / 127.0f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// signed byte b (0..3) of w as an exact float
__device__ __forceinline__ float i8f(uint32_t w, int b) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 + b)) - 8388736.0f;
}

// One warp quantizes one HD-element row into dst (and dst2 unless null).
template <int HD>
__device__ __forceinline__ void quantize_row(const float* src, int8_t* dst,
                                             float* dst_scale, int lane,
                                             int8_t* dst2 = nullptr,
                                             float* dst2_scale = nullptr) {
  constexpr int PER = HD / 32;
  float v[PER];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = src[lane + 32 * i];
    amax = fmaxf(amax, fabsf(v[i]));
  }
  amax = warp_max(amax);
  const float scale = amax * RECIP_127;
  const float safe = scale == 0.f ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int8_t c = static_cast<int8_t>(fminf(fmaxf(rintf(v[i] / safe), -127.f), 127.f));
    dst[lane + 32 * i] = c;
    if (dst2) dst2[lane + 32 * i] = c;
  }
  if (lane == 0) {
    *dst_scale = scale;
    if (dst2) *dst2_scale = scale;
  }
}

}  // namespace
