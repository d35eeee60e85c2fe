// K3: INT8 KV-cache insert.  K4: GQA decode attention over the INT8 cache,
// optionally with the t = 1 insert fused in.
//
// K3 replaces gguf_tpu/ops/attention.py:_insert_kernel (kv_cache_insert).
// One block per (batch, kv-head); one warp quantizes one (token, head) row:
// scale = absmax * f32(1/127) (the product XLA compiles the reference's
// absmax / 127 into), codes = clip(rintf(x / scale), +-127) with an IEEE
// division and round-half-to-even. This file is built without
// --use_fast_math, so the codes are bit-identical to the reference. Rows
// outside [0, S) are skipped: inactive engine slots step at pos = max_seq.
//
// K4 replaces gguf_tpu/ops/attention.py:_attn_kernel (decode_attention)
// and :_fused_attn_kernel (decode_attention_update at t = 1). One block per
// (batch, kv-head) serves its g = H/KVH query heads x t tokens and reads
// only the first `span` cache rows. With the insert flag (t = 1) warps 0
// and 1 first quantize and write this head's new K and V row; after the
// block barrier every warp attends over the updated rows, so one launch
// does what the fused TPU kernel does and no block waits on another.
// Each warp owns query rows; softmax is two-pass in f32: pass 1 keeps a
// per-lane online (max, sum) over its keys and merges them across the
// warp, pass 2 recomputes each score, forms p = exp(s - m) / sum exactly
// as the reference does, rounds p * v_scale to the operand type, and
// accumulates p * v with lanes spread over the head dimension.
//
// What bounds it on an H100: the int8 K/V bytes of the span (2 * span * hd
// per head row pair) at decode, plus the recomputed q.k dot products
// (pass 1 and pass 2 both score every key). At TinyLlama shapes the grid
// is only B * KVH = 64 blocks, so the launch and per-block latency matter
// more than bandwidth; a split-span (flash-decoding) grid is the later fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -3.402823466e38f;  // finfo(float32).min, as the reference
constexpr float RECIP_127 = 1.0f / 127.0f;
constexpr int NTHREADS = 256;

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

// signed byte b (0..3) of a 32-bit word
__device__ __forceinline__ float sbyte(unsigned w, int b) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * b)) >> 24);
}

// One warp quantizes one HD-element row into the cache.
template <int HD>
__device__ __forceinline__ void quantize_row(const float* src, int8_t* dst,
                                             float* dst_scale, int lane) {
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
    const float c = fminf(fmaxf(rintf(v[i] / safe), -127.f), 127.f);
    dst[lane + 32 * i] = static_cast<int8_t>(c);
  }
  if (lane == 0) *dst_scale = scale;
}

template <int HD>
__global__ void __launch_bounds__(128)
kv_insert_kernel(const float* __restrict__ kn, const float* __restrict__ vn,
                 int8_t* k, float* ks, int8_t* v, float* vs,
                 const int* __restrict__ pos, int KVH, int T, int S) {
  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = pos[bh / KVH];
  for (int item = warp; item < 2 * T; item += blockDim.x >> 5) {
    const bool is_v = item >= T;
    const int tj = item % T;
    const int row = p0 + tj;
    if (row < 0 || row >= S) continue;
    const size_t src = (static_cast<size_t>(bh) * T + tj) * HD;
    const size_t dst = static_cast<size_t>(bh) * S + row;
    if (is_v) quantize_row<HD>(vn + src, v + dst * HD, vs + dst, lane);
    else quantize_row<HD>(kn + src, k + dst * HD, ks + dst, lane);
  }
}

// Cache pointers are deliberately neither const nor __restrict__: with the
// insert flag this block writes a row it then reads, so those loads must
// not go through the non-coherent read-only path.
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
attn_kernel(const float* __restrict__ q, const float* __restrict__ kn,
            const float* __restrict__ vn, int8_t* k, float* ks, int8_t* v,
            float* vs, const int* __restrict__ pos, float* __restrict__ out,
            int KVH, int G, int T, int S, int span, float scale,
            float softcap, int window, int fast, int insert) {
  constexpr int PER = HD / 32;
  extern __shared__ float q_s[];  // [G*T][HD]
  const int bh = blockIdx.y * KVH + blockIdx.x;
  const int R = G * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = pos[blockIdx.y];
  int8_t* kc = k + static_cast<size_t>(bh) * S * HD;
  int8_t* vc = v + static_cast<size_t>(bh) * S * HD;
  float* ksc = ks + static_cast<size_t>(bh) * S;
  float* vsc = vs + static_cast<size_t>(bh) * S;

  if (insert && p0 >= 0 && p0 < S) {
    if (warp == 0) quantize_row<HD>(kn + static_cast<size_t>(bh) * HD, kc + static_cast<size_t>(p0) * HD, ksc + p0, lane);
    if (warp == 1) quantize_row<HD>(vn + static_cast<size_t>(bh) * HD, vc + static_cast<size_t>(p0) * HD, vsc + p0, lane);
  }
  const float* qb = q + static_cast<size_t>(bh) * R * HD;
  for (int e = threadIdx.x; e < R * HD; e += NTHREADS) q_s[e] = fast ? bf16_round(qb[e]) : qb[e];
  __syncthreads();

  for (int r = warp; r < R; r += NTHREADS / 32) {
    const float* qr = q_s + r * HD;
    const int lim = p0 + r % T;  // token r % t sits at pos + r % t
    auto score = [&](int j) -> float {
      const int8_t* kr = kc + static_cast<size_t>(j) * HD;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
        const unsigned wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int b = 0; b < 16; ++b) acc = fmaf(qr[c + b], sbyte(wd[b >> 2], b & 3), acc);
      }
      float s = acc * (ksc[j] * scale);
      if (softcap != 0.f) s = softcap * tanhf(s * (1.0f / softcap));
      const bool live = j <= lim && (window == 0 || j > lim - window);
      return live ? s : NEG_INF;
    };

    float m_l = -INFINITY, l_l = 0.f;
    for (int j = lane; j < span; j += 32) {
      const float s = score(j);
      if (s > m_l) {
        l_l = l_l * expf(m_l - s) + 1.f;
        m_l = s;
      } else {
        l_l += expf(s - m_l);
      }
    }
    const float m = warp_max(m_l);
    const float l = warp_sum(l_l * expf(m_l - m));

    float acc[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < span; j0 += 32) {
      const int j = j0 + lane;
      float pv = 0.f;
      if (j < span) {
        pv = (expf(score(j) - m) / l) * vsc[j];
        if (fast) pv = bf16_round(pv);
      }
      const int nj = min(32, span - j0);
      for (int i = 0; i < nj; ++i) {
        const float pj = __shfl_sync(0xffffffffu, pv, i);
        const int8_t* vr = vc + static_cast<size_t>(j0 + i) * HD + lane * PER;
#pragma unroll
        for (int e = 0; e < PER; ++e) acc[e] = fmaf(pj, static_cast<float>(vr[e]), acc[e]);
      }
    }
    float* o = out + (static_cast<size_t>(bh) * R + r) * HD + lane * PER;
#pragma unroll
    for (int e = 0; e < PER; ++e) o[e] = acc[e];
  }
}

}  // namespace

// kn, vn (B, KVH, T, HD) f32; k, v (B, KVH, S, HD) int8; ks, vs (B, KVH, S)
// f32; pos (B,) int32.
extern "C" int kv_cache_insert_launch(const void* kn, const void* vn, void* k,
                                      void* ks, void* v, void* vs,
                                      const void* pos, int B, int KVH, int T,
                                      int S, int HD, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * KVH);
#define K3_ARGS static_cast<const float*>(kn), static_cast<const float*>(vn), \
    static_cast<int8_t*>(k), static_cast<float*>(ks), static_cast<int8_t*>(v), \
    static_cast<float*>(vs), static_cast<const int*>(pos), KVH, T, S
  if (HD == 64) kv_insert_kernel<64><<<grid, 128, 0, st>>>(K3_ARGS);
  else if (HD == 128) kv_insert_kernel<128><<<grid, 128, 0, st>>>(K3_ARGS);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef K3_ARGS
  return static_cast<int>(cudaGetLastError());
}

// q (B, KVH*G, T, HD) f32; out likewise; flags bit 0 = fast (bf16
// operands), bit 1 = insert (T == 1, kn/vn (B, KVH, 1, HD) f32).
extern "C" int decode_attention_launch(const void* q, const void* kn,
                                       const void* vn, void* k, void* ks,
                                       void* v, void* vs, const void* pos,
                                       void* out, int B, int KVH, int G, int T,
                                       int S, int span, int HD, float scale,
                                       float softcap, int window, int flags,
                                       void* stream) {
  const int insert = (flags >> 1) & 1;
  if (span <= 0 || span > S || (insert && T != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(KVH, B);
  const size_t smem = static_cast<size_t>(G) * T * HD * sizeof(float);
#define K4_ARGS static_cast<const float*>(q), static_cast<const float*>(kn), \
    static_cast<const float*>(vn), static_cast<int8_t*>(k), static_cast<float*>(ks), \
    static_cast<int8_t*>(v), static_cast<float*>(vs), static_cast<const int*>(pos), \
    static_cast<float*>(out), KVH, G, T, S, span, scale, softcap, window, flags & 1, insert
  if (HD == 64) attn_kernel<64><<<grid, NTHREADS, smem, st>>>(K4_ARGS);
  else if (HD == 128) attn_kernel<128><<<grid, NTHREADS, smem, st>>>(K4_ARGS);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef K4_ARGS
  return static_cast<int>(cudaGetLastError());
}
