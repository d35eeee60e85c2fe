// K5 quantize_q8_1_codes and K6 fake_quantize_q8_1: Q8_1 activation
// quantization, one warp per 32-element block; K15 rms_norm, one block per
// row.
//
// Replaces gguf_tpu/ops/activation.py:_codes_kernel (K5: int8 codes, d and
// s = fp16(d * sum(q)) per block) and :_fq_kernel (K6: the f32 round trip
// q * d). The TPU kernels transpose the (n, K) tile so the 32-blocks lie
// on sublanes; here lane i of a warp owns element i of one block, so the
// block max and the code sum are two warp shuffles reductions and every
// load and store is coalesced.
//
// What bounds it on an H100: bytes. It reads the activations once (4 or 2
// bytes per element, 8 with the GLU's gate and up) and writes 1 (K5) or 4
// (K6) bytes per element; at decode widths (n <= 16, K <= 5632) that is
// under 0.5 MB, so launch latency is what it costs.
//
// Numerics: every fp16 rounding point of the JAX package, made with
// __float2half_rn (round to nearest even), IEEE division (no fast-math),
// rintf (half to even). d = fp16(amax / 127) by division; XLA may compile
// the division by the constant as a product with f32(1/127), but after the
// fp16 rounding both give the same d for every fp16 amax.
// With glu the element is h = act(gate) * up in f32, as mmq_q4_k's
// act_quant route computes it, not rounded to bf16.
//
// K15 replaces gguf_tpu/ops/activation.py:_rmsnorm_kernel (reached through
// rms_norm_pallas, which the JAX package does not route from its model):
// out (n, d) f32 = x * rsqrt(mean(x^2) + eps) * w for x in f32, bf16 or
// fp16. The TPU kernel is one block over the whole (n, d) tile; here one
// block of 256 threads owns a row, sums its squares with warp shuffles and
// one pass through shared memory, and scales it. Bytes bound it (one read
// of x, one f32 write); at decode widths launch latency is what it costs.
// rsqrtf may differ from the reference's rsqrt by an ulp.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mmq_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ float fp16_round(float v) {
  return __half2float(__float2half_rn(v));
}

// One warp per (row, 32-block): returns this lane's code and the block's
// d (and s through `s_out`).
template <bool XBF16>
__device__ __forceinline__ float q8_1_lane(const void* x, int ldx, int K,
                                           int row, int blk, int glu,
                                           float& d_out, float& s_out) {
  const int lane = threadIdx.x & 31;
  const size_t i = static_cast<size_t>(row) * ldx + blk * 32 + lane;
  float h;
  if (glu) {
    h = mmq::glu_act(mmq::load_x<XBF16>(x, i), glu) * mmq::load_x<XBF16>(x, i + K);
  } else {
    h = mmq::load_x<XBF16>(x, i);
  }
  const float g = fp16_round(h);
  float amax = fabsf(g);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
  const float d = fp16_round(amax / 127.0f);
  const float d_safe = d == 0.f ? 1.f : d;
  const float q = fminf(fmaxf(rintf(fp16_round(g / d_safe)), -127.f), 127.f);
  int sum = static_cast<int>(q);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
  d_out = d;
  s_out = fp16_round(__fmul_rn(d, static_cast<float>(sum)));
  return q;
}

template <bool XBF16>
__global__ void __launch_bounds__(32 * WARPS)
quantize_q8_1_kernel(const void* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ d, float* __restrict__ s, int N,
                     int K, int ldx, int glu) {
  const int nb = K / 32;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= N * nb) return;                 // whole warps leave together
  const int row = b / nb, blk = b % nb;
  float dv, sv;
  const float qv = q8_1_lane<XBF16>(x, ldx, K, row, blk, glu, dv, sv);
  q[static_cast<size_t>(row) * K + blk * 32 + (threadIdx.x & 31)] =
      static_cast<int8_t>(qv);
  if ((threadIdx.x & 31) == 0) {
    d[b] = dv;
    s[b] = sv;
  }
}

template <bool XBF16>
__global__ void __launch_bounds__(32 * WARPS)
fake_quantize_q8_1_kernel(const void* __restrict__ x, float* __restrict__ out,
                          int N, int K, int ldx, int glu) {
  const int nb = K / 32;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= N * nb) return;
  const int row = b / nb, blk = b % nb;
  float dv, sv;
  const float qv = q8_1_lane<XBF16>(x, ldx, K, row, blk, glu, dv, sv);
  out[static_cast<size_t>(row) * K + blk * 32 + (threadIdx.x & 31)] =
      __fmul_rn(qv, dv);
}

int grid_for(int N, int K) { return (N * (K / 32) + WARPS - 1) / WARPS; }

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) return __bfloat162float(v);
  else if constexpr (std::is_same_v<T, __half>) return __half2float(v);
  else return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int D, float eps) {
  __shared__ float part[WARPS];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += 32 * WARPS) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) total += part[i];
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(D)), eps));
  float* o = out + static_cast<size_t>(blockIdx.x) * D;
  for (int i = threadIdx.x; i < D; i += 32 * WARPS)
    o[i] = __fmul_rn(__fmul_rn(to_f32(xr[i]), r), w[i]);
}

}  // namespace

// x: (N, ldx) f32 or bf16 (ldx = K, or 2K = [gate | up] with glu 1/2 =
// silu/gelu); q: (N, K) int8; d, s: (N, K/32) f32.
extern "C" int quantize_q8_1_launch(const void* x, void* q, void* d, void* s,
                                    int N, int K, int ldx, int x_bf16, int glu,
                                    void* stream) {
  if (K % 32 != 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_for(N, K)), block(32 * WARPS);
  auto* qp = static_cast<int8_t*>(q);
  auto* dp = static_cast<float*>(d);
  auto* sp = static_cast<float*>(s);
  if (x_bf16) quantize_q8_1_kernel<true><<<grid, block, 0, st>>>(x, qp, dp, sp, N, K, ldx, glu);
  else quantize_q8_1_kernel<false><<<grid, block, 0, st>>>(x, qp, dp, sp, N, K, ldx, glu);
  return static_cast<int>(cudaGetLastError());
}

// out: (N, K) f32 = q * d of the same blocks.
extern "C" int fake_quantize_q8_1_launch(const void* x, void* out, int N, int K,
                                         int ldx, int x_bf16, int glu,
                                         void* stream) {
  if (K % 32 != 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_for(N, K)), block(32 * WARPS);
  auto* op = static_cast<float*>(out);
  if (x_bf16) fake_quantize_q8_1_kernel<true><<<grid, block, 0, st>>>(x, op, N, K, ldx, glu);
  else fake_quantize_q8_1_kernel<false><<<grid, block, 0, st>>>(x, op, N, K, ldx, glu);
  return static_cast<int>(cudaGetLastError());
}

// x: (N, D) of dtype 0 f32, 1 bf16, 2 fp16; w: (D,) f32; out: (N, D) f32.
extern "C" int rms_norm_launch(const void* x, const void* w, void* out, int N,
                               int D, int dtype, float eps, void* stream) {
  if (N <= 0 || D <= 0 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N), block(32 * WARPS);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  if (dtype == 1) {
    rms_norm_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wp, op, D, eps);
  } else if (dtype == 2) {
    rms_norm_kernel<__half><<<grid, block, 0, st>>>(
        static_cast<const __half*>(x), wp, op, D, eps);
  } else {
    rms_norm_kernel<float><<<grid, block, 0, st>>>(static_cast<const float*>(x),
                                                   wp, op, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
