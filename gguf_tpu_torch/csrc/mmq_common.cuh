// Shared tile machinery of the MMQ kernels (K1 mmq_q4_k.cu, K2
// mmq_q6_k.cu, K8 mmq_q5_k.cu, K12 mmq_q2_k.cu, K13 mmq_q3_k.cu, and the
// block32.cuh tile of K10, K11 and K14).
//
// out (N, M) f32 = x (N, K) . W (M, K)^T with W dequantized from GGUF
// blocks. A block of 256 threads owns BM = 64 output rows m and BN
// activation rows n. It walks K in steps of KT = 64 elements: every step
// dequantizes a (KT x BM) weight tile into shared memory (each thread
// decodes 16 weights of one row), stages the (KT x BN) activation tile
// beside it, and every thread accumulates a TM x TN micro-tile of outputs
// with f32 FMAs. Under "fast" both tiles hold bf16-rounded values, so each
// product is exact in f32 and only the summation order differs from the
// reference's bf16 MXU passes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmq {

constexpr int BM = 64;
constexpr int KT = 64;
constexpr int NTHREADS = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// glu: 1 = silu, 2 = tanh-approximate gelu (jax.nn.gelu(approximate=True))
__device__ __forceinline__ float glu_act(float g, int glu) {
  if (glu == 1) return g / (1.0f + expf(-g));
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
}

template <bool XBF16>
__device__ __forceinline__ float load_x(const void* x, size_t i) {
  if constexpr (XBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

// Stage activations x[n0 .. n0+BN) x [k0 .. k0+KT) into xs[kk][n]. With
// glu the row holds [gate | up] (ldx = 2K) and the operand is
// act(gate) * up in f32, then rounded like any operand.
template <int BN, bool XBF16>
__device__ __forceinline__ void stage_x(float (*xs)[BN + 1], const void* x,
                                        int ldx, int N, int K, int n0, int k0,
                                        int glu, int fast) {
  for (int e = threadIdx.x; e < BN * KT; e += NTHREADS) {
    const int n = e / KT, kk = e % KT;
    float v = 0.f;
    if (n0 + n < N) {
      const size_t row = static_cast<size_t>(n0 + n) * ldx + k0 + kk;
      if (glu) {
        v = glu_act(load_x<XBF16>(x, row), glu) * load_x<XBF16>(x, row + K);
      } else {
        v = load_x<XBF16>(x, row);
      }
      if (fast) v = bf16_round(v);
    }
    xs[kk][n] = v;
  }
}

// One KT step of the TM x TN register micro-tile. Thread (tx, ty) owns
// outputs m = tx + TX*i, n = ty + TY*j: consecutive threads read
// consecutive shared-memory words (no bank conflicts).
template <int BN, int TM, int TN>
__device__ __forceinline__ void fma_tile(float (*ws)[BM + 1],
                                         float (*xs)[BN + 1],
                                         float (&acc)[TM][TN], int tx, int ty) {
  constexpr int TX = BM / TM, TY = BN / TN;
#pragma unroll 16
  for (int kk = 0; kk < KT; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = ws[kk][tx + TX * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = xs[kk][ty + TY * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int BN, int TM, int TN>
__device__ __forceinline__ void store_tile(float* out, const float (&acc)[TM][TN],
                                           int M, int N, int m0, int n0,
                                           int tx, int ty) {
  constexpr int TX = BM / TM, TY = BN / TN;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + tx + TX * i, n = n0 + ty + TY * j;
      if (m < M && n < N) out[static_cast<size_t>(n) * M + m] = acc[i][j];
    }
}

// out[i] = part[0][i] + part[1][i] + ... in split order: the second launch
// of a kernel whose grid cut K into ranges (MMQ_SPLIT_DISPATCH)
__global__ void __launch_bounds__(256)
add_splits(const float* __restrict__ part, float* __restrict__ out, int splits,
           size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int z = 1; z < splits; ++z) s += part[static_cast<size_t>(z) * total + i];
  out[i] = s;
}

}  // namespace mmq

// Instantiate and launch a kernel template KERNEL<BN, TM, TN, XBF16> with
// the tile shape picked from N: decode widths waste less work on a
// narrower N tile. Returns cudaGetLastError() of the launch.
#define MMQ_DISPATCH(KERNEL, M, N, x_bf16, stream, ...)                        \
  do {                                                                         \
    const dim3 block(mmq::NTHREADS);                                           \
    const int gx = ((M) + mmq::BM - 1) / mmq::BM;                              \
    if ((N) <= 8) {                                                            \
      const dim3 grid(gx, ((N) + 7) / 8);                                      \
      if (x_bf16) KERNEL<8, 2, 1, true><<<grid, block, 0, stream>>>(__VA_ARGS__); \
      else KERNEL<8, 2, 1, false><<<grid, block, 0, stream>>>(__VA_ARGS__);   \
    } else if ((N) <= 16) {                                                    \
      const dim3 grid(gx, ((N) + 15) / 16);                                    \
      if (x_bf16) KERNEL<16, 2, 2, true><<<grid, block, 0, stream>>>(__VA_ARGS__); \
      else KERNEL<16, 2, 2, false><<<grid, block, 0, stream>>>(__VA_ARGS__);  \
    } else {                                                                   \
      const dim3 grid(gx, ((N) + 63) / 64);                                    \
      if (x_bf16) KERNEL<64, 4, 4, true><<<grid, block, 0, stream>>>(__VA_ARGS__); \
      else KERNEL<64, 4, 4, false><<<grid, block, 0, stream>>>(__VA_ARGS__);  \
    }                                                                          \
  } while (0)

// Split K: at decode widths M/64 x N/BN blocks cannot fill 132 SMs (32
// blocks at M = 2048), so the grid's z axis cuts the K steps into `splits`
// ranges; each block writes its partial tile to part[z] and a second launch
// adds them in z order, so the result is the same on every run. Instantiate
// and launch KERNEL<BN, TM, TN, XBF16> over a (M/64, N/BN, splits) grid,
// then the split sum when splits > 1; the caller returns
// cudaGetLastError().
#define MMQ_SPLIT_DISPATCH(KERNEL, M, N, splits, x_bf16, stream, out, part, ...) \
  do {                                                                         \
    const dim3 block(mmq::NTHREADS);                                           \
    const int gx = ((M) + mmq::BM - 1) / mmq::BM;                              \
    if ((N) <= 8) {                                                            \
      const dim3 grid(gx, ((N) + 7) / 8, (splits));                            \
      if (x_bf16) KERNEL<8, 2, 1, true><<<grid, block, 0, stream>>>(__VA_ARGS__); \
      else KERNEL<8, 2, 1, false><<<grid, block, 0, stream>>>(__VA_ARGS__);   \
    } else if ((N) <= 16) {                                                    \
      const dim3 grid(gx, ((N) + 15) / 16, (splits));                          \
      if (x_bf16) KERNEL<16, 2, 2, true><<<grid, block, 0, stream>>>(__VA_ARGS__); \
      else KERNEL<16, 2, 2, false><<<grid, block, 0, stream>>>(__VA_ARGS__);  \
    } else {                                                                   \
      const dim3 grid(gx, ((N) + 63) / 64, (splits));                          \
      if (x_bf16) KERNEL<64, 4, 4, true><<<grid, block, 0, stream>>>(__VA_ARGS__); \
      else KERNEL<64, 4, 4, false><<<grid, block, 0, stream>>>(__VA_ARGS__);  \
    }                                                                          \
    if ((splits) > 1) {                                                        \
      const size_t total = static_cast<size_t>(N) * (M);                       \
      mmq::add_splits<<<static_cast<unsigned>((total + 255) / 256), 256, 0,    \
                        stream>>>(part, out, (splits), total);                 \
    }                                                                          \
  } while (0)
