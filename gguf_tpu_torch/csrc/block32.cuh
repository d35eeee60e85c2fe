// The MMQ tile of the 32-element-block formats, shared by K10
// (mmq_q8_0.cu) and K11 (mmq_legacy.cu).
//
// out (N, M) f32 = x (N, K) . W (M, K)^T, W read from the per-field arrays
// QuantWeight splits the GGUF blocks into (rows keep the GGUF byte order):
//   Q8_0: d fp16 (M, K/32) | qs int8 (M, K)           w = d*q
//   Q4_0: d | qs (M, K/32*16)                         w = d*(q-8)
//   Q4_1: d | m fp16 (M, K/32) | qs                   w = d*q + m
//   Q5_0: d | qh u32 (M, K/32) | qs                   w = d*(q-16)
//   Q5_1: d | m | qh | qs                             w = d*q + m
// Byte j of a legacy block's 16 qs bytes holds element j (low nibble) and
// j+16 (high nibble); bit j of qh is element j's fifth bit.
//
// The legacy formats follow the reference's split product: the staged
// weight is d*q with the RAW code q (no offset), rounded to bf16 under
// "fast" like the activations, and a per-32-block correction
// corr[m] * bsum[n] is added in f32, where corr is m (_1) or -off*d (_0)
// and bsum is the sum of the block's unrounded f32 activations (rounded
// through fp16 under act_quant: Q8_1's s field). Q8_0 has no correction.
//
// Tile: a block of 256 threads owns BM = 64 rows and BN activation rows
// and walks K in KT = 64-element steps (two 32-blocks) as the K-quant
// tiles do (mmq_common.cuh): thread (r, q) decodes the 16 weights
// 32*(q/2) + 16*(q%2) .. +15 of row r into shared memory, the activations
// are staged beside them (one warp per (row n, 32-block), so the block sum
// is a warp reduction of the unrounded values), and every thread
// accumulates a TM x TN micro-tile with f32 FMAs. A K that is a multiple
// of 32 but not of 64 ends on a half step whose missing block is zero.
//
// Split K: at decode widths M/64 x N/BN blocks cannot fill 132 SMs (32
// blocks at M = 2048), so the grid's z axis cuts the K steps into `splits`
// ranges; each writes its partial tile to part[z] and a second launch adds
// them in z order, so the result is the same on every run.
#pragma once

#include "mmq_common.cuh"

namespace block32 {

enum Fmt { Q8_0 = 0, Q4_0 = 1, Q4_1 = 2, Q5_0 = 3, Q5_1 = 4 };

template <int F>
struct Traits {
  static constexpr bool LEGACY = F != Q8_0;
  static constexpr bool AFFINE = F == Q4_1 || F == Q5_1;
  static constexpr bool FIVE = F == Q5_0 || F == Q5_1;
  static constexpr float OFFSET = F == Q4_0 ? 8.f : (F == Q5_0 ? 16.f : 0.f);
};

__device__ __forceinline__ unsigned byte_of(const uint4& v, int i) {
  const unsigned w = i < 4 ? v.x : (i < 8 ? v.y : (i < 12 ? v.z : v.w));
  return (w >> (8 * (i & 3))) & 0xFF;
}

template <int F, int BN, int TM, int TN, bool XBF16>
__device__ __forceinline__ void mmq_tile(
    const __half* __restrict__ dv, const __half* __restrict__ mv,
    const uint32_t* __restrict__ qhv, const uint8_t* __restrict__ qs,
    const void* __restrict__ x, float* __restrict__ out,
    float* __restrict__ part, int M, int N, int K, int fast, int fp16_bsum,
    int steps_per_split) {
  using namespace mmq;
  using T = Traits<F>;
  __shared__ float ws[KT][BM + 1];
  __shared__ float xs[KT][BN + 1];
  __shared__ float cs[2][BM];   // legacy: the correction of each row, block
  __shared__ float bs[2][BN];   // legacy: the activation sum of each n, block
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM), ty = tid / (BM / TM);
  const int r = tid >> 2, b = (tid >> 1) & 1, h = tid & 1;
  const bool row_ok = m0 + r < M;
  const size_t row = row_ok ? m0 + r : 0;
  const int nblk = K / 32;
  const int nsteps = (K + KT - 1) / KT;
  const int s0 = blockIdx.z * steps_per_split;
  const int s1 = min(nsteps, s0 + steps_per_split);
  float acc[TM][TN] = {};

  for (int s = s0; s < s1; ++s) {
    const int j = 2 * s + b;            // this thread's 32-block of row r
    const bool ok = row_ok && j < nblk;
    const size_t blk = row * nblk + j;
    const float d = ok ? __half2float(dv[blk]) : 0.f;
    uint4 c = make_uint4(0, 0, 0, 0);
    unsigned hb = 0;
    if (ok) {
      if constexpr (F == Q8_0) {
        c = *reinterpret_cast<const uint4*>(qs + row * K + 32 * j + 16 * h);
      } else {
        c = *reinterpret_cast<const uint4*>(qs + blk * 16);
        if constexpr (T::FIVE) hb = qhv[blk] >> (16 * h);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int code;
      if constexpr (F == Q8_0) {
        code = static_cast<int>(static_cast<int8_t>(byte_of(c, i)));
      } else {
        code = static_cast<int>((byte_of(c, i) >> (4 * h)) & 0xF);
        if constexpr (T::FIVE) code |= static_cast<int>((hb >> i) & 1) << 4;
      }
      float w = __fmul_rn(d, static_cast<float>(code));   // exact
      if (fast) w = bf16_round(w);
      ws[32 * b + 16 * h + i][r] = w;
    }
    if constexpr (T::LEGACY) {
      if (h == 0) {
        float corr = 0.f;
        if (ok) corr = T::AFFINE ? __half2float(mv[blk]) : __fmul_rn(d, -T::OFFSET);
        cs[b][r] = corr;
      }
    }
    // stage x[n0 .. n0+BN) x [k0 .. k0+KT): the 32 lanes of a warp hold
    // one (n, 32-block) in every pass, since BN*KT is a multiple of 256
    const int k0 = s * KT;
    for (int e = tid; e < BN * KT; e += NTHREADS) {
      const int n = e / KT, kk = e % KT;
      float v = 0.f;
      if (n0 + n < N && k0 + kk < K)
        v = load_x<XBF16>(x, static_cast<size_t>(n0 + n) * K + k0 + kk);
      if constexpr (T::LEGACY) {
        float sum = v;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if ((kk & 31) == 0)
          bs[kk >> 5][n] = fp16_bsum ? __half2float(__float2half_rn(sum)) : sum;
      }
      xs[kk][n] = fast ? bf16_round(v) : v;
    }
    __syncthreads();
    fma_tile<BN, TM, TN>(ws, xs, acc, tx, ty);
    if constexpr (T::LEGACY) {
      constexpr int TX = BM / TM, TY = BN / TN;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          const int mm = tx + TX * i, nn = ty + TY * jj;
          acc[i][jj] = fmaf(cs[0][mm], bs[0][nn], acc[i][jj]);
          acc[i][jj] = fmaf(cs[1][mm], bs[1][nn], acc[i][jj]);
        }
    }
    __syncthreads();
  }
  float* dst = gridDim.z > 1 ? part + static_cast<size_t>(blockIdx.z) * N * M : out;
  store_tile<BN, TM, TN>(dst, acc, M, N, m0, n0, tx, ty);
}

// out[i] = part[0][i] + part[1][i] + ... in split order
__global__ void __launch_bounds__(256)
add_splits(const float* __restrict__ part, float* __restrict__ out, int splits,
           size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int z = 1; z < splits; ++z) s += part[static_cast<size_t>(z) * total + i];
  out[i] = s;
}

}  // namespace block32

// Instantiate and launch KERNEL<BN, TM, TN, XBF16> over a (M/64, N/BN,
// splits) grid, then the split sum when splits > 1; the caller returns
// cudaGetLastError().
#define BLOCK32_DISPATCH(KERNEL, M, N, splits, x_bf16, stream, out, part, ...) \
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
      block32::add_splits<<<static_cast<unsigned>((total + 255) / 256), 256, 0, \
                            stream>>>(                                        \
          part, out, (splits), total);                                         \
    }                                                                          \
  } while (0)
