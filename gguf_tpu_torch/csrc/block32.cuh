// The SIMT MMQ tile of the 32-element-block formats under "high" (f32
// operands and products), shared by K10 (mmq_q8_0.cu), K11
// (mmq_legacy.cu) and K14 (mmq_iq4.cu); their "fast" arms run the
// tensor-core tile of block32_tc.cuh.
//
// out (N, M) f32 = x (N, K) . W (M, K)^T, W read from the per-field arrays
// QuantWeight splits the GGUF blocks into (rows keep the GGUF byte order):
//   Q8_0: d fp16 (M, K/32) | qs int8 (M, K)           w = d*q
//   Q4_0: d | qs (M, K/32*16)                         w = d*(q-8)
//   Q4_1: d | m fp16 (M, K/32) | qs                   w = d*q + m
//   Q5_0: d | qh u32 (M, K/32) | qs                   w = d*(q-16)
//   Q5_1: d | m | qh | qs                             w = d*q + m
//   IQ4_NL: d | qs                                    w = d*KV[q]
//   IQ4_XS: d fp16 (M, K/256) | scales_h u16 (M, K/256) | scales_l
//           (M, K/256*4) | qs (M, K/32*16)            w = (d*ls)*KV[q]
// Byte j of a block's 16 qs bytes holds element j (low nibble) and j+16
// (high nibble); bit j of qh is element j's fifth bit. KV is the IQ4
// codebook; IQ4_XS's sub-block ib of superblock s has the 6-bit scale
// ls = (nibble ib of scales_l[s] | ((scales_h[s] >> 2*ib) & 3) << 4) - 32,
// and its 16 code bytes sit where an IQ4_NL block's would, at 16*(8s+ib).
//
// The legacy formats follow the reference's split product: the staged
// weight is d*q with the RAW code q (no offset), and a per-32-block
// correction
// corr[m] * bsum[n] is added in f32, where corr is m (_1) or -off*d (_0)
// and bsum is the sum of the block's unrounded f32 activations (rounded
// through fp16 under act_quant: Q8_1's s field). Q8_0 and the IQ4 formats
// (symmetric: the codebook carries the sign) have no correction.
//
// Tile: a block of 256 threads owns BM = 64 rows and BN activation rows
// and walks K in KT = 64-element steps (two 32-blocks) as the K-quant
// tiles do (mmq_common.cuh): thread (r, q) decodes the 16 weights
// 32*(q/2) + 16*(q%2) .. +15 of row r into shared memory, the activations
// are staged beside them (one warp per (row n, 32-block), so the block sum
// is a warp reduction of the unrounded values), and every thread
// accumulates a TM x TN micro-tile with f32 FMAs. A K that is a multiple
// of 32 but not of 64 ends on a half step whose missing block is zero.
// K is cut across the grid's z axis at decode widths (MMQ_SPLIT_DISPATCH).
#pragma once

#include "mmq_common.cuh"

namespace block32 {

enum Fmt { Q8_0 = 0, Q4_0 = 1, Q4_1 = 2, Q5_0 = 3, Q5_1 = 4, IQ4_NL = 5,
           IQ4_XS = 6 };

template <int F>
struct Traits {
  static constexpr bool LEGACY = F >= Q4_0 && F <= Q5_1;
  static constexpr bool AFFINE = F == Q4_1 || F == Q5_1;
  static constexpr bool FIVE = F == Q5_0 || F == Q5_1;
  static constexpr bool IQ4 = F == IQ4_NL || F == IQ4_XS;
  static constexpr float OFFSET = F == Q4_0 ? 8.f : (F == Q5_0 ? 16.f : 0.f);
};

// KV[q] of the IQ4 codebook (ggml's kvalues_iq4nl: -127, -104, -83, -65,
// -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113) as int8 bytes packed
// little-endian into four words: one byte permute picks the entry, with no
// table in memory and no divergent loads.
__device__ __forceinline__ int iq4_value(unsigned q) {
  const unsigned v = (q & 8) ? __byte_perm(0x26190D01u, 0x71594535u, q & 7)
                             : __byte_perm(0xBFAD9881u, 0xF6EADDCFu, q & 7);
  return static_cast<int>(static_cast<int8_t>(v & 0xFF));
}

__device__ __forceinline__ unsigned byte_of(const uint4& v, int i) {
  const unsigned w = i < 4 ? v.x : (i < 8 ? v.y : (i < 12 ? v.z : v.w));
  return (w >> (8 * (i & 3))) & 0xFF;
}

// mv: Q4_1/Q5_1 m, or IQ4_XS scales_h; qhv: Q5_0/Q5_1 qh, or IQ4_XS
// scales_l (null where the format has no such field)
template <int F, int BN, int TM, int TN, bool XBF16>
__device__ __forceinline__ void mmq_tile(
    const __half* __restrict__ dv, const void* __restrict__ mv,
    const void* __restrict__ qhv, const uint8_t* __restrict__ qs,
    const void* __restrict__ x, float* __restrict__ out,
    float* __restrict__ part, int M, int N, int K, int fp16_bsum,
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
    float d = 0.f;
    uint4 c = make_uint4(0, 0, 0, 0);
    unsigned hb = 0;
    if (ok) {
      if constexpr (F == IQ4_XS) {   // K % 256 == 0: superblock blk / 8
        const size_t sbk = blk >> 3;
        const int ib = j & 7;
        const unsigned sh = static_cast<const uint16_t*>(mv)[sbk];
        const unsigned sl = static_cast<const uint8_t*>(qhv)[sbk * 4 + (ib >> 1)];
        const int ls = static_cast<int>(((sl >> (4 * (ib & 1))) & 0xF) |
                                        (((sh >> (2 * ib)) & 3) << 4)) - 32;
        d = __fmul_rn(__half2float(dv[sbk]), static_cast<float>(ls));
      } else {
        d = __half2float(dv[blk]);
      }
      if constexpr (F == Q8_0) {
        c = *reinterpret_cast<const uint4*>(qs + row * K + 32 * j + 16 * h);
      } else {
        c = *reinterpret_cast<const uint4*>(qs + blk * 16);
        if constexpr (T::FIVE) hb = static_cast<const uint32_t*>(qhv)[blk] >> (16 * h);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int code;
      if constexpr (F == Q8_0) {
        code = static_cast<int>(static_cast<int8_t>(byte_of(c, i)));
      } else if constexpr (T::IQ4) {
        code = iq4_value((byte_of(c, i) >> (4 * h)) & 0xF);
      } else {
        code = static_cast<int>((byte_of(c, i) >> (4 * h)) & 0xF);
        if constexpr (T::FIVE) code |= static_cast<int>((hb >> i) & 1) << 4;
      }
      ws[32 * b + 16 * h + i][r] = __fmul_rn(d, static_cast<float>(code));   // exact
    }
    if constexpr (T::LEGACY) {
      if (h == 0) {
        float corr = 0.f;
        if (ok) {
          corr = T::AFFINE ? __half2float(static_cast<const __half*>(mv)[blk])
                           : __fmul_rn(d, -T::OFFSET);
        }
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
      xs[kk][n] = v;
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

}  // namespace block32
