// Q4_K and Q5_K superblocks as stored in GGUF, shared by K1 (mmq_q4_k.cu),
// K8 (mmq_q5_k.cu) and K7 (mmq_i8.cu).
//
// Q4_K, 144 bytes: fp16 d | fp16 dmin | 12 bytes of packed 6-bit
//   scales/mins | 128 bytes of nibbles.
// Q5_K, 176 bytes: the same 16-byte header | 32 bytes qh | 128 bytes of
//   nibbles; bit 2g+h of qh byte l is the fifth bit of element 64g+32h+l.
// Nibble byte 32g+l holds element 64g+l (low) and 64g+32+l (high), so
// 32-block b = 2g+h takes nibble h of bytes 32g .. 32g+31. Element value:
// (d*sc[b]) * q - dmin*mn[b], q in [0, 16) or [0, 32).
#pragma once

#include "mmq_common.cuh"

namespace kquant {

template <bool HAS_QH>
struct Layout {
  static constexpr int BYTES = HAS_QH ? 176 : 144;
  static constexpr int QS = HAS_QH ? 48 : 16;   // first nibble byte
  static constexpr int QH = 16;                 // first qh byte (Q5_K)
};

// 6-bit scale/min j (0..7) from the 12 packed bytes held in h.y, h.z, h.w
__device__ __forceinline__ int scale_byte(const uint4& h, int i) {
  const unsigned w = i < 4 ? h.y : (i < 8 ? h.z : h.w);
  return (w >> (8 * (i & 3))) & 0xFF;
}

__device__ __forceinline__ void scale_min(const uint4& h, int j, int& sc,
                                          int& mn) {
  if (j < 4) {
    sc = scale_byte(h, j) & 63;
    mn = scale_byte(h, j + 4) & 63;
  } else {
    sc = (scale_byte(h, j + 4) & 0xF) | ((scale_byte(h, j - 4) >> 6) << 4);
    mn = (scale_byte(h, j + 4) >> 4) | ((scale_byte(h, j) >> 6) << 4);
  }
}

__device__ __forceinline__ float half_lo(unsigned v) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(v & 0xFFFF)));
}

__device__ __forceinline__ float half_hi(unsigned v) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(v >> 16)));
}

// The SIMT MMQ tile of K1 and K8 under "high" (f32 operands and products;
// "fast" runs kquant_tc.cuh): out (N, M) f32 = x (N, K) . W (M, K)^T.
// A block of 256 threads owns BM = 64 rows and BN activation rows and walks
// K in 64-element steps (mmq_common.cuh). Thread (r, q) decodes bytes
// 8q .. 8q+7 of each 32-byte nibble run of row r: 8 low-nibble elements of
// block 2g and 8 high-nibble elements of block 2g+1, and for Q5_K their
// fifth bits from qh bytes 8q .. 8q+7 (loaded once per superblock).
// Products are rounded in the codec's order (no FMA contraction), so an
// unrounded "high" weight is bit-equal to gguf_tpu's dequantize.
template <bool HAS_QH, int BN, int TM, int TN, bool XBF16>
__device__ __forceinline__ void mmq_tile(const uint8_t* __restrict__ w,
                                         const void* __restrict__ x,
                                         float* __restrict__ out, int M, int N,
                                         int K, int ldx, int glu) {
  using namespace mmq;
  using L = Layout<HAS_QH>;
  __shared__ float ws[KT][BM + 1];
  __shared__ float xs[KT][BN + 1];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM), ty = tid / (BM / TM);
  const int r = tid >> 2, q = tid & 3;
  const bool row_ok = m0 + r < M;
  const int nsb = K / 256;
  const uint8_t* wrow = w + static_cast<size_t>(row_ok ? m0 + r : 0) * nsb * L::BYTES;
  float acc[TM][TN] = {};

  for (int sb = 0; sb < nsb; ++sb) {
    const uint8_t* blk = wrow + static_cast<size_t>(sb) * L::BYTES;
    uint4 h = make_uint4(0, 0, 0, 0);
    uint2 hv = make_uint2(0, 0);
    if (row_ok) {
      h = *reinterpret_cast<const uint4*>(blk);
      if constexpr (HAS_QH) hv = *reinterpret_cast<const uint2*>(blk + L::QH + 8 * q);
    }
    const float d = half_lo(h.x), dmin = half_hi(h.x);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      int sc0, mn0, sc1, mn1;
      scale_min(h, 2 * g, sc0, mn0);
      scale_min(h, 2 * g + 1, sc1, mn1);
      const float s0 = __fmul_rn(d, static_cast<float>(sc0));
      const float z0 = __fmul_rn(dmin, static_cast<float>(mn0));
      const float s1 = __fmul_rn(d, static_cast<float>(sc1));
      const float z1 = __fmul_rn(dmin, static_cast<float>(mn1));
      uint2 qv = make_uint2(0, 0);
      if (row_ok) qv = *reinterpret_cast<const uint2*>(blk + L::QS + 32 * g + 8 * q);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int sh = 8 * (i & 3);
        const unsigned byte = ((i < 4 ? qv.x : qv.y) >> sh) & 0xFF;
        unsigned lo = byte & 0xF, hi = byte >> 4;
        if constexpr (HAS_QH) {
          const unsigned hb = ((i < 4 ? hv.x : hv.y) >> sh) & 0xFF;
          lo |= ((hb >> (2 * g)) & 1) << 4;
          hi |= ((hb >> (2 * g + 1)) & 1) << 4;
        }
        const float wl = __fsub_rn(__fmul_rn(s0, static_cast<float>(lo)), z0);
        const float wh = __fsub_rn(__fmul_rn(s1, static_cast<float>(hi)), z1);
        ws[8 * q + i][r] = row_ok ? wl : 0.f;
        ws[32 + 8 * q + i][r] = row_ok ? wh : 0.f;
      }
      stage_x<BN, XBF16>(xs, x, ldx, N, K, n0, sb * 256 + 64 * g, glu, 0);
      __syncthreads();
      fma_tile<BN, TM, TN>(ws, xs, acc, tx, ty);
      __syncthreads();
    }
  }
  store_tile<BN, TM, TN>(out, acc, M, N, m0, n0, tx, ty);
}

}  // namespace kquant
