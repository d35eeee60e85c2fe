// K1: fused Q4_K dequantize + matmul (any N), optional GLU prologue.
//
// Replaces gguf_tpu/ops/mmq_q4_k.py:_kernel_ink (decode widths, with the
// glu prologue) and :_kernel (prefill widths), both reached through
// mmq_q4_k. It reads the 144-byte GGUF blocks as stored — fp16 d, fp16
// dmin, 12 bytes of packed 6-bit scales/mins, 128 bytes of nibbles — so
// the TPU's plane permutation and 0/1 glue matmuls have no counterpart.
//
// What bounds it on an H100: the weight stream (0.5625 B per weight) is
// the floor at decode widths, but this first version sits far above it:
// each block walks K in 64-element steps, and every step is a serial
// chain (global loads, dequantize into shared memory, barrier, SIMT FMAs,
// barrier) measured at 2.7-3.5 us, while M/64 blocks (32 at M = 2048)
// cannot fill 132 SMs. At prefill widths the f32 FMAs of the tile loop
// bound it. The design keeps every load coalesced (a row's 16-byte header
// and 8-byte nibble runs fill 32-byte sectors) and shared memory free of
// bank conflicts; split-K or a pipelined K loop, then wgmma tiles fed by
// TMA, are the later fixes.
//
// Dequantization follows the codec's op order exactly:
// w = (d*sc)*q - dmin*mn with every product rounded (no FMA contraction),
// so an unrounded "high" weight is bit-equal to gguf_tpu's dequantize.

#include "mmq_common.cuh"

namespace {

using namespace mmq;

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

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(NTHREADS)
mmq_q4_k_kernel(const uint8_t* __restrict__ w, const void* __restrict__ x,
                float* __restrict__ out, int M, int N, int K, int ldx,
                int glu, int fast) {
  __shared__ float ws[KT][BM + 1];
  __shared__ float xs[KT][BN + 1];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM), ty = tid / (BM / TM);
  // dequant role: row r of the tile, quarter q of each 32-byte nibble run
  const int r = tid >> 2, q = tid & 3;
  const bool row_ok = m0 + r < M;
  const int nsb = K / 256;
  const uint8_t* wrow = w + static_cast<size_t>(row_ok ? m0 + r : 0) * nsb * 144;
  float acc[TM][TN] = {};

  for (int sb = 0; sb < nsb; ++sb) {
    const uint8_t* blk = wrow + static_cast<size_t>(sb) * 144;
    uint4 h = make_uint4(0, 0, 0, 0);
    if (row_ok) h = *reinterpret_cast<const uint4*>(blk);
    const float d = __half2float(__ushort_as_half(static_cast<unsigned short>(h.x & 0xFFFF)));
    const float dmin = __half2float(__ushort_as_half(static_cast<unsigned short>(h.x >> 16)));
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      // group g: byte 32g+l holds elem 64g+l (low) and 64g+32+l (high)
      int sc0, mn0, sc1, mn1;
      scale_min(h, 2 * g, sc0, mn0);
      scale_min(h, 2 * g + 1, sc1, mn1);
      const float s0 = __fmul_rn(d, static_cast<float>(sc0));
      const float z0 = __fmul_rn(dmin, static_cast<float>(mn0));
      const float s1 = __fmul_rn(d, static_cast<float>(sc1));
      const float z1 = __fmul_rn(dmin, static_cast<float>(mn1));
      uint2 qv = make_uint2(0, 0);
      if (row_ok) qv = *reinterpret_cast<const uint2*>(blk + 16 + 32 * g + 8 * q);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned byte = ((i < 4 ? qv.x : qv.y) >> (8 * (i & 3))) & 0xFF;
        float lo = __fsub_rn(__fmul_rn(s0, static_cast<float>(byte & 0xF)), z0);
        float hi = __fsub_rn(__fmul_rn(s1, static_cast<float>(byte >> 4)), z1);
        if (fast) {
          lo = bf16_round(lo);
          hi = bf16_round(hi);
        }
        ws[8 * q + i][r] = row_ok ? lo : 0.f;
        ws[32 + 8 * q + i][r] = row_ok ? hi : 0.f;
      }
      stage_x<BN, XBF16>(xs, x, ldx, N, K, n0, sb * 256 + 64 * g, glu, fast);
      __syncthreads();
      fma_tile<BN, TM, TN>(ws, xs, acc, tx, ty);
      __syncthreads();
    }
  }
  store_tile<BN, TM, TN>(out, acc, M, N, m0, n0, tx, ty);
}

}  // namespace

// w: (M, K/256*144) GGUF bytes, 16-byte aligned; x: (N, ldx) f32 or bf16
// (ldx = K, or 2K with glu); out: (N, M) f32. glu 0/1/2 = none/silu/gelu.
extern "C" int mmq_q4_k_launch(const void* w, const void* x, void* out, int M,
                               int N, int K, int ldx, int x_bf16, int glu,
                               int fast, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MMQ_DISPATCH(mmq_q4_k_kernel, M, N, x_bf16, st,
               static_cast<const uint8_t*>(w), x, static_cast<float*>(out),
               M, N, K, ldx, glu, fast);
  return static_cast<int>(cudaGetLastError());
}
