// K2: fused Q6_K dequantize + matmul (any N) — the Q4_K_M LM head.
//
// Replaces gguf_tpu/ops/mmq_q6_k.py:_kernel_ink (decode widths) and
// :_kernel (prefill widths), reached through mmq_q6_k. Q6_K's 210-byte
// block (ql 128 | qh 64 | int8 scales 16 | fp16 d) is not 4-byte aligned,
// so the loader splits it into per-field arrays that keep the GGUF byte
// order inside each field; this kernel reads those with aligned 8-byte
// loads. Element value: (d * scale16) * (q - 32), q = ql nibble | qh crumb
// << 4, products rounded in the codec's order (bit-equal dequantize).
//
// What bounds it on an H100: as for K1 (mmq_q4_k.cu) — the weight stream
// (0.82 B per weight) is the floor at decode widths, the serial K-step
// chain of each block is what it measures today; at prefill widths the
// SIMT FMAs of the tile loop. The 32000-row head gives 500 blocks, so
// unlike K1's small projections it fills the card. Tensor-core tiles are
// the later fix.

#include "mmq_common.cuh"

namespace {

using namespace mmq;

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(NTHREADS)
mmq_q6_k_kernel(const uint8_t* __restrict__ ql, const uint8_t* __restrict__ qh,
                const int8_t* __restrict__ sc, const __half* __restrict__ dv,
                const void* __restrict__ x, float* __restrict__ out, int M,
                int N, int K, int ldx, int fast) {
  __shared__ float ws[KT][BM + 1];
  __shared__ float xs[KT][BN + 1];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM), ty = tid / (BM / TM);
  const int r = tid >> 2, q = tid & 3;
  const bool row_ok = m0 + r < M;
  const int nsb = K / 256;
  const size_t row = static_cast<size_t>(row_ok ? m0 + r : 0) * nsb;
  float acc[TM][TN] = {};

  for (int sb = 0; sb < nsb; ++sb) {
    const uint8_t* qlb = ql + (row + sb) * 128;
    const uint8_t* qhb = qh + (row + sb) * 64;
    const int8_t* scb = sc + (row + sb) * 16;
    const float d = row_ok ? __half2float(dv[row + sb]) : 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // step s covers elements 128h + 64p + kk, kk in [0, 64): nibble p of
      // ql byte 64h + kk, crumb 2p + kk/32 of qh byte 32h + kk%32
      const int h = s >> 1, p = s & 1;
      uint2 la = make_uint2(0, 0), lb = make_uint2(0, 0), hv = make_uint2(0, 0);
      float sa = 0.f, sbv = 0.f;
      if (row_ok) {
        la = *reinterpret_cast<const uint2*>(qlb + 64 * h + 8 * q);
        lb = *reinterpret_cast<const uint2*>(qlb + 64 * h + 32 + 8 * q);
        hv = *reinterpret_cast<const uint2*>(qhb + 32 * h + 8 * q);
        sa = __fmul_rn(d, static_cast<float>(scb[8 * h + 4 * p + (q >> 1)]));
        sbv = __fmul_rn(d, static_cast<float>(scb[8 * h + 4 * p + 2 + (q >> 1)]));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int sh = 8 * (i & 3);
        const unsigned a = ((i < 4 ? la.x : la.y) >> sh) & 0xFF;
        const unsigned b = ((i < 4 ? lb.x : lb.y) >> sh) & 0xFF;
        const unsigned c = ((i < 4 ? hv.x : hv.y) >> sh) & 0xFF;
        const int qa = static_cast<int>(((a >> (4 * p)) & 0xF) | (((c >> (4 * p)) & 3) << 4)) - 32;
        const int qb = static_cast<int>(((b >> (4 * p)) & 0xF) | (((c >> (4 * p + 2)) & 3) << 4)) - 32;
        float wa = __fmul_rn(sa, static_cast<float>(qa));
        float wb = __fmul_rn(sbv, static_cast<float>(qb));
        if (fast) {
          wa = bf16_round(wa);
          wb = bf16_round(wb);
        }
        ws[8 * q + i][r] = wa;
        ws[32 + 8 * q + i][r] = wb;
      }
      stage_x<BN, XBF16>(xs, x, ldx, N, K, n0, sb * 256 + 128 * h + 64 * p, 0, fast);
      __syncthreads();
      fma_tile<BN, TM, TN>(ws, xs, acc, tx, ty);
      __syncthreads();
    }
  }
  store_tile<BN, TM, TN>(out, acc, M, N, m0, n0, tx, ty);
}

}  // namespace

// ql (M, K/2), qh (M, K/4), sc (M, K/16) int8, d (M, K/256) fp16: the
// fields of the GGUF blocks; x (N, ldx) f32 or bf16; out (N, M) f32.
extern "C" int mmq_q6_k_launch(const void* ql, const void* qh, const void* sc,
                               const void* d, const void* x, void* out, int M,
                               int N, int K, int ldx, int x_bf16, int fast,
                               void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MMQ_DISPATCH(mmq_q6_k_kernel, M, N, x_bf16, st,
               static_cast<const uint8_t*>(ql), static_cast<const uint8_t*>(qh),
               static_cast<const int8_t*>(sc), static_cast<const __half*>(d), x,
               static_cast<float*>(out), M, N, K, ldx, fast);
  return static_cast<int>(cudaGetLastError());
}
