// K11: fused dequantize + matmul for the legacy 32-element-block formats
// Q4_0, Q4_1, Q5_0 and Q5_1 (any N, K a multiple of 32; the wrapper keeps
// the reference's K % 256), the format a template parameter.
//
// Replaces gguf_tpu/ops/mmq_legacy.py:_kernel (decode and prefill widths),
// reached through mmq_q4_0 .. mmq_q5_1. The TPU's 256-group nibble repack
// and bit planes have no counterpart: this kernel reads the d, m, qh and
// qs fields of the GGUF blocks as stored. It keeps the reference's split
// product (block32.cuh): b . (d*q_raw)^T with bf16 operands under "fast",
// plus the f32 per-32-block correction bsum . corr^T against the sums of
// the unrounded activations (fp16-rounded under act_quant).
//
// What bounds it on an H100: the weight stream at decode widths (0.5625 to
// 0.75 B per weight), the SIMT f32 FMAs at prefill widths. Same design as
// K10 (mmq_q8_0.cu): K1's tile, K cut across the grid when M/64 blocks
// cannot fill the card, one 16-byte load per thread and block for the
// codes; the block sums come from a warp reduction of the staged
// activations, so there is no extra pass over x.

#include "block32.cuh"

namespace {

// one kernel name per format, so that MMQ_SPLIT_DISPATCH can add the tile
// shape's template arguments
#define LEGACY_KERNEL(NAME, FMT)                                               \
  template <int BN, int TM, int TN, bool XBF16>                                \
  __global__ void __launch_bounds__(mmq::NTHREADS)                             \
  NAME(const __half* __restrict__ d, const __half* __restrict__ m,             \
       const uint32_t* __restrict__ qh, const uint8_t* __restrict__ qs,        \
       const void* __restrict__ x, float* __restrict__ out,                    \
       float* __restrict__ part, int M, int N, int K, int fast, int fp16_bsum, \
       int steps_per_split) {                                                  \
    block32::mmq_tile<FMT, BN, TM, TN, XBF16>(d, m, qh, qs, x, out, part, M,   \
                                              N, K, fast, fp16_bsum,           \
                                              steps_per_split);                \
  }

LEGACY_KERNEL(mmq_q4_0_kernel, block32::Q4_0)
LEGACY_KERNEL(mmq_q4_1_kernel, block32::Q4_1)
LEGACY_KERNEL(mmq_q5_0_kernel, block32::Q5_0)
LEGACY_KERNEL(mmq_q5_1_kernel, block32::Q5_1)

}  // namespace

// fmt: 1 q4_0, 2 q4_1, 3 q5_0, 4 q5_1 (block32::Fmt). d, m: (M, K/32)
// fp16 (m null for the _0 formats); qh: (M, K/32) u32 (null for q4_*);
// qs: (M, K/32*16) bytes, 16-byte aligned; x: (N, K) f32 or bf16; out:
// (N, M) f32; part: (splits, N, M) f32 scratch when splits > 1.
// fp16_bsum rounds the block sums through fp16 (act_quant).
extern "C" int mmq_legacy_launch(const void* d, const void* m, const void* qh,
                                 const void* qs, const void* x, void* out,
                                 void* part, int fmt, int fp16_bsum, int M,
                                 int N, int K, int x_bf16, int fast,
                                 int splits, int steps_per_split,
                                 void* stream) {
  if (K % 32 != 0 || M <= 0 || N <= 0 || splits < 1 || steps_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool affine = fmt == block32::Q4_1 || fmt == block32::Q5_1;
  const bool five = fmt == block32::Q5_0 || fmt == block32::Q5_1;
  if (fmt < block32::Q4_0 || fmt > block32::Q5_1 || (affine && !m) ||
      (five && !qh))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __half* dp = static_cast<const __half*>(d);
  const __half* mp = static_cast<const __half*>(m);
  const uint32_t* hp = static_cast<const uint32_t*>(qh);
  const uint8_t* qp = static_cast<const uint8_t*>(qs);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  switch (fmt) {
    case block32::Q4_0:
      MMQ_SPLIT_DISPATCH(mmq_q4_0_kernel, M, N, splits, x_bf16, st, o, p, dp, mp,
                       hp, qp, x, o, p, M, N, K, fast, fp16_bsum,
                       steps_per_split);
      break;
    case block32::Q4_1:
      MMQ_SPLIT_DISPATCH(mmq_q4_1_kernel, M, N, splits, x_bf16, st, o, p, dp, mp,
                       hp, qp, x, o, p, M, N, K, fast, fp16_bsum,
                       steps_per_split);
      break;
    case block32::Q5_0:
      MMQ_SPLIT_DISPATCH(mmq_q5_0_kernel, M, N, splits, x_bf16, st, o, p, dp, mp,
                       hp, qp, x, o, p, M, N, K, fast, fp16_bsum,
                       steps_per_split);
      break;
    default:
      MMQ_SPLIT_DISPATCH(mmq_q5_1_kernel, M, N, splits, x_bf16, st, o, p, dp, mp,
                       hp, qp, x, o, p, M, N, K, fast, fp16_bsum,
                       steps_per_split);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
