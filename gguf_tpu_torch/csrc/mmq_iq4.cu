// K14: fused dequantize + matmul for the IQ4 codebook formats IQ4_NL and
// IQ4_XS (any N, K a multiple of 256).
//
// Replaces gguf_tpu/ops/mmq_iq4.py:_kernel (decode and prefill widths),
// reached through mmq_iq4_nl and mmq_iq4_xs. The TPU kernel packs the
// codebook into four int32 constants because a 16-entry gather serializes
// there; here the same four words feed one byte permute per code
// (block32.cuh: iq4_value), and the TPU's 256-group nibble repack has no
// counterpart: the kernel reads the d, scales and qs fields of the GGUF
// blocks as stored. Element value d*KV[q] (IQ4_NL) or (d*ls)*KV[q]
// (IQ4_XS), exact in f32; both formats are symmetric, so there is no
// correction term. Under "fast" both w and the activations are rounded to
// bf16 before the f32-accumulated product.
//
// Why the block32 tile: an IQ4_NL block has Q4_0's byte layout (fp16 d,
// 16 code bytes, element j low and j+16 high) and an IQ4_XS superblock is
// eight such code runs under one d with a 6-bit scale each, so both are
// another Fmt of the tile K10 and K11 share, with its split K and its
// 16-byte code loads; only the scale and the code-to-value step differ.
//
// What bounds it on an H100: the weight stream (0.5625 B per weight for
// IQ4_NL, 0.53125 for IQ4_XS) at decode widths, the SIMT f32 FMAs at
// prefill widths, as for K10/K11.

#include "block32.cuh"

namespace {

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_iq4_nl_kernel(const __half* __restrict__ d, const uint8_t* __restrict__ qs,
                  const void* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ part, int M, int N, int K, int fast,
                  int steps_per_split) {
  block32::mmq_tile<block32::IQ4_NL, BN, TM, TN, XBF16>(
      d, nullptr, nullptr, qs, x, out, part, M, N, K, fast, 0,
      steps_per_split);
}

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_iq4_xs_kernel(const __half* __restrict__ d,
                  const uint16_t* __restrict__ scales_h,
                  const uint8_t* __restrict__ scales_l,
                  const uint8_t* __restrict__ qs, const void* __restrict__ x,
                  float* __restrict__ out, float* __restrict__ part, int M,
                  int N, int K, int fast, int steps_per_split) {
  block32::mmq_tile<block32::IQ4_XS, BN, TM, TN, XBF16>(
      d, scales_h, scales_l, qs, x, out, part, M, N, K, fast, 0,
      steps_per_split);
}

}  // namespace

// xs: 0 IQ4_NL, 1 IQ4_XS. d: (M, K/32) fp16 for IQ4_NL, (M, K/256) for
// IQ4_XS; scales_h (M, K/256) u16 and scales_l (M, K/256*4) bytes, IQ4_XS
// only (null for IQ4_NL); qs: (M, K/32*16) bytes, 16-byte aligned; x: (N,
// K) f32 or bf16; out: (N, M) f32; part: (splits, N, M) f32 scratch when
// splits > 1.
extern "C" int mmq_iq4_launch(const void* d, const void* scales_h,
                              const void* scales_l, const void* qs,
                              const void* x, void* out, void* part, int xs,
                              int M, int N, int K, int x_bf16, int fast,
                              int splits, int steps_per_split, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0 || splits < 1 || steps_per_split < 1 ||
      (xs && (!scales_h || !scales_l)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __half* dp = static_cast<const __half*>(d);
  const uint8_t* qp = static_cast<const uint8_t*>(qs);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  if (xs) {
    MMQ_SPLIT_DISPATCH(mmq_iq4_xs_kernel, M, N, splits, x_bf16, st, o, p, dp,
                       static_cast<const uint16_t*>(scales_h),
                       static_cast<const uint8_t*>(scales_l), qp, x, o, p, M,
                       N, K, fast, steps_per_split);
  } else {
    MMQ_SPLIT_DISPATCH(mmq_iq4_nl_kernel, M, N, splits, x_bf16, st, o, p, dp,
                       qp, x, o, p, M, N, K, fast, steps_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}
