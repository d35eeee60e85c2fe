// K10: fused Q8_0 dequantize + matmul (any N, K a multiple of 32).
//
// Replaces gguf_tpu/ops/mmq_q8_0.py:_kernel (element order, K % 256 != 0),
// :_kernel_plane (prefill widths) and :_kernel_ink (decode widths), all
// reached through mmq_q8_0. The TPU's plane row order, activation permute
// and 0/1 glue matmuls have no counterpart: this kernel reads the fp16 d
// and int8 qs fields of the GGUF blocks in natural element order. Element
// value d*q, exact in f32; under "fast" both d*q and the activations are
// rounded to bf16 before the f32-accumulated product.
//
// What bounds it on an H100: the weight stream (34 bytes per 32 weights,
// 1.0625 B per weight) at decode widths, the SIMT f32 FMAs of the tile at
// prefill widths. The design (block32.cuh) keeps K1's shared-memory tile
// but cuts K across the grid when M/64 blocks cannot fill the card, and
// reads each thread's 16 codes with one 16-byte load.

#include "block32.cuh"

namespace {

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_q8_0_kernel(const __half* __restrict__ d, const uint8_t* __restrict__ qs,
                const void* __restrict__ x, float* __restrict__ out,
                float* __restrict__ part, int M, int N, int K, int fast,
                int steps_per_split) {
  block32::mmq_tile<block32::Q8_0, BN, TM, TN, XBF16>(
      d, nullptr, nullptr, qs, x, out, part, M, N, K, fast, 0, steps_per_split);
}

}  // namespace

// d: (M, K/32) fp16; qs: (M, K) int8, 16-byte aligned; x: (N, K) f32 or
// bf16; out: (N, M) f32; part: (splits, N, M) f32 scratch when splits > 1.
extern "C" int mmq_q8_0_launch(const void* d, const void* qs, const void* x,
                               void* out, void* part, int M, int N, int K,
                               int x_bf16, int fast, int splits,
                               int steps_per_split, void* stream) {
  if (K % 32 != 0 || M <= 0 || N <= 0 || splits < 1 || steps_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  MMQ_SPLIT_DISPATCH(mmq_q8_0_kernel, M, N, splits, x_bf16, st, o, p,
                   static_cast<const __half*>(d),
                   static_cast<const uint8_t*>(qs), x, o, p, M, N, K, fast,
                   steps_per_split);
  return static_cast<int>(cudaGetLastError());
}
