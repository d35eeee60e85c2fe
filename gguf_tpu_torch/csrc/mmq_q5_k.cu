// K8: fused Q5_K dequantize + matmul (any N), "fast" and "high".
//
// Replaces gguf_tpu/ops/mmq_q5_k.py:_kernel_ink (decode widths) and
// :_kernel (prefill widths), both reached through mmq_q5_k. It is K1's
// design (mmq_q4_k.cu) on the 176-byte Q5_K blocks as stored: the same
// 16-byte header and nibbles, plus each element's fifth bit from the
// block's 32 qh bytes, read with one 8-byte load per thread and
// superblock. The TPU's bit-plane shift/mask concatenation and plane
// permutation have no counterpart. No GLU: the JAX package never fuses
// the gated activation into a Q5_K down projection.
//
// What bounds it on an H100: as for K1 — the weight stream (0.6875 B per
// weight) is the floor at decode widths, the serial K-step chain of each
// block is what it costs today, and the SIMT FMAs at prefill widths.
//
// The tile is kquant::mmq_tile (kquant.cuh) with HAS_QH = true.

#include "kquant.cuh"

namespace {

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_q5_k_kernel(const uint8_t* __restrict__ w, const void* __restrict__ x,
                float* __restrict__ out, int M, int N, int K, int ldx,
                int fast) {
  kquant::mmq_tile<true, BN, TM, TN, XBF16>(w, x, out, M, N, K, ldx, 0, fast);
}

}  // namespace

// w: (M, K/256*176) GGUF bytes, 16-byte aligned; x: (N, K) f32 or bf16;
// out: (N, M) f32.
extern "C" int mmq_q5_k_launch(const void* w, const void* x, void* out, int M,
                               int N, int K, int x_bf16, int fast,
                               void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MMQ_DISPATCH(mmq_q5_k_kernel, M, N, x_bf16, st,
               static_cast<const uint8_t*>(w), x, static_cast<float*>(out),
               M, N, K, K, fast);
  return static_cast<int>(cudaGetLastError());
}
