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
// The tile itself is kquant::mmq_tile (kquant.cuh), shared with K8.

#include "kquant.cuh"

namespace {

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_q4_k_kernel(const uint8_t* __restrict__ w, const void* __restrict__ x,
                float* __restrict__ out, int M, int N, int K, int ldx,
                int glu, int fast) {
  kquant::mmq_tile<false, BN, TM, TN, XBF16>(w, x, out, M, N, K, ldx, glu, fast);
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
