// K10: fused Q8_0 dequantize + matmul (any N, K a multiple of 32).
//
// Replaces gguf_tpu/ops/mmq_q8_0.py:_kernel (element order, K % 256 != 0),
// :_kernel_plane (prefill widths) and :_kernel_ink (decode widths), all
// reached through mmq_q8_0. The TPU's plane row order, activation permute
// and 0/1 glue matmuls have no counterpart: this kernel reads the fp16 d
// and int8 qs fields of the GGUF blocks in natural element order. Element
// value d*q, exact in f32.
//
// "fast" (w = bf16(d*q), x = bf16(x), f32 sums) runs the bf16 tensor-core
// tile of block32_tc.cuh in 128-element chunks with the Q8 policy below:
// per row and chunk one 128-byte TMA box of the (M, K) int8 qs field
// (128-byte swizzle; lane t's four codes of a k16 step are two 32-bit
// shared loads and one byte permute, no lookup), and the chunk's four fp16
// d as one 8-byte plain load one chunk ahead when K % 128 == 0 (the d row
// of K/16 bytes is then 8-byte aligned), else 2 bytes at a time with the
// blocks past K read as 0. Q8_0 is symmetric: no correction term. Every K
// that is a multiple of 32 runs this tile: a ragged last chunk's x and qs
// arrive as zeros from TMA's out-of-bounds fill, and its masked d is 0, so
// it adds exact zeros (unmasked d past K could be NaN, and 0 * NaN is not
// 0). The split of K is ops/mmq_q4_k.py:tc_plan's. What bounds it on an
// H100: the weight stream at decode widths (34 bytes per 32 weights, 1.0625
// B per weight, twice Q4_0's code bytes) with the per-code product d*q and
// the chain of dependent wgmma steps behind it; at prefill widths the
// tensor cores' rate beside the same products.
//
// "high" (f32 operands and products) cannot go through bf16 tensor cores
// within its 1e-5 bound and keeps block32.cuh's SIMT tile (K cut across
// the grid when M/64 blocks cannot fill the card; each thread's 16 codes
// one 16-byte load) through mmq_q8_0_launch, which refuses "fast".

#include "block32.cuh"
#include "block32_tc.cuh"

namespace {

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_q8_0_kernel(const __half* __restrict__ d, const uint8_t* __restrict__ qs,
                const void* __restrict__ x, float* __restrict__ out,
                float* __restrict__ part, int M, int N, int K,
                int steps_per_split) {
  block32::mmq_tile<block32::Q8_0, BN, TM, TN, XBF16>(
      d, nullptr, nullptr, qs, x, out, part, M, N, K, 0, steps_per_split);
}

// Q8_0's policy for block32_tc::tile: Small holds row m's four fp16 d of
// chunk c (0 past K)
struct Q8 {
  using Small = uint2;
  static constexpr bool CORR = false;   // symmetric: no correction term
  static constexpr int CODE = 128;      // 32 int8 codes per 32-block
  __device__ static uint2 small(const block32_tc::Fields& f, size_t m, int K, int c) {
    const int nb = K / 32;
    const uint16_t* d = f.d + m * nb + 4 * c;
    if (K % tc::KH == 0) return *reinterpret_cast<const uint2*>(d);
    uint32_t h[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) h[b] = 4 * c + b < nb ? d[b] : 0u;
    return make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
  }
  __device__ static float scale(const uint2& v, int, int b) {
    const uint32_t w = b < 2 ? v.x : v.y;
    return (b & 1) ? kquant::half_hi(w) : kquant::half_lo(w);
  }
};

template <int BN, int WG>
__global__ void __launch_bounds__(tc::NTHREADS * WG)
mmq_q8_0_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tqs,
            const block32_tc::Fields f, float* __restrict__ out, float* __restrict__ part,
            int M, int N, int K, int chunks_per_split) {
  block32_tc::tile<Q8, BN, WG>(tx, tqs, f, out, part, M, N, K, chunks_per_split);
}

template <int BN, int WG>
cudaError_t launch_tc(const block32_tc::Fields& f, const uint8_t* qs, const void* xb,
                      float* out, float* part, int M, int N, int K, int splits, int per,
                      cudaStream_t st) {
  return block32_tc::launch<BN, WG, Q8::CODE>(mmq_q8_0_tc<BN, WG>, f, qs, xb, out, part, M, N,
                                              K, splits, per, st);
}

}  // namespace

// "high". d: (M, K/32) fp16; qs: (M, K) int8, 16-byte aligned; x: (N, K)
// f32 or bf16; out: (N, M) f32; part: (splits, N, M) f32 scratch when
// splits > 1. fast must be 0: "fast" runs mmq_q8_0_tc_launch.
extern "C" int mmq_q8_0_launch(const void* d, const void* qs, const void* x,
                               void* out, void* part, int M, int N, int K,
                               int x_bf16, int fast, int splits,
                               int steps_per_split, void* stream) {
  if (K % 32 != 0 || M <= 0 || N <= 0 || fast || splits < 1 || steps_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  MMQ_SPLIT_DISPATCH(mmq_q8_0_kernel, M, N, splits, x_bf16, st, o, p,
                   static_cast<const __half*>(d),
                   static_cast<const uint8_t*>(qs), x, o, p, M, N, K,
                   steps_per_split);
  return static_cast<int>(cudaGetLastError());
}

// "fast": d (M, K/32) fp16, 8-byte aligned when K % 128 == 0, else
// 2-byte; qs (M, K) int8, 16-byte aligned; x (N, K) f32 or bf16; xb the
// (N, K) bf16 operand, 16-byte aligned: x itself when the caller passes it,
// else scratch this call fills first; part: (splits, N, M) f32 scratch
// when splits > 1, K cut into splits ranges of chunks_per_split
// 128-element chunks (the last may be ragged).
extern "C" int mmq_q8_0_tc_launch(const void* d, const void* qs, const void* x, void* xb,
                                  void* out, void* part, int M, int N, int K, int x_bf16,
                                  int splits, int chunks_per_split, void* stream) {
  const int chunks = (K + tc::KH - 1) / tc::KH;   // every split has a chunk
  if (K % 32 != 0 || K <= 0 || M <= 0 || N <= 0 || splits < 1 || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= chunks || splits * chunks_per_split < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::launch_to_bf16(x, xb, N, K, K, x_bf16, 0, st);
  const block32_tc::Fields f{static_cast<const uint16_t*>(d), nullptr, nullptr,
                             nullptr, nullptr, nullptr, 0};
  const auto* qp = static_cast<const uint8_t*>(qs);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(part);
  const int per = chunks_per_split;
  cudaError_t err;   // tiles as ops/mmq_q4_k.py:tc_tile
  if (N <= 8)
    err = launch_tc<8, 1>(f, qp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 16)
    err = launch_tc<16, 1>(f, qp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 64)
    err = launch_tc<64, 1>(f, qp, xb, op, pp, M, N, K, splits, per, st);
  else
    err = launch_tc<128, 2>(f, qp, xb, op, pp, M, N, K, splits, per, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
