// K8: fused Q5_K dequantize + matmul (any N), "fast" and "high".
//
// Replaces gguf_tpu/ops/mmq_q5_k.py:_kernel_ink (decode widths) and
// :_kernel (prefill widths), both reached through mmq_q5_k. It reads the
// 176-byte Q5_K blocks as stored: K1's 16-byte header and nibbles, plus
// each element's fifth bit from the block's 32 qh bytes. The TPU's
// bit-plane shift/mask concatenation and plane permutation have no
// counterpart. No GLU: the JAX package never fuses the gated activation
// into a Q5_K down projection.
//
// "fast" (w = bf16((d*sc)*q - dmin*mn) with the 5-bit q, the min folded
// into each weight before rounding; x = bf16(x); f32 sums) runs K1's bf16
// tensor-core tile (kquant_tc.cuh) with HAS_QH: a stage gains a fourth TMA
// box, the rows' 32 qh bytes, through the nibble runs' tensor map and
// swizzle, so the byte permute that gives a lane the nibble bytes of its
// four codes of a k16 step gives it their qh bytes too; bit 2j + h of each
// (block 2j + h of the chunk's run j) is ORed in as bit 4 of the code
// before the fold, in the codec's rounding order (kquant.cuh). The split
// of K and the bf16 operand are K1's (ops/mmq_q4_k.py:k1_plan). What
// bounds it on an H100: as for K1, the dequantize arithmetic above the
// weight stream (0.6875 B per weight) at decode widths and beside the
// tensor-core rate at prefill widths; the qh bytes add a box (L2 hits
// after the first chunk of a superblock) and two instructions per code.
//
// "high" (f32 operands, f32 products) cannot go through bf16 tensor cores
// within its 1e-5 bound and keeps the SIMT tile kquant::mmq_tile with
// HAS_QH = true (kquant.cuh), whose C entry refuses "fast".

#include "kquant_tc.cuh"

namespace {

using namespace tc;

template <int BN, int WG>
__global__ void __launch_bounds__(NTHREADS * WG)
mmq_q5_k_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap thdr,
            const __grid_constant__ CUtensorMap tnib, float* __restrict__ out,
            float* __restrict__ part, int M, int N, int K, int chunks_per_split) {
  kquant_tc::tile<BN, WG, true>(tx, thdr, tnib, out, part, M, N, K, chunks_per_split);
}

template <int BN, int WG>
cudaError_t launch_tc(const uint8_t* w, const __nv_bfloat16* xb, float* out, float* part,
                      int M, int N, int K, int splits, int per, cudaStream_t st) {
  return kquant_tc::launch<BN, WG, true>(mmq_q5_k_tc<BN, WG>, w, xb, out, part, M, N, K,
                                         splits, per, st);
}

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_q5_k_kernel(const uint8_t* __restrict__ w, const void* __restrict__ x,
                float* __restrict__ out, int M, int N, int K, int ldx) {
  kquant::mmq_tile<true, BN, TM, TN, XBF16>(w, x, out, M, N, K, ldx, 0);
}

}  // namespace

// "high": w (M, K/256*176) GGUF bytes, 16-byte aligned; x (N, K) f32 or
// bf16; out (N, M) f32. fast must be 0: "fast" runs mmq_q5_k_tc_launch.
extern "C" int mmq_q5_k_launch(const void* w, const void* x, void* out, int M,
                               int N, int K, int x_bf16, int fast,
                               void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0 || fast) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MMQ_DISPATCH(mmq_q5_k_kernel, M, N, x_bf16, st,
               static_cast<const uint8_t*>(w), x, static_cast<float*>(out),
               M, N, K, K);
  return static_cast<int>(cudaGetLastError());
}

// "fast": w as above; x (N, K) f32 or bf16; xb the (N, K) bf16 operand,
// 16-byte aligned: x itself when the caller passes it, else scratch this
// call fills first; part: (splits, N, M) f32 scratch when splits > 1, K cut
// into splits ranges of chunks_per_split 64-element chunks.
extern "C" int mmq_q5_k_tc_launch(const void* w, const void* x, void* xb, void* out,
                                  void* part, int M, int N, int K, int x_bf16, int splits,
                                  int chunks_per_split, void* stream) {
  const int chunks = K / KC;   // every split has a chunk
  if (K % 256 != 0 || M <= 0 || N <= 0 || splits < 1 || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= chunks || splits * chunks_per_split < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_to_bf16(x, xb, N, K, K, x_bf16, 0, st);
  const auto* wp = static_cast<const uint8_t*>(w);
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(part);
  cudaError_t err;
  const int per = chunks_per_split;   // tiles as ops/mmq_q4_k.py:tc_tile
  if (N <= 8) err = launch_tc<8, 1>(wp, xbp, op, pp, M, N, K, splits, per, st);
  else if (N <= 16) err = launch_tc<16, 1>(wp, xbp, op, pp, M, N, K, splits, per, st);
  else if (N <= 64) err = launch_tc<64, 1>(wp, xbp, op, pp, M, N, K, splits, per, st);
  else err = launch_tc<128, 2>(wp, xbp, op, pp, M, N, K, splits, per, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
