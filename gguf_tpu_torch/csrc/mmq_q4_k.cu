// K1: fused Q4_K dequantize + matmul (any N), optional GLU prologue.
//
// Replaces gguf_tpu/ops/mmq_q4_k.py:_kernel_ink (decode widths, with the
// glu prologue) and :_kernel (prefill widths), both reached through
// mmq_q4_k. It reads the 144-byte GGUF blocks as stored — fp16 d, fp16
// dmin, 12 bytes of packed 6-bit scales/mins, 128 bytes of nibbles — so
// the TPU's plane permutation and 0/1 glue matmuls have no counterpart.
//
// "fast" (the reference's bf16 MXU contract: w = bf16((d*sc)*q - dmin*mn),
// x = bf16(x) or bf16(act(gate)*up), f32 sums) runs on the bf16 tensor
// cores at every width: a warpgroup owns 64 weight rows and issues wgmma
// m64nBNk16 with A in registers and B, the activations, in shared memory;
// BN = 8 or 16 at decode widths, 64, and 128 with two warpgroups sharing
// each activation tile above n = 64. What bounds it on an H100: the
// dequantize arithmetic (~7 instructions per weight and activation tile:
// code to float, two products rounded in the codec's order, the bf16 pack,
// and the chunk's scales), above the weight stream (0.5625 B per weight)
// at decode widths and beside the tensor-core rate at prefill widths. The
// design (the tile is kquant_tc.cuh's, which K8 runs with a fifth bit):
//  - one thread fills a ring of shared-memory stages with TMA copies
//    (mmq_tc.cuh), each stage one chunk of 64 K elements: the x tile, the
//    rows' headers and nibble runs; STAGES - 2 chunks are in flight while
//    the current one computes, because the last wgmma of the previous chunk
//    may still read its stage; per-thread copies (cp.async) cost more than
//    the copies moved at prefill widths;
//  - each lane decodes its A fragment straight from the staged nibbles
//    (two 32-bit loads and a byte permute give the four codes of a k16
//    step), folds (d*sc)*q - dmin*mn in f32 in the codec's order and packs
//    bf16 pairs; the decode of step s+1 overlaps the wgmma of step s;
//  - the activations come as a bf16 (N, K) operand: the caller's own when
//    it is one, else one pass (act(gate)*up in f32 with glu, rounded to
//    bf16) writes it to scratch, so no block repeats the GLU;
//  - two warpgroups per block above n = 64 halve how often each activation
//    tile is read from L2, and blocks start at different chunks of their K
//    range so that they do not read the same tile at once;
//  - where M/64 blocks cannot fill 132 SMs, K is cut across the grid's z
//    axis and a second launch adds the partial tiles in split order: the
//    same bits each run.
// At decode widths (n <= 16) K1 runs its own tile instead (kquant_dec.cuh:
// a producer warp and a ring of whole superblocks, two consumer
// warpgroups, persistent blocks with the split sum inside, and the same
// bits from fewer instructions per weight); the tile above stays for n >
// 16, and K8 runs it at every width.
//
// "high" (f32 operands, f32 products) cannot go through bf16 tensor cores
// within its 1e-5 bound and keeps the SIMT tile kquant::mmq_tile, which
// K8's "high" arm (mmq_q5_k.cu) also runs.

#include "kquant_dec.cuh"
#include "kquant_tc.cuh"

namespace {

using namespace tc;

template <int BN, int WG>
__global__ void __launch_bounds__(NTHREADS * WG)
mmq_q4_k_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap thdr,
            const __grid_constant__ CUtensorMap tnib, float* __restrict__ out,
            float* __restrict__ part, int M, int N, int K, int chunks_per_split) {
  kquant_tc::tile<BN, WG, false>(tx, thdr, tnib, out, part, M, N, K, chunks_per_split);
}

template <int BN, int WG>
cudaError_t launch_tc(const uint8_t* w, const __nv_bfloat16* xb, float* out, float* part,
                      int M, int N, int K, int splits, int per, cudaStream_t st) {
  return kquant_tc::launch<BN, WG, false>(mmq_q4_k_tc<BN, WG>, w, xb, out, part, M, N, K,
                                          splits, per, st);
}

// the decode tile's counters, one per (row tile, warpgroup): zero at load,
// and every launch leaves them zero
__device__ int dec_done[kquant_dec::MAX_COUNTERS];

constexpr int DEC_WGS = 2, DEC_STAGES = 4;   // as ops/mmq_q4_k.py:dec_tile
constexpr int DEC_ROWS = BM * DEC_WGS;

template <int BN>
__global__ void __launch_bounds__(kquant_dec::Dec<BN, DEC_WGS, DEC_STAGES>::THREADS, 1)
mmq_q4_k_dec(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             float* __restrict__ out, float* __restrict__ part, int M, int N, int K) {
  kquant_dec::tile<BN, DEC_WGS, DEC_STAGES>(tx, tw, out, part, dec_done, M, N, K);
}

template <int BN>
cudaError_t launch_dec(const uint8_t* w, const __nv_bfloat16* xb, float* out, float* part,
                       int M, int N, int K, int blocks, cudaStream_t st) {
  return kquant_dec::launch<BN, DEC_WGS, DEC_STAGES>(mmq_q4_k_dec<BN>, w, xb, out, part,
                                                     M, N, K, blocks, st);
}

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_q4_k_kernel(const uint8_t* __restrict__ w, const void* __restrict__ x,
                float* __restrict__ out, int M, int N, int K, int ldx, int glu) {
  kquant::mmq_tile<false, BN, TM, TN, XBF16>(w, x, out, M, N, K, ldx, glu);
}

}  // namespace

// w: (M, K/256*144) GGUF bytes, 16-byte aligned; x: (N, ldx) f32 or bf16
// (ldx = K, or 2K with glu); out: (N, M) f32. glu 0/1/2 = none/silu/gelu.
// "high" (fast = 0) runs the SIMT tile; xb, part and the plan are unused.
// "fast": xb is the (N, K) bf16 operand, 16-byte aligned — x itself when
// the caller passes it (bf16, no glu), else scratch this call fills first.
// dec_blocks > 0 (N <= 16) runs the decode tile on that many persistent
// blocks, part then the (dec_blocks + M/128 - 1) slots of 128 x BN f32 for
// its partial sums (ops/mmq_q4_k.py:k1_decode_plan); dec_blocks = 0 runs
// the tensor-core tile, part then (splits, N, M) f32 scratch when splits >
// 1, K cut into splits ranges of chunks_per_split 64-element chunks.
extern "C" int mmq_q4_k_launch(const void* w, const void* x, void* out, void* part,
                               void* xb, int M, int N, int K, int ldx, int x_bf16,
                               int glu, int fast, int splits, int chunks_per_split,
                               int dec_blocks, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint8_t*>(w);
  auto* op = static_cast<float*>(out);
  if (!fast) {
    MMQ_DISPATCH(mmq_q4_k_kernel, M, N, x_bf16, st, wp, x, op, M, N, K, ldx, glu);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = K / KC;   // every split has a chunk
  if (dec_blocks > 0 ? N > 16 || static_cast<long long>(dec_blocks) > (M + DEC_ROWS - 1) / DEC_ROWS * (K / 256)
                     : splits < 1 || chunks_per_split < 1 ||
                           (splits - 1) * chunks_per_split >= chunks ||
                           splits * chunks_per_split < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  launch_to_bf16(x, xb, N, K, ldx, x_bf16, glu, st);
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  auto* pp = static_cast<float*>(part);
  cudaError_t err;
  const int per = chunks_per_split;   // tiles as ops/mmq_q4_k.py:tc_tile and dec_tile
  if (dec_blocks > 0) {
    if (N <= 8) err = launch_dec<8>(wp, xbp, op, pp, M, N, K, dec_blocks, st);
    else err = launch_dec<16>(wp, xbp, op, pp, M, N, K, dec_blocks, st);
  } else if (N <= 8) err = launch_tc<8, 1>(wp, xbp, op, pp, M, N, K, splits, per, st);
  else if (N <= 16) err = launch_tc<16, 1>(wp, xbp, op, pp, M, N, K, splits, per, st);
  else if (N <= 64) err = launch_tc<64, 1>(wp, xbp, op, pp, M, N, K, splits, per, st);
  else err = launch_tc<128, 2>(wp, xbp, op, pp, M, N, K, splits, per, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
