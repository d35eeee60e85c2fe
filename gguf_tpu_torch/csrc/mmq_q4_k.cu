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
// design:
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
//  - at decode widths M/64 blocks cannot fill 132 SMs (32 at M = 2048, 4
//    for a 256-row wv), so K is cut across the grid's z axis and a second
//    launch adds the partial tiles in split order: the same bits each run.
//
// "high" (f32 operands, f32 products) cannot go through bf16 tensor cores
// within its 1e-5 bound and keeps the SIMT tile kquant::mmq_tile, which K8
// (mmq_q5_k.cu) also runs.

#include "mmq_tc.cuh"

namespace {

using namespace tc;

// BN activation rows x WG warpgroups of 64 weight rows per block. A stage
// is three TMA boxes: x (BN x 64 bf16, 128-byte swizzle: wgmma's K-major
// layout), the rows' headers (ROWS x 16 bytes) and the chunk's nibble runs
// (ROWS x 32 bytes, 32-byte swizzle: conflict-free fragment loads).
template <int BN, int WG>
struct Tile {
  static constexpr int ROWS = BM * WG;
  static constexpr int THREADS = NTHREADS * WG;
  static constexpr int STAGES = 4;
  static constexpr int AHEAD = STAGES - 2;   // chunks loaded ahead
  static constexpr int HDR = BN * KC * 2;
  static constexpr int NIB = HDR + ROWS * 16;
  static constexpr int STAGE = NIB + ROWS * 32;   // a multiple of 1024
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

template <int BN, int WG>
__global__ void __launch_bounds__(NTHREADS * WG)
mmq_q4_k_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap thdr,
            const __grid_constant__ CUtensorMap tnib, float* __restrict__ out,
            float* __restrict__ part, int M, int N, int K, int chunks_per_split) {
  using T = Tile<BN, WG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[T::STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * T::ROWS, n0 = blockIdx.y * BN;
  const int c0 = blockIdx.z * chunks_per_split;
  const int nch = min(K / KC, c0 + chunks_per_split) - c0;
  // blocks start at different chunks of their range, so the blocks that
  // share an activation tile do not all read the same one at once
  const int rot = blockIdx.x % nch;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + g;   // and row + 8

  auto load = [&](int i) {   // the block's i-th chunk into stage i % STAGES
    if (threadIdx.x == 0 && i < nch) {
      const int c = c0 + (i + rot) % nch, st = i % T::STAGES;
      uint8_t* dst = smem + st * T::STAGE;
      const int col = (c >> 2) * 144;   // the superblock's bytes in a row
      mbar_expect_tx(&full[st], T::STAGE);
      tma_load_2d(dst, &tx, KC * c, n0, &full[st]);
      tma_load_2d(dst + T::HDR, &thdr, col, m0, &full[st]);
      tma_load_2d(dst + T::NIB, &tnib, col + 16 + 32 * (c & 3), m0, &full[st]);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::AHEAD; ++i) load(i);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][4];
  // lane t's codes of a k16 step are bytes 2t, 2t+1, 8+2t, 9+2t of a
  // 16-byte half of the nibble run: halves of words t/2 and t/2 + 2; the
  // halves of rows with bit 2 set trade places (32-byte swizzle)
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  const int flip = (g >> 2) & 1;

  for (int i = 0; i < nch; ++i) {
    // every warp is past chunk i-1's first wgmma_wait, so chunk i-2's
    // stage is free for chunk i + AHEAD
    __syncthreads();
    load(i + T::AHEAD);
    const int c = c0 + (i + rot) % nch;
    uint8_t* st = smem + (i % T::STAGES) * T::STAGE;
    mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
    float s[2][2], z[2][2];   // [row, row + 8][block 2j, 2j+1]
    uint32_t v[2][2];         // [row, row + 8][half of the nibble run]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e;
      chunk_scales(*reinterpret_cast<const uint4*>(st + T::HDR + 16 * r), c & 3, s[e], z[e]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint8_t* p = st + T::NIB + 32 * r + 16 * (q ^ flip) + 4 * (t >> 1);
        v[e][q] = __byte_perm(*reinterpret_cast<const uint32_t*>(p),
                              *reinterpret_cast<const uint32_t*>(p + 8), sel);
      }
    }
    const uint64_t db = smem_desc_sw128(st);
#pragma unroll
    for (int k = 0; k < 4; ++k) {   // k16 step: block 2j + k/2, half k%2
      const int h = k >> 1;
      uint32_t(&af)[4] = a[k & 1];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t nib = (v[e][k & 1] >> (4 * h)) & 0x0F0F0F0Fu;
        af[e] = pack_bf16(fold(s[e][h], z[e][h], code_f(nib, 0)),
                          fold(s[e][h], z[e][h], code_f(nib, 1)));
        af[2 + e] = pack_bf16(fold(s[e][h], z[e][h], code_f(nib, 2)),
                              fold(s[e][h], z[e][h], code_f(nib, 3)));
      }
      wgmma_fence();
      wgmma_bf16<BN>(acc, af, db + 2 * k);   // 32 bytes (16 bf16) per k16 step
      wgmma_commit();
      wgmma_wait<1>();   // step k-1 is done: its A registers are free
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
  store_acc<BN>(acc, out, part, M, N, m0 + row, n0 + 2 * t);
}

template <int BN, int WG>
cudaError_t launch_tc(const uint8_t* w, const __nv_bfloat16* xb, float* out, float* part,
                      int M, int N, int K, int splits, int per, cudaStream_t st) {
  using T = Tile<BN, WG>;
  CUtensorMap tx, thdr, tnib;
  const uint64_t row_bytes = static_cast<uint64_t>(K / 256) * 144;
  cudaError_t err = tensor_map_2d(&tx, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN, KC,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&thdr, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, row_bytes, T::ROWS, 16,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tnib, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, row_bytes, T::ROWS, 32,
                        CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mmq_q4_k_tc<BN, WG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + T::ROWS - 1) / T::ROWS, (N + BN - 1) / BN, splits);
  mmq_q4_k_tc<BN, WG><<<grid, T::THREADS, T::SMEM, st>>>(tx, thdr, tnib, out, part, M, N, K,
                                                          per);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(N) * M;
    mmq::add_splits<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
        part, out, splits, total);
  }
  return cudaSuccess;
}

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_q4_k_kernel(const uint8_t* __restrict__ w, const void* __restrict__ x,
                float* __restrict__ out, int M, int N, int K, int ldx, int glu) {
  kquant::mmq_tile<false, BN, TM, TN, XBF16>(w, x, out, M, N, K, ldx, glu, 0);
}

}  // namespace

// w: (M, K/256*144) GGUF bytes, 16-byte aligned; x: (N, ldx) f32 or bf16
// (ldx = K, or 2K with glu); out: (N, M) f32. glu 0/1/2 = none/silu/gelu.
// "high" (fast = 0) runs the SIMT tile; xb, part and the split are unused.
// "fast": xb is the (N, K) bf16 operand, 16-byte aligned — x itself when
// the caller passes it (bf16, no glu), else scratch this call fills first;
// part: (splits, N, M) f32 scratch when splits > 1, K cut into splits
// ranges of chunks_per_split 64-element chunks.
extern "C" int mmq_q4_k_launch(const void* w, const void* x, void* out, void* part,
                               void* xb, int M, int N, int K, int ldx, int x_bf16,
                               int glu, int fast, int splits, int chunks_per_split,
                               void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint8_t*>(w);
  auto* op = static_cast<float*>(out);
  if (!fast) {
    MMQ_DISPATCH(mmq_q4_k_kernel, M, N, x_bf16, st, wp, x, op, M, N, K, ldx, glu);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = K / KC;   // every split has a chunk
  if (splits < 1 || chunks_per_split < 1 || (splits - 1) * chunks_per_split >= chunks ||
      splits * chunks_per_split < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  launch_to_bf16(x, xb, N, K, ldx, x_bf16, glu, st);
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
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
