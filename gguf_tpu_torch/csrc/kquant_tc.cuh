// The bf16 tensor-core tile of K1 (mmq_q4_k.cu) and K8 (mmq_q5_k.cu) under
// "fast": one body over Q4_K (144-byte) and Q5_K (176-byte) superblocks as
// stored in GGUF (kquant.cuh), HAS_QH adding Q5_K's fifth bit.
//
// The reference's function (gguf_tpu/ops/mmq_q4_k.py and mmq_q5_k.py under
// "fast"): w = bf16((d*sc)*q - dmin*mn), the min folded into each weight
// before rounding, x = bf16(x), f32 sums. A warpgroup owns 64 weight rows
// and issues wgmma m64nBNk16 with A in registers and B, the activations, in
// shared memory; BN = 8 or 16 at decode widths, 64, and 128 with two
// warpgroups sharing each activation tile above n = 64. One thread fills a
// ring of shared-memory stages with TMA copies (mmq_tc.cuh), each stage
// one chunk c of KC = 64 elements, the nibble run j = c % 4 of superblock
// c / 4: the x tile (BN x 64 bf16, 128-byte swizzle: wgmma's K-major
// layout), the rows' 16-byte headers, for Q5_K the rows' 32 qh bytes, and
// the rows' 32-byte nibble runs. The qh and nibble boxes come through one
// tensor map (32-byte swizzle: conflict-free fragment loads) at two
// columns, so one byte permute gives each lane the nibble bytes of its four
// codes of a k16 step and the qh bytes of the same four elements. Header
// and qh bytes are fetched again for each chunk of a superblock: L2 hits,
// the device-memory stream stays one pass over the weight. STAGES - 2
// chunks are in flight while the current one computes, because the last
// wgmma of the previous chunk may still read its stage. Blocks start at
// different chunks of their K range so that the blocks sharing an
// activation tile do not read the same one at once. K is cut across the
// grid's z axis in whole chunks (split K) and mmq::add_splits adds the
// partial tiles in split order: the same bits each run.
#pragma once

#include "mmq_tc.cuh"

namespace kquant_tc {

using namespace tc;

// BN activation rows x WG warpgroups of 64 weight rows per block. A stage:
// x (BN x 64 bf16), the headers (ROWS x 16 bytes), Q5_K's qh bytes (ROWS
// x 32) and the nibble runs (ROWS x 32), each box 1024-byte aligned.
template <int BN, int WG, bool HAS_QH>
struct Tile {
  using L = kquant::Layout<HAS_QH>;
  static constexpr int ROWS = BM * WG;
  static constexpr int THREADS = NTHREADS * WG;
  static constexpr int STAGES = 4;
  static constexpr int AHEAD = STAGES - 2;   // chunks loaded ahead
  static constexpr int HDR = BN * KC * 2;
  static constexpr int QH = HDR + ROWS * 16;
  static constexpr int NIB = QH + (HAS_QH ? ROWS * 32 : 0);
  static constexpr int STAGE = NIB + ROWS * 32;
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static_assert(HDR % 1024 == 0 && QH % 1024 == 0 && NIB % 1024 == 0 && STAGE % 1024 == 0,
                "every box of a stage must be 1024-byte aligned");
};

// The kernel body: out (N, M) f32 (or split z's partial tile) = x . W^T
// over the block's range of chunks; tx maps the (N, K) bf16 operand, thdr
// and tnib the (M, K/256 * L::BYTES) weight bytes in 16- and 32-byte boxes.
template <int BN, int WG, bool HAS_QH>
__device__ __forceinline__ void tile(const CUtensorMap& tx, const CUtensorMap& thdr,
                                     const CUtensorMap& tnib, float* __restrict__ out,
                                     float* __restrict__ part, int M, int N, int K,
                                     int chunks_per_split) {
  using T = Tile<BN, WG, HAS_QH>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[T::STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * T::ROWS, n0 = blockIdx.y * BN;
  const int c0 = blockIdx.z * chunks_per_split;
  const int nch = min(K / KC, c0 + chunks_per_split) - c0;
  const int rot = blockIdx.x % nch;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + g;   // and row + 8

  auto load = [&](int i) {   // the block's i-th chunk into stage i % STAGES
    if (threadIdx.x == 0 && i < nch) {
      const int c = c0 + (i + rot) % nch, st = i % T::STAGES;
      uint8_t* dst = smem + st * T::STAGE;
      const int col = (c >> 2) * T::L::BYTES;   // the superblock's bytes in a row
      mbar_expect_tx(&full[st], T::STAGE);
      tma_load_2d(dst, &tx, KC * c, n0, &full[st]);
      tma_load_2d(dst + T::HDR, &thdr, col, m0, &full[st]);
      if constexpr (HAS_QH) tma_load_2d(dst + T::QH, &tnib, col + T::L::QH, m0, &full[st]);
      tma_load_2d(dst + T::NIB, &tnib, col + T::L::QS + 32 * (c & 3), m0, &full[st]);
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
  // 16-byte half of the nibble run (and of the qh bytes): halves of words
  // t/2 and t/2 + 2; the halves of rows with bit 2 set trade places
  // (32-byte swizzle)
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  const int flip = (g >> 2) & 1;
  auto lane_bytes = [&](const uint8_t* box, int r, int q) {
    const uint8_t* p = box + 32 * r + 16 * (q ^ flip) + 4 * (t >> 1);
    return __byte_perm(*reinterpret_cast<const uint32_t*>(p),
                       *reinterpret_cast<const uint32_t*>(p + 8), sel);
  };

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
    uint32_t hv[2][2];        // Q5_K: the same elements' qh bytes
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e;
      chunk_scales(*reinterpret_cast<const uint4*>(st + T::HDR + 16 * r), c & 3, s[e], z[e]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        v[e][q] = lane_bytes(st + T::NIB, r, q);
        if constexpr (HAS_QH) hv[e][q] = lane_bytes(st + T::QH, r, q);
      }
    }
    const int jb = 2 * (c & 3);   // bit 2j + h of a qh byte: block 2j + h's fifth bit
    const uint64_t db = smem_desc_sw128(st);
#pragma unroll
    for (int k = 0; k < 4; ++k) {   // k16 step: block 2j + k/2, half k%2
      const int h = k >> 1;
      uint32_t(&af)[4] = a[k & 1];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t q = (v[e][k & 1] >> (4 * h)) & 0x0F0F0F0Fu;
        if constexpr (HAS_QH) q |= ((hv[e][k & 1] >> (jb + h)) & 0x01010101u) << 4;
        af[e] = pack_bf16(fold(s[e][h], z[e][h], code_f(q, 0)),
                          fold(s[e][h], z[e][h], code_f(q, 1)));
        af[2 + e] = pack_bf16(fold(s[e][h], z[e][h], code_f(q, 2)),
                              fold(s[e][h], z[e][h], code_f(q, 3)));
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

// Launch `kernel` (a __global__ wrapper of tile<BN, WG, HAS_QH>, named for
// its format) over a (M / ROWS, N / BN, splits) grid, then the split sum.
template <int BN, int WG, bool HAS_QH, typename Kernel>
cudaError_t launch(Kernel kernel, const uint8_t* w, const __nv_bfloat16* xb, float* out,
                   float* part, int M, int N, int K, int splits, int per, cudaStream_t st) {
  using T = Tile<BN, WG, HAS_QH>;
  CUtensorMap tx, thdr, tnib;
  const uint64_t row_bytes = static_cast<uint64_t>(K / 256) * T::L::BYTES;
  cudaError_t err = tensor_map_2d(&tx, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN, KC,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&thdr, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, row_bytes, T::ROWS, 16,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tnib, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, row_bytes, T::ROWS, 32,
                        CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + T::ROWS - 1) / T::ROWS, (N + BN - 1) / BN, splits);
  void* args[] = {&tx, &thdr, &tnib, &out, &part, &M, &N, &K, &per};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, dim3(T::THREADS), args, T::SMEM, st);
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const size_t total = static_cast<size_t>(N) * M;
    mmq::add_splits<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
        part, out, splits, total);
  }
  return cudaSuccess;
}

}  // namespace kquant_tc
