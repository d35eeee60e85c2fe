// The bf16 tensor-core tile of the 32-element-block formats under "fast",
// over the per-field arrays QuantWeight splits their blocks into
// (block32.cuh lists them). K14 (mmq_iq4.cu: IQ4_NL, IQ4_XS) runs it; the
// format is a policy F (the fields read by plain loads, the scale of each
// 32-block, the code-to-value step), so K10 and K11 can take the same ring
// with policies of their own.
//
// out (N, M) f32 = x . W^T with w = bf16(scale * value(q)) rounded in that
// order and x = bf16(x), f32 sums. A warpgroup owns 64 weight rows (two
// share each activation tile above n = 64) and walks K in chunks of KH =
// 128 elements: four 32-blocks, whose 16 code bytes each (byte j: element
// j in the low nibble, j + 16 in the high) are one 64-byte TMA box per row
// of the (M, K/2) qs field, so every code byte leaves device memory once.
// A stage holds the x tile (two (BN x 64) bf16 boxes, 128-byte swizzle:
// wgmma's K-major layout) and the rows' 64 code bytes (64-byte swizzle:
// conflict-free fragment loads); the scale fields, a few bytes per row and
// chunk (below TMA's 16-byte box, and IQ4_XS's d row of K/128 bytes breaks
// its 16-byte stride rule at K = 256), are plain loads one chunk ahead.
// k16 step s of a chunk lies in 32-block s/2: the low nibbles when s is
// even, the high ones when odd, so lane t's four codes of steps 2b and
// 2b+1 are nibbles of bytes 2t, 2t+1, 2t+8 and 2t+9 of block b: K1's byte
// permute gives them in one word, and F::values turns its eight codes into
// two words of int8 values, one per step. STAGES - 2 chunks are in flight;
// blocks start at different chunks of their K range; K is cut across the
// grid's z axis in whole chunks and mmq::add_splits adds the partial tiles
// in split order.
#pragma once

#include "mmq_tc.cuh"

namespace block32_tc {

using namespace tc;

// BN activation rows x WG warpgroups of 64 weight rows per block. A stage:
// the x tile (two (BN x 64) bf16 boxes of XBOX bytes) and the rows' 64 code
// bytes of the chunk.
template <int BN, int WG>
struct Tile {
  static constexpr int ROWS = BM * WG;
  static constexpr int THREADS = NTHREADS * WG;
  static constexpr int STAGES = 4;
  static constexpr int AHEAD = STAGES - 2;   // chunks loaded ahead
  static constexpr int XBOX = BN * KC * 2;
  static constexpr int QS = 2 * XBOX;
  static constexpr int STAGE = QS + ROWS * 64;
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static_assert(XBOX % 1024 == 0 && STAGE % 1024 == 0,
                "every box of a stage must be 1024-byte aligned");
};

// The weight's fields besides qs, as the format's policy reads them (null
// where it has no such field).
struct Fields {
  const uint16_t* d;
  const uint16_t* scales_h;
  const uint8_t* scales_l;
};

// The kernel body. F provides:
//   F::small(fields, m, K, c) -> uint2: row m's scale fields of chunk c;
//   F::scale(small, c, b) -> float: the f32 scale of 32-block b (0..3) of
//     chunk c, rounded as the reference rounds it;
//   F::values(v, lo, hi): v holds four code bytes; lo and hi get the int8
//     values of their low and of their high nibbles, in byte order.
template <class F, int BN, int WG>
__device__ __forceinline__ void tile(const CUtensorMap& tx, const CUtensorMap& tqs,
                                     const Fields& f, float* __restrict__ out,
                                     float* __restrict__ part, int M, int N, int K,
                                     int chunks_per_split) {
  using T = Tile<BN, WG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[T::STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * T::ROWS, n0 = blockIdx.y * BN;
  const int c0 = blockIdx.z * chunks_per_split;
  const int nch = min(K / KH, c0 + chunks_per_split) - c0;
  const int rot = blockIdx.x % nch;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + g;   // and row + 8

  auto chunk = [&](int i) { return c0 + (i + rot) % nch; };
  auto load = [&](int i) {   // the block's i-th chunk into stage i % STAGES
    if (threadIdx.x == 0 && i < nch) {
      const int c = chunk(i), st = i % T::STAGES;
      uint8_t* dst = smem + st * T::STAGE;
      mbar_expect_tx(&full[st], T::STAGE);
      tma_load_2d(dst, &tx, KH * c, n0, &full[st]);
      tma_load_2d(dst + T::XBOX, &tx, KH * c + KC, n0, &full[st]);
      tma_load_2d(dst + T::QS, &tqs, 64 * c, m0, &full[st]);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::AHEAD; ++i) load(i);

  // this lane's rows' scale fields of a chunk, read one chunk ahead (the
  // four lanes of a row read the same bytes)
  uint2 smn[2];
  auto load_small = [&](int i) {
    const int c = chunk(i);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + row + 8 * e;
      smn[e] = m < M ? F::small(f, static_cast<size_t>(m), K, c) : make_uint2(0, 0);
    }
  };
  load_small(0);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][4];
  // lane t's codes of a step are bytes 2t, 2t+1, 8+2t, 9+2t of a block's 16
  // bytes: halves of words t/2 and t/2 + 2 (K1's pattern); block b of row r
  // sits at 16-byte piece b ^ ((r >> 1) & 3) (64-byte swizzle)
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  const int sw = (g >> 1) & 3;

  for (int i = 0; i < nch; ++i) {
    // every warp is past chunk i-1's first wgmma_wait, so chunk i-2's
    // stage is free for chunk i + AHEAD
    __syncthreads();
    load(i + T::AHEAD);
    const int c = chunk(i);
    const uint2 smc[2] = {smn[0], smn[1]};
    if (i + 1 < nch) load_small(i + 1);
    const uint8_t* st = smem + (i % T::STAGES) * T::STAGE;
    mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
    float s[2][4];      // [row, row + 8][32-block] scale
    uint32_t v[2][4];   // [row, row + 8][32-block] this lane's code bytes
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[e][b] = F::scale(smc[e], c, b);
        const uint8_t* p = st + T::QS + 64 * (row + 8 * e) + 16 * (b ^ sw) + 4 * (t >> 1);
        v[e][b] = __byte_perm(*reinterpret_cast<const uint32_t*>(p),
                              *reinterpret_cast<const uint32_t*>(p + 8), sel);
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      uint32_t val[2][2];   // [row, row + 8][low, high nibbles]
#pragma unroll
      for (int e = 0; e < 2; ++e) F::values(v[e][b], val[e][0], val[e][1]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {   // k16 step 2b + hf
        uint32_t(&af)[4] = a[hf];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t q = val[e][hf];
          af[e] = pack_bf16(__fmul_rn(s[e][b], scode_f(q, 0)),
                            __fmul_rn(s[e][b], scode_f(q, 1)));
          af[2 + e] = pack_bf16(__fmul_rn(s[e][b], scode_f(q, 2)),
                                __fmul_rn(s[e][b], scode_f(q, 3)));
        }
        wgmma_fence();
        wgmma_bf16<BN>(acc, af, x_desc_kh(st, T::XBOX, 2 * b + hf));
        wgmma_commit();
        wgmma_wait<1>();   // step k-1 is done: its A registers are free
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
  store_acc<BN>(acc, out, part, M, N, m0 + row, n0 + 2 * t);
}

// Launch `kernel` (a __global__ wrapper of tile<F, BN, WG>, named for its
// format) over a (M / ROWS, N / BN, splits) grid, then the split sum.
template <int BN, int WG, typename Kernel>
cudaError_t launch(Kernel kernel, const Fields& f, const uint8_t* qs, const void* xb,
                   float* out, float* part, int M, int N, int K, int splits, int per,
                   cudaStream_t st) {
  using T = Tile<BN, WG>;
  CUtensorMap tx, tqs;
  cudaError_t err = tensor_map_2d(&tx, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN, KC,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tqs, qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K / 2, T::ROWS, 64,
                        CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + T::ROWS - 1) / T::ROWS, (N + BN - 1) / BN, splits);
  Fields fv = f;
  void* args[] = {&tx, &tqs, &fv, &out, &part, &M, &N, &K, &per};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, dim3(T::THREADS), args,
                         T::SMEM, st);
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const size_t total = static_cast<size_t>(N) * M;
    mmq::add_splits<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
        part, out, splits, total);
  }
  return cudaSuccess;
}

}  // namespace block32_tc
