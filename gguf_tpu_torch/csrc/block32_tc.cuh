// The bf16 tensor-core tile of the 32-element-block formats under "fast",
// over the per-field arrays QuantWeight splits their blocks into
// (block32.cuh lists them). K14 (mmq_iq4.cu: IQ4_NL, IQ4_XS), K11
// (mmq_legacy.cu: Q4_0, Q4_1, Q5_0, Q5_1) and K10 (mmq_q8_0.cu: Q8_0) run
// it; the format is a policy F (the code bytes per row and chunk, the
// fields read by plain loads, the scale of each 32-block, the
// code-to-value step, and for K11 the f32 correction term).
//
// out (N, M) f32 = x . W^T with w = bf16(scale * value(q)) rounded in that
// order and x = bf16(x), f32 sums. A warpgroup owns 64 weight rows (two
// share each activation tile above n = 64) and walks K in chunks of KH =
// 128 elements: four 32-blocks, whose code bytes are one TMA box per row
// of the qs field, so every code byte leaves device memory once. F::CODE
// says how many: 64 for the nibble formats (16 bytes per block, byte j
// holding element j in the low nibble and j + 16 in the high; a box over
// the (M, K/2) field, 64-byte swizzle) or 128 for Q8_0 (32 int8 codes per
// block in element order; a box over the (M, K) field, 128-byte swizzle).
// A stage holds the x tile (two (BN x 64) bf16 boxes, 128-byte swizzle:
// wgmma's K-major layout) and the rows' code bytes (swizzled so the
// fragment loads are conflict-free); the other fields, a few bytes per row and
// chunk (IQ4_XS's d row of K/128 bytes breaks TMA's 16-byte stride rule at
// K = 256, and loading 16-byte-wide boxes for K7's dA/s raised
// cudaErrorIllegalInstruction on the H100), are plain loads one chunk
// ahead.
// k16 step s of a chunk lies in 32-block s/2. For the nibble formats it is
// the low nibbles when s is even, the high ones when odd, so lane t's four
// codes of steps 2b and 2b+1 are nibbles of bytes 2t, 2t+1, 2t+8 and 2t+9
// of block b: K1's byte permute gives them in one word, and F::values
// turns its eight codes into two words of int8 values, one per step. For
// Q8_0 step s is the 16 code bytes s of the row's 128, and lane t's four
// codes are bytes 2t, 2t+1, 2t+8 and 2t+9 of them: two 32-bit shared loads
// and the same byte permute give them as int8 values, with no lookup.
// A chunk past K (Q8_0 takes any K that is a multiple of 32, so its last
// chunk may hold 1-3 blocks) arrives as zeros from TMA's out-of-bounds
// fill, and F::small masks the plain loads past K. STAGES - 2 chunks are in flight;
// blocks start at different chunks of their K range; K is cut across the
// grid's z axis in whole chunks and mmq::add_splits adds the partial tiles
// in split order.
//
// A policy with a correction term (F::CORR, K11's split product) adds
// bsum . corr^T in f32: corr = F::corr per row and 32-block, bsum the sum
// of the block's activations as the caller gave them (not bf16-rounded).
// Those sums come from one of two places, and both keep the reference's
// numbers: when the operand is bf16 (xb == x, the served path) the staged
// tile holds exactly the caller's values, so each chunk's four sums per
// activation row are taken from it in f32 (K12's pattern: no extra pass);
// when it is f32 (K6's output under act_quant, compat, direct calls) the
// staged tile has lost those values, so the pass that writes the bf16
// operand (to_bf16_bsum) reads x once and also writes the (N, K/32) f32
// sums, which the tile reads (Fields::bsum). Under act_quant (fp16_bsum)
// each sum is rounded through fp16, Q8_1's s field. The term is an f32
// register tile beside the wgmma accumulator, fed one chunk late from
// shared memory after the loop's one barrier, and added to the product
// once at the end (main + correction, the reference's order). Such a tile
// drains its wgmma steps at each chunk's end: with one in flight across
// the boundary ptxas serialized them all (C7515), and the drain costs less.
#pragma once

#include "mmq_tc.cuh"

namespace block32_tc {

using namespace tc;

// BN activation rows x WG warpgroups of 64 weight rows per block. A stage:
// the x tile (two (BN x 64) bf16 boxes of XBOX bytes) and the rows' CODE
// code bytes of the chunk.
template <int BN, int WG, int CODE = 64>
struct Tile {
  static constexpr int ROWS = BM * WG;
  static constexpr int THREADS = NTHREADS * WG;
  static constexpr int STAGES = 4;
  static constexpr int AHEAD = STAGES - 2;   // chunks loaded ahead
  static constexpr int XBOX = BN * KC * 2;
  static constexpr int QS = 2 * XBOX;
  static constexpr int STAGE = QS + ROWS * CODE;
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static_assert(XBOX % 1024 == 0 && STAGE % 1024 == 0,
                "every box of a stage must be 1024-byte aligned");
};

// xb (N, K) bf16 = bf16(x) and bsum (N, K/32) f32 = the sums of x's
// 32-blocks as given (rounded through fp16 when fp16_bsum): one warp per
// block, one element per lane, the sum a butterfly reduction
template <bool XBF16>
__global__ void __launch_bounds__(256)
to_bf16_bsum(const void* __restrict__ x, __nv_bfloat16* __restrict__ xb,
             float* __restrict__ bsum, size_t blocks, int fp16_bsum) {
  const int lane = threadIdx.x & 31;
  const size_t warps = (static_cast<size_t>(gridDim.x) * blockDim.x) >> 5;
  for (size_t w = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       w < blocks; w += warps) {
    const size_t e = 32 * w + lane;
    const float v = mmq::load_x<XBF16>(x, e);
    xb[e] = __float2bfloat16_rn(v);
    float sum = v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) bsum[w] = fp16_bsum ? __half2float(__float2half_rn(sum)) : sum;
  }
}

inline void launch_to_bf16_bsum(const void* x, void* xb, float* bsum, int N, int K, int x_bf16,
                                int fp16_bsum, cudaStream_t st) {
  const size_t blocks = static_cast<size_t>(N) * (K / 32);
  const unsigned grid = static_cast<unsigned>(std::min<size_t>((blocks + 7) / 8, 4096));
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  if (x_bf16) to_bf16_bsum<true><<<grid, 256, 0, st>>>(x, xbp, bsum, blocks, fp16_bsum);
  else to_bf16_bsum<false><<<grid, 256, 0, st>>>(x, xbp, bsum, blocks, fp16_bsum);
}

// The weight's fields besides qs, as the format's policy reads them (null
// where it has no such field), and a correction term's block sums: bsum
// (N, K/32) f32 from to_bf16_bsum, or null to sum the staged bf16 tile;
// fp16_bsum rounds the latter through fp16.
struct Fields {
  const uint16_t* d;
  const uint16_t* scales_h;
  const uint8_t* scales_l;
  const uint16_t* m;
  const uint32_t* qh;
  const float* bsum;
  int fp16_bsum;
};

// The kernel body. F provides:
//   F::CODE: code bytes per row and chunk, 64 (nibbles) or 128 (int8);
//   F::Small, F::small(fields, m, K, c) -> Small: row m's plain-load fields
//     of chunk c (zero past K);
//   F::scale(small, c, b) -> float: the f32 scale of 32-block b (0..3) of
//     chunk c, rounded as the reference rounds it;
//   F::values(v, small, b, t, lo, hi) (CODE 64 only): v holds lane t's
//     four code bytes of block b; lo and hi get the int8 values of their
//     low and of their high nibbles, in byte order;
//   F::CORR, F::corr(small, b) -> float: whether there is a correction
//     term, and (CORR only) its f32 factor for block b.
template <class F, int BN, int WG>
__device__ __forceinline__ void tile(const CUtensorMap& tx, const CUtensorMap& tqs,
                                     const Fields& f, float* __restrict__ out,
                                     float* __restrict__ part, int M, int N, int K,
                                     int chunks_per_split) {
  using T = Tile<BN, WG, F::CODE>;
  using Small = typename F::Small;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[T::STAGES];
  // F::CORR: the block sums by chunk parity, 32-block, n (read as float2)
  __shared__ __align__(16) float bs[F::CORR ? 2 : 1][4][F::CORR ? BN : 2];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * T::ROWS, n0 = blockIdx.y * BN;
  const int c0 = blockIdx.z * chunks_per_split;
  const int nch = min((K + KH - 1) / KH, c0 + chunks_per_split) - c0;
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
      tma_load_2d(dst + T::QS, &tqs, F::CODE * c, m0, &full[st]);
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
  Small smn[2];
  auto load_small = [&](int i) {
    const int c = chunk(i);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + row + 8 * e;
      smn[e] = m < M ? F::small(f, static_cast<size_t>(m), K, c) : Small{};
    }
  };
  load_small(0);

  float acc[BN / 2], accc[F::CORR ? BN / 2 : 1];   // accc: the correction term
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (F::CORR ? BN / 2 : 1); ++i) accc[i] = 0.f;
  float cp[2][4];   // F::CORR: the previous chunk's corr [row, row + 8][32-block]
  // accc += bsum . corr^T of the previous chunk
  auto add_corr = [&](const float (*b)[F::CORR ? BN : 2]) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const float2 bv = *reinterpret_cast<const float2*>(&b[s][8 * jn + 2 * t]);
        accc[4 * jn] = fmaf(cp[0][s], bv.x, accc[4 * jn]);
        accc[4 * jn + 1] = fmaf(cp[0][s], bv.y, accc[4 * jn + 1]);
        accc[4 * jn + 2] = fmaf(cp[1][s], bv.x, accc[4 * jn + 2]);
        accc[4 * jn + 3] = fmaf(cp[1][s], bv.y, accc[4 * jn + 3]);
      }
  };
  uint32_t a[2][4];
  // lane t's codes of a step are bytes 2t, 2t+1, 8+2t, 9+2t of 16 code
  // bytes (a nibble block's, or a Q8_0 step's): halves of words t/2 and
  // t/2 + 2 (K1's pattern). Piece u (16 bytes) of row r sits at u ^ ((r >>
  // 1) & 3) under the 64-byte swizzle and at u ^ (r & 7) under the 128-byte
  // one; r & 7 is g for both of this lane's rows.
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  const int sw = F::CODE == 64 ? (g >> 1) & 3 : g;
  auto codes = [&](const uint8_t* qrow, int u) {   // piece u of a row's codes
    const uint8_t* p = qrow + 16 * (u ^ sw) + 4 * (t >> 1);
    return __byte_perm(*reinterpret_cast<const uint32_t*>(p),
                       *reinterpret_cast<const uint32_t*>(p + 8), sel);
  };

  for (int i = 0; i < nch; ++i) {
    // every warp is past chunk i-1's first wgmma_wait, so chunk i-2's
    // stage is free for chunk i + AHEAD, and chunk i-1's block sums are
    // written
    __syncthreads();
    load(i + T::AHEAD);
    if constexpr (F::CORR) {
      if (i > 0) add_corr(bs[(i - 1) & 1]);
    }
    const int c = chunk(i);
    const Small smc[2] = {smn[0], smn[1]};
    if (i + 1 < nch) load_small(i + 1);
    const uint8_t* st = smem + (i % T::STAGES) * T::STAGE;
    mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
    if constexpr (F::CORR) {
      // this chunk's 4 block sums per activation row: from to_bf16_bsum's
      // array, or 32 bf16 of the staged x tile (16-byte piece u of row n
      // sits at u ^ (n % 8))
      for (int p = threadIdx.x; p < 4 * BN; p += T::THREADS) {
        const int n = p >> 2, b = p & 3;
        float sum = 0.f;
        if (f.bsum) {
          if (n0 + n < N) sum = f.bsum[static_cast<size_t>(n0 + n) * (K / 32) + 4 * c + b];
        } else {
          const uint8_t* xr = st + (b >> 1) * T::XBOX + 128 * n;
#pragma unroll
          for (int u = 4 * (b & 1); u < 4 * (b & 1) + 4; ++u)
            sum += bf16_sum8(*reinterpret_cast<const uint4*>(xr + 16 * (u ^ (n & 7))));
          if (f.fp16_bsum) sum = __half2float(__float2half_rn(sum));
        }
        bs[i & 1][b][n] = sum;
      }
    }
    float s[2][4];      // [row, row + 8][32-block] scale
    uint32_t v[2][4];   // [row, row + 8][32-block] this lane's nibble bytes
    const uint8_t* qrow[2] = {st + T::QS + F::CODE * row, st + T::QS + F::CODE * (row + 8)};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[e][b] = F::scale(smc[e], c, b);
        if constexpr (F::CORR) cp[e][b] = F::corr(smc[e], b);
        if constexpr (F::CODE == 64) v[e][b] = codes(qrow[e], b);
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      uint32_t val[2][2];   // [row, row + 8][steps 2b, 2b + 1]: int8 values
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (F::CODE == 64) {
          F::values(v[e][b], smc[e], b, t, val[e][0], val[e][1]);
        } else {
          val[e][0] = codes(qrow[e], 2 * b);
          val[e][1] = codes(qrow[e], 2 * b + 1);
        }
      }
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
    if constexpr (F::CORR) wgmma_wait<0>();   // no step in flight across chunks
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
  if constexpr (F::CORR) {
    __syncthreads();   // the last chunk's block sums
    add_corr(bs[(nch - 1) & 1]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += accc[i];   // main + correction
  }
  store_acc<BN>(acc, out, part, M, N, m0 + row, n0 + 2 * t);
}

// Launch `kernel` (a __global__ wrapper of tile<F, BN, WG>, named for its
// format, F::CODE = CODE) over a (M / ROWS, N / BN, splits) grid, then the
// split sum.
template <int BN, int WG, int CODE = 64, typename Kernel>
cudaError_t launch(Kernel kernel, const Fields& f, const uint8_t* qs, const void* xb,
                   float* out, float* part, int M, int N, int K, int splits, int per,
                   cudaStream_t st) {
  using T = Tile<BN, WG, CODE>;
  CUtensorMap tx, tqs;
  cudaError_t err = tensor_map_2d(&tx, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN, KC,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tqs, qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M,
                        static_cast<uint64_t>(K) * CODE / KH, T::ROWS, CODE,
                        CODE == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
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
