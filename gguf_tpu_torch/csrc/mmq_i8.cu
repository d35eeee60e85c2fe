// K7: the Q8_1 integer MMQ contract for Q4_K and Q5_K weights, n <= 16.
//
// Replaces gguf_tpu/ops/mmq_q4_k.py:_kernel_i8, reached through mmq_q4_k
// and mmq_q5_k under act_quant with precision "high" at n <= 16. It
// computes llama.cpp's integer MMQ math (gguf_tpu/quant/golden.py:
// mmq_q4_k_q8_1_golden): per 32-block b of row m and activation row n,
//
//   p = sum_k wq[m, k] * aq[n, k]      (int32, exact)
//   out[n, m] = sum_b p * dA[n, b] * (d*sc)[m, b]  -  sum_b s[n, b] * (dmin*mn)[m, b]
//
// with the Q8_1 codes aq, their d (dA) and s = fp16(d * sum(aq)) from K5.
// The TPU kernel builds block-partial int8 MXU dots with pltpu.repeat and
// an iota mask over K-major planes. Here every p is one int8 tensor-core
// step, mma.sync m16n8k32 s8 x s8 -> s32: A is 16 weight rows x one
// 32-block of codes (0..31 fit s8), B that block's codes of 8 activation
// rows (one or two n8 tiles). Each step's exact int32 fragment is folded
// into f32 accumulators at once, acc += (p * dA) * (d*sc), and the min term
// accm += s * (dmin*mn) beside it (fused multiply-adds: the f32 sums differ
// from the plain version's in rounding and order only), so no block's sum
// is rescaled late. (wgmma.m64nNk32.s8 would need one accumulator set per
// 32-block and a wait before each fold; mma.sync returns each block's
// fragment to the lanes that fold it.)
//
// What bounds it on an H100: the weight stream (144 or 176 bytes per 256
// weights) is the floor at n <= 16; above it the per-block work of
// unpacking scales and codes, then the fold, five operations per (row,
// activation row, 32-block). The design: a block of four warps owns 64
// rows and walks K in chunks of 128 elements through a ring of
// shared-memory stages that one thread fills with TMA copies (mmq_tc.cuh),
// STAGES - 1 chunks in flight; each lane's A fragment is 32-bit shared
// loads of nibbles ((v >> 4h) & 0x0F0F0F0F, Q5_K's fifth bits OR-ed in
// from qh); the chunk's activation codes ride in the same stage, dA and s
// are read one chunk ahead. M/64 blocks cannot fill 132 SMs at decode
// widths, so K is cut across the grid's z axis and a second launch adds the
// partial tiles in split order: the same bits each run.

#include "mmq_tc.cuh"

namespace {

using namespace tc;

// K7 walks K in chunks of KC7 = 128 elements: chunk c is nibble runs 2j and
// 2j+1 (j = c % 2) of superblock c / 2, i.e. 32-blocks 4j .. 4j+3, so one
// wait and one barrier cover four independent mma steps per row tile. One
// stage: TMA boxes of the activation codes (8*NT x 128 bytes, 128-byte
// swizzle), the chunk's nibble runs (64 x 64 bytes, 64-byte swizzle), for
// Q5_K the qh bytes (64 x 32, 32-byte swizzle) and the headers (64 x 16).
// The swizzles keep the fragment loads free of bank conflicts.
constexpr int KC7 = 2 * KC;

template <bool HAS_QH, int NT>
struct Tile {
  static constexpr int STAGES = 3;
  static constexpr int AHEAD = STAGES - 1;   // mma.sync is done with a stage
  static constexpr int CODES = 0;
  static constexpr int NIB = 8 * NT * KC7;
  static constexpr int QH = NIB + BM * 64;
  static constexpr int HDR = QH + (HAS_QH ? BM * 32 : 0);
  static constexpr int BYTES = HDR + BM * 16;   // what one stage's copies bring
  static constexpr int STAGE = (BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// (d*sc, dmin*mn) of 32-blocks 4j .. 4j+3 from a superblock header
__device__ __forceinline__ void scales4(const uint4& h, int j, float (&s)[4], float (&z)[4]) {
  float s2[2], z2[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    chunk_scales(h, 2 * j + e, s2, z2);
    s[2 * e] = s2[0];
    s[2 * e + 1] = s2[1];
    z[2 * e] = z2[0];
    z[2 * e + 1] = z2[1];
  }
}

template <bool HAS_QH, int NT>
__global__ void __launch_bounds__(NTHREADS)
mmq_i8_kernel(const __grid_constant__ CUtensorMap thdr, const __grid_constant__ CUtensorMap tqh,
              const __grid_constant__ CUtensorMap tnib, const __grid_constant__ CUtensorMap tcodes,
              const float* __restrict__ da, const float* __restrict__ sa,
              float* __restrict__ out, float* __restrict__ part, int M, int N, int K,
              int chunks_per_split) {
  using T = Tile<HAS_QH, NT>;
  using L = kquant::Layout<HAS_QH>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[T::STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.z * chunks_per_split;
  const int nch = min(K / KC7, c0 + chunks_per_split) - c0;
  const int nb = K / 32;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + g;   // and row + 8

  auto load = [&](int i) {   // the block's i-th chunk into stage i % STAGES
    if (threadIdx.x == 0 && i < nch) {
      const int c = c0 + i, st = i % T::STAGES;
      uint8_t* dst = smem + st * T::STAGE;
      const int col = (c >> 1) * L::BYTES;   // the superblock's bytes in a row
      mbar_expect_tx(&full[st], T::BYTES);
      tma_load_2d(dst + T::CODES, &tcodes, KC7 * c, 0, &full[st]);
      tma_load_2d(dst + T::NIB, &tnib, col + L::QS + 64 * (c & 1), m0, &full[st]);
      if constexpr (HAS_QH) tma_load_2d(dst + T::QH, &tqh, col + L::QH, m0, &full[st]);
      tma_load_2d(dst + T::HDR, &thdr, col, m0, &full[st]);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::AHEAD; ++i) load(i);

  float acc[NT][4], accm[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = accm[j][e] = 0.f;
  // dA and s of this lane's activation rows n = 8j + 2t + u for blocks
  // 4c .. 4c+3 (L1/L2 hits), read one chunk ahead
  float4 dnext[NT][2], snext[NT][2];
  auto load_ds = [&](int c) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const size_t e = static_cast<size_t>(min(8 * j + 2 * t + u, N - 1)) * nb + 4 * c;
        dnext[j][u] = *reinterpret_cast<const float4*>(da + e);
        snext[j][u] = *reinterpret_cast<const float4*>(sa + e);
      }
  };
  load_ds(c0);
  const int sw64 = (g >> 1) & 3, sw32 = (g >> 2) & 1;   // the rows' swizzle phases

  for (int i = 0; i < nch; ++i) {
    __syncthreads();   // every warp is done with chunk i-1's stage
    load(i + T::AHEAD);
    const int c = c0 + i;
    const uint8_t* st = smem + (i % T::STAGES) * T::STAGE;
    float4 dv[NT][2], sv[NT][2];   // this chunk's, then the next one's
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        dv[j][u] = dnext[j][u];
        sv[j][u] = snext[j][u];
      }
    if (i + 1 < nch) load_ds(c + 1);
    mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
    float s[2][4], z[2][4];   // [row, row + 8][block 4j .. 4j+3]
    uint32_t nw[2][4], qw[2][2] = {};   // nibble words t, 4+t of runs 2j, 2j+1
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e;
      scales4(*reinterpret_cast<const uint4*>(st + T::HDR + 16 * r), c & 1, s[e], z[e]);
#pragma unroll
      for (int p = 0; p < 4; ++p)   // 16-byte piece p of the 64-byte row
        nw[e][p] = *reinterpret_cast<const uint32_t*>(st + T::NIB + 64 * r +
                                                      16 * (p ^ sw64) + 4 * t);
      if constexpr (HAS_QH)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          qw[e][u] = *reinterpret_cast<const uint32_t*>(st + T::QH + 32 * r +
                                                        16 * (u ^ sw32) + 4 * t);
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {   // 32-block 4j + h: nibble h%2 of run 2j + h/2
      const int b = 4 * (c & 1) + h;
      uint32_t a[4];   // (row, k 4t..), (row+8, k 4t..), (row, k 16+4t..), (row+8, ..)
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        a[i4] = (nw[i4 & 1][2 * (h >> 1) + (i4 >> 1)] >> (4 * (h & 1))) & 0x0F0F0F0Fu;
        if constexpr (HAS_QH) a[i4] |= ((qw[i4 & 1][i4 >> 1] >> b) & 0x01010101u) << 4;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // codes row n = 8j + g: 16-byte pieces 2h and 2h+1, 128-byte swizzle
        const int n = 8 * j + g;
        const uint8_t* cr = st + T::CODES + KC7 * n + 4 * t;
        int p[4];
        mma_s8(p, a, *reinterpret_cast<const uint32_t*>(cr + 16 * ((2 * h) ^ g)),
               *reinterpret_cast<const uint32_t*>(cr + 16 * ((2 * h + 1) ^ g)));
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // (row + 8*(e/2), n = 8j + 2t + e%2)
          const float4& d4 = dv[j][e & 1];
          const float4& s4 = sv[j][e & 1];
          const float dn = h == 0 ? d4.x : h == 1 ? d4.y : h == 2 ? d4.z : d4.w;
          const float sn = h == 0 ? s4.x : h == 1 ? s4.y : h == 2 ? s4.z : s4.w;
          // |p| <= 32 * 127 * 31 < 2^22: p + 1.5 * 2^23 is exact as a float
          const float pf = __int_as_float(p[e] + 0x4B400000) - 12582912.0f;
          acc[j][e] = fmaf(pf * dn, s[e >> 1][h], acc[j][e]);
          accm[j][e] = fmaf(sn, z[e >> 1][h], accm[j][e]);
        }
      }
    }
  }
  float* dst = gridDim.z > 1 ? part + static_cast<size_t>(blockIdx.z) * N * M : out;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + row + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      if (m < M && n < N) dst[static_cast<size_t>(n) * M + m] = acc[j][e] - accm[j][e];
    }
}

template <bool HAS_QH, int NT>
cudaError_t launch(const uint8_t* w, const int8_t* aq, const float* da, const float* sa,
                   float* out, float* part, int M, int N, int K, int splits, int per,
                   cudaStream_t st) {
  using T = Tile<HAS_QH, NT>;
  using L = kquant::Layout<HAS_QH>;
  const uint64_t row_bytes = static_cast<uint64_t>(K / 256) * L::BYTES;
  const auto U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap thdr, tqh, tnib, tcodes;
  cudaError_t err = tensor_map_2d(&thdr, w, U8, 1, M, row_bytes, BM, 16,
                                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tnib, w, U8, 1, M, row_bytes, BM, 64, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)   // never read for Q4_K
    err = tensor_map_2d(&tqh, w, U8, 1, M, row_bytes, BM, 32, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tcodes, aq, U8, 1, N, K, 8 * NT, KC7, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mmq_i8_kernel<HAS_QH, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, 1, splits);
  mmq_i8_kernel<HAS_QH, NT><<<grid, NTHREADS, T::SMEM, st>>>(thdr, tqh, tnib, tcodes, da, sa,
                                                             out, part, M, N, K, per);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(N) * M;
    mmq::add_splits<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
        part, out, splits, total);
  }
  return cudaSuccess;
}

}  // namespace

// w: (M, K/256*144) Q4_K or (M, K/256*176) Q5_K GGUF bytes (has_qh),
// 16-byte aligned; aq: (N, K) int8 Q8_1 codes, da, sa: (N, K/32) f32 d and
// s, all 16-byte aligned; out: (N, M) f32; part: (splits,
// N, M) f32 scratch when splits > 1, K cut into splits ranges of
// chunks_per_split 64-element chunks. N <= 16.
extern "C" int mmq_i8_launch(const void* w, const void* aq, const void* da,
                             const void* sa, void* out, void* part, int M, int N, int K,
                             int has_qh, int splits, int chunks_per_split, void* stream) {
  const int chunks = K / KC7;   // every split has a chunk
  if (K % 256 != 0 || M <= 0 || N <= 0 || N > 16 || splits < 1 || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= chunks || splits * chunks_per_split < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* ap = static_cast<const int8_t*>(aq);
  const auto* dp = static_cast<const float*>(da);
  const auto* sp = static_cast<const float*>(sa);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(part);
  const int per = chunks_per_split;
  cudaError_t err;
  if (has_qh) {
    if (N <= 8) err = launch<true, 1>(wp, ap, dp, sp, op, pp, M, N, K, splits, per, st);
    else err = launch<true, 2>(wp, ap, dp, sp, op, pp, M, N, K, splits, per, st);
  } else {
    if (N <= 8) err = launch<false, 1>(wp, ap, dp, sp, op, pp, M, N, K, splits, per, st);
    else err = launch<false, 2>(wp, ap, dp, sp, op, pp, M, N, K, splits, per, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
