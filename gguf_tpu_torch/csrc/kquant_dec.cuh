// K1's decode-width tile under "fast" (n <= 16): Q4_K superblocks as stored
// in GGUF (kquant.cuh), bf16 wgmma with A decoded in registers, for Hopper.
//
// The function is kquant_tc.cuh's: w = bf16((d*sc)*q - dmin*mn), the min
// folded into each weight before rounding, x = bf16(x), f32 sums. What
// bounded that tile at decode widths was latency, issue slots and a second
// launch, not bytes: one stage was one 64-element chunk, only STAGES - 2 =
// 2 chunks were in flight per block, thread 0 issued copies and computed,
// a __syncthreads ran every chunk, the header came again for each of a
// superblock's four chunks, and where M / 64 row tiles could not fill 132
// SMs, K was split across the grid and mmq::add_splits summed the parts.
// This tile:
//  - warp specialisation and a ring of whole superblocks: one producer
//    warp only issues TMA copies into a ring of STAGES stages; WGS consumer
//    warpgroups each own 64 weight rows of a ROWS = 64 * WGS row tile and
//    share each staged x tile (x's L2 reads halve at two). A stage is one
//    whole superblock of the tile's rows, so each header is fetched once:
//    the x tile (BN x 256 bf16, four 128-byte-swizzled boxes of BN x 64:
//    wgmma's K-major layout) and the rows' 144 bytes (one box of ROWS x 36
//    words, unswizzled: the row stride of 36 words puts lanes g = 0..7 on
//    distinct banks), read with ld.shared (a pointer rounded through an
//    integer compiles to generic loads). With (BN, WGS, STAGES) = (16, 2,
//    4) a stage is 26 KB and up to 3 x 18 KB of weight bytes are in flight
//    per SM (Little's law at 3.35 TB/s needs ~25 KB); deeper rings timed
//    slower at n = 16 (8 stages: 42.5% of the bytes bound at gate_up
//    against 47.5%), the shared memory they take leaving the SM little L1. A warp
//    decodes half a superblock (8 k16 steps) into one of two register sets
//    of A, then issues its 8 wgmma steps as one group over four
//    independent accumulator chains and decodes the other half while they
//    run; it gives a stage back once the groups that read it are done,
//    the previous superblock's after the first group of the next. No C++
//    branch or loop sits between wgmma steps in flight (the mbarrier spin
//    and the conditional arrival are inside their asm, a row tile's
//    segment is an outer loop), where ptxas would serialize them.
//  - a cheaper dequantize with the same bits: d*sc is exact in f32 (an
//    11-bit fp16 significand times a 6-bit scale) and so is (d*sc)*q (at
//    most 21 bits), so fmaf(d*sc, q, -(dmin*mn)) rounds once, exactly where
//    __fsub_rn(__fmul_rn(d*sc, q), dmin*mn) does. And no instruction turns
//    a code into a float: a nibble masked in place at bits p .. p+3 of a
//    word is the subnormal float q 2^(p - 149), exact, so one LOP3 gives
//    it, and the fma takes d*sc 2^(105 - p) and dmin*mn 2^-44: its result
//    is the codec's weight times 2^-44, rounded at the same place (every
//    operand and result normal: |d*sc| < 2^22, a nonzero weight a multiple
//    of 2^-24), so bf16 of it is the codec's bf16 weight times 2^-44, bit
//    for bit, and the f32 sums, scaled alike, are multiplied back by 2^44
//    when stored. In the SASS of the (16, 2, 4) instantiation (cuobjdump
//    -sass) a lane's superblock, 128 weights, is 710 instructions: per
//    code one LOP3, one FFMA and half an F2FP, the rest scales, loads and
//    wgmma steps; with kquant_tc.cuh's magic-number codes (a PRMT into
//    0x4B0000qq and an FADD of -2^23 per code, the nibble masks) the same
//    loop was 845.
//  - persistent work with the split sum inside: gridDim.x blocks (about
//    one per SM) walk the W (row tile, superblock) units of the weight in
//    tile-major order, block b taking units [b W / G, (b+1) W / G), so
//    every SM gets an equal share at every shape. A block's range cuts
//    row tiles into segments; a segment that covers its tile's whole K
//    stores its sums, any other writes them to slot b + t of the scratch
//    (distinct per segment: the next segment is block b+1's or tile t+1's)
//    and the last of the tile's segments to finish, found by an atomic
//    counter per (tile, warpgroup) that it then resets, adds the slots in
//    block order. So the result has the same bits on every run and every
//    graph replay, nothing is read back to the host, and no add_splits
//    runs. The counters are one __device__ array of the library: launches
//    of this tile must not run concurrently on two streams.
#pragma once

#include "mmq_tc.cuh"

namespace kquant_dec {

using namespace tc;

constexpr int SB = 256;            // K elements per superblock
constexpr int SBW = 36;            // 32-bit words per Q4_K superblock (144 bytes)
constexpr int MAX_COUNTERS = 65536;

// BN activation rows (8 or 16), WGS consumer warpgroups of 64 weight rows,
// a ring of STAGES superblock stages: x (four BN x 64 bf16 boxes), then the
// tile's rows (ROWS x 144 bytes), each stage 1024-byte aligned.
template <int BN, int WGS, int STAGES>
struct Dec {
  static constexpr int ROWS = BM * WGS;
  static constexpr int CONSUMERS = NTHREADS * WGS;
  static constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
  static constexpr int XBOX = BN * KC * 2;
  static constexpr int WOFF = 4 * XBOX;   // the weight rows' offset in a stage
  static constexpr int STAGE = WOFF + ROWS * SBW * 4;
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static constexpr int PER = BN / 2;               // accumulators per thread and chain
  static constexpr int CHAINS = 4;                 // independent accumulator chains
  static_assert(XBOX % 1024 == 0 && STAGE % 1024 == 0, "stages and boxes 1024-byte aligned");
  static_assert(SMEM <= 232448, "the ring exceeds a block's shared memory");
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// an arrival where `pred`, predicated inside the instruction: no branch
// between the wgmma steps, which ptxas would answer by serializing them
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, int pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(pred)
      : "memory");
}

// mmq_tc.cuh:mbar_wait with its spin loop inside the asm, for the same reason
__device__ __forceinline__ void mbar_wait_asm(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a barrier of the `count` threads of one warpgroup (ids 1.., 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// the fixed fields of smem_desc_sw128 (mmq_tc.cuh): OR in (address >> 4)
constexpr uint64_t DESC_HI = 1ull << 16 | static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;

// The codes as subnormal floats (see the note above): a code at bits p ..
// p+3 of a word, masked in place, is the float q 2^(p - 149), exact; so
// fmaf(d*sc 2^(105 - p), q 2^(p - 149), -dmin*mn 2^-44) is the codec's
// (d*sc)*q - dmin*mn, rounded once, times 2^-44 exactly (every operand and
// result a normal float: |d| < 2^16, |w| >= 2^-24 unless 0), and the sums
// are scaled back by 2^44 before they are stored.
constexpr float SUB_OUT = 0x1p44f;

// (d*sc 2^(105 - p), at both code positions p of the block's nibble, and
// dmin*mn 2^-44) of 32-blocks 4hh .. 4hh+3 from a superblock header: p = 0
// and 8 for the low nibbles (even blocks), 4 and 12 for the high ones
__device__ __forceinline__ void half_scales(const uint4& h, int hh, float d, float dmin,
                                            float (&s)[4][2], float (&z)[4]) {
  uint32_t sc, mn;
  if (hh == 0) {   // the low 6 bits of bytes 0..3 / 4..7
    sc = h.y & 0x3F3F3F3Fu;
    mn = h.z & 0x3F3F3F3Fu;
  } else {         // nibbles of bytes 8..11, top bits of 0..7
    sc = (h.w & 0x0F0F0F0Fu) | ((h.y >> 2) & 0x30303030u);
    mn = ((h.w >> 4) & 0x0F0F0F0Fu) | ((h.z >> 2) & 0x30303030u);
  }
  const float dz = __fmul_rn(dmin, 0x1p-44f);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float scf = code_f(sc, e);
    // d 2^(105 - p): p = 0, 8 for a low nibble, 4, 12 for a high one
    const float d0 = __fmul_rn(d, (e & 1) ? 0x1p101f : 0x1p105f);
    const float d1 = __fmul_rn(d, (e & 1) ? 0x1p93f : 0x1p97f);
    s[e][0] = __fmul_rn(d0, scf);
    s[e][1] = __fmul_rn(d1, scf);
    z[e] = __fmul_rn(dz, code_f(mn, e));
  }
}

// the codec's weight, rounded once (see the note above)
__device__ __forceinline__ float dq(float s, float z, float q) {
  return __fmaf_rn(s, q, -z);
}

// the code masked in place as a float (q 2^(p - 149))
__device__ __forceinline__ float sub_f(uint32_t v, uint32_t mask) {
  return __uint_as_float(v & mask);
}

// the block that owns unit u when `units` are cut into G ranges [b units / G, ...)
__device__ __forceinline__ int owner(int u, long long units, int G) {
  return static_cast<int>((static_cast<long long>(u + 1) * G - 1) / units);
}

// out (N, M) f32 = x . W^T over the block's range of units; tx maps the
// (N, K) bf16 operand in BN x 64 boxes, tw the (M, K/256 * 36) words of the
// weight in ROWS x 36 boxes; part: the (G + T - 1) slots of ROWS x BN f32
// partial sums; done: T * WGS counters, zero between launches.
template <int BN, int WGS, int STAGES>
__device__ __forceinline__ void tile(const CUtensorMap& tx, const CUtensorMap& tw,
                                     float* __restrict__ out, float* __restrict__ part,
                                     int* __restrict__ done, int M, int N, int K) {
  using D = Dec<BN, WGS, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ int last[WGS];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int S = K / SB, T = (M + D::ROWS - 1) / D::ROWS;
  const long long units = static_cast<long long>(T) * S;
  const int G = gridDim.x, b = blockIdx.x;
  const int lo = static_cast<int>(b * units / G),
            hi = static_cast<int>((b + 1) * units / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], D::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * WGS) {   // the producer: copies only
    if (lane == 0) {
      for (int u = lo, i = 0; u < hi; ++u, ++i) {
        const int st = i % STAGES, t = u / S, sb = u - t * S;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        uint8_t* dst = smem + st * D::STAGE;
        mbar_expect_tx(&full[st], D::STAGE);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tma_load_2d(dst + c * D::XBOX, &tx, SB * sb + KC * c, 0, &full[st]);
        tma_load_2d(dst + D::WOFF, &tw, SBW * sb, t * D::ROWS, &full[st]);
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, tq = lane & 3;
  const int tid = threadIdx.x - wg * NTHREADS;
  const int r0 = wg * BM + 16 * (warp & 3) + g;   // this lane's stage rows: r0, r0 + 8
  // lane tq's codes of a k16 step are bytes 2tq, 2tq+1, 8+2tq, 9+2tq of a
  // 16-byte half of the nibble run: halves of words tq/2 and tq/2 + 2
  const uint32_t sel = (tq & 1) ? 0x7632u : 0x5410u;
  const uint32_t base = smem_u32(smem);
  float acc[D::CHAINS][D::PER];   // step k adds into chain k % CHAINS
  uint32_t a[2][8][4];   // A of the eight k16 steps of each half of a superblock

  for (int u = lo, i = 0; u < hi;) {   // a segment: the block's units of row tile t
    const int t = u / S, first = u, end = min(hi, (t + 1) * S);
#pragma unroll
    for (int c = 0; c < D::CHAINS; ++c)
#pragma unroll
      for (int e = 0; e < D::PER; ++e) acc[c][e] = 0.f;
    for (; u < end; ++u, ++i) {
      const int st = i % STAGES;
      const uint32_t stg = base + st * D::STAGE;
      const uint32_t wr[2] = {stg + D::WOFF + 144 * r0, stg + D::WOFF + 144 * (r0 + 8)};
      const uint32_t xd = (stg & 0x3FFFF) >> 4;   // the x tile's descriptor address
      mbar_wait_asm(&full[st], (i / STAGES) & 1);
      uint4 h[2];
      float d[2], dmin[2];
      uint32_t v[2][4][2];   // [row][nibble run][half of the run]: this lane's code bytes
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        h[e] = lds128(wr[e]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const uint32_t p = wr[e] + 16 + 32 * j + 16 * q + 4 * (tq >> 1);
            v[e][j][q] = __byte_perm(lds32(p), lds32(p + 8), sel);
          }
        d[e] = kquant::half_lo(h[e].x);
        dmin[e] = kquant::half_hi(h[e].x);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {   // blocks 4hh .. 4hh+3: nibble runs 2hh, 2hh+1
        float s[2][4][2], z[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e) half_scales(h[e], hh, d[e], dmin[e], s[e], z[e]);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {   // run 2hh + kk/4: block 2(2hh + kk/4) + k/2, half k%2
          const int jj = kk >> 2, k = kk & 3, bl = 2 * jj + (k >> 1);
          const uint32_t m0 = (k >> 1) ? 0xF0u : 0x0Fu, m1 = m0 << 8;   // nibble of byte 0, 1
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t w = v[e][2 * hh + jj][k & 1], w2 = w >> 16;   // bytes 0, 1 | 2, 3
            const float s0 = s[e][bl][0], s1 = s[e][bl][1], zz = z[e][bl];
            a[hh][kk][e] = pack_bf16(dq(s0, zz, sub_f(w, m0)), dq(s1, zz, sub_f(w, m1)));
            a[hh][kk][2 + e] = pack_bf16(dq(s0, zz, sub_f(w2, m0)), dq(s1, zz, sub_f(w2, m1)));
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)   // x box 2hh + kk/4, 32 bytes (16 bf16) per k16 step
          wgmma_bf16<BN>(acc[kk % D::CHAINS], a[hh][kk],
                         DESC_HI | (xd + (2 * hh + (kk >> 2)) * (D::XBOX >> 4) + 2 * (kk & 3)));
        wgmma_commit();
        wgmma_wait<1>();   // the group before is done: its A set and its stage are free
        // after the first half, the previous unit's stage (none at a segment's start)
        if (hh == 0) mbar_arrive_if(&empty[(i + STAGES - 1) % STAGES], u > first);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D::CHAINS; ++c)
#pragma unroll
      for (int e = 0; e < D::PER; ++e) fence_operand(acc[c][e]);
#pragma unroll
    for (int c = 1; c < D::CHAINS; ++c)   // the chains in a fixed order: the same bits each run
#pragma unroll
      for (int e = 0; e < D::PER; ++e) acc[0][e] += acc[c][e];
    mbar_arrive(&empty[(i + STAGES - 1) % STAGES]);   // the segment's last unit's

    // the segment's end: store, or add to the tile's other segments
    const int m = t * D::ROWS + r0, n = 2 * tq;
    auto store = [&](const float(&c)[D::PER]) {
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int mm = m + 8 * (e >> 1), nn = n + 8 * jn + (e & 1);
          if (mm < M && nn < N) out[static_cast<size_t>(nn) * M + mm] = c[4 * jn + e] * SUB_OUT;
        }
    };
    const int b0 = owner(t * S, units, G), b1 = owner(t * S + S - 1, units, G);
    if (b0 == b1) {
      store(acc[0]);
    } else {
      auto slot = [&](int bb) {
        return part + (static_cast<size_t>(bb + t) * WGS + wg) * (NTHREADS * D::PER) +
               tid * D::PER;
      };
      float4* mine = reinterpret_cast<float4*>(slot(b));
#pragma unroll
      for (int e = 0; e < D::PER / 4; ++e)
        mine[e] = make_float4(acc[0][4 * e], acc[0][4 * e + 1], acc[0][4 * e + 2],
                              acc[0][4 * e + 3]);
      __threadfence();
      group_sync(1 + wg, NTHREADS);
      if (tid == 0) last[wg] = atomicAdd(&done[t * WGS + wg], 1) == b1 - b0;
      group_sync(1 + wg, NTHREADS);
      if (last[wg]) {   // every other segment of the tile is in: add them in block order
        __threadfence();
        float sum[D::PER];
        for (int bb = b0; bb <= b1; ++bb) {
          const float* p = slot(bb);
#pragma unroll
          for (int e = 0; e < D::PER; ++e) {
            const float x = bb == b ? acc[0][e] : __ldcg(p + e);
            sum[e] = bb == b0 ? x : sum[e] + x;
          }
        }
        store(sum);
        if (tid == 0) done[t * WGS + wg] = 0;   // clean for the next launch or replay
      }
    }
  }
}

// Launch `kernel` (a __global__ wrapper of tile<BN, WGS, STAGES>, named for
// its format, taking (tx, tw, out, part, M, N, K) and its counters from the
// library) on `blocks` persistent blocks.
template <int BN, int WGS, int STAGES, typename Kernel>
cudaError_t launch(Kernel kernel, const uint8_t* w, const __nv_bfloat16* xb, float* out,
                   float* part, int M, int N, int K, int blocks, cudaStream_t st) {
  using D = Dec<BN, WGS, STAGES>;
  if ((M + D::ROWS - 1) / D::ROWS * WGS > MAX_COUNTERS) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  cudaError_t err = tensor_map_2d(&tx, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN, KC,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, M,
                        static_cast<uint64_t>(K / SB) * SBW, D::ROWS, SBW,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM);
  if (err != cudaSuccess) return err;
  void* args[] = {&tx, &tw, &out, &part, &M, &N, &K};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                          dim3(D::THREADS), args, D::SMEM, st);
}

}  // namespace kquant_dec
