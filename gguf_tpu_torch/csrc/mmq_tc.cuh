// The tensor-core MMQ tiles of K1 and K8 under "fast" (kquant_tc.cuh, for
// mmq_q4_k.cu and mmq_q5_k.cu) and K7 (mmq_i8.cu) over Q4_K / Q5_K
// superblocks as stored in GGUF (kquant.cuh), and of K2 (mmq_q6_k.cu), K12
// (mmq_q2_k.cu), K13 (mmq_q3_k.cu), K14, K11 and K10 (block32_tc.cuh,
// for mmq_iq4.cu, mmq_legacy.cu and mmq_q8_0.cu) under "fast" over the
// per-field arrays of Q6_K / Q2_K / Q3_K / IQ4 / Q4_0..Q5_1 / Q8_0
// (KH-element chunks, their notes say how): TMA copies of the weight
// bytes into a ring of shared-memory stages, each completing on its
// stage's mbarrier, the A fragments decoded from those bytes in registers,
// and the bf16 wgmma instructions with A from registers.
//
// A warpgroup owns BM = 64 weight rows (four warps of 16) and walks K in
// chunks: K1's chunk c of KC = 64 elements is the nibble run j = c % 4 of
// superblock c / 4, i.e. 32-blocks 2j (low nibbles) and 2j+1 (high
// nibbles); K7 takes two runs per chunk. A stage holds, per row, the
// superblock's 16-byte header (fp16 d, fp16 dmin, 12 bytes of 6-bit
// scales/mins), for Q5_K its 32 qh bytes, and the chunk's nibble runs, each
// a box of a 2-D tensor map over the (M, K/256 * 144 or 176) byte matrix,
// beside the caller's activation tile. The header is fetched again for each
// chunk of a superblock: those are L2 hits, the device-memory stream stays
// one pass over the weight. One thread issues a stage's copies; rows and
// activation rows past the tensor's end arrive as zeros. K is cut across
// the grid's z axis in whole chunks (split K); each split writes its
// partial tile and mmq::add_splits adds them in order.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k32 and wgmma RS): lane
// (g, t) = (lane / 4, lane % 4) of warp w holds rows 16w + g and 16w + g + 8;
// for a bf16 k16 step it holds k = 2t, 2t+1 (registers 0, 1) and 2t+8,
// 2t+9 (registers 2, 3); for an s8 k32 step k = 4t..4t+3 and 16+4t..19+4t.
#pragma once

#include <cuda.h>

#include <algorithm>

#include "kquant.cuh"

namespace tc {

constexpr int BM = 64;         // weight rows per warpgroup
constexpr int KC = 64;         // K elements per nibble run
constexpr int KH = 2 * KC;     // K elements per chunk of K2, K10-K14: half a superblock
constexpr int NTHREADS = 128;  // four warps: one warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------- TMA and mbarriers ---

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// box (x, y) of a 2-D tensor map -> shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// A row-major (rows, cols) tensor of elem_bytes elements, copied in boxes
// of (box_rows, box_cols); rows past the end read as zeros.
inline cudaError_t tensor_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                                 int elem_bytes, uint64_t rows, uint64_t cols,
                                 uint32_t box_rows, uint32_t box_cols,
                                 CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<Encode>(fn) : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// --------------------------------------------------------------- decoding ---

// byte i (a code < 256) of v as an exact float
__device__ __forceinline__ float code_f(uint32_t v, int i) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + i)) - 8388608.0f;
}

// signed byte i of v as an exact float
__device__ __forceinline__ float scode_f(uint32_t v, int i) {
  return __uint_as_float(__byte_perm(v ^ 0x80808080u, 0x4B000000u, 0x7440 + i)) - 8388736.0f;
}

// (d*sc, dmin*mn) of 32-blocks 2j and 2j+1 from a superblock header,
// rounded as the codec rounds them; the 6-bit packing is decoded four
// scales (or mins) at a time
__device__ __forceinline__ void chunk_scales(const uint4& h, int j, float (&s)[2],
                                             float (&z)[2]) {
  uint32_t sc, mn;
  if (j < 2) {   // blocks 0..3: the low 6 bits of bytes 0..3 / 4..7
    sc = h.y & 0x3F3F3F3Fu;
    mn = h.z & 0x3F3F3F3Fu;
  } else {       // blocks 4..7: nibbles of bytes 8..11, top bits of 0..7
    sc = (h.w & 0x0F0F0F0Fu) | ((h.y >> 2) & 0x30303030u);
    mn = ((h.w >> 4) & 0x0F0F0F0Fu) | ((h.z >> 2) & 0x30303030u);
  }
  const int b = 2 * (j & 1);   // byte of block 2j in those words
  const float d = kquant::half_lo(h.x), dmin = kquant::half_hi(h.x);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    s[e] = __fmul_rn(d, code_f(sc, b + e));
    z[e] = __fmul_rn(dmin, code_f(mn, b + e));
  }
}

// bf16((d*sc)*q - dmin*mn), products rounded in the codec's order
__device__ __forceinline__ float fold(float s, float z, float q) {
  return __fsub_rn(__fmul_rn(s, q), z);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// the sum of the 8 bf16 values of a 16-byte piece, in f32 (the block sums
// of K11's correction and K12's min term, from a staged x tile)
__device__ __forceinline__ float bf16_sum8(const uint4& v) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    s += __uint_as_float(w << 16) + __uint_as_float(w & 0xFFFF0000u);
  }
  return s;
}

// ------------------------------------------------- the bf16 activations ---

// xb (N, K) bf16 = bf16(x), or bf16(act(gate) * up) in f32 with glu
template <bool XBF16>
__global__ void __launch_bounds__(256)
to_bf16(const void* __restrict__ x, __nv_bfloat16* __restrict__ xb, int N, int K, int ldx,
        int glu) {
  const size_t total = static_cast<size_t>(N) * K;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t e = (i / K) * ldx + i % K;
    const float v = glu ? mmq::glu_act(mmq::load_x<XBF16>(x, e), glu) *
                              mmq::load_x<XBF16>(x, e + K)
                        : mmq::load_x<XBF16>(x, e);
    xb[i] = __float2bfloat16_rn(v);
  }
}

// the tiles' (N, K) bf16 operand: x itself when the caller passed it
// (xb == x), else one pass writes it to the scratch xb
inline void launch_to_bf16(const void* x, void* xb, int N, int K, int ldx, int x_bf16, int glu,
                           cudaStream_t st) {
  if (xb == x) return;
  const size_t total = static_cast<size_t>(N) * K;
  const unsigned blocks = static_cast<unsigned>(std::min<size_t>((total + 255) / 256, 4096));
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  if (x_bf16) to_bf16<true><<<blocks, 256, 0, st>>>(x, xbp, N, K, ldx, glu);
  else to_bf16<false><<<blocks, 256, 0, st>>>(x, xbp, N, K, ldx, glu);
}

// ----------------------------------------------------------------- wgmma ---

// Shared-memory matrix descriptor of a K-major operand stored as TMA's
// 128-byte swizzle writes it: rows of 64 bf16 (128 bytes), 8-row groups
// 1024 bytes apart, the tile 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | 1ull << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// descriptor of k16 step k (0..7) of a KH-element chunk's x tile: two TMA
// boxes of (BN x 64) bf16, `xbox` bytes each, 128-byte swizzle
__device__ __forceinline__ uint64_t x_desc_kh(const uint8_t* st, int xbox, int k) {
  return smem_desc_sw128(st + (k >> 2) * xbox) + 2 * (k & 3);
}

// a warpgroup's accumulator tile into split z's partial tile, or into out
// when K is not split; this lane holds rows m, m + 8 and columns
// n + 8 jn + {0, 1}
template <int BN>
__device__ __forceinline__ void store_acc(const float (&acc)[BN / 2], float* out, float* part,
                                          int M, int N, int m, int n) {
  float* dst = gridDim.z > 1 ? part + static_cast<size_t>(blockIdx.z) * N * M : out;
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int mm = m + 8 * (e >> 1), nn = n + 8 * jn + (e & 1);
      if (mm < M && nn < N) dst[static_cast<size_t>(nn) * M + mm] = acc[4 * jn + e];
    }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (64 x N f32, the accumulator layout of m16n8 repeated over N/8) +=
// A (64 x 16 bf16 in registers) . B (N x 16 bf16, K-major, descriptor b)
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace tc
