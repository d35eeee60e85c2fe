// K14: fused dequantize + matmul for the IQ4 codebook formats IQ4_NL and
// IQ4_XS (any N, K a multiple of 256).
//
// Replaces gguf_tpu/ops/mmq_iq4.py:_kernel (decode and prefill widths),
// reached through mmq_iq4_nl and mmq_iq4_xs. The TPU kernel packs the
// codebook into four int32 constants because a 16-entry gather serializes
// there; here the same four words feed byte permutes, and the TPU's
// 256-group nibble repack has no counterpart: the kernel reads the d,
// scales and qs fields of the GGUF blocks as stored. Element value
// scale*KV[q], scale = d (IQ4_NL, an fp16 d per 32-block) or d*ls (IQ4_XS,
// an fp16 d per superblock times a signed 6-bit scale per 32-block, the
// product rounded first), exact in f32; both formats are symmetric, so
// there is no correction term.
//
// "fast" (w = bf16(scale*KV[q]), x = bf16(x), f32 sums) runs the bf16
// tensor-core tile of block32_tc.cuh in 128-element chunks: per row and
// chunk one 64-byte TMA box of qs (four 32-blocks), and as plain loads one
// chunk ahead IQ4_NL's four fp16 d (8 bytes) or IQ4_XS's fp16 d, its
// scales_h u16 and the two scales_l bytes of the half superblock. A lane's
// eight codes of one block's word (the low nibbles for one k16 step, the
// high ones for the next) are looked up four at a time (iq4_values): two
// byte permutes per four codes over the codebook's low and high eight
// entries, a third picking between them by each code's bit 3, as
// llama.cpp's get_int_from_table_16 does. Each int8 value becomes an exact
// f32 and then bf16(scale * KV), in the reference's order. The split of K
// is ops/mmq_q4_k.py:tc_plan's (2 blocks per SM; the 32000-row heads are
// not split). What bounds it on an H100: the weight stream (0.5625 B per
// weight for IQ4_NL, 0.53125 for IQ4_XS) at decode widths, with the
// per-code decode (about four instructions per code and lane) and the
// chain of dependent wgmma steps behind it; at prefill widths the tensor
// cores' rate beside the same decode.
//
// "high" (f32 operands and products) cannot go through bf16 tensor cores
// within its 1e-5 bound and keeps block32.cuh's SIMT tile, with its split
// K, through mmq_iq4_launch, which refuses "fast".

#include "block32.cuh"
#include "block32_tc.cuh"

namespace {

// ggml's kvalues_iq4nl (-127, -104, -83, -65, -49, -35, -22, -10, 1, 13,
// 25, 38, 53, 69, 89, 113) as int8 bytes, little-endian: entries 0-3, 4-7,
// 8-11, 12-15 (block32.cuh: iq4_value packs the same words)
constexpr uint32_t IQ4_KV0 = 0xBFAD9881u;
constexpr uint32_t IQ4_KV1 = 0xF6EADDCFu;
constexpr uint32_t IQ4_KV2 = 0x26190D01u;
constexpr uint32_t IQ4_KV3 = 0x71594535u;
// selectors: a code's low three bits index a half of the codebook; bit 3
// (moved to bit 2) picks the high half's byte; the last permutes part the
// low nibbles' values from the high ones'
constexpr uint32_t IQ4_IDX = 0x77777777u;
constexpr uint32_t IQ4_BIT3 = 0x88888888u;
constexpr uint32_t IQ4_PICK = 0x32103210u;
constexpr uint32_t IQ4_LO = 0x6420u;
constexpr uint32_t IQ4_HI = 0x7531u;

// the codebook values of the eight codes in the four bytes of v: lo gets
// those of the low nibbles, hi those of the high nibbles, as int8 bytes in
// v's byte order
__device__ __forceinline__ void iq4_values(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t idx = v & IQ4_IDX;
  const uint32_t pick = IQ4_PICK | ((v & IQ4_BIT3) >> 1);
  uint32_t r[2];   // the values of the codes of bytes 0, 1 and of bytes 2, 3
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t q = idx >> (16 * i);
    r[i] = __byte_perm(__byte_perm(IQ4_KV0, IQ4_KV1, q), __byte_perm(IQ4_KV2, IQ4_KV3, q),
                       pick >> (16 * i));
  }
  lo = __byte_perm(r[0], r[1], IQ4_LO);
  hi = __byte_perm(r[0], r[1], IQ4_HI);
}

// IQ4_NL: the four fp16 d of the chunk's 32-blocks
struct NL {
  using Small = uint2;
  static constexpr bool CORR = false;   // symmetric: no correction term
  static constexpr int CODE = 64;       // 16 nibble bytes per 32-block
  __device__ static uint2 small(const block32_tc::Fields& f, size_t m, int K, int c) {
    return *reinterpret_cast<const uint2*>(f.d + m * (K / 32) + 4 * c);
  }
  __device__ static float scale(const uint2& v, int, int b) {
    const uint32_t w = b < 2 ? v.x : v.y;
    return (b & 1) ? kquant::half_hi(w) : kquant::half_lo(w);
  }
  __device__ static void values(uint32_t v, const uint2&, int, int, uint32_t& lo, uint32_t& hi) {
    iq4_values(v, lo, hi);
  }
  __device__ static float corr(const uint2&, int) { return 0.f; }
};

// IQ4_XS: x = d | scales_h << 16 of the superblock, y = the two scales_l
// bytes of the chunk's half superblock (sub-blocks 4 (c % 2) .. +3)
struct XS {
  using Small = uint2;
  static constexpr bool CORR = false;
  static constexpr int CODE = 64;
  __device__ static uint2 small(const block32_tc::Fields& f, size_t m, int K, int c) {
    const size_t sb = m * (K / 256) + (c >> 1);
    return make_uint2(f.d[sb] | static_cast<uint32_t>(f.scales_h[sb]) << 16,
                      *reinterpret_cast<const uint16_t*>(f.scales_l + m * (K / 64) + 2 * c));
  }
  // d * ls, ls = (nibble of scales_l | 2 bits of scales_h << 4) - 32
  __device__ static float scale(const uint2& v, int c, int b) {
    const int ls = static_cast<int>(((v.y >> (4 * b)) & 0xF) |
                                    (((v.x >> (16 + 8 * (c & 1) + 2 * b)) & 3) << 4)) - 32;
    return __fmul_rn(kquant::half_lo(v.x), static_cast<float>(ls));
  }
  __device__ static void values(uint32_t v, const uint2&, int, int, uint32_t& lo, uint32_t& hi) {
    iq4_values(v, lo, hi);
  }
  __device__ static float corr(const uint2&, int) { return 0.f; }
};

template <class F, int BN, int WG>
__global__ void __launch_bounds__(tc::NTHREADS * WG)
mmq_iq4_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tqs,
           const block32_tc::Fields f, float* __restrict__ out, float* __restrict__ part, int M,
           int N, int K, int chunks_per_split) {
  block32_tc::tile<F, BN, WG>(tx, tqs, f, out, part, M, N, K, chunks_per_split);
}

template <int BN, int WG>
cudaError_t launch_tc(int xs, const block32_tc::Fields& f, const uint8_t* qs, const void* xb,
                      float* out, float* part, int M, int N, int K, int splits, int per,
                      cudaStream_t st) {
  return xs ? block32_tc::launch<BN, WG>(mmq_iq4_tc<XS, BN, WG>, f, qs, xb, out, part, M, N, K,
                                         splits, per, st)
            : block32_tc::launch<BN, WG>(mmq_iq4_tc<NL, BN, WG>, f, qs, xb, out, part, M, N, K,
                                         splits, per, st);
}

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_iq4_nl_kernel(const __half* __restrict__ d, const uint8_t* __restrict__ qs,
                  const void* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ part, int M, int N, int K,
                  int steps_per_split) {
  block32::mmq_tile<block32::IQ4_NL, BN, TM, TN, XBF16>(
      d, nullptr, nullptr, qs, x, out, part, M, N, K, 0, steps_per_split);
}

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(mmq::NTHREADS)
mmq_iq4_xs_kernel(const __half* __restrict__ d,
                  const uint16_t* __restrict__ scales_h,
                  const uint8_t* __restrict__ scales_l,
                  const uint8_t* __restrict__ qs, const void* __restrict__ x,
                  float* __restrict__ out, float* __restrict__ part, int M,
                  int N, int K, int steps_per_split) {
  block32::mmq_tile<block32::IQ4_XS, BN, TM, TN, XBF16>(
      d, scales_h, scales_l, qs, x, out, part, M, N, K, 0, steps_per_split);
}

}  // namespace

// "high". xs: 0 IQ4_NL, 1 IQ4_XS. d: (M, K/32) fp16 for IQ4_NL, (M,
// K/256) for IQ4_XS; scales_h (M, K/256) u16 and scales_l (M, K/256*4)
// bytes, IQ4_XS only (null for IQ4_NL); qs: (M, K/32*16) bytes, 16-byte
// aligned; x: (N, K) f32 or bf16; out: (N, M) f32; part: (splits, N, M)
// f32 scratch when splits > 1. fast must be 0: "fast" runs
// mmq_iq4_tc_launch.
extern "C" int mmq_iq4_launch(const void* d, const void* scales_h,
                              const void* scales_l, const void* qs,
                              const void* x, void* out, void* part, int xs,
                              int M, int N, int K, int x_bf16, int fast,
                              int splits, int steps_per_split, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0 || fast || splits < 1 || steps_per_split < 1 ||
      (xs && (!scales_h || !scales_l)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __half* dp = static_cast<const __half*>(d);
  const uint8_t* qp = static_cast<const uint8_t*>(qs);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  if (xs) {
    MMQ_SPLIT_DISPATCH(mmq_iq4_xs_kernel, M, N, splits, x_bf16, st, o, p, dp,
                       static_cast<const uint16_t*>(scales_h),
                       static_cast<const uint8_t*>(scales_l), qp, x, o, p, M,
                       N, K, steps_per_split);
  } else {
    MMQ_SPLIT_DISPATCH(mmq_iq4_nl_kernel, M, N, splits, x_bf16, st, o, p, dp,
                       qp, x, o, p, M, N, K, steps_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}

// "fast": the fields as above, d 8-byte (IQ4_NL) or 2-byte (IQ4_XS),
// scales_l 2-byte and qs 16-byte aligned; x (N, K) f32 or bf16; xb the (N,
// K) bf16 operand, 16-byte aligned: x itself when the caller passes it,
// else scratch this call fills first; part: (splits, N, M) f32 scratch
// when splits > 1, K cut into splits ranges of chunks_per_split
// 128-element chunks.
extern "C" int mmq_iq4_tc_launch(const void* d, const void* scales_h, const void* scales_l,
                                 const void* qs, const void* x, void* xb, void* out,
                                 void* part, int xs, int M, int N, int K, int x_bf16,
                                 int splits, int chunks_per_split, void* stream) {
  const int chunks = K / tc::KH;   // every split has a chunk
  if (K % 256 != 0 || M <= 0 || N <= 0 || splits < 1 || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= chunks || splits * chunks_per_split < chunks ||
      (xs && (!scales_h || !scales_l)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::launch_to_bf16(x, xb, N, K, K, x_bf16, 0, st);
  const block32_tc::Fields f{static_cast<const uint16_t*>(d),
                             static_cast<const uint16_t*>(scales_h),
                             static_cast<const uint8_t*>(scales_l),
                             nullptr, nullptr, nullptr, 0};
  const auto* qp = static_cast<const uint8_t*>(qs);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(part);
  const int per = chunks_per_split;
  cudaError_t err;   // tiles as ops/mmq_q4_k.py:tc_tile
  if (N <= 8)
    err = launch_tc<8, 1>(xs, f, qp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 16)
    err = launch_tc<16, 1>(xs, f, qp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 64)
    err = launch_tc<64, 1>(xs, f, qp, xb, op, pp, M, N, K, splits, per, st);
  else
    err = launch_tc<128, 2>(xs, f, qp, xb, op, pp, M, N, K, splits, per, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
