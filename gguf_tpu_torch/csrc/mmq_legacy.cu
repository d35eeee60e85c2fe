// K11: fused dequantize + matmul for the legacy 32-element-block formats
// Q4_0, Q4_1, Q5_0 and Q5_1 (any N, K a multiple of 256).
//
// Replaces gguf_tpu/ops/mmq_legacy.py:_kernel (decode and prefill widths),
// reached through mmq_q4_0 .. mmq_q5_1. The TPU's 256-group nibble repack
// and bit planes have no counterpart: this kernel reads the d, m, qh and
// qs fields of the GGUF blocks as stored. It keeps the reference's split
// product (block32.cuh): b . (d*q_raw)^T with bf16 operands under "fast",
// plus the f32 per-32-block correction bsum . corr^T, corr = m (_1) or
// -off*d (_0), against the sums of the unrounded activations
// (fp16-rounded under act_quant). Rounding d*(q - off) to bf16 instead
// would differ by whole bf16 ulps under cancellation.
//
// "fast" runs the bf16 tensor-core tile of block32_tc.cuh in 128-element
// chunks, a policy per format (Legacy<F>), each behind a __global__ of its
// own name (mmq_q4_0_tc .. mmq_q5_1_tc) so the profiler splits them: per
// row and chunk one 64-byte TMA box of qs (four 32-blocks; IQ4_NL's nibble
// order, so K1's byte permute carries over), and as plain loads one chunk
// ahead the four fp16 d (8 bytes), for the _1 formats the four fp16 m (8
// bytes) and for the 5-bit formats the four u32 qh (16 bytes). qh stays a
// plain load rather than a second TMA box: 16 bytes per row and chunk is
// TMA's narrowest box, the width whose loads faulted for K7 on the H100,
// and the four lanes of a row read the same 16 bytes. The staged weight is
// bf16(d * q_raw): q_raw the 4-bit code, with qh's bit ORed in as bit 4 for
// Q5_0/Q5_1 (two byte permutes spread a lane's eight qh bits onto its
// eight codes), no offset. The correction term is the tile's f32 register
// tile beside the accumulator; its block sums come from the staged bf16
// tile when the operand is bf16, else from to_bf16_bsum's pass over the
// f32 operand (block32_tc.cuh says why both keep the reference's numbers).
// The split of K is ops/mmq_q4_k.py:tc_plan's. What bounds it on an H100:
// the weight stream at decode widths (0.5625 to 0.75 B per weight) with
// the per-code decode and the chain of dependent wgmma steps behind it;
// at prefill widths the tensor cores' rate beside the decode and the
// correction term's FMAs (2 BN per lane and chunk).
//
// "high" (f32 operands and products) cannot go through bf16 tensor cores
// within its 1e-5 bound and keeps block32.cuh's SIMT tile (K1's tile shape,
// K cut across the grid when M/64 blocks cannot fill the card; the block
// sums from a warp reduction of the staged activations) through
// mmq_legacy_launch, which refuses "fast".

#include "block32.cuh"
#include "block32_tc.cuh"

namespace {

// ------------------------------------------------ "high": the SIMT tile ---

// one kernel name per format, so that MMQ_SPLIT_DISPATCH can add the tile
// shape's template arguments
#define LEGACY_KERNEL(NAME, FMT)                                               \
  template <int BN, int TM, int TN, bool XBF16>                                \
  __global__ void __launch_bounds__(mmq::NTHREADS)                             \
  NAME(const __half* __restrict__ d, const __half* __restrict__ m,             \
       const uint32_t* __restrict__ qh, const uint8_t* __restrict__ qs,        \
       const void* __restrict__ x, float* __restrict__ out,                    \
       float* __restrict__ part, int M, int N, int K, int fp16_bsum,           \
       int steps_per_split) {                                                  \
    block32::mmq_tile<FMT, BN, TM, TN, XBF16>(d, m, qh, qs, x, out, part, M,   \
                                              N, K, fp16_bsum,                 \
                                              steps_per_split);                \
  }

LEGACY_KERNEL(mmq_q4_0_kernel, block32::Q4_0)
LEGACY_KERNEL(mmq_q4_1_kernel, block32::Q4_1)
LEGACY_KERNEL(mmq_q5_0_kernel, block32::Q5_0)
LEGACY_KERNEL(mmq_q5_1_kernel, block32::Q5_1)

// ------------------------------------- "fast": the tensor-core tile ---

// the selectors that spread a lane's qh bits onto its codes: with h = qh >>
// 2t, byte i of h holds bits 2t + 8i (bit 0) and 2t + 8i + 1 (bit 1), so
// byte_perm(h, h >> 1) of these selectors gives, in bit 0 of byte i, the
// fifth bit of the code in byte i of the low (elements 2t, 2t+1, 2t+8,
// 2t+9) or the high nibbles (elements 16 more)
constexpr uint32_t LEGACY_QH_LO = 0x5140u;
constexpr uint32_t LEGACY_QH_HI = 0x7362u;

// the format F's policy for block32_tc::tile: Small holds row m's four d
// (and m, qh) of chunk c
template <int F>
struct Legacy {
  using Tr = block32::Traits<F>;
  static constexpr bool CORR = true;
  static constexpr int CODE = 64;   // 16 nibble bytes per 32-block
  struct Small {
    uint2 d, m;
    uint4 qh;
  };
  __device__ static Small small(const block32_tc::Fields& f, size_t m, int K, int c) {
    Small s{};
    const size_t blk = m * (K / 32) + 4 * c;
    s.d = *reinterpret_cast<const uint2*>(f.d + blk);
    if constexpr (Tr::AFFINE) s.m = *reinterpret_cast<const uint2*>(f.m + blk);
    if constexpr (Tr::FIVE) s.qh = *reinterpret_cast<const uint4*>(f.qh + blk);
    return s;
  }
  __device__ static float half_of(const uint2& v, int b) {
    const uint32_t w = b < 2 ? v.x : v.y;
    return (b & 1) ? kquant::half_hi(w) : kquant::half_lo(w);
  }
  __device__ static float scale(const Small& s, int, int b) { return half_of(s.d, b); }
  // m (_1), or -off*d (_0), exact in f32
  __device__ static float corr(const Small& s, int b) {
    if constexpr (Tr::AFFINE) return half_of(s.m, b);
    return __fmul_rn(half_of(s.d, b), -Tr::OFFSET);
  }
  // the raw codes 0..15 (0..31 with qh's bit) as int8 bytes
  __device__ static void values(uint32_t v, const Small& s, int b, int t, uint32_t& lo,
                                uint32_t& hi) {
    lo = v & 0x0F0F0F0Fu;
    hi = (v >> 4) & 0x0F0F0F0Fu;
    if constexpr (Tr::FIVE) {
      const uint32_t q = b == 0 ? s.qh.x : b == 1 ? s.qh.y : b == 2 ? s.qh.z : s.qh.w;
      const uint32_t h = q >> (2 * t);
      lo |= (__byte_perm(h, h >> 1, LEGACY_QH_LO) & 0x01010101u) << 4;
      hi |= (__byte_perm(h, h >> 1, LEGACY_QH_HI) & 0x01010101u) << 4;
    }
  }
};

#define LEGACY_TC_KERNEL(NAME, FMT)                                                          \
  template <int BN, int WG>                                                                  \
  __global__ void __launch_bounds__(tc::NTHREADS * WG)                                       \
  NAME(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tqs,     \
       const block32_tc::Fields f, float* __restrict__ out, float* __restrict__ part, int M, \
       int N, int K, int chunks_per_split) {                                                 \
    block32_tc::tile<Legacy<FMT>, BN, WG>(tx, tqs, f, out, part, M, N, K, chunks_per_split); \
  }

LEGACY_TC_KERNEL(mmq_q4_0_tc, block32::Q4_0)
LEGACY_TC_KERNEL(mmq_q4_1_tc, block32::Q4_1)
LEGACY_TC_KERNEL(mmq_q5_0_tc, block32::Q5_0)
LEGACY_TC_KERNEL(mmq_q5_1_tc, block32::Q5_1)

template <int BN, int WG>
cudaError_t launch_tc(int fmt, const block32_tc::Fields& f, const uint8_t* qs, const void* xb,
                      float* out, float* part, int M, int N, int K, int splits, int per,
                      cudaStream_t st) {
  switch (fmt) {
    case block32::Q4_0:
      return block32_tc::launch<BN, WG>(mmq_q4_0_tc<BN, WG>, f, qs, xb, out, part, M, N, K,
                                        splits, per, st);
    case block32::Q4_1:
      return block32_tc::launch<BN, WG>(mmq_q4_1_tc<BN, WG>, f, qs, xb, out, part, M, N, K,
                                        splits, per, st);
    case block32::Q5_0:
      return block32_tc::launch<BN, WG>(mmq_q5_0_tc<BN, WG>, f, qs, xb, out, part, M, N, K,
                                        splits, per, st);
    default:
      return block32_tc::launch<BN, WG>(mmq_q5_1_tc<BN, WG>, f, qs, xb, out, part, M, N, K,
                                        splits, per, st);
  }
}

// the format code and its fields, checked
bool bad_format(int fmt, const void* m, const void* qh) {
  const bool affine = fmt == block32::Q4_1 || fmt == block32::Q5_1;
  const bool five = fmt == block32::Q5_0 || fmt == block32::Q5_1;
  return fmt < block32::Q4_0 || fmt > block32::Q5_1 || (affine && !m) || (five && !qh);
}

}  // namespace

// "high". fmt: 1 q4_0, 2 q4_1, 3 q5_0, 4 q5_1 (block32::Fmt). d, m: (M,
// K/32) fp16 (m null for the _0 formats); qh: (M, K/32) u32 (null for
// q4_*); qs: (M, K/32*16) bytes, 16-byte aligned; x: (N, K) f32 or bf16;
// out: (N, M) f32; part: (splits, N, M) f32 scratch when splits > 1.
// fp16_bsum rounds the block sums through fp16 (act_quant). fast must be
// 0: "fast" runs mmq_legacy_tc_launch.
extern "C" int mmq_legacy_launch(const void* d, const void* m, const void* qh,
                                 const void* qs, const void* x, void* out,
                                 void* part, int fmt, int fp16_bsum, int M,
                                 int N, int K, int x_bf16, int fast,
                                 int splits, int steps_per_split,
                                 void* stream) {
  if (K % 32 != 0 || M <= 0 || N <= 0 || fast || splits < 1 || steps_per_split < 1 ||
      bad_format(fmt, m, qh))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __half* dp = static_cast<const __half*>(d);
  const __half* mp = static_cast<const __half*>(m);
  const uint32_t* hp = static_cast<const uint32_t*>(qh);
  const uint8_t* qp = static_cast<const uint8_t*>(qs);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  switch (fmt) {
    case block32::Q4_0:
      MMQ_SPLIT_DISPATCH(mmq_q4_0_kernel, M, N, splits, x_bf16, st, o, p, dp, mp,
                         hp, qp, x, o, p, M, N, K, fp16_bsum, steps_per_split);
      break;
    case block32::Q4_1:
      MMQ_SPLIT_DISPATCH(mmq_q4_1_kernel, M, N, splits, x_bf16, st, o, p, dp, mp,
                         hp, qp, x, o, p, M, N, K, fp16_bsum, steps_per_split);
      break;
    case block32::Q5_0:
      MMQ_SPLIT_DISPATCH(mmq_q5_0_kernel, M, N, splits, x_bf16, st, o, p, dp, mp,
                         hp, qp, x, o, p, M, N, K, fp16_bsum, steps_per_split);
      break;
    default:
      MMQ_SPLIT_DISPATCH(mmq_q5_1_kernel, M, N, splits, x_bf16, st, o, p, dp, mp,
                         hp, qp, x, o, p, M, N, K, fp16_bsum, steps_per_split);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// "fast": the fields as above, d and m 8-byte, qh and qs 16-byte aligned;
// x (N, K) f32 or bf16; xb the (N, K) bf16 operand, 16-byte aligned: x
// itself when the caller passes it (the block sums then come from the
// staged tile), else scratch this call fills first, with bsum, (N, K/32)
// f32 scratch for the sums of x's blocks; part: (splits, N, M) f32 scratch
// when splits > 1, K cut into splits ranges of chunks_per_split
// 128-element chunks.
extern "C" int mmq_legacy_tc_launch(const void* d, const void* m, const void* qh,
                                    const void* qs, const void* x, void* xb, void* bsum,
                                    void* out, void* part, int fmt, int fp16_bsum, int M,
                                    int N, int K, int x_bf16, int splits,
                                    int chunks_per_split, void* stream) {
  const int chunks = K / tc::KH;   // every split has a chunk
  if (K % 256 != 0 || M <= 0 || N <= 0 || splits < 1 || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= chunks || splits * chunks_per_split < chunks ||
      bad_format(fmt, m, qh) || (xb != x && !bsum))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* bp = static_cast<float*>(bsum);
  if (xb != x) block32_tc::launch_to_bf16_bsum(x, xb, bp, N, K, x_bf16, fp16_bsum, st);
  const block32_tc::Fields f{static_cast<const uint16_t*>(d), nullptr, nullptr,
                             static_cast<const uint16_t*>(m),
                             static_cast<const uint32_t*>(qh), xb != x ? bp : nullptr,
                             fp16_bsum};
  const auto* qp = static_cast<const uint8_t*>(qs);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(part);
  const int per = chunks_per_split;
  cudaError_t err;   // tiles as ops/mmq_q4_k.py:tc_tile
  if (N <= 8)
    err = launch_tc<8, 1>(fmt, f, qp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 16)
    err = launch_tc<16, 1>(fmt, f, qp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 64)
    err = launch_tc<64, 1>(fmt, f, qp, xb, op, pp, M, N, K, splits, per, st);
  else
    err = launch_tc<128, 2>(fmt, f, qp, xb, op, pp, M, N, K, splits, per, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
