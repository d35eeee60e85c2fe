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
// an iota mask over K-major planes; here one warp owns one weight row: lane
// l takes 32-block b = l/4 of each superblock and 8 of its codes (quarter
// l%4), forms the partial with two __dp4a per activation row and sums the
// four quarters with two shuffles. Codes 0..31 (Q5_K's fifth bit from qh)
// fit a signed byte.
//
// What bounds it on an H100: at n <= 16 the weight stream (144 or 176
// bytes per 256 weights) is the floor; the activations (16 x K bytes) stay
// in L1/L2. This first version issues ~15 instructions per (row, block,
// activation row), so instruction issue, not bytes, is what it costs.

#include "kquant.cuh"

namespace {

constexpr int WARPS = 8;            // weight rows per block
constexpr unsigned FULL = 0xFFFFFFFFu;

template <bool HAS_QH, int NT>
__global__ void __launch_bounds__(32 * WARPS)
mmq_i8_kernel(const uint8_t* __restrict__ w, const int8_t* __restrict__ aq,
              const float* __restrict__ da, const float* __restrict__ sa,
              float* __restrict__ out, int M, int N, int K) {
  using L = kquant::Layout<HAS_QH>;
  const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= M) return;                      // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int b = lane >> 2, c = lane & 3;   // 32-block of the superblock, quarter
  const int g = b >> 1, h = b & 1;
  const int nsb = K / 256, nb = K / 32;
  const uint8_t* row = w + static_cast<size_t>(m) * nsb * L::BYTES;
  float acc[NT], accm[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j] = accm[j] = 0.f;

  for (int sb = 0; sb < nsb; ++sb) {
    const uint8_t* blk = row + static_cast<size_t>(sb) * L::BYTES;
    const uint4 hd = *reinterpret_cast<const uint4*>(blk);
    int sc, mn;
    kquant::scale_min(hd, b, sc, mn);
    const float scale = __fmul_rn(kquant::half_lo(hd.x), static_cast<float>(sc));
    const float minv = __fmul_rn(kquant::half_hi(hd.x), static_cast<float>(mn));
    const uint2 qv = *reinterpret_cast<const uint2*>(blk + L::QS + 32 * g + 8 * c);
    int w0 = static_cast<int>((qv.x >> (4 * h)) & 0x0F0F0F0Fu);
    int w1 = static_cast<int>((qv.y >> (4 * h)) & 0x0F0F0F0Fu);
    if constexpr (HAS_QH) {
      const uint2 hv = *reinterpret_cast<const uint2*>(blk + L::QH + 8 * c);
      w0 |= static_cast<int>(((hv.x >> b) & 0x01010101u) << 4);
      w1 |= static_cast<int>(((hv.y >> b) & 0x01010101u) << 4);
    }
    const int kb = sb * 8 + b;             // 32-block index along K
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < N) {                         // N is uniform: shuffles stay full
        const int2 a = *reinterpret_cast<const int2*>(
            aq + static_cast<size_t>(j) * K + kb * 32 + 8 * c);
        int p = __dp4a(w0, a.x, __dp4a(w1, a.y, 0));
        p += __shfl_xor_sync(FULL, p, 1);
        p += __shfl_xor_sync(FULL, p, 2);
        if (c == 0) {
          const size_t e = static_cast<size_t>(j) * nb + kb;
          acc[j] += __fmul_rn(__fmul_rn(static_cast<float>(p), da[e]), scale);
          accm[j] += __fmul_rn(sa[e], minv);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float v = acc[j], vm = accm[j];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      v += __shfl_xor_sync(FULL, v, o);
      vm += __shfl_xor_sync(FULL, vm, o);
    }
    if (lane == 0 && j < N) out[static_cast<size_t>(j) * M + m] = v - vm;
  }
}

template <bool HAS_QH>
void launch(const uint8_t* w, const int8_t* aq, const float* da,
            const float* sa, float* out, int M, int N, int K,
            cudaStream_t st) {
  const dim3 grid((M + WARPS - 1) / WARPS), block(32 * WARPS);
  if (N <= 1) mmq_i8_kernel<HAS_QH, 1><<<grid, block, 0, st>>>(w, aq, da, sa, out, M, N, K);
  else if (N <= 4) mmq_i8_kernel<HAS_QH, 4><<<grid, block, 0, st>>>(w, aq, da, sa, out, M, N, K);
  else if (N <= 8) mmq_i8_kernel<HAS_QH, 8><<<grid, block, 0, st>>>(w, aq, da, sa, out, M, N, K);
  else mmq_i8_kernel<HAS_QH, 16><<<grid, block, 0, st>>>(w, aq, da, sa, out, M, N, K);
}

}  // namespace

// w: (M, K/256*144) Q4_K or (M, K/256*176) Q5_K GGUF bytes (has_qh),
// 16-byte aligned; aq: (N, K) int8 Q8_1 codes, 8-byte aligned; da, sa:
// (N, K/32) f32 d and s; out: (N, M) f32. N <= 16.
extern "C" int mmq_i8_launch(const void* w, const void* aq, const void* da,
                             const void* sa, void* out, int M, int N, int K,
                             int has_qh, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0 || N > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* ap = static_cast<const int8_t*>(aq);
  const auto* dp = static_cast<const float*>(da);
  const auto* sp = static_cast<const float*>(sa);
  auto* op = static_cast<float*>(out);
  if (has_qh) launch<true>(wp, ap, dp, sp, op, M, N, K, st);
  else launch<false>(wp, ap, dp, sp, op, M, N, K, st);
  return static_cast<int>(cudaGetLastError());
}
