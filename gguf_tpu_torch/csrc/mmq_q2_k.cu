// K12: fused Q2_K dequantize + matmul (any N, K a multiple of 256).
//
// Replaces gguf_tpu/ops/mmq_q2_k.py:_kernel (decode and prefill widths),
// reached through mmq_q2_k. The TPU kernel re-lays the codes into crumb
// planes whose rows share a 16-element sub-block and permutes the
// activations to match; here the kernel decodes the GGUF bytes in element
// order, so neither exists. Q2_K's 84-byte block is split at load into its
// fields (sc 16 | qs 64 | fp16 d | fp16 dmin), so a thread reads its codes
// with one aligned 8-byte load. Element value (d*sc)*q - dmin*mn per
// 16-element sub-block, q a 2-bit code.
//
// Two arms, as the reference has them, chosen by the wrapper from the
// call's width (`split`):
//   split (n_pad <= 64, the reference's decode arm): the staged weight is
//     (d*sc)*q alone, and the min term is subtracted per K step as
//     bsum16 . (dmin*mn)^T in f32, where bsum16 holds the per-16 sums of
//     the STAGED activations (bf16-rounded under "fast"); the sums are warp
//     reductions over 16 lanes of the staging loop;
//   folded (n_pad > 64, the prefill arm): the staged weight is
//     (d*sc)*q - dmin*mn, rounded in the codec's order (no FMA), so an
//     unrounded "high" weight is bit-equal to the dequantized one.
// The two differ by whole bf16 ulps under "fast" (the bf16 rounding of the
// weight with and without its min), so the arm is part of the contract.
//
// Tile (mmq_common.cuh): a block of 256 threads owns BM = 64 rows and BN
// activation rows and walks K in 64-element steps; step t of a superblock
// covers its elements 64t .. 64t+63: crumbs 2p and 2p+1 (p = t%2) of qs
// bytes 32h .. 32h+31 (h = t/2), under the four sub-blocks 4t .. 4t+3.
// Thread (r, q) decodes bytes 8q .. 8q+7 of that run for row r: elements
// 8q+i (sub-block 4t + q/2) and 32+8q+i (sub-block 4t+2 + q/2). K is cut
// across the grid's z axis when M/64 blocks cannot fill the card
// (MMQ_SPLIT_DISPATCH).
//
// What bounds it on an H100: the weight stream (0.33 B per weight) at
// decode widths, the SIMT f32 FMAs of the tile at prefill widths.

#include "mmq_common.cuh"

namespace {

using namespace mmq;

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(NTHREADS)
mmq_q2_k_kernel(const uint8_t* __restrict__ sc, const uint8_t* __restrict__ qs,
                const __half* __restrict__ dv, const __half* __restrict__ dminv,
                const void* __restrict__ x, float* __restrict__ out,
                float* __restrict__ part, int split, int M, int N, int K,
                int fast, int steps_per_split) {
  __shared__ float ws[KT][BM + 1];
  __shared__ float xs[KT][BN + 1];
  __shared__ float cs[4][BM];   // split: dmin*mn of each row's 4 sub-blocks
  __shared__ float bs[4][BN];   // split: the 4 per-16 sums of each n
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM), ty = tid / (BM / TM);
  const int r = tid >> 2, q = tid & 3;
  const bool row_ok = m0 + r < M;
  const size_t row = static_cast<size_t>(row_ok ? m0 + r : 0) * (K / 256);
  const int s0 = blockIdx.z * steps_per_split;
  const int s1 = min(K / KT, s0 + steps_per_split);
  float acc[TM][TN] = {};

  for (int s = s0; s < s1; ++s) {
    const int t = s & 3, h = t >> 1, p = t & 1;
    const size_t blk = row + (s >> 2);
    uint2 c = make_uint2(0, 0);
    float sa = 0.f, za = 0.f, sb = 0.f, zb = 0.f;
    if (row_ok) {
      c = *reinterpret_cast<const uint2*>(qs + blk * 64 + 32 * h + 8 * q);
      const float d = __half2float(dv[blk]), dmin = __half2float(dminv[blk]);
      const unsigned a = sc[blk * 16 + 4 * t + (q >> 1)];
      const unsigned b = sc[blk * 16 + 4 * t + 2 + (q >> 1)];
      sa = __fmul_rn(d, static_cast<float>(a & 0xF));
      za = __fmul_rn(dmin, static_cast<float>(a >> 4));
      sb = __fmul_rn(d, static_cast<float>(b & 0xF));
      zb = __fmul_rn(dmin, static_cast<float>(b >> 4));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned byte = ((i < 4 ? c.x : c.y) >> (8 * (i & 3))) & 0xFF;
      float wa = __fmul_rn(sa, static_cast<float>((byte >> (4 * p)) & 3));
      float wb = __fmul_rn(sb, static_cast<float>((byte >> (4 * p + 2)) & 3));
      if (!split) {
        wa = __fsub_rn(wa, za);
        wb = __fsub_rn(wb, zb);
      }
      if (fast) {
        wa = bf16_round(wa);
        wb = bf16_round(wb);
      }
      ws[8 * q + i][r] = wa;
      ws[32 + 8 * q + i][r] = wb;
    }
    if (split && !(q & 1)) {
      cs[q >> 1][r] = za;
      cs[2 + (q >> 1)][r] = zb;
    }
    // stage x[n0 .. n0+BN) x [k0 .. k0+KT): the 32 lanes of a warp hold
    // one n and two 16-element sub-blocks in every pass (BN*KT is a
    // multiple of 256), so each sub-block's sum is a 16-lane reduction
    const int k0 = s * KT;
    for (int e = tid; e < BN * KT; e += NTHREADS) {
      const int n = e / KT, kk = e % KT;
      float v = 0.f;
      if (n0 + n < N) v = load_x<XBF16>(x, static_cast<size_t>(n0 + n) * K + k0 + kk);
      if (fast) v = bf16_round(v);
      xs[kk][n] = v;
      if (split) {
        float sum = v;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if ((kk & 15) == 0) bs[kk >> 4][n] = sum;
      }
    }
    __syncthreads();
    fma_tile<BN, TM, TN>(ws, xs, acc, tx, ty);
    if (split) {
      constexpr int TX = BM / TM, TY = BN / TN;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          const int mm = tx + TX * i, nn = ty + TY * jj;
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[i][jj] = fmaf(-cs[g][mm], bs[g][nn], acc[i][jj]);
        }
    }
    __syncthreads();
  }
  float* dst = gridDim.z > 1 ? part + static_cast<size_t>(blockIdx.z) * N * M : out;
  store_tile<BN, TM, TN>(dst, acc, M, N, m0, n0, tx, ty);
}

}  // namespace

// sc (M, K/256*16) and qs (M, K/256*64) bytes, d and dmin (M, K/256)
// fp16: the fields of the GGUF blocks, qs 8-byte aligned; x: (N, K) f32 or
// bf16; out: (N, M) f32; part: (splits, N, M) f32 scratch when splits > 1;
// split: 1 for the split arm, 0 for the folded one.
extern "C" int mmq_q2_k_launch(const void* sc, const void* qs, const void* d,
                               const void* dmin, const void* x, void* out,
                               void* part, int split, int M, int N, int K,
                               int x_bf16, int fast, int splits,
                               int steps_per_split, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0 || splits < 1 || steps_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  MMQ_SPLIT_DISPATCH(mmq_q2_k_kernel, M, N, splits, x_bf16, st, o, p,
                     static_cast<const uint8_t*>(sc),
                     static_cast<const uint8_t*>(qs),
                     static_cast<const __half*>(d),
                     static_cast<const __half*>(dmin), x, o, p, split, M, N,
                     K, fast, steps_per_split);
  return static_cast<int>(cudaGetLastError());
}
