// K13: fused Q3_K dequantize + matmul (any N, K a multiple of 256).
//
// Replaces gguf_tpu/ops/mmq_q3_k.py:_kernel (decode and prefill widths),
// reached through mmq_q3_k. The TPU kernel re-lays the codes into bit
// planes whose rows share a 16-element sub-block, and permutes the
// activations to match (an XLA transpose or an in-kernel 0/1 matmul); here
// the kernel decodes the GGUF bytes in element order, so neither exists.
// Q3_K's 110-byte block is split at load into its fields (hmask 32 | qs 64
// | scales 12 | fp16 d), so a thread reads its codes with aligned 8-byte
// loads. Element value (d*sc) * (q - 4), q = low2 | hbit << 2, sc the
// signed 6-bit scale of the element's 16-element sub-block: exact in f32,
// so it equals the reference's q*s - 4*s bit for bit. No min term.
//
// Tile (mmq_common.cuh): a block of 256 threads owns BM = 64 rows and BN
// activation rows and walks K in 64-element steps; step t of a superblock
// covers its elements 64t .. 64t+63, which are crumbs 2p and 2p+1 (p = t%2)
// of qs bytes 32h .. 32h+31 (h = t/2) and bits 2t, 2t+1 of hmask bytes
// 0 .. 31, under the four sub-blocks 4t .. 4t+3. Thread (r, q) decodes
// bytes 8q .. 8q+7 of those runs for row r: elements 8q+i (sub-block
// 4t + q/2) and 32+8q+i (sub-block 4t+2 + q/2). K is cut across the
// grid's z axis when M/64 blocks cannot fill the card (MMQ_SPLIT_DISPATCH).
//
// What bounds it on an H100: the weight stream (0.43 B per weight) at
// decode widths, the SIMT f32 FMAs of the tile at prefill widths.

#include "mmq_common.cuh"

namespace {

using namespace mmq;

// the signed scale of sub-block j (0..15) from a block's 12 scale bytes:
// low 4 bits in byte j (j < 8) or byte j-8's high nibble, top 2 bits at
// bit 2*(j/4) of byte 8 + j%4
__device__ __forceinline__ int q3_k_scale(const uint8_t* s, int j) {
  const int lo = j < 8 ? (s[j] & 0xF) : (s[j - 8] >> 4);
  const int hi = (s[8 + (j & 3)] >> (2 * (j >> 2))) & 3;
  return (lo | (hi << 4)) - 32;
}

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(NTHREADS)
mmq_q3_k_kernel(const uint8_t* __restrict__ hmask,
                const uint8_t* __restrict__ qs,
                const uint8_t* __restrict__ scales,
                const __half* __restrict__ dv, const void* __restrict__ x,
                float* __restrict__ out, float* __restrict__ part, int M,
                int N, int K, int fast, int steps_per_split) {
  __shared__ float ws[KT][BM + 1];
  __shared__ float xs[KT][BN + 1];
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
    uint2 c = make_uint2(0, 0), hm = make_uint2(0, 0);
    float sa = 0.f, sb = 0.f;
    if (row_ok) {
      c = *reinterpret_cast<const uint2*>(qs + blk * 64 + 32 * h + 8 * q);
      hm = *reinterpret_cast<const uint2*>(hmask + blk * 32 + 8 * q);
      const float d = __half2float(dv[blk]);
      const uint8_t* sc = scales + blk * 12;
      sa = __fmul_rn(d, static_cast<float>(q3_k_scale(sc, 4 * t + (q >> 1))));
      sb = __fmul_rn(d, static_cast<float>(q3_k_scale(sc, 4 * t + 2 + (q >> 1))));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int sh = 8 * (i & 3);
      const unsigned byte = ((i < 4 ? c.x : c.y) >> sh) & 0xFF;
      const unsigned hb = ((i < 4 ? hm.x : hm.y) >> sh) & 0xFF;
      const int qa = static_cast<int>(((byte >> (4 * p)) & 3) |
                                      (((hb >> (2 * t)) & 1) << 2)) - 4;
      const int qb = static_cast<int>(((byte >> (4 * p + 2)) & 3) |
                                      (((hb >> (2 * t + 1)) & 1) << 2)) - 4;
      float wa = __fmul_rn(sa, static_cast<float>(qa));
      float wb = __fmul_rn(sb, static_cast<float>(qb));
      if (fast) {
        wa = bf16_round(wa);
        wb = bf16_round(wb);
      }
      ws[8 * q + i][r] = wa;
      ws[32 + 8 * q + i][r] = wb;
    }
    stage_x<BN, XBF16>(xs, x, K, N, K, n0, s * KT, 0, fast);
    __syncthreads();
    fma_tile<BN, TM, TN>(ws, xs, acc, tx, ty);
    __syncthreads();
  }
  float* dst = gridDim.z > 1 ? part + static_cast<size_t>(blockIdx.z) * N * M : out;
  store_tile<BN, TM, TN>(dst, acc, M, N, m0, n0, tx, ty);
}

}  // namespace

// hmask (M, K/256*32), qs (M, K/256*64), scales (M, K/256*12) bytes and d
// (M, K/256) fp16: the fields of the GGUF blocks, hmask and qs 8-byte
// aligned; x: (N, K) f32 or bf16; out: (N, M) f32; part: (splits, N, M)
// f32 scratch when splits > 1.
extern "C" int mmq_q3_k_launch(const void* hmask, const void* qs,
                               const void* scales, const void* d,
                               const void* x, void* out, void* part, int M,
                               int N, int K, int x_bf16, int fast, int splits,
                               int steps_per_split, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0 || splits < 1 || steps_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  MMQ_SPLIT_DISPATCH(mmq_q3_k_kernel, M, N, splits, x_bf16, st, o, p,
                     static_cast<const uint8_t*>(hmask),
                     static_cast<const uint8_t*>(qs),
                     static_cast<const uint8_t*>(scales),
                     static_cast<const __half*>(d), x, o, p, M, N, K, fast,
                     steps_per_split);
  return static_cast<int>(cudaGetLastError());
}
