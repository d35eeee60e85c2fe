// K12: fused Q2_K dequantize + matmul (any N, K a multiple of 256).
//
// Replaces gguf_tpu/ops/mmq_q2_k.py:_kernel (decode and prefill widths),
// reached through mmq_q2_k. The TPU kernel re-lays the codes into crumb
// planes whose rows share a 16-element sub-block and permutes the
// activations to match; here the kernel decodes the GGUF bytes in element
// order, so neither exists. Q2_K's 84-byte block is split at load into its
// fields (sc 16 | qs 64 | fp16 d | fp16 dmin), each kept per row in GGUF
// byte order. Element 128h + 32j + l of a superblock is crumb j of qs byte
// 32h + l; its value is (d*sc)*q - dmin*mn for its 16-element sub-block
// (sc byte: low nibble the scale, high nibble the min).
//
// Two arms, as the reference has them, chosen from the call's width
// (n_pad <= 64):
//   split (n <= 64, the reference's decode arm): the weight is (d*sc)*q
//     alone, and the min term bsum16 . (dmin*mn)^T is subtracted in f32,
//     where bsum16 holds the per-16 sums of the activations as the product
//     sees them (bf16-rounded under "fast");
//   folded (n > 64, the prefill arm): the weight is (d*sc)*q - dmin*mn,
//     rounded in the codec's order (no FMA).
// The two differ by whole bf16 ulps under "fast" (the bf16 rounding of the
// weight with and without its min), so the arm is part of the contract.
//
// "fast" (bf16 operands, f32 sums) runs on the bf16 tensor cores at every
// width, over the TMA ring of mmq_tc.cuh. A warpgroup owns 64 rows and
// walks K in chunks of KH = 128 elements, one half h of a superblock: per
// row its 32 qs bytes hold all four crumbs of the chunk, so every weight
// byte leaves device memory once. A stage holds the x tile (two (BN x 64)
// bf16 boxes, 128-byte swizzle: wgmma's K-major layout) and the rows' qs
// bytes (32-byte swizzle: conflict-free fragment loads); the chunk's 8 sc
// bytes and the superblock's d and dmin (8 and 2 bytes per row, below
// TMA's 16-byte box) are plain loads one chunk ahead. A k16 step lies in
// one sub-block, so a lane needs one (d*sc, dmin*mn) pair per row and step,
// and its four codes of a step come from K1's byte permute,
// (v >> 2j) & 0x03030303. The tile decides the arm:
//  - BN = 8, 16, 64 (one warpgroup, n <= 64) is the split arm: the min
//    term is an f32 register tile beside the wgmma accumulator, and bsum16
//    is summed per chunk from the bf16 x tile already staged (no pre-pass
//    launch), into shared memory, and applied after the next barrier, so
//    the loop keeps one barrier per chunk; main - min once at the end;
//  - BN = 128 (two warpgroups sharing each x tile, n > 64) is the folded
//    arm, A = bf16(fold(d*sc, dmin*mn, q)) as in K1.
// At decode widths the row blocks cannot fill 132 SMs (176 at TinyLlama's
// gate_up, 4 at the 256-row wk), so K is cut across the grid's z axis;
// each split writes its main - min partial and mmq::add_splits adds them
// in split order, the same bits each run.
//
// What bounds it on an H100: its floor at decode widths is the weight
// stream (84 bytes per 256 weights), yet at TinyLlama's gate_up, n = 16,
// it runs at about 8x that floor; what holds it there is among the
// per-chunk chain (a wait, the decode, eight dependent wgmma steps) with
// few warps per SM, the decode arithmetic (about four instructions per
// weight and lane, and in the split arm BN/2 x 8 FMAs of the min term per
// lane and chunk) and the split-K pass, PERF.md keeping what is measured.
// At prefill widths: the tensor cores' rate beside the same decode.
//
// "high" (f32 operands and products) cannot go through bf16 tensor cores
// within its 1e-5 bound and keeps the SIMT tile of mmq_common.cuh: a block
// of 256 threads owns 64 rows and walks K in 64-element steps; step t of a
// superblock covers its elements 64t .. 64t+63: crumbs 2p and 2p+1 (p =
// t%2) of qs bytes 32h .. 32h+31 (h = t/2), under the four sub-blocks
// 4t .. 4t+3. Thread (r, q) decodes bytes 8q .. 8q+7 of that run for row
// r: elements 8q+i (sub-block 4t + q/2) and 32+8q+i (sub-block 4t+2 +
// q/2); the split arm's per-16 sums are warp reductions over 16 lanes of
// the staging loop. K is cut across the grid as above (MMQ_SPLIT_DISPATCH).

#include "mmq_tc.cuh"

namespace {

// ------------------------------------------------ "high": the SIMT tile ---

namespace simt {

using namespace mmq;

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(NTHREADS)
mmq_q2_k_kernel(const uint8_t* __restrict__ sc, const uint8_t* __restrict__ qs,
                const __half* __restrict__ dv, const __half* __restrict__ dminv,
                const void* __restrict__ x, float* __restrict__ out,
                float* __restrict__ part, int split, int M, int N, int K,
                int steps_per_split) {
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

}  // namespace simt

// ------------------------------------- "fast": the tensor-core tile ---

namespace tcore {

using namespace tc;

// BN activation rows x WG warpgroups of 64 weight rows per block; the tile
// decides the arm. A stage: the x tile (two (BN x 64) bf16 boxes of XBOX
// bytes) and the rows' 32 qs bytes of the chunk.
template <int BN, int WG>
struct Tile {
  static constexpr bool SPLIT = BN <= 64;   // the reference's arm at these widths
  static constexpr int ROWS = BM * WG;
  static constexpr int THREADS = NTHREADS * WG;
  static constexpr int STAGES = 4;
  static constexpr int AHEAD = STAGES - 2;   // chunks loaded ahead
  static constexpr int XBOX = BN * KC * 2;
  static constexpr int QS = 2 * XBOX;
  static constexpr int STAGE = QS + ROWS * 32;   // a multiple of 1024
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

template <int BN, int WG>
__global__ void __launch_bounds__(NTHREADS * WG)
mmq_q2_k_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tqs,
            const uint8_t* __restrict__ sc, const uint16_t* __restrict__ dv,
            const uint16_t* __restrict__ dminv, float* __restrict__ out,
            float* __restrict__ part, int M, int N, int K, int chunks_per_split) {
  using T = Tile<BN, WG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[T::STAGES];
  // split arm: bsum16 by chunk parity, sub-block, n (read as float2)
  __shared__ __align__(16) float bs[2][8][BN];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * T::ROWS, n0 = blockIdx.y * BN;
  const int c0 = blockIdx.z * chunks_per_split;
  const int nch = min(K / KH, c0 + chunks_per_split) - c0;
  // blocks start at different chunks of their range, so the blocks that
  // share an activation tile do not all read the same one at once
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
      tma_load_2d(dst + T::QS, &tqs, 32 * c, m0, &full[st]);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::AHEAD; ++i) load(i);

  // this lane's rows' 8 sc bytes of a chunk and their superblock's
  // d | dmin << 16, read one chunk ahead (the four lanes of a row read the
  // same bytes)
  uint2 scn[2];
  uint32_t ddn[2];
  auto load_scales = [&](int i) {
    const int c = chunk(i);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + row + 8 * e;
      scn[e] = make_uint2(0, 0);
      ddn[e] = 0;
      if (m < M) {
        const size_t sb = static_cast<size_t>(m) * (K / 256) + (c >> 1);
        scn[e] = *reinterpret_cast<const uint2*>(sc + static_cast<size_t>(m) * (K / 16) + 8 * c);
        ddn[e] = dv[sb] | static_cast<uint32_t>(dminv[sb]) << 16;
      }
    }
  };
  load_scales(0);

  float acc[BN / 2], accm[BN / 2];   // accm: the split arm's min term
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = accm[i] = 0.f;
  float zp[2][8];   // split arm: the previous chunk's dmin*mn [row, row + 8][sub-block]
  // accm += bsum16 . (dmin*mn)^T of the previous chunk
  auto add_min = [&](const float (*b)[BN]) {
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const float2 bv = *reinterpret_cast<const float2*>(&b[s][8 * jn + 2 * t]);
        accm[4 * jn] = fmaf(zp[0][s], bv.x, accm[4 * jn]);
        accm[4 * jn + 1] = fmaf(zp[0][s], bv.y, accm[4 * jn + 1]);
        accm[4 * jn + 2] = fmaf(zp[1][s], bv.x, accm[4 * jn + 2]);
        accm[4 * jn + 3] = fmaf(zp[1][s], bv.y, accm[4 * jn + 3]);
      }
  };
  uint32_t a[2][4];
  // lane t's codes of a k16 step are bytes 2t, 2t+1, 8+2t, 9+2t of a
  // 16-byte half of the row's 32 qs bytes: halves of words t/2 and t/2 + 2;
  // the halves of rows with bit 2 set trade places (32-byte swizzle)
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  const int flip = (g >> 2) & 1;

  for (int i = 0; i < nch; ++i) {
    // every warp is past chunk i-1's first wgmma_wait, so chunk i-2's
    // stage is free for chunk i + AHEAD, and chunk i-1's bsum16 is written
    __syncthreads();
    load(i + T::AHEAD);
    if constexpr (T::SPLIT) {
      if (i > 0) add_min(bs[(i - 1) & 1]);
    }
    const uint2 scc[2] = {scn[0], scn[1]};
    const uint32_t ddc[2] = {ddn[0], ddn[1]};
    if (i + 1 < nch) load_scales(i + 1);
    const uint8_t* st = smem + (i % T::STAGES) * T::STAGE;
    mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
    if constexpr (T::SPLIT) {
      // bsum16 of this chunk: 8 sums of 16 bf16 per activation row of the
      // staged x tile (16-byte piece u of row n sits at u ^ (n % 8))
      for (int p = threadIdx.x; p < 8 * BN; p += T::THREADS) {
        const int n = p >> 3, s = p & 7, u = 2 * (s & 3);
        const uint8_t* xr = st + (s >> 2) * T::XBOX + 128 * n;
        bs[i & 1][s][n] = bf16_sum8(*reinterpret_cast<const uint4*>(xr + 16 * (u ^ (n & 7)))) +
                          bf16_sum8(*reinterpret_cast<const uint4*>(xr + 16 * ((u + 1) ^ (n & 7))));
      }
    }
    float s[2][8], z[2][8];   // [row, row + 8][sub-block k] d*sc, dmin*mn
    uint32_t v[2][2];         // [row, row + 8][half of the 32 qs bytes]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float d = kquant::half_lo(ddc[e]), dmin = kquant::half_hi(ddc[e]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t w = k < 4 ? scc[e].x : scc[e].y;
        s[e][k] = __fmul_rn(d, code_f(w & 0x0F0F0F0Fu, k & 3));
        z[e][k] = __fmul_rn(dmin, code_f((w >> 4) & 0x0F0F0F0Fu, k & 3));
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint8_t* p = st + T::QS + 32 * (row + 8 * e) + 16 * (q ^ flip) + 4 * (t >> 1);
        v[e][q] = __byte_perm(*reinterpret_cast<const uint32_t*>(p),
                              *reinterpret_cast<const uint32_t*>(p + 8), sel);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {   // k16 step: sub-block k, crumb k/2 of half k%2
      uint32_t(&af)[4] = a[k & 1];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t q4 = (v[e][k & 1] >> (2 * (k >> 1))) & 0x03030303u;
        float w[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          w[b] = T::SPLIT ? __fmul_rn(s[e][k], code_f(q4, b))
                          : fold(s[e][k], z[e][k], code_f(q4, b));
        af[e] = pack_bf16(w[0], w[1]);
        af[2 + e] = pack_bf16(w[2], w[3]);
      }
      wgmma_fence();
      wgmma_bf16<BN>(acc, af, x_desc_kh(st, T::XBOX, k));
      wgmma_commit();
      wgmma_wait<1>();   // step k-1 is done: its A registers are free
    }
    if constexpr (T::SPLIT) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k = 0; k < 8; ++k) zp[e][k] = z[e][k];
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
  if constexpr (T::SPLIT) {
    __syncthreads();   // the last chunk's bsum16
    add_min(bs[(nch - 1) & 1]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] -= accm[i];   // main - min, the plain order
  }
  store_acc<BN>(acc, out, part, M, N, m0 + row, n0 + 2 * t);
}

template <int BN, int WG>
cudaError_t launch(const uint8_t* sc, const uint8_t* qs, const uint16_t* d,
                   const uint16_t* dmin, const void* xb, float* out, float* part, int M, int N,
                   int K, int splits, int per, cudaStream_t st) {
  using T = Tile<BN, WG>;
  CUtensorMap tx, tqs;
  cudaError_t err = tensor_map_2d(&tx, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN, KC,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tqs, qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K / 4, T::ROWS, 32,
                        CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mmq_q2_k_tc<BN, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + T::ROWS - 1) / T::ROWS, (N + BN - 1) / BN, splits);
  mmq_q2_k_tc<BN, WG><<<grid, T::THREADS, T::SMEM, st>>>(tx, tqs, sc, d, dmin, out, part, M, N,
                                                          K, per);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(N) * M;
    mmq::add_splits<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
        part, out, splits, total);
  }
  return cudaSuccess;
}

}  // namespace tcore

}  // namespace

// "high": sc (M, K/256*16) and qs (M, K/256*64) bytes, d and dmin (M,
// K/256) fp16: the fields of the GGUF blocks, qs 8-byte aligned; x: (N, K)
// f32 or bf16; out: (N, M) f32; part: (splits, N, M) f32 scratch when
// splits > 1; split: 1 for the split arm, 0 for the folded one. fast must
// be 0: "fast" runs mmq_q2_k_tc_launch.
extern "C" int mmq_q2_k_launch(const void* sc, const void* qs, const void* d,
                               const void* dmin, const void* x, void* out,
                               void* part, int split, int M, int N, int K,
                               int x_bf16, int fast, int splits,
                               int steps_per_split, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0 || fast || splits < 1 || steps_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  MMQ_SPLIT_DISPATCH(simt::mmq_q2_k_kernel, M, N, splits, x_bf16, st, o, p,
                     static_cast<const uint8_t*>(sc),
                     static_cast<const uint8_t*>(qs),
                     static_cast<const __half*>(d),
                     static_cast<const __half*>(dmin), x, o, p, split, M, N,
                     K, steps_per_split);
  return static_cast<int>(cudaGetLastError());
}

// "fast": the fields as above, sc 8-byte and qs 16-byte aligned; x (N, K)
// f32 or bf16; xb the (N, K) bf16 operand, 16-byte aligned: x itself when
// the caller passes it, else scratch this call fills first; part: (splits,
// N, M) f32 scratch when splits > 1, K cut into splits ranges of
// chunks_per_split 128-element chunks. The arm is the tile's: split at
// N <= 64, folded above (ops/mmq_q2_k.py:split_arm).
extern "C" int mmq_q2_k_tc_launch(const void* sc, const void* qs, const void* d,
                                  const void* dmin, const void* x, void* xb, void* out,
                                  void* part, int M, int N, int K, int x_bf16, int splits,
                                  int chunks_per_split, void* stream) {
  const int chunks = K / tc::KH;   // every split has a chunk
  if (K % 256 != 0 || M <= 0 || N <= 0 || splits < 1 || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= chunks || splits * chunks_per_split < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::launch_to_bf16(x, xb, N, K, K, x_bf16, 0, st);
  const auto* scp = static_cast<const uint8_t*>(sc);
  const auto* qsp = static_cast<const uint8_t*>(qs);
  const auto* dp = static_cast<const uint16_t*>(d);
  const auto* mp = static_cast<const uint16_t*>(dmin);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(part);
  const int per = chunks_per_split;
  cudaError_t err;   // tiles as ops/mmq_q4_k.py:tc_tile
  if (N <= 8)
    err = tcore::launch<8, 1>(scp, qsp, dp, mp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 16)
    err = tcore::launch<16, 1>(scp, qsp, dp, mp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 64)
    err = tcore::launch<64, 1>(scp, qsp, dp, mp, xb, op, pp, M, N, K, splits, per, st);
  else
    err = tcore::launch<128, 2>(scp, qsp, dp, mp, xb, op, pp, M, N, K, splits, per, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
