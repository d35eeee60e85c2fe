// K13: fused Q3_K dequantize + matmul (any N, K a multiple of 256).
//
// Replaces gguf_tpu/ops/mmq_q3_k.py:_kernel (decode and prefill widths),
// reached through mmq_q3_k. The TPU kernel re-lays the codes into bit
// planes whose rows share a 16-element sub-block, and permutes the
// activations to match (an XLA transpose or an in-kernel 0/1 matmul); here
// the kernel decodes the GGUF bytes in element order, so neither exists.
// Q3_K's 110-byte block is split at load into its fields (hmask 32 | qs 64
// | scales 12 | fp16 d). Element 128h + 32j + l of a superblock has the
// low two bits in crumb j of qs byte 32h + l and the third in bit 4h + j
// of hmask byte l; its value is (d*sc) * (q - 4), sc the signed 6-bit
// scale of its 16-element sub-block 8h + 2j + l/16: exact in f32, so it
// equals the reference's q*s - 4*s bit for bit, and both of the
// reference's width arms compute the same numbers. No min term.
//
// "fast" (w = bf16((d*sc)*(q-4)), x = bf16(x), f32 sums) runs on the bf16
// tensor cores at every width, over the TMA ring of mmq_tc.cuh, as K12
// (mmq_q2_k.cu) does: a warpgroup owns 64 rows (two share each activation
// tile above n = 64) and walks K in chunks of KH = 128 elements, one half h
// of a superblock. A stage holds the x tile (two (BN x 64) bf16 boxes,
// 128-byte swizzle), the rows' 32 qs bytes of the chunk and, where the
// chunk brings them, the superblock's 32 hmask bytes (both 32-byte
// swizzle: conflict-free fragment loads). Both halves of a superblock read
// the same hmask bytes (bits 0-3 for h = 0, 4-7 for h = 1) at the same
// byte positions as their qs bytes, so a lane keeps its hmask words in
// registers from the even chunk to the odd one that follows it: only a
// chunk whose even partner did not come just before (the first of a
// block's range, or the first after the range wraps) loads the box, and
// each hmask byte leaves device memory once per superblock. The 12 scale
// bytes and d of the superblock (14 bytes per row, below TMA's 16-byte box)
// are plain loads one chunk ahead. A k16 step k lies in sub-block 8h + k,
// so a lane needs one d*sc per row and step; its four codes of a step are
// K1's byte permute of the qs bytes, (v >> 2j) & 0x03030303, and the same
// permute of the hmask bytes gives their third bits,
// (hv >> (4h + j)) & 0x01010101; the int8 value q - 4 is the crumb with
// 0xFC ORed in where the third bit is clear. K is cut across the grid's z
// axis as ops/mmq_q4_k.py:tc_plan says; mmq::add_splits adds the partial
// tiles in split order, the same bits each run.
//
// What bounds it on an H100: the weight stream (110 bytes per 256 weights)
// at decode widths, with the per-code decode and the chain of dependent
// wgmma steps behind it; at prefill widths the tensor cores' rate beside
// the same decode.
//
// "high" (f32 operands and products) cannot go through bf16 tensor cores
// within its 1e-5 bound and keeps the SIMT tile of mmq_common.cuh: a block
// of 256 threads owns BM = 64 rows and BN activation rows and walks K in
// 64-element steps; step t of a superblock covers its elements 64t ..
// 64t+63, which are crumbs 2p and 2p+1 (p = t%2) of qs bytes 32h .. 32h+31
// (h = t/2) and bits 2t, 2t+1 of hmask bytes 0 .. 31, under the four
// sub-blocks 4t .. 4t+3. Thread (r, q) decodes bytes 8q .. 8q+7 of those
// runs for row r: elements 8q+i (sub-block 4t + q/2) and 32+8q+i
// (sub-block 4t+2 + q/2). K is cut across the grid's z axis when M/64
// blocks cannot fill the card (MMQ_SPLIT_DISPATCH). Its C entry,
// mmq_q3_k_launch, refuses "fast".

#include "mmq_tc.cuh"

namespace {

// ------------------------------------------------ "high": the SIMT tile ---

namespace simt {

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
                int N, int K, int steps_per_split) {
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
      ws[8 * q + i][r] = __fmul_rn(sa, static_cast<float>(qa));
      ws[32 + 8 * q + i][r] = __fmul_rn(sb, static_cast<float>(qb));
    }
    stage_x<BN, XBF16>(xs, x, K, N, K, n0, s * KT, 0, 0);
    __syncthreads();
    fma_tile<BN, TM, TN>(ws, xs, acc, tx, ty);
    __syncthreads();
  }
  float* dst = gridDim.z > 1 ? part + static_cast<size_t>(blockIdx.z) * N * M : out;
  store_tile<BN, TM, TN>(dst, acc, M, N, m0, n0, tx, ty);
}

}  // namespace simt

// ------------------------------------- "fast": the tensor-core tile ---

namespace tcore {

using namespace tc;

// BN activation rows x WG warpgroups of 64 weight rows per block. A stage:
// the x tile (two (BN x 64) bf16 boxes of XBOX bytes), the rows' 32 qs
// bytes of the chunk and room for their superblock's 32 hmask bytes.
template <int BN, int WG>
struct Tile {
  static constexpr int ROWS = BM * WG;
  static constexpr int THREADS = NTHREADS * WG;
  static constexpr int STAGES = 4;
  static constexpr int AHEAD = STAGES - 2;   // chunks loaded ahead
  static constexpr int XBOX = BN * KC * 2;
  static constexpr int QS = 2 * XBOX;
  static constexpr int HM = QS + ROWS * 32;
  static constexpr int STAGE = HM + ROWS * 32;
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static_assert(XBOX % 1024 == 0 && HM % 1024 == 0 && STAGE % 1024 == 0,
                "every box of a stage must be 1024-byte aligned");
};

template <int BN, int WG>
__global__ void __launch_bounds__(NTHREADS * WG)
mmq_q3_k_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tqs,
            const __grid_constant__ CUtensorMap thm, const uint8_t* __restrict__ scales,
            const uint16_t* __restrict__ dv, float* __restrict__ out, float* __restrict__ part,
            int M, int N, int K, int chunks_per_split) {
  using T = Tile<BN, WG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[T::STAGES];
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
  // whether the block's i-th chunk brings its superblock's hmask bytes:
  // every even chunk, and an odd one whose even partner is not the
  // block's chunk i-1 (it then follows chunk i-1 = chunk(i) - 1 unless it
  // is the first of the range or of the wrapped part)
  auto fresh = [&](int i) {
    const int c = chunk(i);
    return !(c & 1) || i == 0 || c == c0;
  };
  auto load = [&](int i) {   // the block's i-th chunk into stage i % STAGES
    if (threadIdx.x == 0 && i < nch) {
      const int c = chunk(i), st = i % T::STAGES;
      const bool hm = fresh(i);
      uint8_t* dst = smem + st * T::STAGE;
      mbar_expect_tx(&full[st], hm ? T::STAGE : T::HM);
      tma_load_2d(dst, &tx, KH * c, n0, &full[st]);
      tma_load_2d(dst + T::XBOX, &tx, KH * c + KC, n0, &full[st]);
      tma_load_2d(dst + T::QS, &tqs, 32 * c, m0, &full[st]);
      if (hm) tma_load_2d(dst + T::HM, &thm, 32 * (c >> 1), m0, &full[st]);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::AHEAD; ++i) load(i);

  // this lane's rows' 12 scale bytes (x, y, z) and d (w) of a chunk's
  // superblock, read one chunk ahead (the four lanes of a row read the
  // same bytes)
  uint4 scn[2];
  auto load_scales = [&](int i) {
    const int c = chunk(i);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + row + 8 * e;
      scn[e] = make_uint4(0, 0, 0, 0);
      if (m < M) {
        const size_t sb = static_cast<size_t>(m) * (K / 256) + (c >> 1);
        const uint32_t* sc = reinterpret_cast<const uint32_t*>(scales + 12 * sb);
        scn[e] = make_uint4(sc[0], sc[1], sc[2], dv[sb]);
      }
    }
  };
  load_scales(0);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][4];
  // lane t's codes of a k16 step are bytes 2t, 2t+1, 8+2t, 9+2t of a
  // 16-byte half of the row's 32 qs (and hmask) bytes: halves of words t/2
  // and t/2 + 2; the halves of rows with bit 2 set trade places (32-byte
  // swizzle)
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  const int flip = (g >> 2) & 1;
  auto lane_bytes = [&](const uint8_t* box, int e, int q) {
    const uint8_t* p = box + 32 * (row + 8 * e) + 16 * (q ^ flip) + 4 * (t >> 1);
    return __byte_perm(*reinterpret_cast<const uint32_t*>(p),
                       *reinterpret_cast<const uint32_t*>(p + 8), sel);
  };
  uint32_t hv[2][2] = {};   // [row, row + 8][half]: hmask bytes, kept for the odd chunk

  for (int i = 0; i < nch; ++i) {
    // every warp is past chunk i-1's first wgmma_wait, so chunk i-2's
    // stage is free for chunk i + AHEAD
    __syncthreads();
    load(i + T::AHEAD);
    const int c = chunk(i), h = c & 1;
    const uint4 scc[2] = {scn[0], scn[1]};
    if (i + 1 < nch) load_scales(i + 1);
    const uint8_t* st = smem + (i % T::STAGES) * T::STAGE;
    mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
    const bool hm = fresh(i);
    float s[2][8];      // [row, row + 8][sub-block 8h + k] d*sc
    uint32_t v[2][2];   // [row, row + 8][half of the 32 qs bytes]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // sub-block 8h + k: low 4 bits in nibble h of scale byte k, top 2
      // bits at bit 4h + 2(k/4) of byte 8 + k%4
      const float d = kquant::half_lo(scc[e].w);
      const uint32_t lo[2] = {(scc[e].x >> (4 * h)) & 0x0F0F0F0Fu,
                              (scc[e].y >> (4 * h)) & 0x0F0F0F0Fu};
      const uint32_t sc4[2] = {lo[0] | (((scc[e].z >> (4 * h)) & 0x03030303u) << 4),
                               lo[1] | (((scc[e].z >> (4 * h + 2)) & 0x03030303u) << 4)};
#pragma unroll
      for (int k = 0; k < 8; ++k) s[e][k] = __fmul_rn(d, code_f(sc4[k >> 2], k & 3) - 32.f);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        v[e][q] = lane_bytes(st + T::QS, e, q);
        if (hm) hv[e][q] = lane_bytes(st + T::HM, e, q);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {   // k16 step: sub-block 8h + k, crumb k/2 of half k%2
      uint32_t(&af)[4] = a[k & 1];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t crumbs = (v[e][k & 1] >> (2 * (k >> 1))) & 0x03030303u;
        const uint32_t hbit = (hv[e][k & 1] >> (4 * h + (k >> 1))) & 0x01010101u;
        const uint32_t q = crumbs | ((hbit ^ 0x01010101u) * 0xFCu);   // int8 q - 4
        af[e] = pack_bf16(__fmul_rn(s[e][k], scode_f(q, 0)), __fmul_rn(s[e][k], scode_f(q, 1)));
        af[2 + e] =
            pack_bf16(__fmul_rn(s[e][k], scode_f(q, 2)), __fmul_rn(s[e][k], scode_f(q, 3)));
      }
      wgmma_fence();
      wgmma_bf16<BN>(acc, af, x_desc_kh(st, T::XBOX, k));
      wgmma_commit();
      wgmma_wait<1>();   // step k-1 is done: its A registers are free
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
  store_acc<BN>(acc, out, part, M, N, m0 + row, n0 + 2 * t);
}

template <int BN, int WG>
cudaError_t launch(const uint8_t* hmask, const uint8_t* qs, const uint8_t* scales,
                   const uint16_t* d, const void* xb, float* out, float* part, int M, int N,
                   int K, int splits, int per, cudaStream_t st) {
  using T = Tile<BN, WG>;
  CUtensorMap tx, tqs, thm;
  cudaError_t err = tensor_map_2d(&tx, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN, KC,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tqs, qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K / 4, T::ROWS, 32,
                        CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&thm, hmask, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K / 8, T::ROWS, 32,
                        CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mmq_q3_k_tc<BN, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + T::ROWS - 1) / T::ROWS, (N + BN - 1) / BN, splits);
  mmq_q3_k_tc<BN, WG><<<grid, T::THREADS, T::SMEM, st>>>(tx, tqs, thm, scales, d, out, part, M,
                                                          N, K, per);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(N) * M;
    mmq::add_splits<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
        part, out, splits, total);
  }
  return cudaSuccess;
}

}  // namespace tcore

}  // namespace

// "high": hmask (M, K/256*32), qs (M, K/256*64), scales (M, K/256*12) bytes
// and d (M, K/256) fp16: the fields of the GGUF blocks, hmask and qs 8-byte
// aligned; x: (N, K) f32 or bf16; out: (N, M) f32; part: (splits, N, M)
// f32 scratch when splits > 1. fast must be 0: "fast" runs
// mmq_q3_k_tc_launch.
extern "C" int mmq_q3_k_launch(const void* hmask, const void* qs,
                               const void* scales, const void* d,
                               const void* x, void* out, void* part, int M,
                               int N, int K, int x_bf16, int fast, int splits,
                               int steps_per_split, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0 || fast || splits < 1 || steps_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  MMQ_SPLIT_DISPATCH(simt::mmq_q3_k_kernel, M, N, splits, x_bf16, st, o, p,
                     static_cast<const uint8_t*>(hmask),
                     static_cast<const uint8_t*>(qs),
                     static_cast<const uint8_t*>(scales),
                     static_cast<const __half*>(d), x, o, p, M, N, K,
                     steps_per_split);
  return static_cast<int>(cudaGetLastError());
}

// "fast": the fields as above, hmask and qs 16-byte, scales 4-byte
// aligned; x (N, K) f32 or bf16; xb the (N, K) bf16 operand, 16-byte
// aligned: x itself when the caller passes it, else scratch this call fills
// first; part: (splits, N, M) f32 scratch when splits > 1, K cut into
// splits ranges of chunks_per_split 128-element chunks.
extern "C" int mmq_q3_k_tc_launch(const void* hmask, const void* qs, const void* scales,
                                  const void* d, const void* x, void* xb, void* out,
                                  void* part, int M, int N, int K, int x_bf16, int splits,
                                  int chunks_per_split, void* stream) {
  const int chunks = K / tc::KH;   // every split has a chunk
  if (K % 256 != 0 || M <= 0 || N <= 0 || splits < 1 || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= chunks || splits * chunks_per_split < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::launch_to_bf16(x, xb, N, K, K, x_bf16, 0, st);
  const auto* hp = static_cast<const uint8_t*>(hmask);
  const auto* qp = static_cast<const uint8_t*>(qs);
  const auto* sp = static_cast<const uint8_t*>(scales);
  const auto* dp = static_cast<const uint16_t*>(d);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(part);
  const int per = chunks_per_split;
  cudaError_t err;   // tiles as ops/mmq_q4_k.py:tc_tile
  if (N <= 8)
    err = tcore::launch<8, 1>(hp, qp, sp, dp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 16)
    err = tcore::launch<16, 1>(hp, qp, sp, dp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 64)
    err = tcore::launch<64, 1>(hp, qp, sp, dp, xb, op, pp, M, N, K, splits, per, st);
  else
    err = tcore::launch<128, 2>(hp, qp, sp, dp, xb, op, pp, M, N, K, splits, per, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
