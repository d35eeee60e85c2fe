// K2: fused Q6_K dequantize + matmul (any N) — the K-quant files' LM head.
//
// Replaces gguf_tpu/ops/mmq_q6_k.py:_kernel_ink (decode widths) and
// :_kernel (prefill widths), reached through mmq_q6_k. Q6_K's 210-byte
// block (ql 128 | qh 64 | int8 scales 16 | fp16 d) is not 4-byte aligned,
// so the loader splits it into per-field arrays that keep the GGUF byte
// order inside each field. Element 128h + 32j + l of a superblock is
// nibble j/2 of ql byte 64h + 32(j%2) + l joined with crumb j of qh byte
// 32h + l (as its bits 4-5), minus 32; its value is (d * sc16) * (q - 32),
// products rounded in the codec's order (bit-equal dequantize), sc16 the
// signed scale of its 16-element sub-block.
//
// "fast" (bf16 operands, f32 sums) runs on the bf16 tensor cores at every
// width, over the TMA ring of mmq_tc.cuh: a warpgroup owns 64 rows (two
// warpgroups share each activation tile above n = 64) and walks K in
// chunks of KH = 128 elements, one half h of a superblock, i.e. per row 64
// ql bytes and 32 qh bytes, so every weight byte leaves device memory
// once. A stage holds the x tile (two (BN x 64) bf16 boxes, 128-byte
// swizzle: wgmma's K-major layout), the ql bytes (64-byte swizzle) and the
// qh bytes (32-byte swizzle), the swizzles keeping the fragment loads free
// of bank conflicts; the chunk's 8 signed scales and the superblock's d
// (8 and 2 bytes per row, below TMA's 16-byte box) are plain loads one
// chunk ahead. A k16 step lies in one sub-block: each lane needs one
// d*sc16 per row and step, and its four codes of a step (bytes 2t, 2t+1,
// 2t+8, 2t+9 of a 16-byte run, K1's byte permute) are
// ((l >> 4(j/2)) & 0x0F0F0F0F) | ((h >> 2j) & 0x03030303) << 4. The weight
// is bf16((d*sc16) * (q - 32)), rounded in that order. The 32000-row head
// gives 500 row blocks, enough for 132 SMs: K is split only where
// ops/mmq_q4_k.py:split_k asks for more blocks (the partials added in
// split order by mmq::add_splits).
//
// What bounds it on an H100: the weight stream (210 bytes per 256 weights)
// at decode widths, which it reaches within about 2x at the 32000-row head
// (PERF.md), with the decode arithmetic (about five instructions per
// weight and lane) behind it; at prefill widths (the head at n = 512) the
// tensor cores' rate beside the same decode.
//
// "high" (f32 operands and products; the act_quant path's head, fed K6's
// f32 output) cannot go through bf16 tensor cores within its 1e-5 bound
// and keeps the SIMT tile of mmq_common.cuh, whose weights it stages with
// aligned 8-byte loads.

#include "mmq_tc.cuh"

namespace {

// ------------------------------------------------ "high": the SIMT tile ---

namespace simt {

using namespace mmq;

template <int BN, int TM, int TN, bool XBF16>
__global__ void __launch_bounds__(NTHREADS)
mmq_q6_k_kernel(const uint8_t* __restrict__ ql, const uint8_t* __restrict__ qh,
                const int8_t* __restrict__ sc, const __half* __restrict__ dv,
                const void* __restrict__ x, float* __restrict__ out, int M,
                int N, int K, int ldx) {
  __shared__ float ws[KT][BM + 1];
  __shared__ float xs[KT][BN + 1];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM), ty = tid / (BM / TM);
  const int r = tid >> 2, q = tid & 3;
  const bool row_ok = m0 + r < M;
  const int nsb = K / 256;
  const size_t row = static_cast<size_t>(row_ok ? m0 + r : 0) * nsb;
  float acc[TM][TN] = {};

  for (int sb = 0; sb < nsb; ++sb) {
    const uint8_t* qlb = ql + (row + sb) * 128;
    const uint8_t* qhb = qh + (row + sb) * 64;
    const int8_t* scb = sc + (row + sb) * 16;
    const float d = row_ok ? __half2float(dv[row + sb]) : 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // step s covers elements 128h + 64p + kk, kk in [0, 64): nibble p of
      // ql byte 64h + kk, crumb 2p + kk/32 of qh byte 32h + kk%32
      const int h = s >> 1, p = s & 1;
      uint2 la = make_uint2(0, 0), lb = make_uint2(0, 0), hv = make_uint2(0, 0);
      float sa = 0.f, sbv = 0.f;
      if (row_ok) {
        la = *reinterpret_cast<const uint2*>(qlb + 64 * h + 8 * q);
        lb = *reinterpret_cast<const uint2*>(qlb + 64 * h + 32 + 8 * q);
        hv = *reinterpret_cast<const uint2*>(qhb + 32 * h + 8 * q);
        sa = __fmul_rn(d, static_cast<float>(scb[8 * h + 4 * p + (q >> 1)]));
        sbv = __fmul_rn(d, static_cast<float>(scb[8 * h + 4 * p + 2 + (q >> 1)]));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int sh = 8 * (i & 3);
        const unsigned a = ((i < 4 ? la.x : la.y) >> sh) & 0xFF;
        const unsigned b = ((i < 4 ? lb.x : lb.y) >> sh) & 0xFF;
        const unsigned c = ((i < 4 ? hv.x : hv.y) >> sh) & 0xFF;
        const int qa = static_cast<int>(((a >> (4 * p)) & 0xF) | (((c >> (4 * p)) & 3) << 4)) - 32;
        const int qb = static_cast<int>(((b >> (4 * p)) & 0xF) | (((c >> (4 * p + 2)) & 3) << 4)) - 32;
        ws[8 * q + i][r] = __fmul_rn(sa, static_cast<float>(qa));
        ws[32 + 8 * q + i][r] = __fmul_rn(sbv, static_cast<float>(qb));
      }
      stage_x<BN, XBF16>(xs, x, ldx, N, K, n0, sb * 256 + 128 * h + 64 * p, 0, 0);
      __syncthreads();
      fma_tile<BN, TM, TN>(ws, xs, acc, tx, ty);
      __syncthreads();
    }
  }
  store_tile<BN, TM, TN>(out, acc, M, N, m0, n0, tx, ty);
}

}  // namespace simt

// ------------------------------------- "fast": the tensor-core tile ---

namespace tcore {

using namespace tc;

// BN activation rows x WG warpgroups of 64 weight rows per block. A stage:
// the x tile (two (BN x 64) bf16 boxes of XBOX bytes), the rows' 64 ql
// bytes and 32 qh bytes of the chunk.
template <int BN, int WG>
struct Tile {
  static constexpr int ROWS = BM * WG;
  static constexpr int THREADS = NTHREADS * WG;
  static constexpr int STAGES = 4;
  static constexpr int AHEAD = STAGES - 2;   // chunks loaded ahead
  static constexpr int XBOX = BN * KC * 2;
  static constexpr int QL = 2 * XBOX;
  static constexpr int QH = QL + ROWS * 64;
  static constexpr int STAGE = QH + ROWS * 32;   // a multiple of 1024
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

// byte i of v (a 6-bit code) minus 32, as an exact float
__device__ __forceinline__ float q6_f(uint32_t v, int i) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + i)) - 8388640.0f;
}

template <int BN, int WG>
__global__ void __launch_bounds__(NTHREADS * WG)
mmq_q6_k_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tql,
            const __grid_constant__ CUtensorMap tqh, const uint8_t* __restrict__ sc,
            const uint16_t* __restrict__ dv, float* __restrict__ out,
            float* __restrict__ part, int M, int N, int K, int chunks_per_split) {
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
  auto load = [&](int i) {   // the block's i-th chunk into stage i % STAGES
    if (threadIdx.x == 0 && i < nch) {
      const int c = chunk(i), st = i % T::STAGES;
      uint8_t* dst = smem + st * T::STAGE;
      mbar_expect_tx(&full[st], T::STAGE);
      tma_load_2d(dst, &tx, KH * c, n0, &full[st]);
      tma_load_2d(dst + T::XBOX, &tx, KH * c + KC, n0, &full[st]);
      tma_load_2d(dst + T::QL, &tql, 64 * c, m0, &full[st]);
      tma_load_2d(dst + T::QH, &tqh, 32 * c, m0, &full[st]);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::AHEAD; ++i) load(i);

  // this lane's rows' 8 scale bytes of a chunk and their superblock's d
  // (the four lanes of a row read the same bytes), read one chunk ahead
  uint2 scn[2];
  uint32_t dn[2];
  auto load_scales = [&](int i) {
    const int c = chunk(i);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + row + 8 * e;
      scn[e] = make_uint2(0, 0);
      dn[e] = 0;
      if (m < M) {
        scn[e] = *reinterpret_cast<const uint2*>(sc + static_cast<size_t>(m) * (K / 16) + 8 * c);
        dn[e] = dv[static_cast<size_t>(m) * (K / 256) + (c >> 1)];
      }
    }
  };
  load_scales(0);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][4];
  // lane t's codes of a k16 step are bytes 2t, 2t+1, 8+2t, 9+2t of a
  // 16-byte piece: halves of words t/2 and t/2 + 2 (K1's pattern); piece u
  // of row r sits at u ^ ((r >> 1) & 3) in the ql rows (64-byte swizzle)
  // and at u ^ ((r >> 2) & 1) in the qh rows (32-byte swizzle)
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  const int sw64 = (g >> 1) & 3, sw32 = (g >> 2) & 1;

  for (int i = 0; i < nch; ++i) {
    // every warp is past chunk i-1's first wgmma_wait, so chunk i-2's
    // stage is free for chunk i + AHEAD
    __syncthreads();
    load(i + T::AHEAD);
    const uint2 scc[2] = {scn[0], scn[1]};
    const uint32_t dc[2] = {dn[0], dn[1]};
    if (i + 1 < nch) load_scales(i + 1);
    const uint8_t* st = smem + (i % T::STAGES) * T::STAGE;
    mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
    float s[2][8];        // [row, row + 8][sub-block k] d*sc16
    uint32_t vl[2][4];    // [row, row + 8][16-byte piece of the 64 ql bytes]
    uint32_t vh[2][2];    // [row, row + 8][16-byte piece of the 32 qh bytes]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e;
      const float d = kquant::half_lo(dc[e]);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        s[e][k] = __fmul_rn(d, scode_f(k < 4 ? scc[e].x : scc[e].y, k & 3));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint8_t* p = st + T::QL + 64 * r + 16 * (u ^ sw64) + 4 * (t >> 1);
        vl[e][u] = __byte_perm(*reinterpret_cast<const uint32_t*>(p),
                               *reinterpret_cast<const uint32_t*>(p + 8), sel);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint8_t* p = st + T::QH + 32 * r + 16 * (u ^ sw32) + 4 * (t >> 1);
        vh[e][u] = __byte_perm(*reinterpret_cast<const uint32_t*>(p),
                               *reinterpret_cast<const uint32_t*>(p + 8), sel);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {   // k16 step: sub-block k, j = k/2, piece k%2
      const int j = k >> 1, q = k & 1;
      uint32_t(&af)[4] = a[k & 1];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t code = ((vl[e][2 * (j & 1) + q] >> (4 * (j >> 1))) & 0x0F0F0F0Fu) |
                              ((vh[e][q] >> (2 * j)) & 0x03030303u) << 4;
        af[e] = pack_bf16(__fmul_rn(s[e][k], q6_f(code, 0)), __fmul_rn(s[e][k], q6_f(code, 1)));
        af[2 + e] = pack_bf16(__fmul_rn(s[e][k], q6_f(code, 2)),
                              __fmul_rn(s[e][k], q6_f(code, 3)));
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
cudaError_t launch(const uint8_t* ql, const uint8_t* qh, const uint8_t* sc, const uint16_t* d,
                   const void* xb, float* out, float* part, int M, int N, int K, int splits,
                   int per, cudaStream_t st) {
  using T = Tile<BN, WG>;
  const auto U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap tx, tql, tqh;
  cudaError_t err = tensor_map_2d(&tx, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN, KC,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tql, ql, U8, 1, M, K / 2, T::ROWS, 64, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tqh, qh, U8, 1, M, K / 4, T::ROWS, 32, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mmq_q6_k_tc<BN, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + T::ROWS - 1) / T::ROWS, (N + BN - 1) / BN, splits);
  mmq_q6_k_tc<BN, WG><<<grid, T::THREADS, T::SMEM, st>>>(tx, tql, tqh, sc, d, out, part, M, N,
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

// "high": ql (M, K/2), qh (M, K/4), sc (M, K/16) int8, d (M, K/256) fp16:
// the fields of the GGUF blocks, ql, qh and sc 8-byte aligned; x (N, ldx)
// f32 or bf16; out (N, M) f32. "fast" runs mmq_q6_k_tc_launch.
extern "C" int mmq_q6_k_launch(const void* ql, const void* qh, const void* sc,
                               const void* d, const void* x, void* out, int M,
                               int N, int K, int ldx, int x_bf16, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MMQ_DISPATCH(simt::mmq_q6_k_kernel, M, N, x_bf16, st,
               static_cast<const uint8_t*>(ql), static_cast<const uint8_t*>(qh),
               static_cast<const int8_t*>(sc), static_cast<const __half*>(d), x,
               static_cast<float*>(out), M, N, K, ldx);
  return static_cast<int>(cudaGetLastError());
}

// "fast": the fields as above, ql and qh 16-byte and sc 8-byte aligned; x
// (N, K) f32 or bf16; xb the (N, K) bf16 operand, 16-byte aligned: x
// itself when the caller passes it, else scratch this call fills first;
// part: (splits, N, M) f32 scratch when splits > 1, K cut into splits
// ranges of chunks_per_split 128-element chunks.
extern "C" int mmq_q6_k_tc_launch(const void* ql, const void* qh, const void* sc,
                                  const void* d, const void* x, void* xb, void* out, void* part,
                                  int M, int N, int K, int x_bf16, int splits,
                                  int chunks_per_split, void* stream) {
  const int chunks = K / tc::KH;   // every split has a chunk
  if (K % 256 != 0 || M <= 0 || N <= 0 || splits < 1 || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= chunks || splits * chunks_per_split < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::launch_to_bf16(x, xb, N, K, K, x_bf16, 0, st);
  const auto* lp = static_cast<const uint8_t*>(ql);
  const auto* hp = static_cast<const uint8_t*>(qh);
  const auto* sp = static_cast<const uint8_t*>(sc);
  const auto* dp = static_cast<const uint16_t*>(d);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(part);
  const int per = chunks_per_split;
  cudaError_t err;   // tiles as ops/mmq_q4_k.py:tc_tile
  if (N <= 8)
    err = tcore::launch<8, 1>(lp, hp, sp, dp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 16)
    err = tcore::launch<16, 1>(lp, hp, sp, dp, xb, op, pp, M, N, K, splits, per, st);
  else if (N <= 64)
    err = tcore::launch<64, 1>(lp, hp, sp, dp, xb, op, pp, M, N, K, splits, per, st);
  else
    err = tcore::launch<128, 2>(lp, hp, sp, dp, xb, op, pp, M, N, K, splits, per, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
