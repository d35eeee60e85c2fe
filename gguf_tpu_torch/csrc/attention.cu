// K3: INT8 KV-cache insert.  K4: GQA decode attention over the INT8 cache,
// optionally with the t = 1 insert fused in.  (K9, flash-decoding over long
// spans, is csrc/attention_tiled.cu; the row quantizer is kv_quant.cuh.)
//
// K3 replaces gguf_tpu/ops/attention.py:_insert_kernel (kv_cache_insert).
// One block per (batch, kv-head); one warp quantizes one (token, head) row:
// scale = absmax * f32(1/127) (the product XLA compiles the reference's
// absmax / 127 into), codes = clip(rintf(x / scale), +-127) with an IEEE
// division and round-half-to-even. This file is built without
// --use_fast_math, so the codes are bit-identical to the reference. Rows
// outside [0, S) are skipped: inactive engine slots step at pos = max_seq.
// K3 and K4 take an optional row index: sequence b reads and writes cache
// batch row cache_rows[b] (read from device memory, so a prefill chunk's
// CUDA graph serves every slot), or row b where it is NULL.
//
// K4 replaces gguf_tpu/ops/attention.py:_attn_kernel (decode_attention)
// and :_fused_attn_kernel (decode_attention_update at t = 1), in one launch
// per call. It keeps the reference's rounding points: s = (q.k) *
// (k_scale / sqrt(hd)) with q bf16 under "fast" (f32 under "high") and the
// int8 codes exact, softcap before the causal (lim = pos + r % t) and
// window mask, p = exp(s - m) / l against the row's GLOBAL max m and sum l
// over the span (the two-pass softmax, not K9's running max), pv =
// bf16(p * v_scale) under "fast", out = pv . v; only the order of the f32
// sums differs.
//
// The grid is a thread-block cluster of C CTAs per (batch, KV head) (C =
// 1 when B * KVH blocks fill the card; the wrapper's plan picks C and the
// key tile per shape). Only the live prefix of the span is read: keys past
// pos + t - 1 are masked for every row of the block and exp(NEG_INF - m) is
// exactly 0 in f32, so they are skipped (a row whose limit reaches the
// span, e.g. an inactive slot at pos = S, reads the whole span). The live
// keys are cut into C contiguous ranges, one per CTA, and each CTA's 8
// warps split its range again, so every warp works at G * t = 1:
//   1. scores: a warp takes 32 keys, one per lane (the key row's 16-byte
//      pieces loaded together, the bytes of a line consumed by the same
//      lane's next loads), against a slice of the block's query rows read
//      from shared memory; rows are sliced finer when the keys give fewer
//      items than warps. Scores stay in shared memory.
//   2. the rows' max: per warp, then per CTA; the CTAs exchange them
//      through distributed shared memory (barrier.cluster), and every CTA
//      takes the same global m.
//   3. e = exp(s - m) in place, the sums likewise merged into the global l.
//   4. pv = round(e / l * v_scale) in place; then p . v with the warps
//      splitting the keys again and each lane owning hd / 32 columns (a
//      warp reads whole V rows, coalesced); the warps' partial outputs are
//      added in warp order, the CTAs' in rank order (each CTA sums a slice
//      of the outputs over the cluster), so the result does not depend on
//      the schedule.
// Where the scores of a CTA's range do not fit in shared memory (large g *
// t at long spans; never on the model's routes), the CTA walks its range
// in tiles of the plan's size and scores each tile again in 3. and 4.
// With the insert flag (t = 1) every CTA quantizes this head's new K and V
// row itself from kn / vn into shared memory (the codes are deterministic,
// so every CTA has the same ones) and uses that copy in place of cache row
// pos; only rank 0 writes it to the cache, so no CTA's global write has to
// be ordered before another's read.
//
// What bounds it on an H100: the live int8 K/V rows and their scales (2 *
// (hd + 4) bytes per row and KV head) at decode; at TinyLlama's 64 (batch,
// KV head) blocks and G * t = 8 rows the per-CTA latency of the phases
// (a few barriers each) more than the bytes. "fast" and "high" share the
// f32 SIMT path: the tensor cores would need the V tile transposed for p.v,
// and the scores are a few microseconds of FMAs at these shapes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int NTHREADS = 256;

template <int HD>
__global__ void __launch_bounds__(128)
kv_insert_kernel(const float* __restrict__ kn, const float* __restrict__ vn,
                 int8_t* k, float* ks, int8_t* v, float* vs,
                 const int* __restrict__ pos, const int* __restrict__ cache_rows, int KVH,
                 int T, int S) {
  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = bh / KVH;
  const int p0 = pos[b];
  const size_t cbh = static_cast<size_t>(cache_rows ? cache_rows[b] : b) * KVH + bh % KVH;
  for (int item = warp; item < 2 * T; item += blockDim.x >> 5) {
    const bool is_v = item >= T;
    const int tj = item % T;
    const int row = p0 + tj;
    if (row < 0 || row >= S) continue;
    const size_t src = (static_cast<size_t>(bh) * T + tj) * HD;
    const size_t dst = cbh * S + row;
    if (is_v) quantize_row<HD>(vn + src, v + dst * HD, vs + dst, lane);
    else quantize_row<HD>(kn + src, k + dst * HD, ks + dst, lane);
  }
}

// ------------------------------------------------------------- K4 ---

constexpr int WARPS = NTHREADS / 32;
constexpr int PV_AHEAD = 16;   // V rows a warp has in flight in p . v

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// K4's dynamic shared memory, float offsets (each 16-byte aligned), for R
// query rows, a tile of kt keys and RB rows per p.v pass: q [R][HD] (f32,
// bf16 values under "fast"); sc [R][kt] (scores, then e, then pv); red
// [WARPS][RB][HD] (the warps' p.v partials); outp [R][HD] (this CTA's
// output partial); part [WARPS][R] (per-warp row partials); m, l [R] (row
// max and sum); xm, xl [R] (published to the cluster); kv (the inserted K
// and V rows, 2 HD bytes, and their two scales). Mirrored by
// ops/attention.py:k4_smem_bytes.
struct AttnSmem {
  int q, sc, red, outp, part, m, l, xm, xl, kv, total;
  __host__ __device__ AttnSmem(int R, int HD, int RB, int kt)
      : q(0), sc(R * HD), red(sc + R * up4(kt)), outp(red + WARPS * RB * HD),
        part(outp + R * HD), m(part + up4(WARPS * R)), l(m + up4(R)), xm(l + up4(R)),
        xl(xm + up4(R)), kv(xl + up4(R)), total(kv + HD / 2 + 4) {}
};

// Grid (C, KVH, B) in clusters of C along x; NTHREADS threads, at most
// 64 registers for one query row (4 CTAs per SM: Llama-2-7B's 512 CTAs in
// one wave), 128 above. Cache pointers are not __restrict__: rank 0
// writes the inserted row.
template <int HD, int RB>
__global__ void __launch_bounds__(NTHREADS, RB == 1 ? 4 : 2)
attn_kernel(const float* __restrict__ q, const float* __restrict__ kn,
            const float* __restrict__ vn, int8_t* k, float* ks, int8_t* v,
            float* vs, const int* __restrict__ pos, const int* __restrict__ cache_rows,
            float* __restrict__ out, int KVH, int G, int T, int S, int span, float scale,
            float softcap, int window, int fast, int insert, int kt) {
  constexpr int PER = HD / 32;   // p.v columns per lane
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, rank = blockIdx.x;
  const int R = G * T, ktp = up4(kt);
  const AttnSmem L(R, HD, RB, kt);
  float* q_s = smem + L.q;
  float* sc = smem + L.sc;
  float* red = smem + L.red;
  float* outp = smem + L.outp;
  float* part = smem + L.part;
  float* m_s = smem + L.m;
  float* l_s = smem + L.l;
  float* xm = smem + L.xm;
  float* xl = smem + L.xl;
  int8_t* kn_s = reinterpret_cast<int8_t*>(smem + L.kv);
  int8_t* vn_s = kn_s + HD;
  float* new_scale = smem + L.kv + HD / 2;   // [0] K's, [1] V's
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = static_cast<size_t>(blockIdx.z) * KVH + blockIdx.y;
  const size_t cbh = static_cast<size_t>(cache_rows ? cache_rows[blockIdx.z] : blockIdx.z) * KVH +
                     blockIdx.y;
  const int p0 = pos[blockIdx.z];
  int8_t* kc = k + cbh * S * HD;
  int8_t* vc = v + cbh * S * HD;
  float* ksc = ks + cbh * S;
  float* vsc = vs + cbh * S;

  // the cluster's barrier and its shared memory; a lone CTA its own
  auto csync = [&] {
    if (C > 1) cg::this_cluster().sync();
    else __syncthreads();
  };
  auto at = [&](float* p, int r) -> const float* {
    return C > 1 ? cg::this_cluster().map_shared_rank(p, r) : p;
  };

  const int pnew = insert && p0 >= 0 && p0 < S ? p0 : -1;
  if (pnew >= 0) {
    const size_t row = static_cast<size_t>(pnew) * HD;
    if (warp == 0)
      quantize_row<HD>(kn + bh * HD, kn_s, new_scale, lane, rank == 0 ? kc + row : nullptr,
                       ksc + pnew);
    if (warp == 1)
      quantize_row<HD>(vn + bh * HD, vn_s, new_scale + 1, lane, rank == 0 ? vc + row : nullptr,
                       vsc + pnew);
  }
  const float* qb = q + bh * R * HD;
  for (int e = threadIdx.x; e < R * HD; e += NTHREADS) {
    q_s[e] = fast ? bf16_round(qb[e]) : qb[e];
    outp[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += NTHREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();
  // the inserted row from shared memory, every other row from the cache
  auto krow = [&](int key) { return key == pnew ? kn_s : kc + static_cast<size_t>(key) * HD; };
  auto vrow = [&](int key) { return key == pnew ? vn_s : vc + static_cast<size_t>(key) * HD; };
  auto kscale = [&](int key) { return key == pnew ? new_scale[0] : ksc[key]; };
  auto vscale = [&](int key) { return key == pnew ? new_scale[1] : vsc[key]; };

  // this CTA's keys: a contiguous range of the live prefix
  const int live = p0 >= 0 && p0 + T < span ? p0 + T : span;
  const int per = (live + C - 1) / C;
  const int c0 = rank * per, nk = max(0, min(live, c0 + per) - c0);
  const int ntile = (nk + kt - 1) / kt;

  // scores of keys c0 + j0 .. + nj into sc[r][j]: items of (32 keys, a
  // slice of at most RB rows), sliced finer while warps would idle
  auto score = [&](int j0, int nj) {
    const int groups = (nj + 31) >> 5;
    int slices = (R + RB - 1) / RB;
    if (groups * slices < WARPS) slices = max(slices, min(R, WARPS / groups));
    const int rps = (R + slices - 1) / slices;
    for (int it = warp; it < groups * slices; it += WARPS) {
      const int r0 = (it % slices) * rps, nr = min(rps, R - r0);
      const int j = 32 * (it / slices) + lane;
      if (nr <= 0) continue;
      const int key = c0 + j0 + min(j, nj - 1);
      const int8_t* kr = krow(key);
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + 16 * c);
        const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
        float kf[16];
#pragma unroll
        for (int b = 0; b < 16; ++b) kf[b] = i8f(wd[b >> 2], b & 3);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < nr) {
            const float4* qv = reinterpret_cast<const float4*>(q_s + (r0 + r) * HD + 16 * c);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 qq = qv[u];
              acc[r] = fmaf(qq.x, kf[4 * u], acc[r]);
              acc[r] = fmaf(qq.y, kf[4 * u + 1], acc[r]);
              acc[r] = fmaf(qq.z, kf[4 * u + 2], acc[r]);
              acc[r] = fmaf(qq.w, kf[4 * u + 3], acc[r]);
            }
          }
        }
      }
      if (j < nj) {
        const float ksv = kscale(key) * scale;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < nr) {
            float s = acc[r] * ksv;
            if (softcap != 0.f) s = softcap * tanhf(s * (1.0f / softcap));
            const int lim = p0 + (r0 + r) % T;
            const bool ok = key <= lim && (window == 0 || key > lim - window);
            sc[(r0 + r) * ktp + j] = ok ? s : NEG_INF;
          }
        }
      }
    }
  };

  // per-row reductions over sc[r][0..nj): wpr warps per row, each a
  // lane-strided partial, combined in warp order into acc_s[r]
  const int wpr = max(1, WARPS / R), rstep = WARPS / wpr;
  auto rows = [&](int nj, float* acc_s, bool is_max) {
    const int rg = warp / wpr, sub = warp % wpr;
    for (int r = rg; r < R; r += rstep) {
      float a = is_max ? -INFINITY : 0.f;
      for (int j = sub * 32 + lane; j < nj; j += wpr * 32) {
        float* sp = sc + r * ktp + j;
        if (is_max) {
          a = fmaxf(a, *sp);
        } else {
          const float e = expf(*sp - m_s[r]);
          *sp = e;
          a += e;
        }
      }
      a = is_max ? warp_max(a) : warp_sum(a);
      if (lane == 0) part[sub * R + r] = a;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += NTHREADS) {
      float a = acc_s[r];
      for (int u = 0; u < wpr; ++u) a = is_max ? fmaxf(a, part[u * R + r]) : a + part[u * R + r];
      acc_s[r] = a;
    }
    __syncthreads();
  };
  // the cluster's value of each row from every CTA's (in rank order)
  auto merge = [&](float* acc_s, float* x_s, bool is_max) {
    for (int r = threadIdx.x; r < R; r += NTHREADS) x_s[r] = acc_s[r];
    csync();
    for (int r = threadIdx.x; r < R; r += NTHREADS) {
      float a = is_max ? -INFINITY : 0.f;
      for (int c = 0; c < C; ++c) a = is_max ? fmaxf(a, at(x_s, c)[r]) : a + at(x_s, c)[r];
      acc_s[r] = a;
    }
    __syncthreads();
  };

  for (int ti = 0; ti < ntile; ++ti) {   // 1. the global max m
    const int j0 = ti * kt, nj = min(kt, nk - j0);
    score(j0, nj);
    __syncthreads();
    rows(nj, m_s, true);
  }
  merge(m_s, xm, true);
  for (int ti = 0; ti < ntile; ++ti) {   // 2. e = exp(s - m) and the global sum l
    const int j0 = ti * kt, nj = min(kt, nk - j0);
    if (ntile > 1) {
      score(j0, nj);
      __syncthreads();
    }
    rows(nj, l_s, false);
  }
  merge(l_s, xl, false);
  for (int ti = 0; ti < ntile; ++ti) {   // 3. pv = round(e / l * v_scale), p . v
    const int j0 = ti * kt, nj = min(kt, nk - j0);
    if (ntile > 1) {
      score(j0, nj);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < R * nj; i += NTHREADS) {
      const int r = i / nj, j = i % nj;
      float* sp = sc + r * ktp + j;
      const float e = ntile > 1 ? expf(*sp - m_s[r]) : *sp;
      const float pv = (e / l_s[r]) * vscale(c0 + j0 + j);
      *sp = fast ? bf16_round(pv) : pv;
    }
    __syncthreads();
    const int kw = (nj + WARPS - 1) / WARPS, jb = warp * kw, je = min(nj, jb + kw);
    for (int rp = 0; rp < R; rp += RB) {
      const int nr = min(RB, R - rp);
      float acc[RB][PER];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int e = 0; e < PER; ++e) acc[r][e] = 0.f;
      for (int j = jb; j < je; j += PV_AHEAD) {
        uint32_t w[PV_AHEAD];   // this lane's columns of PV_AHEAD V rows, loaded together
#pragma unroll
        for (int u = 0; u < PV_AHEAD; ++u) {
          const int8_t* vr = vrow(c0 + j0 + min(j + u, je - 1)) + lane * PER;
          w[u] = PER == 4 ? *reinterpret_cast<const uint32_t*>(vr)
                          : *reinterpret_cast<const uint16_t*>(vr);
        }
#pragma unroll
        for (int u = 0; u < PV_AHEAD; ++u) {
          if (j + u < je) {
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              if (r < nr) {
                const float pj = sc[(rp + r) * ktp + j + u];
#pragma unroll
                for (int e = 0; e < PER; ++e) acc[r][e] = fmaf(pj, i8f(w[u], e), acc[r][e]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nr)
#pragma unroll
          for (int e = 0; e < PER; ++e) red[(warp * RB + r) * HD + lane * PER + e] = acc[r][e];
      __syncthreads();
      for (int i = threadIdx.x; i < nr * HD; i += NTHREADS) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) a += red[w * RB * HD + i];
        outp[rp * HD + i] += a;
      }
      __syncthreads();
    }
  }
  // 4. out = the CTAs' partials in rank order; each CTA writes a slice
  csync();
  float* o = out + bh * R * HD;
  for (int i = rank * NTHREADS + threadIdx.x; i < R * HD; i += C * NTHREADS) {
    float a = 0.f;
    for (int c = 0; c < C; ++c) a += at(outp, c)[i];
    o[i] = a;
  }
  if (C > 1) cg::this_cluster().sync();   // no CTA leaves while its partial is read
}

template <int HD, int RB>
int launch_attn(const void* q, const void* kn, const void* vn, void* k, void* ks, void* v,
                void* vs, const void* pos, const void* rows, void* out, int B, int KVH, int G,
                int T, int S, int span, float scale, float softcap, int window, int fast, int insert,
                int clusters, int kt, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(AttnSmem(G * T, HD, RB, kt).total) * sizeof(float);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attn_kernel<HD, RB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, KVH, B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = clusters > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(q), static_cast<const float*>(kn),
      static_cast<const float*>(vn), static_cast<int8_t*>(k), static_cast<float*>(ks),
      static_cast<int8_t*>(v), static_cast<float*>(vs), static_cast<const int*>(pos),
      static_cast<const int*>(rows), static_cast<float*>(out), KVH, G, T, S, span, scale,
      softcap, window, fast, insert, kt));
}

}  // namespace

// kn, vn (B, KVH, T, HD) f32; k, v (Bc, KVH, S, HD) int8; ks, vs (Bc, KVH,
// S) f32; pos (B,) int32; rows (B,) int32, the cache row of each sequence
// (NULL: sequence b writes row b).
extern "C" int kv_cache_insert_launch(const void* kn, const void* vn, void* k,
                                      void* ks, void* v, void* vs,
                                      const void* pos, const void* rows, int B,
                                      int KVH, int T, int S, int HD,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * KVH);
#define K3_ARGS static_cast<const float*>(kn), static_cast<const float*>(vn), \
    static_cast<int8_t*>(k), static_cast<float*>(ks), static_cast<int8_t*>(v), \
    static_cast<float*>(vs), static_cast<const int*>(pos), static_cast<const int*>(rows), \
    KVH, T, S
  if (HD == 64) kv_insert_kernel<64><<<grid, 128, 0, st>>>(K3_ARGS);
  else if (HD == 128) kv_insert_kernel<128><<<grid, 128, 0, st>>>(K3_ARGS);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef K3_ARGS
  return static_cast<int>(cudaGetLastError());
}

// q (B, KVH*G, T, HD) f32; out likewise; the cache and rows as K3's;
// flags bit 0 = fast (bf16 operands), bit 1 = insert (T == 1, kn/vn (B,
// KVH, 1, HD) f32); clusters (1-8) CTAs per (batch, KV head) and a key
// tile of tile_keys, as ops/attention.py:k4_plan picks them.
extern "C" int decode_attention_launch(const void* q, const void* kn,
                                       const void* vn, void* k, void* ks,
                                       void* v, void* vs, const void* pos,
                                       const void* rows, void* out, int B,
                                       int KVH, int G, int T,
                                       int S, int span, int HD, float scale,
                                       float softcap, int window, int flags,
                                       int clusters, int tile_keys,
                                       void* stream) {
  const int insert = (flags >> 1) & 1;
  if (span <= 0 || span > S || (insert && T != 1) || clusters < 1 || clusters > 8 ||
      tile_keys < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K4_ARGS q, kn, vn, k, ks, v, vs, pos, rows, out, B, KVH, G, T, S, span, scale, softcap, \
    window, flags & 1, insert, clusters, tile_keys, st
  const bool one = G * T == 1;
  if (HD == 64) return one ? launch_attn<64, 1>(K4_ARGS) : launch_attn<64, 8>(K4_ARGS);
  if (HD == 128) return one ? launch_attn<128, 1>(K4_ARGS) : launch_attn<128, 8>(K4_ARGS);
#undef K4_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
