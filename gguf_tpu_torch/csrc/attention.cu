// K3: INT8 KV-cache insert.  K4: GQA decode attention over the INT8 cache,
// optionally with the t = 1 insert fused in.  K9: flash-decoding (t = 1)
// over 256-row tiles of the cache, for long spans.
//
// K3 replaces gguf_tpu/ops/attention.py:_insert_kernel (kv_cache_insert).
// One block per (batch, kv-head); one warp quantizes one (token, head) row:
// scale = absmax * f32(1/127) (the product XLA compiles the reference's
// absmax / 127 into), codes = clip(rintf(x / scale), +-127) with an IEEE
// division and round-half-to-even. This file is built without
// --use_fast_math, so the codes are bit-identical to the reference. Rows
// outside [0, S) are skipped: inactive engine slots step at pos = max_seq.
//
// K4 replaces gguf_tpu/ops/attention.py:_attn_kernel (decode_attention)
// and :_fused_attn_kernel (decode_attention_update at t = 1). One block per
// (batch, kv-head) serves its g = H/KVH query heads x t tokens and reads
// only the first `span` cache rows. With the insert flag (t = 1) warps 0
// and 1 first quantize and write this head's new K and V row; after the
// block barrier every warp attends over the updated rows, so one launch
// does what the fused TPU kernel does and no block waits on another.
// Each warp owns query rows; softmax is two-pass in f32: pass 1 keeps a
// per-lane online (max, sum) over its keys and merges them across the
// warp, pass 2 recomputes each score, forms p = exp(s - m) / sum exactly
// as the reference does, rounds p * v_scale to the operand type, and
// accumulates p * v with lanes spread over the head dimension.
//
// What bounds it on an H100: the int8 K/V bytes of the span (2 * span * hd
// per head row pair) at decode, plus the recomputed q.k dot products
// (pass 1 and pass 2 both score every key). At TinyLlama shapes the grid
// is only B * KVH = 64 blocks, so the launch and per-block latency matter
// more than bandwidth; K9 below is the split-span form.
//
// K9 replaces gguf_tpu/ops/attention.py:_attn_tiled_kernel
// (decode_attention_tiled): flash-decoding at t = 1 over 256-row tiles of
// the cache. The TPU kernel walks the tiles in order on one core with an
// online softmax; here the tiles run in parallel as a split-span grid,
// one block per (tile, kv-head, batch), in three launches:
//   1. scores: thread j of the block scores key row j against the block's
//      G query rows, (q . k) * (k_scale / sqrt(hd)), softcap, causal and
//      window mask; it writes the f32 scores and each row's tile max.
//   2. p . v: each block takes the running max m_t of its rows through
//      its tile (the max of the tile maxes 0..t, what the reference's
//      online softmax holds at tile t), p = exp(s - m_t), l_t = sum p,
//      rounds p * v_scale to bf16 under "fast" and sums it times v.
//      Rounding relative to m_t, not the tile's own max, keeps the bf16
//      rounding points of the reference: a split grid that rounds against
//      its own max differs from it by ~2e-3 of max|out|.
//   3. combine: out = sum_t exp(m_t - M) acc_t / sum_t exp(m_t - M) l_t.
// Tiles with no live column (wholly past pos, or before the window) are
// skipped by all three: the reference gives them zero weight (a fully
// masked leading tile is wiped by alpha = 0 at the first live one). A row
// with no live column at all comes out 0, never NaN.
// What bounds it: the live int8 K/V rows and their scales (2 * hd + 8 bytes
// per row and kv-head), read once; the f32 scores (4 * G bytes per row)
// and the per-tile partials are the split's extra traffic, a few percent
// of that at G <= 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -3.402823466e38f;  // finfo(float32).min, as the reference
constexpr float RECIP_127 = 1.0f / 127.0f;
constexpr int NTHREADS = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// signed byte b (0..3) of a 32-bit word
__device__ __forceinline__ float sbyte(unsigned w, int b) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * b)) >> 24);
}

// One warp quantizes one HD-element row into the cache.
template <int HD>
__device__ __forceinline__ void quantize_row(const float* src, int8_t* dst,
                                             float* dst_scale, int lane) {
  constexpr int PER = HD / 32;
  float v[PER];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = src[lane + 32 * i];
    amax = fmaxf(amax, fabsf(v[i]));
  }
  amax = warp_max(amax);
  const float scale = amax * RECIP_127;
  const float safe = scale == 0.f ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float c = fminf(fmaxf(rintf(v[i] / safe), -127.f), 127.f);
    dst[lane + 32 * i] = static_cast<int8_t>(c);
  }
  if (lane == 0) *dst_scale = scale;
}

template <int HD>
__global__ void __launch_bounds__(128)
kv_insert_kernel(const float* __restrict__ kn, const float* __restrict__ vn,
                 int8_t* k, float* ks, int8_t* v, float* vs,
                 const int* __restrict__ pos, int KVH, int T, int S) {
  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = pos[bh / KVH];
  for (int item = warp; item < 2 * T; item += blockDim.x >> 5) {
    const bool is_v = item >= T;
    const int tj = item % T;
    const int row = p0 + tj;
    if (row < 0 || row >= S) continue;
    const size_t src = (static_cast<size_t>(bh) * T + tj) * HD;
    const size_t dst = static_cast<size_t>(bh) * S + row;
    if (is_v) quantize_row<HD>(vn + src, v + dst * HD, vs + dst, lane);
    else quantize_row<HD>(kn + src, k + dst * HD, ks + dst, lane);
  }
}

// Cache pointers are deliberately neither const nor __restrict__: with the
// insert flag this block writes a row it then reads, so those loads must
// not go through the non-coherent read-only path.
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
attn_kernel(const float* __restrict__ q, const float* __restrict__ kn,
            const float* __restrict__ vn, int8_t* k, float* ks, int8_t* v,
            float* vs, const int* __restrict__ pos, float* __restrict__ out,
            int KVH, int G, int T, int S, int span, float scale,
            float softcap, int window, int fast, int insert) {
  constexpr int PER = HD / 32;
  extern __shared__ float q_s[];  // [G*T][HD]
  const int bh = blockIdx.y * KVH + blockIdx.x;
  const int R = G * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = pos[blockIdx.y];
  int8_t* kc = k + static_cast<size_t>(bh) * S * HD;
  int8_t* vc = v + static_cast<size_t>(bh) * S * HD;
  float* ksc = ks + static_cast<size_t>(bh) * S;
  float* vsc = vs + static_cast<size_t>(bh) * S;

  if (insert && p0 >= 0 && p0 < S) {
    if (warp == 0) quantize_row<HD>(kn + static_cast<size_t>(bh) * HD, kc + static_cast<size_t>(p0) * HD, ksc + p0, lane);
    if (warp == 1) quantize_row<HD>(vn + static_cast<size_t>(bh) * HD, vc + static_cast<size_t>(p0) * HD, vsc + p0, lane);
  }
  const float* qb = q + static_cast<size_t>(bh) * R * HD;
  for (int e = threadIdx.x; e < R * HD; e += NTHREADS) q_s[e] = fast ? bf16_round(qb[e]) : qb[e];
  __syncthreads();

  for (int r = warp; r < R; r += NTHREADS / 32) {
    const float* qr = q_s + r * HD;
    const int lim = p0 + r % T;  // token r % t sits at pos + r % t
    auto score = [&](int j) -> float {
      const int8_t* kr = kc + static_cast<size_t>(j) * HD;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
        const unsigned wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int b = 0; b < 16; ++b) acc = fmaf(qr[c + b], sbyte(wd[b >> 2], b & 3), acc);
      }
      float s = acc * (ksc[j] * scale);
      if (softcap != 0.f) s = softcap * tanhf(s * (1.0f / softcap));
      const bool live = j <= lim && (window == 0 || j > lim - window);
      return live ? s : NEG_INF;
    };

    float m_l = -INFINITY, l_l = 0.f;
    for (int j = lane; j < span; j += 32) {
      const float s = score(j);
      if (s > m_l) {
        l_l = l_l * expf(m_l - s) + 1.f;
        m_l = s;
      } else {
        l_l += expf(s - m_l);
      }
    }
    const float m = warp_max(m_l);
    const float l = warp_sum(l_l * expf(m_l - m));

    float acc[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < span; j0 += 32) {
      const int j = j0 + lane;
      float pv = 0.f;
      if (j < span) {
        pv = (expf(score(j) - m) / l) * vsc[j];
        if (fast) pv = bf16_round(pv);
      }
      const int nj = min(32, span - j0);
      for (int i = 0; i < nj; ++i) {
        const float pj = __shfl_sync(0xffffffffu, pv, i);
        const int8_t* vr = vc + static_cast<size_t>(j0 + i) * HD + lane * PER;
#pragma unroll
        for (int e = 0; e < PER; ++e) acc[e] = fmaf(pj, static_cast<float>(vr[e]), acc[e]);
      }
    }
    float* o = out + (static_cast<size_t>(bh) * R + r) * HD + lane * PER;
#pragma unroll
    for (int e = 0; e < PER; ++e) o[e] = acc[e];
  }
}

// ------------------------------------------------------ K9: tiled decode ---

constexpr int TILE = 256;             // cache rows per tile (the reference's ts)
constexpr int TILE_WARPS = TILE / 32;

// Does tile [t0, t0 + TILE) hold a column c with c <= p0 and, with a
// window, c > p0 - window?
__device__ __forceinline__ bool tile_live(int t0, int p0, int window) {
  return t0 <= p0 && (window == 0 || t0 + TILE - 1 > p0 - window);
}

// Grid (span / TILE, KVH, B), TILE threads. smem: q [G][HD], wmax [warps][G].
template <int HD>
__global__ void __launch_bounds__(TILE)
tiled_scores_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                    const float* __restrict__ ks, const int* __restrict__ pos,
                    float* __restrict__ sc, float* __restrict__ tmax, int KVH,
                    int G, int S, int span, float scale, float softcap,
                    int window, int fast) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const size_t bh = static_cast<size_t>(blockIdx.z) * KVH + blockIdx.y;
  const int p0 = pos[blockIdx.z];
  const int t0 = tile * TILE;
  float* tm = tmax + (bh * ntiles + tile) * G;
  if (!tile_live(t0, p0, window)) {
    for (int g = threadIdx.x; g < G; g += TILE) tm[g] = NEG_INF;
    return;
  }
  float* q_s = smem;
  float* wmax = smem + G * HD;
  const float* qb = q + bh * G * HD;
  for (int e = threadIdx.x; e < G * HD; e += TILE) q_s[e] = fast ? bf16_round(qb[e]) : qb[e];

  const int j = t0 + threadIdx.x;
  const uint4* kp = reinterpret_cast<const uint4*>(k + (bh * S + j) * HD);
  uint4 kr[HD / 16];
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) kr[c] = kp[c];
  const float kscale = ks[bh * S + j] * scale;
  const bool live = j <= p0 && (window == 0 || j > p0 - window);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* srow = sc + bh * G * span + j;
  for (int g = 0; g < G; ++g) {
    const float4* qg = reinterpret_cast<const float4*>(q_s + g * HD);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const unsigned wd[4] = {kr[c].x, kr[c].y, kr[c].z, kr[c].w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float4 qv = qg[c * 4 + w];
        acc = fmaf(qv.x, sbyte(wd[w], 0), acc);
        acc = fmaf(qv.y, sbyte(wd[w], 1), acc);
        acc = fmaf(qv.z, sbyte(wd[w], 2), acc);
        acc = fmaf(qv.w, sbyte(wd[w], 3), acc);
      }
    }
    float s = acc * kscale;
    if (softcap != 0.f) s = softcap * tanhf(s * (1.0f / softcap));
    s = live ? s : NEG_INF;
    srow[static_cast<size_t>(g) * span] = s;
    const float m = warp_max(s);
    if (lane == 0) wmax[warp * G + g] = m;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += TILE) {
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < TILE_WARPS; ++w) m = fmaxf(m, wmax[w * G + g]);
    tm[g] = m;
  }
}

// Grid (span / TILE, KVH, B), TILE threads; query rows in chunks of GC.
// smem: m [G], pv [GC][TILE], red [warps][GC][HD], lsum [warps][GC].
template <int HD, int GC>
__global__ void __launch_bounds__(TILE)
tiled_pv_kernel(const int8_t* __restrict__ v, const float* __restrict__ vs,
                const int* __restrict__ pos, const float* __restrict__ sc,
                const float* __restrict__ tmax, float* __restrict__ part_acc,
                float* __restrict__ part_ml, int KVH, int G, int S, int span,
                int window, int fast) {
  constexpr int PER = HD / 32;        // head dims per lane
  extern __shared__ float smem[];
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const size_t bh = static_cast<size_t>(blockIdx.z) * KVH + blockIdx.y;
  const int p0 = pos[blockIdx.z];
  const int t0 = tile * TILE;
  if (!tile_live(t0, p0, window)) return;    // the combine skips this tile
  float* m_s = smem;
  float* pv_s = m_s + G;
  float* red = pv_s + GC * TILE;
  float* lsum = red + TILE_WARPS * GC * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* tm = tmax + bh * ntiles * G;
  for (int g = threadIdx.x; g < G; g += TILE) {
    float m = NEG_INF;
    for (int u = 0; u <= tile; ++u) m = fmaxf(m, tm[u * G + g]);
    m_s[g] = m;
  }
  const int j = t0 + threadIdx.x;
  const float vscale = vs[bh * S + j];
  const float* srow = sc + bh * G * span + j;
  const int8_t* vb = v + (bh * S + t0 + warp * 32) * HD + lane * PER;
  const size_t pbase = (bh * ntiles + tile) * G;

  for (int g0 = 0; g0 < G; g0 += GC) {
    const int gc = min(GC, G - g0);
    __syncthreads();                 // m_s written; the last chunk's smem read
    for (int g = 0; g < gc; ++g) {
      const float p = expf(srow[static_cast<size_t>(g0 + g) * span] - m_s[g0 + g]);
      float pv = p * vscale;
      if (fast) pv = bf16_round(pv);
      pv_s[g * TILE + threadIdx.x] = pv;
      const float l = warp_sum(p);
      if (lane == 0) lsum[warp * GC + g] = l;
    }
    __syncthreads();
    // warp w sums rows 32w..32w+31 of the tile; lane owns PER head dims
    float acc[GC][PER];
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < PER; ++e) acc[g][e] = 0.f;
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      float vv[PER];
      if constexpr (PER == 4) {
        const unsigned w = *reinterpret_cast<const unsigned*>(vb + r * HD);
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[e] = sbyte(w, e);
      } else {
        const unsigned w = *reinterpret_cast<const unsigned short*>(vb + r * HD);
#pragma unroll
        for (int e = 0; e < PER; ++e) vv[e] = sbyte(w, e);
      }
      const float* pr = pv_s + warp * 32 + r;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g < gc) {
          const float pj = pr[g * TILE];
#pragma unroll
          for (int e = 0; e < PER; ++e) acc[g][e] = fmaf(pj, vv[e], acc[g][e]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g)
      if (g < gc)
#pragma unroll
        for (int e = 0; e < PER; ++e) red[(warp * GC + g) * HD + lane * PER + e] = acc[g][e];
    __syncthreads();
    for (int e = threadIdx.x; e < gc * HD; e += TILE) {
      const int g = e / HD, d = e % HD;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < TILE_WARPS; ++w) s += red[(w * GC + g) * HD + d];
      part_acc[(pbase + g0 + g) * HD + d] = s;
    }
    for (int g = threadIdx.x; g < gc; g += TILE) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < TILE_WARPS; ++w) l += lsum[w * GC + g];
      part_ml[(pbase + g0 + g) * 2] = m_s[g0 + g];
      part_ml[(pbase + g0 + g) * 2 + 1] = l;
    }
  }
}

// Grid (KVH, B); out (B, KVH, G, HD).
template <int HD>
__global__ void tiled_combine_kernel(const int* __restrict__ pos,
                                     const float* __restrict__ part_acc,
                                     const float* __restrict__ part_ml,
                                     float* __restrict__ out, int KVH, int G,
                                     int ntiles, int window) {
  const size_t bh = static_cast<size_t>(blockIdx.y) * KVH + blockIdx.x;
  const int p0 = pos[blockIdx.y];
  for (int e = threadIdx.x; e < G * HD; e += blockDim.x) {
    const int g = e / HD, d = e % HD;
    float M = NEG_INF;
    for (int t = 0; t < ntiles; ++t)
      if (tile_live(t * TILE, p0, window)) M = fmaxf(M, part_ml[((bh * ntiles + t) * G + g) * 2]);
    float num = 0.f, den = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      if (!tile_live(t * TILE, p0, window)) continue;
      const size_t i = (bh * ntiles + t) * G + g;
      const float w = expf(part_ml[i * 2] - M);
      num = fmaf(w, part_acc[i * HD + d], num);
      den = fmaf(w, part_ml[i * 2 + 1], den);
    }
    out[(bh * G + g) * HD + d] = den > 0.f ? num / den : 0.f;
  }
}

template <typename Kernel>
int launch_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  return 0;
}

template <int HD>
int tiled_attention(const float* q, const int8_t* k, const float* ks,
                    const int8_t* v, const float* vs, const int* pos,
                    float* ws, float* out, int B, int KVH, int G, int S,
                    int span, float scale, float softcap, int window, int fast,
                    cudaStream_t st) {
  const int ntiles = span / TILE;
  float* sc = ws;                                                  // [B][KVH][G][span]
  float* tmax = sc + static_cast<size_t>(B) * KVH * G * span;      // [B][KVH][nt][G]
  float* part_ml = tmax + static_cast<size_t>(B) * KVH * ntiles * G;  // [..][G][2]
  float* part_acc = part_ml + static_cast<size_t>(B) * KVH * ntiles * G * 2;  // [..][G][HD]
  const dim3 grid(ntiles, KVH, B);

  // past 48 KB (G * HD * 4 near the wrapper's 48 KiB limit) only as
  // dynamic shared memory after the opt-in
  const size_t smem_a = (static_cast<size_t>(G) * HD + TILE_WARPS * G) * sizeof(float);
  int err = launch_smem(tiled_scores_kernel<HD>, smem_a);
  if (err) return err;
  tiled_scores_kernel<HD><<<grid, TILE, smem_a, st>>>(
      q, k, ks, pos, sc, tmax, KVH, G, S, span, scale, softcap, window, fast);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  // one query row per chunk for MHA (G = 1), eight otherwise
  const int gc = G == 1 ? 1 : 8;
  const size_t smem_b = (G + static_cast<size_t>(gc) * TILE +
                         TILE_WARPS * gc * HD + TILE_WARPS * gc) * sizeof(float);
  // (under 48 KB for every G the wrapper takes)
  if (gc == 1) {
    tiled_pv_kernel<HD, 1><<<grid, TILE, smem_b, st>>>(
        v, vs, pos, sc, tmax, part_acc, part_ml, KVH, G, S, span, window, fast);
  } else {
    tiled_pv_kernel<HD, 8><<<grid, TILE, smem_b, st>>>(
        v, vs, pos, sc, tmax, part_acc, part_ml, KVH, G, S, span, window, fast);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int threads = G * HD <= 128 ? 128 : 256;
  tiled_combine_kernel<HD><<<dim3(KVH, B), threads, 0, st>>>(
      pos, part_acc, part_ml, out, KVH, G, ntiles, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kn, vn (B, KVH, T, HD) f32; k, v (B, KVH, S, HD) int8; ks, vs (B, KVH, S)
// f32; pos (B,) int32.
extern "C" int kv_cache_insert_launch(const void* kn, const void* vn, void* k,
                                      void* ks, void* v, void* vs,
                                      const void* pos, int B, int KVH, int T,
                                      int S, int HD, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * KVH);
#define K3_ARGS static_cast<const float*>(kn), static_cast<const float*>(vn), \
    static_cast<int8_t*>(k), static_cast<float*>(ks), static_cast<int8_t*>(v), \
    static_cast<float*>(vs), static_cast<const int*>(pos), KVH, T, S
  if (HD == 64) kv_insert_kernel<64><<<grid, 128, 0, st>>>(K3_ARGS);
  else if (HD == 128) kv_insert_kernel<128><<<grid, 128, 0, st>>>(K3_ARGS);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef K3_ARGS
  return static_cast<int>(cudaGetLastError());
}

// q (B, KVH*G, T, HD) f32; out likewise; flags bit 0 = fast (bf16
// operands), bit 1 = insert (T == 1, kn/vn (B, KVH, 1, HD) f32).
extern "C" int decode_attention_launch(const void* q, const void* kn,
                                       const void* vn, void* k, void* ks,
                                       void* v, void* vs, const void* pos,
                                       void* out, int B, int KVH, int G, int T,
                                       int S, int span, int HD, float scale,
                                       float softcap, int window, int flags,
                                       void* stream) {
  const int insert = (flags >> 1) & 1;
  if (span <= 0 || span > S || (insert && T != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(KVH, B);
  const size_t smem = static_cast<size_t>(G) * T * HD * sizeof(float);
#define K4_ARGS static_cast<const float*>(q), static_cast<const float*>(kn), \
    static_cast<const float*>(vn), static_cast<int8_t*>(k), static_cast<float*>(ks), \
    static_cast<int8_t*>(v), static_cast<float*>(vs), static_cast<const int*>(pos), \
    static_cast<float*>(out), KVH, G, T, S, span, scale, softcap, window, flags & 1, insert
  if (HD == 64) attn_kernel<64><<<grid, NTHREADS, smem, st>>>(K4_ARGS);
  else if (HD == 128) attn_kernel<128><<<grid, NTHREADS, smem, st>>>(K4_ARGS);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef K4_ARGS
  return static_cast<int>(cudaGetLastError());
}

// q (B, KVH*G, 1, HD) f32; k, v (B, KVH, S, HD) int8; ks, vs (B, KVH, S)
// f32; pos (B,) int32; out (B, KVH*G, 1, HD) f32; ws holds
// B*KVH*G * (span + (span/256) * (3 + HD)) floats: the scores, the tile
// maxes, the (m, l) and the acc partials. span is a multiple of 256, <= S.
extern "C" int decode_attention_tiled_launch(const void* q, const void* k,
                                             const void* ks, const void* v,
                                             const void* vs, const void* pos,
                                             void* ws, void* out, int B,
                                             int KVH, int G, int S, int span,
                                             int HD, float scale, float softcap,
                                             int window, int fast,
                                             void* stream) {
  if (span <= 0 || span > S || span % TILE) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K9_ARGS static_cast<const float*>(q), static_cast<const int8_t*>(k), \
    static_cast<const float*>(ks), static_cast<const int8_t*>(v), \
    static_cast<const float*>(vs), static_cast<const int*>(pos), \
    static_cast<float*>(ws), static_cast<float*>(out), B, KVH, G, S, span, scale, \
    softcap, window, fast, st
  if (HD == 64) return tiled_attention<64>(K9_ARGS);
  if (HD == 128) return tiled_attention<128>(K9_ARGS);
#undef K9_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
