// K9: single-token GQA decode attention over the INT8 KV cache for spans
// past the single-tile envelope (flash-decoding), in one launch per call,
// optionally with the t = 1 insert (K3's work) fused in.
//
// K9 replaces gguf_tpu/ops/attention.py:_attn_tiled_kernel
// (decode_attention_tiled); with the insert flag it also does the work of
// :_insert_kernel (kv_cache_insert), which the route past the envelope ran
// as a launch of its own just before. It computes what the reference
// computes, at its rounding points: s = (q.k) * (k_scale / sqrt(hd)) with
// q bf16 under "fast" (f32 under "high") and the int8 codes exact, softcap,
// then the causal and window mask; m_t, the running max of the row through
// 256-row tile t (the reference's tile, walked in order with an online
// softmax); p = exp(s - m_t), l = sum p, pv = bf16(p * v_scale) under
// "fast" (f32 under "high"), acc = sum pv . v in f32, out = acc / l. Only
// the order of the f32 sums differs. A row with no live column gives 0.
//
// The grid is a thread-block cluster of C CTAs (ops/attention.py:k9_plan)
// per (slot, KV head): grid (C, KVH, B). The live rows of a slot, [L0, L1)
// with L1 = min(pos + 1, span) and L0 = pos - window + 1 under a window,
// are cut into C contiguous slices, one per CTA. Masked rows are never
// read: the reference gives them p = 0 (a fully masked leading tile is
// wiped by alpha = 0 at the first live one), so the result is the same.
//   1. Each CTA streams its slice's K rows and then its V rows (one
//      contiguous run of bytes each in the (B, KVH, S, hd) cache) through
//      a ring of NS stages of CH rows in shared memory, filled by 1-D bulk
//      copies (cp.async.bulk, completion on the stage's mbarrier) that one
//      thread issues NS stages ahead; V's first copies are in flight while
//      the last K rows are scored. The slice's scales are read once into
//      shared memory at the start.
//   2. scores: HD / 16 threads take a K row, 16 codes each, against the
//      query rows (held in registers at G = 1; GB at a time otherwise,
//      their FMA and shuffle chains interleaved), summed by shuffles. The
//      scores of the slice stay in shared memory.
//   3. m_t: each CTA takes the max of its rows per tile and writes its
//      slice's max and the max of its first tile into every CTA's shared
//      memory (distributed shared memory: remote stores, which do not
//      wait); after one barrier.cluster each CTA forms m_t for its tiles
//      from its own prefix, the whole max of every earlier rank and the
//      first-tile max of any later rank that starts in the same tile (only
//      such a rank can hold rows of a tile this CTA touches), and the
//      global max M.
//   4. p . v: p = exp(s - m_t), pv = round(p * v_scale); each row's p and
//      pv carry its tile's weight exp(m_t - M), so the per-tile partials
//      come out weighted as the combine of the split form weighted them;
//      a warp takes every WARPS-th row of a stage, a lane hd / 32 columns.
//      The warps' partials are added in warp order.
//   5. out = (sum of the CTAs' acc) / (sum of their l), in rank order:
//      each CTA owns a slice of the outputs, every CTA stores its partial
//      of that slice (and its l) into the owner's shared memory, and after
//      one more barrier.cluster each owner sums and writes its slice. No
//      CTA reads another's shared memory, so none waits on a remote load.
// The grid's slot index is a rank by live rows, longest first: blocks
// start in index order, so the longest clusters start first and the
// short ones fill in behind them (each CTA ranks the B positions itself).
// The first bulk copies are issued right after the mbarriers are set up,
// before the query and the scales are read; the cluster barrier that
// makes sure every CTA has started before the first remote store is split
// (arrive at the start, wait after the scores).
// Query rows are taken in blocks of GB = 8 in p . v; where G > 8 (never on
// the model's routes) the V rows are streamed once per block.
// A slice whose scores outgrow shared memory (long spans at G > 1: at hd
// 128 about 7,000 rows at G = 4 and 4,200 at G = 8, so Llama-3.1-8B's and
// -70B's 131,072-row spans at 8 CTAs) is walked in sub-slices of `held`
// rows (a multiple of CH, ops/attention.py:k9_plan), as K4 walks its key
// tiles: the K rows are streamed twice, once for the tile maxes (merged
// over the sub-slices), and again, sub-slice by sub-slice, to score the
// rows anew just before their V rows are streamed for p . v. The scores
// come out bit-equal both times, so the result is that of one pass. The
// MULTI instantiations carry that walk; the others are the one-pass form.
// With the insert flag every CTA quantizes its head's new K and V row into
// shared memory with K3's codes (kv_quant.cuh); the CTA whose slice holds
// row pos uses that copy for the row, and is the only one to write it to
// the cache (rank 0 when no slice holds it, e.g. pos >= span); no CTA reads
// row pos from the cache. A pos outside [0, S) writes nothing.
//
// What bounds it on an H100: the live int8 K/V rows and their scales (2 *
// (hd + 4) bytes per row and KV head), read once. At G = 1 (Llama-2-7B,
// the one served route that reaches K9) the scores and p . v are
// matrix-vector products: the tensor cores would add nothing, so "fast"
// and "high" share one f32 FMA path, and the design goes to the bytes in
// flight (NS - 1 stages of CH rows per CTA, several CTAs per SM) and to
// keeping the scores and the partials on chip.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int TILE = 256;         // the reference's tile: m_t is per tile
constexpr int NTHREADS = 256;
constexpr int WARPS = NTHREADS / 32;
constexpr int CH = 64;            // cache rows per ring stage
constexpr int NS = 3;             // ring stages
constexpr int GB = 8;             // query rows per p . v block where G > 1
constexpr int MAXC = 8;           // CTAs per cluster at most
constexpr int MAX_SMEM = 232448;  // shared memory a block can use on an H100

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// K9's dynamic shared memory, byte offsets (each 16-byte aligned), for G
// query rows, `held` rows of a slice at a time, slices touching at most
// `ntl` tiles, and RB query rows per p . v block: stage [NS][CH][HD] (the
// ring); bar [NS] (its mbarriers); q [G][4][HD / 16] float4s (the query,
// laid out free of bank conflicts); ks, vs [held] (the held rows'
// scales); sc [G][held] (scores, then weighted pv); tm, mt, wt [G][ntl]
// (the slice's max per tile, m_t, exp(m_t - M)); xs [MAXC][2][G] (every rank's slice
// max and first-tile max); red [WARPS][RB][HD], lred [WARPS][RB] (the
// warps' partials); go [C][ceil(G HD / C)] (every rank's acc over this
// CTA's slice of the outputs); gl [MAXC][G] (every rank's l); kv (the
// inserted K and V rows, 2 HD bytes, their two scales and the slot this
// CTA works on). Mirrored by ops/attention.py:k9_smem_bytes.
struct TiledSmem {
  int stage, bar, q, ks, vs, sc, tm, mt, wt, xs, red, lred, go, gl, kv, total;
  __host__ __device__ TiledSmem(int G, int HD, int RB, int held, int ntl)
      : stage(0), bar(stage + NS * CH * HD), q(bar + 8 * NS + 8 * (NS % 2)), ks(q + 4 * G * HD),
        vs(ks + 4 * up4(held)), sc(vs + 4 * up4(held)), tm(sc + 4 * G * up4(held)),
        mt(tm + 4 * up4(G * ntl)), wt(mt + 4 * up4(G * ntl)), xs(wt + 4 * up4(G * ntl)),
        red(xs + 4 * 2 * MAXC * G), lred(red + 4 * WARPS * RB * HD),
        go(lred + 4 * up4(WARPS * RB)), gl(go + 4 * up4(G * HD + MAXC)),
        kv(gl + 4 * MAXC * G), total(kv + 2 * HD + 16) {}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the cluster's barrier, split: arrive (release) ... wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `bytes` (a multiple of 16) of global memory at src -> shared memory at
// dst (both 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Grid (C, KVH, B) in clusters of C along x; NTHREADS threads, at most 64
// registers at G = 1 (R1 = true: 4 CTAs per SM), 128 otherwise. MULTI: a
// slice may hold more than `held` rows (the sub-slice walk). Cache
// pointers are not __restrict__: one CTA writes the inserted row.
template <int HD, bool R1, bool MULTI>
__global__ void __launch_bounds__(NTHREADS, R1 ? 4 : 2)
tiled_kernel(const float* __restrict__ q, const float* __restrict__ kn,
             const float* __restrict__ vn, int8_t* k, float* ks, int8_t* v, float* vs,
             const int* __restrict__ pos, float* __restrict__ out, int KVH, int G, int S,
             int span, float scale, float softcap, int window, int fast, int insert,
             int rows, int held) {
  namespace cg = cooperative_groups;
  constexpr int RB = R1 ? 1 : GB;       // query rows per p . v block
  constexpr int TPR = HD / 16;          // threads per K row in the scores
  constexpr int RPP = NTHREADS / TPR;   // K rows per pass over a stage
  constexpr int PASSES = CH / RPP;
  constexpr int PER = HD / 32;          // p . v columns per lane
  constexpr int RPW = CH / WARPS;       // V rows per warp and stage
  static_assert(PASSES >= 1 && CH % RPP == 0 && CH <= NTHREADS, "stage shape");
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = gridDim.x, rank = blockIdx.x;
  const int ntl = rows / TILE + 2, rs = up4(held);
  const TiledSmem L(G, HD, RB, held, ntl);
  int8_t* stage = reinterpret_cast<int8_t*>(smem + L.stage);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  auto fp = [&](int off) { return reinterpret_cast<float*>(smem + off); };
  float* q_s = fp(L.q);
  float* ks_s = fp(L.ks);
  float* vs_s = fp(L.vs);
  float* sc = fp(L.sc);
  float* tm = fp(L.tm);
  float* mt = fp(L.mt);
  float* wt = fp(L.wt);
  float* xs = fp(L.xs);
  float* red = fp(L.red);
  float* lred = fp(L.lred);
  float* go = fp(L.go);
  float* gl = fp(L.gl);
  int8_t* kn_s = reinterpret_cast<int8_t*>(smem + L.kv);
  int8_t* vn_s = kn_s + HD;
  float* new_scale = fp(L.kv + 2 * HD);   // [0] K's, [1] V's
  int* slot_s = reinterpret_cast<int*>(smem + L.kv + 2 * HD + 8);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the live rows of a slot at position p: [L0, L1)
  auto live_lo = [&](int p) { return window > 0 ? max(0, p - window + 1) : 0; };
  auto live_hi = [&](int p) { return p < 0 ? 0 : min(p + 1, span); };
  // blockIdx.z is a rank among the slots by live rows, longest first (ties
  // by index): blocks start in index order, so the longest slots' clusters
  // start first and the short ones fill in behind them
  if (warp == 0) {
    const int B = gridDim.z;
    for (int i = lane; i < B; i += 32) {
      const int pi = pos[i], ni = max(0, live_hi(pi) - live_lo(pi));
      int before = 0;
      for (int j = 0; j < B; ++j) {
        const int pj = pos[j], nj = max(0, live_hi(pj) - live_lo(pj));
        before += nj > ni || (nj == ni && j < i);
      }
      if (before == static_cast<int>(blockIdx.z)) *slot_s = i;
    }
  }
  __syncthreads();
  const int slot = *slot_s;
  const size_t bh = static_cast<size_t>(slot) * KVH + blockIdx.y;
  const int p0 = pos[slot];
  int8_t* kc = k + bh * S * HD;
  int8_t* vc = v + bh * S * HD;
  float* ksc = ks + bh * S;
  float* vsc = vs + bh * S;

  auto csync = [&] {
    if (C > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
  };
  // this address in rank r's shared memory (a remote store's target)
  auto at = [&](float* p, int r) -> float* {
    return C > 1 ? cg::this_cluster().map_shared_rank(p, r) : p;
  };

  // the slot's live rows [L0, L1) and this CTA's slice [lo, lo + nr)
  const int L1 = live_hi(p0), L0 = live_lo(p0);
  const int per = (max(0, L1 - L0) + C - 1) / C;
  const int lo = L0 + rank * per;
  const int nr = max(0, min(L1, lo + per) - lo);
  const int tlo = lo / TILE;
  const int nt = nr > 0 ? (lo + nr - 1) / TILE - tlo + 1 : 0;
  const int nk = (nr + CH - 1) / CH;              // stages of the slice
  const bool multi = MULTI && nr > held;          // walk the slice in sub-slices
  const int cps = multi ? held / CH : max(nk, 1); // stages per sub-slice
  const int nsub = (nk + cps - 1) / cps;
  const int nblk = R1 ? 1 : (G + GB - 1) / GB;    // p . v blocks
  const int seg = multi ? 2 * nk : nk;            // stages per p . v block
  const int total = nk + nblk * seg;              // K's stages, then each block's
  const int pnew = insert && p0 >= 0 && p0 < S ? p0 : -1;
  const bool mine = pnew >= lo && pnew < lo + nr;
  const bool writer = mine || (rank == 0 && !(pnew >= L0 && pnew < L1));

  // stage i of the stream: K rows of chunk i; then per p . v block the V
  // rows of each chunk, or (multi) per sub-slice its K rows, then its V rows
  auto issue = [&](int i) {
    int c = i;
    bool is_v = false;
    if (i >= nk) {
      const int u = (i - nk) % seg;
      if (multi) {
        const int sb = u / (2 * cps), w = u - 2 * sb * cps, m = min(cps, nk - sb * cps);
        is_v = w >= m;
        c = sb * cps + (is_v ? w - m : w);
      } else {
        is_v = true;
        c = u;
      }
    }
    const int cnt = min(CH, nr - c * CH);
    uint64_t* b = bar + i % NS;
    mbar_expect_tx(b, cnt * HD);
    bulk_load(stage + (i % NS) * CH * HD,
              (is_v ? vc : kc) + static_cast<size_t>(lo + c * CH) * HD, cnt * HD, b);
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(bar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(NS, total); ++i) issue(i);
  }
  if (C > 1) cluster_arrive();   // this CTA has started (waited before the first remote store)
  if (pnew >= 0) {
    const size_t row = static_cast<size_t>(pnew) * HD;
    if (warp == 0)
      quantize_row<HD>(kn + bh * HD, kn_s, new_scale, lane, writer ? kc + row : nullptr,
                       ksc + pnew);
    if (warp == 1)
      quantize_row<HD>(vn + bh * HD, vn_s, new_scale + 1, lane, writer ? vc + row : nullptr,
                       vsc + pnew);
  }
  // q_s holds query row g's float4 u of part p (its codes 16p + 4u..+3)
  // at float4 (g * 4 + u) * TPR + p: the TPR parts a quarter-warp reads
  // together are 16 * TPR contiguous bytes, free of bank conflicts
  const float* qb = q + bh * G * HD;
  for (int e = tid; e < G * HD; e += NTHREADS) {
    const int g = e / HD, d = e % HD;
    q_s[((g * 4 + d % 16 / 4) * TPR + d / 16) * 4 + d % 4] = fast ? bf16_round(qb[e]) : qb[e];
  }
  // the first sub-slice's scales (V's too unless the walk reloads them)
  const int held0 = min(nr, cps * CH);
  for (int j = tid; j < held0; j += NTHREADS) {
    ks_s[j] = ksc[lo + j];
    if (!multi) vs_s[j] = vsc[lo + j];
  }
  if (multi)
    for (int e = tid; e < G * ntl; e += NTHREADS) tm[e] = -INFINITY;
  __syncthreads();
  if (tid == 0 && mine && pnew - lo < held0) {
    ks_s[pnew - lo] = new_scale[0];
    vs_s[pnew - lo] = new_scale[1];
  }
  __syncthreads();
  // sub-slice sb's scales, in place of the last one's (the new row's at pos)
  auto load_scales = [&](int sb) {
    const int r0 = sb * cps * CH, n = min(nr - r0, cps * CH);
    for (int j = tid; j < n; j += NTHREADS) {
      const int r = lo + r0 + j;
      ks_s[j] = r == pnew ? new_scale[0] : ksc[r];
      vs_s[j] = r == pnew ? new_scale[1] : vsc[r];
    }
    __syncthreads();
  };

  // ---- 1-2. scores of chunk c's K rows (stream stage i) into sc[g][j]
  const int part = tid % TPR;   // this thread's 16 codes of a row
  float qr[R1 ? 16 : 1];
  if constexpr (R1) {
#pragma unroll
    for (int e = 0; e < 16; ++e) qr[e] = q_s[((e / 4) * TPR + part) * 4 + e % 4];
  }
  auto score = [&](int i, int c) {
    mbar_wait(bar + i % NS, (i / NS) & 1);
    const int8_t* st = stage + (i % NS) * CH * HD;
    const int r0 = c * CH, cnt = min(CH, nr - r0), h0 = r0 - c / cps * cps * CH;
    uint4 raw[PASSES];
#pragma unroll
    for (int ps = 0; ps < PASSES; ++ps) {
      const int j = min(ps * RPP + tid / TPR, cnt - 1);
      const int8_t* kr = lo + r0 + j == pnew ? kn_s : st + j * HD;
      raw[ps] = *reinterpret_cast<const uint4*>(kr + part * 16);
    }
    // the score of the stage's K row j against query row g
    auto put = [&](int j, int g, float acc) {
      float s = acc * (ks_s[h0 + j] * scale);
      if (softcap != 0.f) s = softcap * tanhf(s * (1.0f / softcap));
      sc[g * rs + h0 + j] = s;
    };
    if constexpr (R1) {   // one query row, in registers: a pass at a time
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps) {
        const int j = ps * RPP + tid / TPR;
        const uint32_t wd[4] = {raw[ps].x, raw[ps].y, raw[ps].z, raw[ps].w};
        float kf[16];
#pragma unroll
        for (int b = 0; b < 16; ++b) kf[b] = i8f(wd[b >> 2], b & 3);
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < 16; ++b) acc = fmaf(qr[b], kf[b], acc);
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (part == 0 && j < cnt) put(j, 0, acc);
      }
    } else {
      // every pass's codes at once; RB query rows at a time, each row's 16
      // values read once for all PASSES K rows, the chains interleaved
      float kf[PASSES][16];
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps) {
        const uint32_t wd[4] = {raw[ps].x, raw[ps].y, raw[ps].z, raw[ps].w};
#pragma unroll
        for (int b = 0; b < 16; ++b) kf[ps][b] = i8f(wd[b >> 2], b & 3);
      }
      for (int g0 = 0; g0 < G; g0 += RB) {
        float acc[PASSES][RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int ps = 0; ps < PASSES; ++ps) acc[ps][r] = 0.f;
          if (g0 + r < G) {
            const float4* qv = reinterpret_cast<const float4*>(q_s) + (g0 + r) * 4 * TPR + part;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 qq = qv[u * TPR];
#pragma unroll
              for (int ps = 0; ps < PASSES; ++ps) {
                acc[ps][r] = fmaf(qq.x, kf[ps][4 * u], acc[ps][r]);
                acc[ps][r] = fmaf(qq.y, kf[ps][4 * u + 1], acc[ps][r]);
                acc[ps][r] = fmaf(qq.z, kf[ps][4 * u + 2], acc[ps][r]);
                acc[ps][r] = fmaf(qq.w, kf[ps][4 * u + 3], acc[ps][r]);
              }
            }
          }
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (g0 + r < G) {   // the same for the whole warp
#pragma unroll
              for (int ps = 0; ps < PASSES; ++ps)
                acc[ps][r] += __shfl_xor_sync(0xffffffffu, acc[ps][r], o);
            }
          }
        }
#pragma unroll
        for (int ps = 0; ps < PASSES; ++ps) {
          const int j = ps * RPP + tid / TPR;
          if (part == 0 && j < cnt) {
#pragma unroll
            for (int r = 0; r < RB; ++r)
              if (g0 + r < G) put(j, g0 + r, acc[ps][r]);
          }
        }
      }
    }
    __syncthreads();   // the stage is read: refill it
    if (tid == 0 && i + NS < total) issue(i + NS);
  };

  // ---- 3. the slice's max per tile; m_t and exp(m_t - M) over the cluster
  int i = 0;
  for (int sb = 0; sb < nsub; ++sb) {
    const int r0 = sb * cps * CH, n = min(nr - r0, cps * CH);
    if (sb > 0) {   // multi: the next sub-slice's K scales
      for (int j = tid; j < n; j += NTHREADS)
        ks_s[j] = lo + r0 + j == pnew ? new_scale[0] : ksc[lo + r0 + j];
      __syncthreads();
    }
    for (int c = sb * cps; c < min(nk, (sb + 1) * cps); ++c, ++i) score(i, c);
    const int t0 = (lo + r0) / TILE - tlo, nts = (lo + r0 + n - 1) / TILE - tlo + 1 - t0;
    for (int it = warp; it < G * nts; it += WARPS) {
      const int g = it / nts, lt = t0 + it % nts;
      const int a = max(lo + r0, (tlo + lt) * TILE) - lo - r0;
      const int b = min(lo + r0 + n, (tlo + lt + 1) * TILE) - lo - r0;
      float m = -INFINITY;
      for (int j = a + lane; j < b; j += 32) m = fmaxf(m, sc[g * rs + j]);
      m = warp_max(m);
      if (lane == 0) tm[g * ntl + lt] = multi ? fmaxf(tm[g * ntl + lt], m) : m;
    }
    __syncthreads();
  }
  if (C > 1) cluster_wait();     // every CTA has started
  for (int it = tid; it < C * G; it += NTHREADS) {   // to rank it / G
    const int r = it / G, g = it % G;
    float m = -INFINITY;
    for (int lt = 0; lt < nt; ++lt) m = fmaxf(m, tm[g * ntl + lt]);
    float* x = at(xs, r) + 2 * rank * G;
    x[g] = m;
    x[G + g] = nt > 0 ? tm[g * ntl] : -INFINITY;
  }
  csync();
  for (int it = tid; it < G * nt; it += NTHREADS) {
    const int g = it / nt, lt = it % nt;
    float m = -INFINITY, top = -INFINITY;
    for (int u = 0; u <= lt; ++u) m = fmaxf(m, tm[g * ntl + u]);
    for (int r = 0; r < C; ++r) {
      const float rm = xs[2 * r * G + g];
      top = fmaxf(top, rm);
      const int lo_r = L0 + r * per;
      if (r < rank) m = fmaxf(m, rm);
      else if (r > rank && lo_r < L1 && lo_r / TILE <= tlo + lt) m = fmaxf(m, xs[(2 * r + 1) * G + g]);
    }
    mt[g * ntl + lt] = m;
    wt[g * ntl + lt] = expf(m - top);
  }
  __syncthreads();

  // ---- 4. p . v, per block of RB query rows (multi: per sub-slice, its
  // rows scored anew first)
  const int per_o = (G * HD + C - 1) / C;   // outputs each CTA owns in 5.
  for (int blk = 0; blk < nblk; ++blk) {
    const int g0 = blk * RB, gc = min(RB, G - g0);
    float acc[RB][PER], lsum[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      lsum[r] = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) acc[r][e] = 0.f;
    }
    for (int sb = 0; sb < nsub; ++sb) {
      const int c1 = min(nk, (sb + 1) * cps);
      if (multi) {
        load_scales(sb);
        for (int c = sb * cps; c < c1; ++c, ++i) score(i, c);
      }
      for (int c = sb * cps; c < c1; ++c, ++i) {
        mbar_wait(bar + i % NS, (i / NS) & 1);
        const int8_t* st = stage + (i % NS) * CH * HD;
        const int r0 = c * CH, cnt = min(CH, nr - r0), h0 = r0 - sb * cps * CH;
        if (tid < cnt) {   // this row's weighted pv, in place of its scores
          const int j = r0 + tid;
          const int lt = (lo + j) / TILE - tlo;
          const float vsj = vs_s[h0 + tid];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r < gc) {
              float* sp = sc + (g0 + r) * rs + h0 + tid;
              const float p = expf(*sp - mt[(g0 + r) * ntl + lt]);
              const float w = wt[(g0 + r) * ntl + lt];
              lsum[r] = fmaf(w, p, lsum[r]);
              const float pv = p * vsj;
              *sp = w * (fast ? bf16_round(pv) : pv);
            }
          }
        }
        __syncthreads();
        uint32_t wv[RPW];   // this lane's columns of the warp's V rows, loaded together
#pragma unroll
        for (int u = 0; u < RPW; ++u) {
          const int j = min(warp + u * WARPS, cnt - 1);
          const int8_t* vr = (lo + r0 + j == pnew ? vn_s : st + j * HD) + lane * PER;
          wv[u] = PER == 4 ? *reinterpret_cast<const uint32_t*>(vr)
                           : *reinterpret_cast<const uint16_t*>(vr);
        }
#pragma unroll
        for (int u = 0; u < RPW; ++u) {
          const int j = warp + u * WARPS;
          if (j < cnt) {
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              if (r < gc) {
                const float pj = sc[(g0 + r) * rs + h0 + j];
#pragma unroll
                for (int e = 0; e < PER; ++e) acc[r][e] = fmaf(pj, i8f(wv[u], e), acc[r][e]);
              }
            }
          }
        }
        __syncthreads();   // the stage is read: refill it
        if (tid == 0 && i + NS < total) issue(i + NS);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < gc) {
#pragma unroll
        for (int e = 0; e < PER; ++e) red[(warp * RB + r) * HD + lane * PER + e] = acc[r][e];
        const float l = warp_sum(lsum[r]);
        if (lane == 0) lred[warp * RB + r] = l;
      }
    }
    __syncthreads();
    for (int e = tid; e < gc * HD; e += NTHREADS) {   // to the output's owner
      const int r = e / HD, d = e % HD;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a += red[(w * RB + r) * HD + d];
      const int ge = (g0 + r) * HD + d, own = ge / per_o;
      at(go, own)[rank * per_o + ge - own * per_o] = a;
    }
    for (int it = tid; it < gc * C; it += NTHREADS) {   // to every rank
      const int r = it % gc;
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) l += lred[w * RB + r];
      at(gl, it / gc)[rank * G + g0 + r] = l;
    }
    __syncthreads();
  }

  // ---- 5. out = the CTAs' acc over their l, in rank order; each CTA its slice
  csync();   // after it no CTA touches another's shared memory
  float* o = out + bh * G * HD;
  for (int e = tid; e < per_o && rank * per_o + e < G * HD; e += NTHREADS) {
    const int g = (rank * per_o + e) / HD;
    float a = 0.f, l = 0.f;
    for (int r = 0; r < C; ++r) {
      a += go[r * per_o + e];
      l += gl[r * G + g];
    }
    o[rank * per_o + e] = l > 0.f ? a / l : 0.f;
  }
}

template <int HD, bool R1, bool MULTI>
int launch_tiled(const void* q, const void* kn, const void* vn, void* k, void* ks, void* v,
                 void* vs, const void* pos, void* out, int B, int KVH, int G, int S, int span,
                 float scale, float softcap, int window, int fast, int insert, int clusters,
                 int rows, int held, cudaStream_t st) {
  const size_t smem = TiledSmem(G, HD, R1 ? 1 : GB, held, rows / TILE + 2).total;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tiled_kernel<HD, R1, MULTI>;
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
      static_cast<float*>(out), KVH, G, S, span, scale, softcap, window, fast, insert, rows,
      held));
}

// the instantiation for G == 1 or not, and a slice held whole or walked
template <int HD, typename... A>
int launch_hd(int G, bool multi, A... a) {
  if (G == 1) return multi ? launch_tiled<HD, true, true>(a...) : launch_tiled<HD, true, false>(a...);
  return multi ? launch_tiled<HD, false, true>(a...) : launch_tiled<HD, false, false>(a...);
}

}  // namespace

// q (B, KVH*G, 1, HD) f32; kn, vn (B, KVH, 1, HD) f32 (read only with the
// insert flag); k, v (B, KVH, S, HD) int8; ks, vs (B, KVH, S) f32; pos (B,)
// int32; out (B, KVH*G, 1, HD) f32. flags bit 0 = fast (bf16 operands),
// bit 1 = insert; clusters (1-8) CTAs per (slot, KV head), each slice at
// most `rows` rows (rows * clusters >= span), `held` of them in shared
// memory at a time (held >= rows: one pass; else a multiple of 64), as
// ops/attention.py:k9_plan picks them.
extern "C" int decode_attention_tiled_launch(const void* q, const void* kn, const void* vn,
                                             void* k, void* ks, void* v, void* vs,
                                             const void* pos, void* out, int B, int KVH,
                                             int G, int S, int span, int HD, float scale,
                                             float softcap, int window, int flags,
                                             int clusters, int rows, int held, void* stream) {
  if (span <= 0 || span > S || clusters < 1 || clusters > 8 || rows < 1 ||
      static_cast<long long>(rows) * clusters < span || (held < rows && (held < CH || held % CH)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool multi = held < rows;
  held = min(held, rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K9_ARGS G, multi, q, kn, vn, k, ks, v, vs, pos, out, B, KVH, G, S, span, scale, softcap, \
    window, flags & 1, (flags >> 1) & 1, clusters, rows, held, st
  if (HD == 64) return launch_hd<64>(K9_ARGS);
  if (HD == 128) return launch_hd<128>(K9_ARGS);
#undef K9_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
