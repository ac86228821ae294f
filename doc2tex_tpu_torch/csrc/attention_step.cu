// Coverage-attention decode step of the LSTM head, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel doc2tex_tpu/ops/attention_step.py::_kernel
// (pl.pallas_call in fused_attention_step).  Same function, per decode row
// r = b*K + k (beam k of sample b):
//
//   x[s,h]   = enc_proj[b,s,h] + q[r,h] + locH[r,s,h]
//   e[s]     = sum_h tanh(x[s,h]) * w_score[h]           (s < valid; else -1e30)
//   alpha[s] = softmax_s(e)                               (f32, written normalised)
//   ctx[d]   = sum_s alpha[s] * enc[b,s,d]                (f32)
//
// in one of two forms of the location term, a template parameter:
//   - feature form, the TPU kernel's input for input:
//       locH[r,s,h] = sum_j loc_feat[r,s,j] * w_loc[j,h] + b_loc[h]     (j < Kl)
//   - coverage form, the location conv of the decoder folded in.  Conv then
//     w_loc is linear in the coverage mem (B*K, S), so with
//       W'[t,h] = sum_j loc_conv_w[t,0,j] * w_loc[j,h]                  (t < 2*ks+1)
//       b'[h]   = sum_j loc_conv_b[j] * w_loc[j,h] + b_loc[h]
//     locH[r,s,h] = sum_t mem[r, s+t-ks] * W'[t,h] + b'[h], mem zero outside
//     [0, S) (the conv's zero padding) and read at every position, those at
//     or past valid included.  Each block computes W' and b' in its prologue.
// Both forms take the memory at sample rows: enc (Bs,S,D) and enc_proj
// (Bs,S,H) in float or bfloat16; q (Bs*K,H) and everything else float; ctx
// (Bs*K,D), alpha (Bs*K,S).  With K = 1 each form is the TPU kernel's
// contract.  D = H; contiguous, 16-byte aligned.
//
// What bounds it.  At the release shape (64 samples x beam 10, S 623, D = H
// = 128, bf16) the coverage form must move ~24 MB (enc and enc_proj once
// per sample, the f32 coverage and the outputs): 7.3 us of HBM.  What is
// left of the arithmetic after the fold is elementwise per (row, s, h): 5
// FMAs, one tanh and one FMA into the score, 51 M of each a step, which no
// tensor core takes (rounding alpha to bf16 for the context would break the
// float32 tolerance).  The tanh is
//   tanh(x) w = w - 2w / (1 + 2^(x 2/ln2)),
// with 2/ln2 folded into the staged weights, q and the first FMA, sum_h w
// added once per score, and the terms of two h summed over one reciprocal:
//   w_a / d_a + w_b / d_b = ((w_a + w_b) + w_a e_b + w_b e_a) / (d_a d_b)
// with e = 2^x' (ex2.approx, x' clamped at 60) and d = 1 + e: 1.5 MUFU
// operations a tanh, |error| ~1e-7.  (tanh.approx.f32 is not used: its
// ~2^-11 relative error, summed over H, moves alpha by ~5e-4.)  The
// design spends Hopper's features on feeding that loop:
//   - grid: (cluster, sample, beam group).  A block owns the Kz = K / zsplit
//     beams of one group of one sample over one S-chunk; S is split over a
//     thread-block cluster of up to 8 blocks, and at few samples the beams
//     over zsplit groups, whose blocks read the sample's tiles again from
//     L2.  ops/attention_step.py's launch_plan chooses (cluster, chunk,
//     zsplit, tile, stages);
//   - prologue, one round trip: the w_loc rows for W' (registers), then one
//     cp.async group of q's rows, b_loc, w_score, the conv weights and the
//     coverage rows with their halo (shared memory), then the first ring
//     tiles;
//   - each enc_proj tile (32 or 16 positions) comes into a ring of shared
//     memory once, by 16-byte cp.async, and every beam of the block is
//     scored against it; the first enc tiles are issued while the block
//     scores, and the rest stream through the same ring after the softmax;
//   - scoring: an item is (position, G beams); HS lanes split its H, each a
//     float4 of h at a time, with the G beams' window taps (coverage) in
//     registers, so one float4 of W' serves G beams.  The same loop runs
//     over Kl feature rows in the feature form;
//   - the f32 scores of the block's positions stay in shared memory.  Row
//     maxima, then row sums, are combined over the cluster through
//     distributed shared memory (every rank's value loaded at once), so the
//     softmax is exact and two-pass as the reference's; each block writes
//     its normalised alpha;
//   - context: threads own a float4 of D over a group of positions for every
//     beam; the groups meet in shared memory, the blocks of the cluster
//     through distributed shared memory, each rank adding its share of the
//     outputs in rank order.  One launch, no workspace in device memory.
// Measured on an H100 (PERF.md §6): the scoring loop issues about one
// instruction every two cycles per scheduler, with or without the MUFU work,
// the shared loads or more warps, and many of its float operations read
// two source registers from one bank.  At the slice's
// shapes a block's fixed chain (prologue, cluster exchanges, output) of
// ~8 us dominates.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 16;          // beams of a sample a block holds
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kMaxStages = 8;
constexpr int kHalo = 2;           // the widest location conv: kernel_size 2
constexpr int kTaps = 2 * kHalo + 1;
constexpr int kRedFloats = 6144;   // prologue partial sums, then context partial sums
constexpr int kMaxSmem = 232448;   // 227 KB: the most a block may use on sm_90
constexpr float kNegInf = -1e30f;  // the score of a position past valid
constexpr float kTwoOverLn2 = 2.8853900817779268f;  // e^(2x) = 2^(x * 2/ln2)
constexpr float kMaxExp = 60.f;    // 2^x' is clamped here: tanh(60 ln2 / 2) = 1 - 1e-18

enum Form { kFeature = 0, kCoverage = 1 };

// Byte offsets of the dynamic shared memory.  ops/attention_step.py's
// smem_bytes() is the same arithmetic; the launcher refuses a plan whose
// bytes are fewer than this layout needs.
struct Layout {
  int w, cw, qb, ws, win, scores, oblk, red, misc, ring, stage, total;
};

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int form, int Kz, int chunk, int tile, int stages,
                                              int H, int Kl, int elem) {
  Layout L;
  int off = 0;
  L.w = off;      off += up16((form == kCoverage ? kTaps : Kl) * H * 4);  // W' or w_loc, scaled
  L.cw = off;     off += up16(form == kCoverage ? (kTaps + 1) * Kl * 4 : 0);  // conv_w, conv_b
  L.qb = off;     off += up16(Kz * H * 4);                                // (q + b') scaled
  L.ws = off;     off += up16(H * 4);                                     // -2 w_score
  L.win = off;    off += up16(form == kCoverage ? Kz * (chunk + 2 * kHalo) * 4 : 0);
  L.scores = off; off += up16(Kz * chunk * 4);
  L.oblk = off;   off += up16(Kz * H * 4);                                // block's context
  L.red = off;    off += kRedFloats * 4;
  L.misc = off;   off += up16((4 * kMaxQ + 4) * 4);
  // a ring stage: tile enc_proj or enc rows, padded by 16 bytes, and in the
  // feature form the tile's loc_feat rows of every beam
  L.stage = up16(tile * (H * elem + 16)) + (form == kFeature ? Kz * tile * (Kl * 4 + 16) : 0);
  L.ring = off;   off += stages * L.stage;
  L.total = off;
  return L;
}

// 4 consecutive elements of T, float or bfloat16 (16 or 8 bytes, aligned) -> f32
template <typename T>
__device__ __forceinline__ float4 load4(const void* p) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
    return make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]), __bfloat162float(e[2]),
                       __bfloat162float(e[3]));
  }
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 4 bytes global -> shared, or zeros when !live (nothing is read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n groups are pending (n is an immediate in PTX)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- scores of one ring tile ------------------------------------------
// Item it = (position pl of the tile, beam group g of G beams), HS lanes
// each; lane `sub` of an item takes the float4 columns sub, sub + HS, ...
// of H.  For each column and beam:
//   x' = P * 2/ln2 + qb + sum_j a_j * w_s[j]     (qb and w_s pre-scaled)
//   e += (-2 w) / (1 + 2^x')
// with j over the 5 window taps (coverage; a_j in registers) or the Kl
// features (feature form; a_j from the tile's loc_feat rows): one loop.
template <typename T, int H, int G, bool kCov>
__device__ __forceinline__ void score_tile(const unsigned char* buf, const float* loc_tile,
                                           const float* w_s, const float* qb_s, const float* ws_s,
                                           const float* win_s, float* sc_s, float sum_ws,
                                           int chunk, int p0, int np, int tile, int Kz, int Kl,
                                           int HS, int tid) {
  constexpr int RS = H * (int)sizeof(T) + 16;
  constexpr int NC = H / 4;  // float4 columns
  const int WL = chunk + 2 * kHalo;
  const int LRF = Kl + 4;    // floats of a padded loc_feat row
  const int items = tile * (Kz / G);
  const int slots = kThreads / HS;
  const int sub = tid % HS;
  const int depth = kCov ? kTaps : Kl;
  for (int base = 0; base < items; base += slots) {
    const int it = base + tid / HS;
    const int pl = it % tile;
    const int g = it / tile;
    const bool live = it < items && pl < np;
    float e[G];
#pragma unroll
    for (int gg = 0; gg < G; ++gg) e[gg] = 0.f;
    if (live) {
      const unsigned char* prow = buf + pl * RS;
      float win[kCov ? G : 1][kTaps];
      const float* lrow[G];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        if constexpr (kCov) {
          const float* wr = win_s + (g * G + gg) * WL + p0 + pl;
#pragma unroll
          for (int t = 0; t < kTaps; ++t) win[gg][t] = wr[t];
          lrow[gg] = nullptr;
        } else {
          lrow[gg] = loc_tile + ((g * G + gg) * tile + pl) * LRF;
        }
      }
      for (int c = sub; c < NC; c += HS) {
        const int h0 = 4 * c;
        const float4 p = load4<T>(prow + h0 * (int)sizeof(T));
        const float4 wsc = *reinterpret_cast<const float4*>(ws_s + h0);
        float x[G][4];
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const float4 qv = *reinterpret_cast<const float4*>(qb_s + (g * G + gg) * H + h0);
          x[gg][0] = fmaf(p.x, kTwoOverLn2, qv.x);
          x[gg][1] = fmaf(p.y, kTwoOverLn2, qv.y);
          x[gg][2] = fmaf(p.z, kTwoOverLn2, qv.z);
          x[gg][3] = fmaf(p.w, kTwoOverLn2, qv.w);
        }
#pragma unroll
        for (int j = 0; j < depth; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(w_s + j * H + h0);
#pragma unroll
          for (int gg = 0; gg < G; ++gg) {
            float a;
            if constexpr (kCov) {
              a = win[gg][j];
            } else {
              a = lrow[gg][j];
            }
            x[gg][0] = fmaf(a, w.x, x[gg][0]);
            x[gg][1] = fmaf(a, w.y, x[gg][1]);
            x[gg][2] = fmaf(a, w.z, x[gg][2]);
            x[gg][3] = fmaf(a, w.w, x[gg][3]);
          }
        }
        // w_a / d_a + w_b / d_b = (w_a d_b + w_b d_a) / (d_a d_b), d = 1 + 2^x'
        // and w_a d_b + w_b d_a = (w_a + w_b) + w_a 2^x'_b + w_b 2^x'_a: one
        // reciprocal a pair of h.  x' <= kMaxExp keeps d_a d_b finite.
        const float s01 = wsc.x + wsc.y, s23 = wsc.z + wsc.w;
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const float e0 = ex2_approx(fminf(x[gg][0], kMaxExp));
          const float e1 = ex2_approx(fminf(x[gg][1], kMaxExp));
          const float e2 = ex2_approx(fminf(x[gg][2], kMaxExp));
          const float e3 = ex2_approx(fminf(x[gg][3], kMaxExp));
          const float d0 = e0 + 1.f, d2 = e2 + 1.f;
          const float n01 = fmaf(wsc.y, e0, fmaf(wsc.x, e1, s01));
          const float n23 = fmaf(wsc.w, e2, fmaf(wsc.z, e3, s23));
          e[gg] = fmaf(n01, rcp_approx(fmaf(d0, e1, d0)), e[gg]);
          e[gg] = fmaf(n23, rcp_approx(fmaf(d2, e3, d2)), e[gg]);
        }
      }
    }
    // the item's HS lanes are neighbours in one warp; every lane shuffles
    for (int o = 1; o < HS; o <<= 1) {
#pragma unroll
      for (int gg = 0; gg < G; ++gg) e[gg] += __shfl_xor_sync(0xffffffffu, e[gg], o);
    }
    if (live && sub == 0) {
#pragma unroll
      for (int gg = 0; gg < G; ++gg) sc_s[(g * G + gg) * chunk + p0 + pl] = sum_ws + e[gg];
    }
  }
}

template <typename T, int H, int G, int FORM>
__global__ void __launch_bounds__(kThreads)
attention_step_kernel(const T* __restrict__ enc, const T* __restrict__ enc_proj,
                      const float* __restrict__ q, const float* __restrict__ loc,
                      const float* __restrict__ conv_w, const float* __restrict__ conv_b,
                      const float* __restrict__ w_loc, const float* __restrict__ b_loc,
                      const float* __restrict__ w_score, float* __restrict__ ctx,
                      float* __restrict__ alpha, int K, int Kz, int S, int Kl, int taps,
                      int valid, int chunk, int tile, int stages) {
  constexpr bool kCov = FORM == kCoverage;
  constexpr int D = H;
  constexpr int ELEM = sizeof(T);
  constexpr int RS = H * ELEM + 16;   // bytes of a padded row in the ring
  constexpr int CPR = H * ELEM / 16;  // 16-byte pieces of a row
  constexpr int VEC = 16 / ELEM;      // elements of a piece
  constexpr int NC = H / 4;           // float4 columns of H (and D)
  static_assert(H == 128 || H == 256, "widths");

  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;  // the cluster spans x
  const int rank = blockIdx.x;
  // a cluster of one block needs only the block's barrier
  auto cluster_sync = [&]() {
    if (C == 1) {
      __syncthreads();
    } else {
      cluster.sync();
    }
  };
  const int b = blockIdx.y;
  const long row0 = (long)b * K + (long)blockIdx.z * Kz;  // the block's first decode row
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const Layout L = make_layout(FORM, Kz, chunk, tile, stages, H, Kl, ELEM);
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  float* qb_s = reinterpret_cast<float*>(smem + L.qb);
  float* ws_s = reinterpret_cast<float*>(smem + L.ws);
  float* win_s = reinterpret_cast<float*>(smem + L.win);
  float* sc_s = reinterpret_cast<float*>(smem + L.scores);  // [Kz][chunk]
  float* o_blk = reinterpret_cast<float*>(smem + L.oblk);   // [Kz][D]
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* blk_max = reinterpret_cast<float*>(smem + L.misc);
  float* blk_sum = blk_max + kMaxQ;
  float* gmax = blk_max + 2 * kMaxQ;
  float* gsum = blk_max + 3 * kMaxQ;
  float* sum_ws_s = blk_max + 4 * kMaxQ;
  unsigned char* ring = smem + L.ring;

  const int lo = rank * chunk;
  const int n_local = max(0, min(S - lo, chunk));  // positions the block owns
  const int n_score = valid < 0 ? S : min(valid, S);
  const int n_ctx = n_score > 0 ? n_score : S;     // positions whose alpha is not 0
  const int n_sc = max(0, min(n_score - lo, n_local));
  const int n_cx = max(0, min(n_ctx - lo, n_local));
  const int nt_p = (n_sc + tile - 1) / tile;
  const int n_stream = nt_p + (n_cx + tile - 1) / tile;
  const T* proj_b = enc_proj + ((long)b * S + lo) * H;
  const T* enc_b = enc + ((long)b * S + lo) * D;

  // tile i of the stream: enc_proj tiles 0..nt_p-1 (with their loc_feat
  // rows in the feature form), then enc tiles.  Every call commits a group.
  auto issue = [&](int i) {
    if (i < n_stream) {
      const bool proj = i < nt_p;
      const int p0 = (proj ? i : i - nt_p) * tile;
      const int np = min(tile, (proj ? n_sc : n_cx) - p0);
      unsigned char* dst = ring + (i % stages) * L.stage;
      const T* src = (proj ? proj_b : enc_b) + (long)p0 * H;
      for (int piece = tid; piece < np * CPR; piece += kThreads) {
        const int r = piece / CPR, c = piece % CPR;
        cp_async16(dst + r * RS + c * 16, src + (long)r * H + c * VEC);
      }
      if constexpr (!kCov) {
        if (proj) {
          unsigned char* ldst = dst + up16(tile * RS);
          const int lpr = Kl / 4;  // 16-byte pieces of a loc_feat row
          for (int piece = tid; piece < Kz * np * lpr; piece += kThreads) {
            const int k = piece / (np * lpr), rem = piece % (np * lpr);
            const int r = rem / lpr, c = rem % lpr;
            cp_async16(ldst + (k * tile + r) * (Kl * 4 + 16) + c * 16,
                       loc + ((row0 + k) * S + lo + p0 + r) * (long)Kl + 4 * c);
          }
        }
      }
    }
    cp_async_commit();
  };
  // ---- prologue.  One group of cp.async, the oldest, brings q's rows, b_loc
  // (into o_blk until the context), w_score, and the location inputs: the
  // conv weights and the coverage rows of the block's beams with a halo of
  // kHalo positions each side, zero outside [0, S) and read at every
  // position, valid or not (coverage form), or w_loc (feature form).
  float* cw_s = reinterpret_cast<float*>(smem + L.cw);
  // coverage form: this thread's first rows of w_loc (see W' below) go first
  constexpr int NJP = kThreads / NC;
  const int h4 = tid % NC, jp = tid / NC;
  const int MJ = (Kl - jp + NJP - 1) / NJP;  // rows of w_loc this thread sums
  float4 wl[8];
  auto load_rows = [&](int m0) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (m0 + m < MJ) {
        wl[m] = __ldg(reinterpret_cast<const float4*>(w_loc + (long)(jp + NJP * (m0 + m)) * H) + h4);
      }
    }
  };
  if constexpr (kCov) load_rows(0);
  for (int i = tid; i < Kz * NC; i += kThreads) cp_async16(qb_s + 4 * i, q + row0 * H + 4 * i);
  for (int i = tid; i < NC; i += kThreads) {
    cp_async16(ws_s + 4 * i, w_score + 4 * i);
    cp_async16(o_blk + 4 * i, b_loc + 4 * i);
  }
  const int WL = chunk + 2 * kHalo;
  if constexpr (kCov) {
    // conv_w row t at window slot u = t - ks + kHalo, zeros in the other
    // slots; conv_b at slot kTaps
    const int ks = (taps - 1) / 2;
    for (int i = tid; i < (kTaps + 1) * Kl; i += kThreads) {
      const int u = i / Kl, t = u - kHalo + ks;
      const bool live = u == kTaps || (t >= 0 && t < taps);
      cp_async4(cw_s + i, u == kTaps ? conv_b + i % Kl : live ? conv_w + t * Kl + i % Kl : conv_w,
                live);
    }
    for (int k = 0; k < Kz; ++k) {
      for (int j = tid; j < WL; j += kThreads) {
        const int s = lo - kHalo + j;
        const bool live = s >= 0 && s < S;
        cp_async4(win_s + k * WL + j, live ? loc + (row0 + k) * S + s : loc, live);
      }
    }
  } else {
    for (int i = tid; i < Kl * NC; i += kThreads) cp_async16(w_s + 4 * i, w_loc + 4 * i);
  }
  cp_async_commit();
  for (int i = 0; i < stages - 1; ++i) issue(i);

  if constexpr (kCov) {
    // W'[u] (window slot u = tap t - ks + kHalo; zero rows outside the
    // conv's taps) and b' = conv_b . w_loc + b_loc.  Thread (jp, h4) sums
    // rows j = jp, jp + NJP, ... of w_loc, a float4 of h, loaded 8 rows at
    // a time (the first 8 in flight since the prologue began); the shares
    // meet in red.
    float4 acc[kTaps + 1];
#pragma unroll
    for (int u = 0; u <= kTaps; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    cp_async_wait(stages - 1);  // the prologue's group
    __syncthreads();
    for (int m0 = 0; m0 < MJ; m0 += 8) {
      if (m0 > 0) load_rows(m0);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if (m0 + m < MJ) {
          const int j = jp + NJP * (m0 + m);
#pragma unroll
          for (int u = 0; u <= kTaps; ++u) {
            const float c = cw_s[u * Kl + j];
            acc[u].x = fmaf(c, wl[m].x, acc[u].x);
            acc[u].y = fmaf(c, wl[m].y, acc[u].y);
            acc[u].z = fmaf(c, wl[m].z, acc[u].z);
            acc[u].w = fmaf(c, wl[m].w, acc[u].w);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u <= kTaps; ++u) {
      reinterpret_cast<float4*>(red + (jp * (kTaps + 1) + u) * H)[h4] = acc[u];
    }
    if (warp == 0) {
      float sum = 0.f;
      for (int h = lane; h < H; h += 32) sum += ws_s[h];
      sum = warp_sum(sum);
      if (lane == 0) *sum_ws_s = sum;
    }
    __syncthreads();
    for (int i = tid; i < (kTaps + 1) * H; i += kThreads) {
      const int u = i / H, h = i % H;
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < NJP; ++p) sum += red[(p * (kTaps + 1) + u) * H + h];
      if (u < kTaps) {
        w_s[u * H + h] = sum * kTwoOverLn2;
      } else {
        o_blk[h] = sum + o_blk[h];  // b' (o_blk held b_loc)
      }
    }
  } else {
    cp_async_wait(stages - 1);  // the prologue's group
    __syncthreads();
    for (int i = tid; i < Kl * H; i += kThreads) w_s[i] *= kTwoOverLn2;
    if (warp == 0) {
      float sum = 0.f;
      for (int h = lane; h < H; h += 32) sum += ws_s[h];
      sum = warp_sum(sum);
      if (lane == 0) *sum_ws_s = sum;
    }
  }
  __syncthreads();
  for (int i = tid; i < Kz * H; i += kThreads) qb_s[i] = (qb_s[i] + o_blk[i % H]) * kTwoOverLn2;
  for (int h = tid; h < H; h += kThreads) ws_s[h] *= -2.f;
  __syncthreads();
  const float sum_ws = *sum_ws_s;

  // ---- scores, a ring tile at a time
  {
    const int items = tile * (Kz / G);
    int HS = kThreads / items;
    HS = HS >= 8 ? 8 : HS >= 4 ? 4 : HS >= 2 ? 2 : 1;
    for (int i = 0; i < nt_p; ++i) {
      cp_async_wait(stages - 2);
      __syncthreads();  // tile i landed for all; everyone is done with tile i - 1
      issue(i + stages - 1);
      const unsigned char* buf = ring + (i % stages) * L.stage;
      const float* loc_tile = reinterpret_cast<const float*>(buf + up16(tile * RS));
      score_tile<T, H, G, kCov>(buf, loc_tile, w_s, qb_s, ws_s, win_s, sc_s, sum_ws, chunk,
                                i * tile, min(tile, n_sc - i * tile), tile, Kz, Kl, HS, tid);
    }
  }
  for (int k = 0; k < Kz; ++k) {
    for (int s = n_sc + tid; s < n_local; s += kThreads) sc_s[k * chunk + s] = kNegInf;
  }
  __syncthreads();

  // ---- softmax over S, in f32: row maxima, then row sums, over the cluster
  for (int k = warp; k < Kz; k += kWarps) {
    float m = -INFINITY;
    for (int s = lane; s < n_local; s += 32) m = fmaxf(m, sc_s[k * chunk + s]);
    m = warp_max(m);
    if (lane == 0) blk_max[k] = m;
  }
  cluster_sync();
  if (tid < Kz) {  // every rank's value in flight at once
    float v[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      v[c] = c < C ? *cluster.map_shared_rank(blk_max + tid, c) : -INFINITY;
    }
    float m = v[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c) m = fmaxf(m, v[c]);
    gmax[tid] = m;
  }
  __syncthreads();
  for (int k = warp; k < Kz; k += kWarps) {
    const float m = gmax[k];
    float sum = 0.f;
    for (int s = lane; s < n_local; s += 32) {
      const float x = expf(sc_s[k * chunk + s] - m);
      sc_s[k * chunk + s] = x;
      sum += x;
    }
    sum = warp_sum(sum);
    if (lane == 0) blk_sum[k] = sum;
  }
  cluster_sync();
  if (tid < Kz) {
    float v[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      v[c] = c < C ? *cluster.map_shared_rank(blk_sum + tid, c) : 0.f;
    }
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) sum += v[c];  // in rank order
    gsum[tid] = sum;
  }
  __syncthreads();
  // alpha = e / sum, correctly rounded in the normal range: q = e * (1/sum)
  // and one FMA step on its remainder
  for (int k = 0; k < Kz; ++k) {
    const float sum = gsum[k];
    const float inv = 1.f / sum;
    for (int s = tid; s < n_local; s += kThreads) {
      const float e = sc_s[k * chunk + s];
      const float q0 = e * inv;
      const float a = fmaf(fmaf(-q0, sum, e), inv, q0);
      sc_s[k * chunk + s] = a;
      alpha[(row0 + k) * S + lo + s] = a;
    }
  }

  // ---- context: thread (pg, d4) takes a float4 of D over positions pg,
  // pg + NPG, ... of each enc tile, for every beam
  constexpr int NPG = kThreads / NC;
  const int d4 = tid % NC, pg = tid / NC;
  float acc[kMaxQ][4];
#pragma unroll
  for (int k = 0; k < kMaxQ; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
  for (int i = nt_p; i < n_stream; ++i) {
    cp_async_wait(stages - 2);
    __syncthreads();  // also orders the alpha writes above before the first tile
    issue(i + stages - 1);
    const unsigned char* buf = ring + (i % stages) * L.stage;
    const int p0 = (i - nt_p) * tile;
    const int np = min(tile, n_cx - p0);
    for (int r = pg; r < np; r += NPG) {
      const float4 v = load4<T>(buf + r * RS + d4 * 4 * ELEM);
      const float* a = sc_s + p0 + r;
      // beams in groups of G (Kz is a multiple of G): one test a group
#pragma unroll
      for (int k0 = 0; k0 + G <= kMaxQ; k0 += G) {
        if (k0 >= Kz) break;
#pragma unroll
        for (int k = k0; k < k0 + G; ++k) {
          const float al = a[k * chunk];
          acc[k][0] = fmaf(al, v.x, acc[k][0]);
          acc[k][1] = fmaf(al, v.y, acc[k][1]);
          acc[k][2] = fmaf(al, v.z, acc[k][2]);
          acc[k][3] = fmaf(al, v.w, acc[k][3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // the position groups' sums meet in red, KB beams at a time
  constexpr int KB = kRedFloats / (NPG * D);
  for (int k0 = 0; k0 < Kz; k0 += KB) {
#pragma unroll
    for (int k = 0; k < kMaxQ; ++k) {
      if (k >= k0 && k < k0 + KB && k < Kz) {
        reinterpret_cast<float4*>(red + (pg * KB + k - k0) * D)[d4] =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      }
    }
    __syncthreads();
    for (int j = tid; j < min(KB, Kz - k0) * D; j += kThreads) {
      const int kk = j / D, d = j % D;
      float x = 0.f;
#pragma unroll
      for (int p = 0; p < NPG; ++p) x += red[(p * KB + kk) * D + d];
      o_blk[(k0 + kk) * D + d] = x;
    }
    __syncthreads();
  }
  // the cluster's blocks' sums, in rank order; rank r writes the r-th share
  cluster_sync();
  const int n_out = Kz * D;
  const int share = (n_out + C - 1) / C;
  for (int j = rank * share + tid; j < min(n_out, (rank + 1) * share); j += kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      v[c] = c >= C ? 0.f : C == 1 ? o_blk[j] : *cluster.map_shared_rank(o_blk + j, c);
    }
    float x = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) x += v[c];  // in rank order
    ctx[(row0 + j / D) * D + j % D] = x;
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

template <typename T, int H, int G, int FORM>
int launch_g(const void* enc, const void* enc_proj, const void* q, const void* loc,
             const void* conv_w, const void* conv_b, const void* w_loc, const void* b_loc,
             const void* w_score, void* ctx, void* alpha, int Bs, int K, int Kz, int S, int Kl,
             int taps, int valid, int cluster, int chunk, int zsplit, int tile, int stages,
             int smem_bytes, cudaStream_t stream) {
  auto kernel = attention_step_kernel<T, H, G, FORM>;
  // once per instance, at its first launch (so outside any graph capture
  // that follows a warm-up call)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, Bs, zsplit);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(enc), static_cast<const T*>(enc_proj),
      static_cast<const float*>(q), static_cast<const float*>(loc),
      static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
      static_cast<const float*>(w_loc), static_cast<const float*>(b_loc),
      static_cast<const float*>(w_score), static_cast<float*>(ctx), static_cast<float*>(alpha),
      K, Kz, S, Kl, taps, valid, chunk, tile, stages);
}

// G = beams an item holds: 5 where the block's beams come in fives (beam 5
// and 10), else 1
template <typename T, int H, int FORM>
int launch_h(const void* enc, const void* enc_proj, const void* q, const void* loc,
             const void* conv_w, const void* conv_b, const void* w_loc, const void* b_loc,
             const void* w_score, void* ctx, void* alpha, int Bs, int K, int Kz, int S, int Kl,
             int taps, int valid, int cluster, int chunk, int zsplit, int tile, int stages,
             int smem_bytes, cudaStream_t s) {
  if (Kz % 5 == 0) {
    return launch_g<T, H, 5, FORM>(enc, enc_proj, q, loc, conv_w, conv_b, w_loc, b_loc, w_score,
                                   ctx, alpha, Bs, K, Kz, S, Kl, taps, valid, cluster, chunk,
                                   zsplit, tile, stages, smem_bytes, s);
  }
  return launch_g<T, H, 1, FORM>(enc, enc_proj, q, loc, conv_w, conv_b, w_loc, b_loc, w_score,
                                 ctx, alpha, Bs, K, Kz, S, Kl, taps, valid, cluster, chunk, zsplit,
                                 tile, stages, smem_bytes, s);
}

template <int FORM>
int launch(const void* enc, const void* enc_proj, const void* q, const void* loc,
           const void* conv_w, const void* conv_b, const void* w_loc, const void* b_loc,
           const void* w_score, void* ctx, void* alpha, int Bs, int K, int S, int D, int H,
           int Kl, int taps, int valid, int dtype, int cluster, int chunk, int zsplit, int tile,
           int stages, int smem_bytes, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  const int Kz = zsplit > 0 ? K / zsplit : 0;
  if (Bs <= 0 || Bs > 65535 || K <= 0 || S <= 0 || Kl <= 0 || D != H ||
      (H != 128 && H != 256) || (dtype != 0 && dtype != 2) || zsplit <= 0 ||
      zsplit > 65535 || K % zsplit != 0 || Kz > kMaxQ || cluster <= 0 ||
      cluster > kMaxCluster || chunk <= 0 || (long)cluster * chunk < S ||
      (long)(cluster - 1) * chunk >= S || (tile != 16 && tile != 32) || stages < 2 ||
      stages > kMaxStages || smem_bytes > kMaxSmem ||
      smem_bytes < make_layout(FORM, Kz, chunk, tile, stages, H, Kl, elem).total) {
    return (int)cudaErrorInvalidValue;
  }
  if (FORM == kCoverage ? (taps < 1 || taps > kTaps || taps % 2 == 0) : Kl % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
#define D2T_ARGS enc, enc_proj, q, loc, conv_w, conv_b, w_loc, b_loc, w_score, ctx, alpha, Bs, K, \
                 Kz, S, Kl, taps, valid, cluster, chunk, zsplit, tile, stages, smem_bytes, s
  if (dtype == 0) {
    rc = H == 128 ? launch_h<float, 128, FORM>(D2T_ARGS) : launch_h<float, 256, FORM>(D2T_ARGS);
  } else {
    rc = H == 128 ? launch_h<__nv_bfloat16, 128, FORM>(D2T_ARGS)
                  : launch_h<__nv_bfloat16, 256, FORM>(D2T_ARGS);
  }
#undef D2T_ARGS
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of enc and enc_proj: 0 = float32, 2 = bfloat16.  valid < 0 means no
// mask.  K = beams per sample (rows of q / Bs).  (cluster, chunk, zsplit,
// tile, stages, smem_bytes) is the wrapper's launch plan: blocks per
// cluster along S, positions per block, beam groups per sample, positions
// per ring tile (16 or 32), ring tiles, and dynamic shared memory per
// block.  Returns 0, or the CUDA error of the launch, or
// cudaErrorInvalidValue for what the kernel does not take.

// feature form: loc_feat (Bs*K, S, Kl), Kl a multiple of 4
extern "C" int d2t_attention_step_features(const void* enc, const void* enc_proj, const void* q,
                                           const void* loc_feat, const void* w_loc,
                                           const void* b_loc, const void* w_score, void* ctx,
                                           void* alpha, int Bs, int K, int S, int D, int H, int Kl,
                                           int valid, int dtype, int cluster, int chunk,
                                           int zsplit, int tile, int stages, int smem_bytes,
                                           void* stream) {
  return launch<kFeature>(enc, enc_proj, q, loc_feat, nullptr, nullptr, w_loc, b_loc, w_score,
                          ctx, alpha, Bs, K, S, D, H, Kl, 0, valid, dtype, cluster, chunk,
                          zsplit, tile, stages, smem_bytes, stream);
}

// coverage form: mem (Bs*K, S), loc_conv_w (taps, 1, Kl), loc_conv_b (Kl),
// taps = 2 * kernel_size + 1 <= 5
extern "C" int d2t_attention_step_coverage(const void* enc, const void* enc_proj, const void* q,
                                           const void* mem, const void* loc_conv_w,
                                           const void* loc_conv_b, const void* w_loc,
                                           const void* b_loc, const void* w_score, void* ctx,
                                           void* alpha, int Bs, int K, int S, int D, int H, int Kl,
                                           int taps, int valid, int dtype, int cluster, int chunk,
                                           int zsplit, int tile, int stages, int smem_bytes,
                                           void* stream) {
  return launch<kCoverage>(enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, b_loc, w_score,
                           ctx, alpha, Bs, K, S, D, H, Kl, taps, valid, dtype, cluster, chunk,
                           zsplit, tile, stages, smem_bytes, stream);
}
