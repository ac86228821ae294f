// Backward of the coverage-attention step (csrc/attention_step.cu) at K = 1,
// in its coverage and content forms, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package trains the LSTM head by letting
// jax.grad differentiate its plain XLA step (doc2tex_tpu/models/
// decoder_lstm.py:196-304); its Pallas kernel (B2) has no backward.  The
// port's step runs the forward kernel on the card, which autograd cannot see
// through, so this kernel is the backward of ops/attention_step.py's
// CoverageAttentionStepFn and ContentAttentionStepFn.
//
// Per row b (one sample, K = 1) and position s, in the coverage form with
// the forward's fold of the location conv into w_loc,
//   W'[t,h] = sum_j conv_w[t,j] w_loc[j,h]     b'[h] = sum_j conv_b[j] w_loc[j,h] + b_loc[h]
//   m_t[s]  = mem[b, s + t - 2]                (zero outside [0, S); a conv of
//                                               fewer than 5 taps sits in the middle)
//   th[s,h] = tanh(enc_proj[b,s,h] + q[b,h] + sum_t m_t[s] W'[t,h] + b'[h])
// (the content form, the bahdanau head: th = tanh(enc_proj + q), no location
// term) and the cotangents g_ctx (B, D) and g_alpha (B, S) of the outputs:
//   ga[s]   = g_alpha[s] + sum_d enc[b,s,d] g_ctx[d]
//   ge[s]   = alpha[s] (ga[s] - sum_s' alpha[s'] ga[s'])
//   gp[s,h] = ge[s] w_score[h] (1 - th[s,h]^2)
//   d enc[b,s,d] = alpha[s] g_ctx[d]    d enc_proj = gp   (the memory's type, rounded once)
//   d q[b,h] = sum_s gp                 d w_score[h] = sum_{b,s} ge th
// and in the coverage form only
//   M[t,h]   = sum_{b,s} m_t[s] gp      P[h] = sum_{b,s} gp = d b_loc
//   d w_loc[j,h]  = sum_t conv_w[t,j] M[t,h] + conv_b[j] P[h]
//   d conv_w[t,j] = sum_h M[t,h] w_loc[j,h]      d conv_b[j] = sum_h P[h] w_loc[j,h]
//   d mem[b,p]    = sum_t R_t[p - t + 2],  R_t[s] = sum_h gp[s,h] W'[t,h]
// The forward's alpha is the only activation it reads: the tanh and the
// location term are recomputed, and after the fold the per-position work is
// 5 taps of H, not Kl features.  D (enc's width) in {128, 256, 512} and H
// (enc_proj's) in {128, 256} are template parameters, each pair an instance.
//
// What bounds it.  At the synthetic recipe's largest launch (32 samples, S
// 623, D = H = 128, bf16 memory) it must read enc, enc_proj, mem, alpha and
// g_alpha and write d enc, d enc_proj and d mem: ~21 MB, 6.2 us of HBM.  Its
// float work after the fold is ~50 H operations a position (~0.13 GFLOP, 2
// us at 67 TFLOP/s), so it is bound by bytes.  Two launches on the caller's
// stream, no atomics in any sum, so two runs on the same inputs give the
// same bits:
//
//   1. main   grid (cluster, row): a thread-block cluster of up to 8 blocks
//      splits a row's S into chunks.  Each block
//      - folds its share of W' and b' (the ranks split H's columns; the
//        shares meet over distributed shared memory after the first
//        cluster barrier), so the fold is done once per row, not once per
//        block;
//      - streams its chunk's enc rows, then its enc_proj rows, through a
//        ring of shared-memory tiles of 32 positions (16-byte cp.async, the
//        next tiles in flight while a tile is worked on);
//      - pass A, per enc tile: a warp takes 4 positions, its lanes a float4
//        of every 128 of D; the 4 dots with g_ctx are summed over the warp
//        in one transposed butterfly (6 shuffles for the 4), ga stays in
//        shared memory, d enc is written from registers;
//      - the row's sum of alpha ga from every rank's partial, in rank order
//        (distributed shared memory), then ge for the chunk;
//      - pass B, per enc_proj tile: a warp takes 4 positions over 128
//        columns of H (at H 256 two warps split a position's columns), so
//        a lane holds 4 columns of W', q + b', w_score and the 7 partial
//        vectors (d q, d w_score, M[5]): ~60 floats at any H.  gp goes to
//        d enc_proj from registers; the 4 positions' 5 tap dots R are
//        summed over the warp in one transposed butterfly (21 shuffles for
//        the 20) into shared memory;
//      - d mem of the chunk from R, the two-position halo read from the
//        neighbouring ranks' shared memory;
//      - the block's partial vectors (its warps' sums in warp order), then
//        the row's over the cluster in rank order, each rank a share: d q,
//        and the row's partials (B, 7 or 2, H) to a workspace;
//   2. finish grid (8, Kl / 16 rounded up), launched while the main pass
//      runs (programmatic dependent launch: its blocks read their inputs,
//      then wait for the main pass's writes): a cluster of 8 blocks spans
//      H, each block H / 8 columns and 16 rows of w_loc.  It sums its
//      columns of the row partials over the rows in row order (P, d
//      w_score, M), writes d w_score, d b_loc and its tile of d w_loc, and
//      its columns' share of d conv_w and d conv_b into rank 0's shared
//      memory, which adds the 8 shares in rank order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHalo = 2;               // the widest location conv: kernel_size 2
constexpr int kTaps = 2 * kHalo + 1;
constexpr int kPW = 4;                 // positions a warp takes at once
constexpr int kTile = kWarps * kPW;    // positions per ring tile
constexpr int kMaxCluster = 8;         // portable cluster size
constexpr int kMaxChunk = 1024;
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;       // 227 KB: the most a block may use on sm_90
constexpr int kFinish = 8;             // finish: blocks (a cluster) spanning H
constexpr int kRows = 16;              // finish: rows of w_loc (Kl) a block takes
constexpr float kTwoOverLn2 = 2.8853900817779268f;  // e^(2x) = 2^(x * 2/ln2)
constexpr float kLn2OverTwo = 0.34657359027997264f;

enum Form { kCoverage = 1, kContent = 2 };

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// the row partials' vectors: d q (= P), d w_score, and M[5] in the coverage form
__host__ __device__ inline int n_vecs(bool cov) { return cov ? 2 + kTaps : 2; }

// Byte offsets of the main kernel's dynamic shared memory.  ops/
// attention_step.py's backward_smem_bytes() is the same arithmetic.
struct Layout {
  int wp, qb, ws, fb, ga, al, win, R, xr, red, misc, ring, stage, total;
};

__host__ __device__ inline Layout make_layout(bool cov, int chunk, int stages, int D, int H,
                                              int elem) {
  Layout L;
  int off = 0;
  L.wp = off;   off += up16(cov ? kTaps * H * 4 : 0);            // W'
  L.qb = off;   off += up16(H * 4);                              // q, then q + b'
  L.ws = off;   off += up16(H * 4);                              // w_score
  L.fb = off;   off += up16(cov ? H * 4 : 0);                    // conv_b . w_loc
  L.ga = off;   off += up16(chunk * 4);                          // g_alpha, ga, then ge
  L.al = off;   off += up16(chunk * 4);                          // alpha
  L.win = off;  off += up16(cov ? (chunk + 2 * kHalo) * 4 : 0);  // mem and its halo
  L.R = off;    off += up16(cov ? (H / 128) * chunk * kTaps * 4 : 0);
  L.xr = off;   off += up16((n_vecs(cov) * H + kMaxCluster) * 4);  // the row's partials by rank
  L.red = off;  off += kWarps * n_vecs(cov) * 128 * 4;            // the warps' partial vectors
  L.misc = off; off += up16((kMaxCluster + 2 * kHalo * kTaps) * 4);  // rank slots, R halo
  L.stage = kTile * (imax(D, H) * elem + 16);
  L.ring = off; off += stages * L.stage;
  L.total = off;
  return L;
}

// 4 consecutive elements of T, float or bfloat16 (16 or 8 bytes, aligned)
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

// rounded once to T (round to nearest even, as a float32 -> bfloat16 cast)
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z), fmaf(a, b.w, c.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
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

// tanh(x) = 1 - 2 / (1 + e^(2x)) from x' = x 2/ln2 (e^(2x) = 2^x'): 2 MUFU
// operations, |error| ~1e-7 (an overflow of 2^x' gives 1, an underflow -1)
__device__ __forceinline__ float tanh_scaled(float xs) {
  return fmaf(-2.f, rcp_approx(1.f + ex2_approx(xs)), 1.f);
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
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// One butterfly level of a transposed warp sum: lanes whose bit `m` is 0
// keep the first h of the c values a lane holds, the others the rest (zero
// past c), each adding its partner's copy of what it keeps.
template <int N>
__device__ __forceinline__ void split_level(float (&v)[N], int c, int h, int m, bool up) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < h) {
      const float hi = k + h < c ? v[k + h] : 0.f;
      const float keep = up ? hi : v[k];
      const float send = up ? v[k] : hi;
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
}

// the 4 positions' dots of pass A summed over the warp: lane l ends with
// the sum of position 2 bit4(l) + bit3(l), complete where l % 8 == 0
__device__ __forceinline__ float warp_sum4(float (&v)[4], int lane) {
  split_level<4>(v, 4, 2, 16, lane & 16);
  split_level<4>(v, 2, 1, 8, lane & 8);
  float x = v[0];
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// the 4 positions' 5 tap dots of pass B (v[p * 5 + t]) summed over the
// warp: lane l ends with position 2 bit4 + bit3 and tap 3 bit2 + 2 bit1 +
// bit0, a tap past the group (3 in the first, 5 and 6 in the second) a pad
__device__ __forceinline__ float warp_sum20(float (&v)[20], int lane) {
  split_level<20>(v, 20, 10, 16, lane & 16);
  split_level<20>(v, 10, 5, 8, lane & 8);
  split_level<20>(v, 5, 3, 4, lane & 4);
  split_level<20>(v, 3, 2, 2, lane & 2);
  split_level<20>(v, 2, 1, 1, lane & 1);
  return v[0];
}

// a column's 6 fold sums (v[4 u + component], u = slot, 5 the b' term)
// summed over the warp: lane l ends with value 12 bit4 + 6 bit3 + 3 bit2 +
// (2 bit1 + bit0), a pad where 2 bit1 + bit0 = 3
__device__ __forceinline__ float warp_sum24(float (&v)[24], int lane) {
  split_level<24>(v, 24, 12, 16, lane & 16);
  split_level<24>(v, 12, 6, 8, lane & 8);
  split_level<24>(v, 6, 3, 4, lane & 4);
  split_level<24>(v, 3, 2, 2, lane & 2);
  split_level<24>(v, 2, 1, 1, lane & 1);
  return v[0];
}

// the cluster barrier in two halves (PTX barrier.cluster): arrive (release
// the thread's writes, or relaxed), then wait (acquire every thread's)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// np rows of W elements of T from src into ring rows of RS bytes, 16 bytes a
// cp.async (W * sizeof(T) / 16 a power of 2)
template <typename T, int W, int RS>
__device__ __forceinline__ void issue_rows(unsigned char* dst, const T* src, int np, int tid) {
  constexpr int CPR = W * (int)sizeof(T) / 16;
  for (int piece = tid; piece < np * CPR; piece += kThreads) {
    const int r = piece / CPR, c = piece % CPR;
    cp_async16(dst + r * RS + c * 16, src + (long)r * W + c * (16 / (int)sizeof(T)));
  }
}

template <typename T, int D, int H, bool COV>
__global__ void __launch_bounds__(kThreads, 2)
b2_bwd_main_kernel(const T* __restrict__ enc, const T* __restrict__ enc_proj,
                   const float* __restrict__ q, const float* __restrict__ mem,
                   const float* __restrict__ conv_w, const float* __restrict__ conv_b,
                   const float* __restrict__ w_loc, const float* __restrict__ b_loc,
                   const float* __restrict__ w_score, const float* __restrict__ alpha,
                   const float* __restrict__ g_ctx, const float* __restrict__ g_alpha,
                   T* __restrict__ d_enc, T* __restrict__ d_enc_proj, float* __restrict__ d_q,
                   float* __restrict__ d_mem, float* __restrict__ rows, int S, int Kl,
                   int taps, int chunk, int stages) {
  constexpr int ELEM = sizeof(T);
  constexpr int V = COV ? 2 + kTaps : 2;
  constexpr int NH = H / 128;          // 128-column halves of H
  constexpr int WPH = kWarps / NH;     // warps a half
  constexpr int NVD = D / 128;         // float4s of D a lane holds
  constexpr int W = D > H ? D : H;
  constexpr int RS = W * ELEM + 16;    // bytes of a ring row
  constexpr int NC = H / 4;            // float4 columns of H
  static_assert(H == 128 || H == 256, "H");
  static_assert(D == 128 || D == 256 || D == 512, "D");

  extern __shared__ __align__(16) unsigned char smem[];
  const int C = gridDim.x;  // the cluster spans x
  const int rank = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  cg::cluster_group cluster = cg::this_cluster();
  // rank c's copy of a shared-memory address (this block's own when c = rank)
  auto peer = [&](float* p, int c) { return c == rank ? p : cluster.map_shared_rank(p, c); };
  // no rank writes another's shared memory before every rank has started
  if (C > 1) cluster_arrive_relaxed();
  // the finish pass may launch now; it waits for this grid's memory
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  const Layout L = make_layout(COV, chunk, stages, D, H, ELEM);
  float* wp_s = reinterpret_cast<float*>(smem + L.wp);
  float* qb_s = reinterpret_cast<float*>(smem + L.qb);
  float* ws_s = reinterpret_cast<float*>(smem + L.ws);
  float* fb_s = reinterpret_cast<float*>(smem + L.fb);
  float* ga_s = reinterpret_cast<float*>(smem + L.ga);
  float* al_s = reinterpret_cast<float*>(smem + L.al);
  float* win_s = reinterpret_cast<float*>(smem + L.win);
  float* R_s = reinterpret_cast<float*>(smem + L.R);      // [half][chunk][tap]
  float* xr_s = reinterpret_cast<float*>(smem + L.xr);    // [rank][share]: the row's partials
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* misc = reinterpret_cast<float*>(smem + L.misc);  // [rank]: alpha ga; halo R below, above
  float* halo_lo = misc + kMaxCluster;
  float* halo_hi = halo_lo + kHalo * kTaps;
  unsigned char* ring = smem + L.ring;

  const int lo = rank * chunk;
  const int n = max(0, min(S - lo, chunk));  // positions the block owns (the last may own none)
  const int nt = (n + kTile - 1) / kTile;    // tiles of each pass
  const long row = (long)b * S + lo;         // the block's first position in (B, S)
  const int ncs = (NC + C - 1) / C;          // float4 columns of a fold share
  const int off = (kTaps - taps) / 2;        // a narrower conv's first window slot
  const int share = (V * H + C - 1) / C;     // the row's partials each rank adds

  // tile i of the stream: enc tiles 0..nt-1, then enc_proj tiles
  auto issue = [&](int i) {
    if (i < nt) {
      const int p0 = i * kTile;
      issue_rows<T, D, RS>(ring + (i % stages) * L.stage, enc + (row + p0) * D,
                           min(kTile, n - p0), tid);
    } else if (i < 2 * nt) {
      const int p0 = (i - nt) * kTile;
      issue_rows<T, H, RS>(ring + (i % stages) * L.stage, enc_proj + (row + p0) * H,
                           min(kTile, n - p0), tid);
    }
    cp_async_commit();
  };

  // ---- prologue: one group of cp.async, the oldest: q, w_score, the
  // chunk's alpha and g_alpha, and its coverage with a halo of kHalo
  // positions each side, zero outside [0, S); then the first ring tiles
  for (int i = tid; i < NC; i += kThreads) {
    cp_async16(qb_s + 4 * i, q + (long)b * H + 4 * i);
    cp_async16(ws_s + 4 * i, w_score + 4 * i);
  }
  for (int s = tid; s < n; s += kThreads) {
    cp_async4(al_s + s, alpha + row + s, true);
    cp_async4(ga_s + s, g_alpha + row + s, true);
  }
  if constexpr (COV) {
    for (int j = tid; j < n + 2 * kHalo; j += kThreads) {
      const int s = lo - kHalo + j;
      const bool live = s >= 0 && s < S;
      cp_async4(win_s + j, live ? mem + (long)b * S + s : mem, live);
    }
  }
  cp_async_commit();
  for (int i = 0; i < stages - 1; ++i) issue(i);

  // ---- the fold of this rank's share of H's float4 columns [c0, c1),
  // while the prologue's loads are in flight: warp w takes columns c0 + w,
  // c0 + w + 8, ...; lane l rows j = l, l + 32, ... of w_loc and of the
  // conv weights (conv_w row t at window slot t + off, zero in the other
  // slots; conv_b at slot kTaps); a column's 24 sums over its lanes in one
  // transposed butterfly
  const int c0 = rank * ncs, c1 = min(NC, c0 + ncs);
  if constexpr (COV) {
    for (int c = c0 + warp; c < c1; c += kWarps) {
      float v[4 * (kTaps + 1)];
#pragma unroll
      for (int k = 0; k < 4 * (kTaps + 1); ++k) v[k] = 0.f;
#pragma unroll 4
      for (int j = lane; j < Kl; j += 32) {
        const float4 wl = __ldg(reinterpret_cast<const float4*>(w_loc + (long)j * H) + c);
#pragma unroll
        for (int u = 0; u <= kTaps; ++u) {
          const int t = u - off;
          const float cv = u == kTaps ? __ldg(conv_b + j)
                           : t >= 0 && t < taps ? __ldg(conv_w + t * Kl + j) : 0.f;
          v[4 * u] = fmaf(cv, wl.x, v[4 * u]);
          v[4 * u + 1] = fmaf(cv, wl.y, v[4 * u + 1]);
          v[4 * u + 2] = fmaf(cv, wl.z, v[4 * u + 2]);
          v[4 * u + 3] = fmaf(cv, wl.w, v[4 * u + 3]);
        }
      }
      const float x = warp_sum24(v, lane);
      const int last = 2 * ((lane >> 1) & 1) + (lane & 1);
      const int k = 12 * ((lane >> 4) & 1) + 6 * ((lane >> 3) & 1) + 3 * ((lane >> 2) & 1) + last;
      if (last < 3) {
        const int u = k / 4;
        (u < kTaps ? wp_s + u * H : fb_s)[4 * c + k % 4] = x;
      }
    }
  }
  cp_async_wait(stages - 1);  // the prologue's group
  __syncthreads();
  if (C > 1) cluster_wait();
  if constexpr (COV) {  // this rank's share of the fold into every other rank's copy
    for (int i = tid; i < (kTaps + 1) * (c1 - c0) * C; i += kThreads) {
      const int k = i / ((kTaps + 1) * (c1 - c0)), e = i % ((kTaps + 1) * (c1 - c0));
      const int u = e / (c1 - c0), c = c0 + e % (c1 - c0);
      if (k != rank) {
        float* p = (u < kTaps ? wp_s + u * H : fb_s) + 4 * c;
        *reinterpret_cast<float4*>(peer(p, k)) = *reinterpret_cast<const float4*>(p);
      }
    }
  }

  // ---- pass A, an enc tile at a time: ga = g_alpha + enc . g_ctx and
  // d enc = alpha g_ctx.  Warp w takes the tile's positions 4w .. 4w + 3.
  {
    float4 g[NVD];
#pragma unroll
    for (int i = 0; i < NVD; ++i) {
      g[i] = __ldg(reinterpret_cast<const float4*>(g_ctx + (long)b * D + i * 128) + lane);
    }
    for (int i = 0; i < nt; ++i) {
      cp_async_wait(stages - 2);
      __syncthreads();  // tile i landed for all; everyone is done with tile i - 1
      issue(i + stages - 1);
      const unsigned char* buf = ring + (i % stages) * L.stage;
      const int p0 = i * kTile;
      const int np = min(kTile, n - p0);
      float d[kPW];
#pragma unroll
      for (int p = 0; p < kPW; ++p) {
        d[p] = 0.f;
        const int pl = kPW * warp + p;
        if (pl < np) {
          const float a = al_s[p0 + pl];
          T* out = d_enc + (row + p0 + pl) * D + 4 * lane;
#pragma unroll
          for (int k = 0; k < NVD; ++k) {
            const float4 e = load4<T>(buf + pl * RS + (k * 128 + 4 * lane) * ELEM);
            d[p] += dot4(e, g[k]);
            store4<T>(out + k * 128, make_float4(a * g[k].x, a * g[k].y, a * g[k].z, a * g[k].w));
          }
        }
      }
      const float x = warp_sum4(d, lane);
      const int pl = kPW * warp + (lane >> 3);
      if ((lane & 7) == 0 && pl < np) ga_s[p0 + pl] += x;
    }
  }
  __syncthreads();
  if (warp == 0) {  // the chunk's sum of alpha ga, in a fixed order, to every rank's slot
    float x = 0.f;
    for (int s = lane; s < n; s += 32) x = fmaf(al_s[s], ga_s[s], x);
    x = warp_sum(x);
    if (lane < C) *peer(misc + rank, lane) = x;
  }

  // ---- the cluster's first exchange: the row's sum of alpha ga from every
  // rank's partial, in rank order, and the whole fold
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  {
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) rs += c < C ? misc[c] : 0.f;
    for (int s = tid; s < n; s += kThreads) ga_s[s] = al_s[s] * (ga_s[s] - rs);  // ge
  }
  if constexpr (COV) {  // q + b', b' = conv_b . w_loc + b_loc
    for (int h = tid; h < H; h += kThreads) qb_s[h] += fb_s[h] + __ldg(b_loc + h);
  }
  __syncthreads();

  // ---- pass B, an enc_proj tile at a time.  Warp w takes columns
  // 128 hh + 4 lane of H (hh = w / WPH) and the tile's batches of 4
  // positions bi = w % WPH, w % WPH + WPH, ...  The tanh's argument is
  // formed scaled by 2/ln2 (q + b' and W' held scaled), and R's dots with
  // the scaled W' are scaled back once
  const int hh = warp / WPH;
  const int h0 = hh * 128 + 4 * lane;
  float4 wp[COV ? kTaps : 1];
  float4 M[COV ? kTaps : 1];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 qb = fma4(kTwoOverLn2, *reinterpret_cast<const float4*>(qb_s + h0), zero);
  const float4 ws = *reinterpret_cast<const float4*>(ws_s + h0);
  float4 dq = zero, dws = zero;
#pragma unroll
  for (int t = 0; t < (COV ? kTaps : 1); ++t) {
    wp[t] = COV ? fma4(kTwoOverLn2, *reinterpret_cast<const float4*>(wp_s + t * H + h0), zero)
                : zero;
    M[t] = zero;
  }
  for (int i = nt; i < 2 * nt; ++i) {
    cp_async_wait(stages - 2);
    __syncthreads();
    issue(i + stages - 1);
    const unsigned char* buf = ring + (i % stages) * L.stage;
    const int p0 = (i - nt) * kTile;
    const int np = min(kTile, n - p0);
    for (int bi = warp % WPH; bi * kPW < np; bi += WPH) {
      float r[kPW * kTaps];
#pragma unroll
      for (int k = 0; k < kPW * kTaps; ++k) r[k] = 0.f;
#pragma unroll
      for (int p = 0; p < kPW; ++p) {
        const int pl = bi * kPW + p;
        if (pl < np) {
          const int s = p0 + pl;
          const float ge = ga_s[s];
          float4 x = fma4(kTwoOverLn2, load4<T>(buf + pl * RS + h0 * ELEM), qb);
          float m[kTaps];
          if constexpr (COV) {
#pragma unroll
            for (int t = 0; t < kTaps; ++t) {
              m[t] = win_s[s + t];
              x = fma4(m[t], wp[t], x);
            }
          }
          const float4 th = make_float4(tanh_scaled(x.x), tanh_scaled(x.y), tanh_scaled(x.z),
                                        tanh_scaled(x.w));
          const float4 gp = make_float4(ge * ws.x * fmaf(-th.x, th.x, 1.f),
                                        ge * ws.y * fmaf(-th.y, th.y, 1.f),
                                        ge * ws.z * fmaf(-th.z, th.z, 1.f),
                                        ge * ws.w * fmaf(-th.w, th.w, 1.f));
          store4<T>(d_enc_proj + (row + s) * H + h0, gp);
          dq = add4(dq, gp);
          dws = fma4(ge, th, dws);
          if constexpr (COV) {
#pragma unroll
            for (int t = 0; t < kTaps; ++t) {
              M[t] = fma4(m[t], gp, M[t]);
              r[p * kTaps + t] = dot4(gp, wp[t]);
            }
          }
        }
      }
      if constexpr (COV) {
        const float x = warp_sum20(r, lane);
        const int p = lane >> 3;
        const int t = (lane & 4 ? 3 : 0) + (lane & 3);
        const int pl = bi * kPW + p;
        if (t < (lane & 4 ? kTaps : 3) && pl < np) {
          R_s[(hh * chunk + p0 + pl) * kTaps + t] = x * kLn2OverTwo;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // ---- the block's partial vectors: each warp's, then their sums over the
  // warps of each half in warp order, each to the rank that adds it; the
  // chunk's first and last kHalo positions' R to the neighbouring ranks
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float4 x = v == 0 ? dq : v == 1 ? dws : M[v >= 2 ? v - 2 : 0];
    reinterpret_cast<float4*>(red + (warp * V + v) * 128)[lane] = x;
  }
  __syncthreads();
  for (int e = tid; e < V * H; e += kThreads) {
    const int v = e / H, h = e % H;
    const int half = h / 128, c = h % 128;
    float x = 0.f;
#pragma unroll
    for (int k = 0; k < WPH; ++k) x += red[((half * WPH + k) * V + v) * 128 + c];
    const int owner = e / share;
    *peer(xr_s + rank * share + e - owner * share, owner) = x;
  }
  if constexpr (COV) {
    if (C > 1 && tid < 2 * kHalo * kTaps) {
      const bool up = tid >= kHalo * kTaps;  // the last positions, to rank + 1
      const int k = tid % (kHalo * kTaps), s = (up ? n - kHalo : 0) + k / kTaps;
      const int to = up ? rank + 1 : rank - 1;
      if (to >= 0 && to < C && s >= 0 && s < n) {
        float x = 0.f;
#pragma unroll
        for (int hh2 = 0; hh2 < NH; ++hh2) x += R_s[(hh2 * chunk + s) * kTaps + k % kTaps];
        *peer((up ? halo_lo : halo_hi) + k, to) = x;
      }
    }
  }

  // ---- the cluster's second exchange: d mem from R (the halo from the
  // neighbouring ranks), and this rank's share of the row's partial vectors
  // over the ranks in rank order.  Nothing is read from another rank after it
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if constexpr (COV) {
    for (int s = tid; s < n; s += kThreads) {
      float x = 0.f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const int qs = s - t + kHalo;  // the chunk's position whose tap t reads s
        if (lo + qs >= 0 && lo + qs < S) {
          if (qs < 0) {
            x += halo_lo[(qs + kHalo) * kTaps + t];
          } else if (qs >= n) {
            x += halo_hi[(qs - n) * kTaps + t];
          } else {
#pragma unroll
            for (int hh2 = 0; hh2 < NH; ++hh2) x += R_s[(hh2 * chunk + qs) * kTaps + t];
          }
        }
      }
      d_mem[row + s] = x;
    }
  }
  for (int e = rank * share + tid; e < min(V * H, (rank + 1) * share); e += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) x += c < C ? xr_s[c * share + e - rank * share] : 0.f;
    rows[(long)b * V * H + e] = x;
    if (e < H) d_q[(long)b * H + e] = x;
  }
}

// launch 2: see the head of the file.  A cluster of kFinish blocks spans
// H, each KC columns; blockIdx.y takes kRows rows of w_loc (Kl).
template <int H, bool COV>
__global__ void __launch_bounds__(kThreads)
b2_bwd_finish_kernel(const float* __restrict__ rows, const float* __restrict__ conv_w,
                     const float* __restrict__ conv_b, const float* __restrict__ w_loc,
                     float* __restrict__ d_conv_w, float* __restrict__ d_conv_b,
                     float* __restrict__ d_w_loc, float* __restrict__ d_b_loc,
                     float* __restrict__ d_w_score, int B, int Kl, int taps) {
  constexpr int V = COV ? 2 + kTaps : 2;
  constexpr int KC = H / kFinish;
  constexpr int NS = V * KC;  // the block's column sums
  // TPS threads a column sum, each over the rows r = k mod TPS in row
  // order, then the TPS partials in order
  constexpr int TPS = kThreads / NS >= 8 ? 8 : kThreads / NS >= 4 ? 4 : kThreads / NS >= 2 ? 2 : 1;
  __shared__ float col_s[V][KC];
  __shared__ float psum[TPS][NS];
  __shared__ float wl_s[kRows][KC + 1];
  __shared__ float conv_s[kRows][kTaps + 1];  // conv_w at its window slots, conv_b at kTaps
  __shared__ float part_s[kFinish][(kTaps + 1) * kRows];  // rank 0's: every rank's d conv share
  const int tid = threadIdx.x;
  const int hx = blockIdx.x, jy = blockIdx.y;  // hx: the block's rank in its cluster
  const int h0 = hx * KC, j0 = jy * kRows;
  const int off = (kTaps - taps) / 2;
  if constexpr (COV) {
    cluster_arrive_relaxed();
    // inputs, not the main pass's: read before the wait
    for (int e = tid; e < kRows * KC; e += kThreads) {
      const int jj = e / KC, c = e % KC, j = j0 + jj;
      wl_s[jj][c] = j < Kl ? w_loc[(long)j * H + h0 + c] : 0.f;
    }
    for (int e = tid; e < kRows * (kTaps + 1); e += kThreads) {
      const int jj = e / (kTaps + 1), u = e % (kTaps + 1), j = j0 + jj, t = u - off;
      conv_s[jj][u] = j >= Kl ? 0.f
                      : u == kTaps ? conv_b[j]
                      : t >= 0 && t < taps ? conv_w[t * Kl + j] : 0.f;
    }
  }
  // launched early (programmatic dependent launch): wait until the main
  // pass has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int e = tid; e < TPS * NS; e += kThreads) {
    const int k = e / NS, i = e % NS, v = i / KC, c = i % KC;
    float x = 0.f;
#pragma unroll 16
    for (int r = k; r < B; r += TPS) x += rows[((long)r * V + v) * H + h0 + c];
    psum[k][i] = x;
  }
  __syncthreads();
  for (int i = tid; i < NS; i += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int k = 0; k < TPS; ++k) x += psum[k][i];
    col_s[i / KC][i % KC] = x;
  }
  __syncthreads();
  if (jy == 0 && tid < KC) {
    d_w_score[h0 + tid] = col_s[1][tid];
    if constexpr (COV) d_b_loc[h0 + tid] = col_s[0][tid];
  }
  if constexpr (COV) {
    for (int e = tid; e < kRows * KC; e += kThreads) {
      const int jj = e / KC, c = e % KC, j = j0 + jj;
      if (j < Kl) {
        float x = 0.f;
#pragma unroll
        for (int u = 0; u < kTaps; ++u) x = fmaf(conv_s[jj][u], col_s[2 + u][c], x);
        d_w_loc[(long)j * H + h0 + c] = fmaf(conv_s[jj][kTaps], col_s[0][c], x);
      }
    }
    // this block's columns' share of d conv_w[t, j] (u = t < taps) and
    // d conv_b[j] (u = taps), to rank 0, which adds the ranks' in order
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
    for (int o = tid; o < (taps + 1) * kRows; o += kThreads) {
      const int u = o / kRows, jj = o % kRows;
      const float* vec = u < taps ? col_s[2 + u + off] : col_s[0];
      float x = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) x = fmaf(vec[c], wl_s[jj][c], x);
      cluster.map_shared_rank(&part_s[0][0], 0)[hx * (kTaps + 1) * kRows + o] = x;
    }
    cluster_arrive();
    cluster_wait();
    if (hx == 0) {
      for (int o = tid; o < (taps + 1) * kRows; o += kThreads) {
        const int u = o / kRows, j = j0 + o % kRows;
        if (j >= Kl) continue;
        float x = 0.f;
#pragma unroll
        for (int k = 0; k < kFinish; ++k) x += part_s[k][o];  // in rank order
        if (u < taps) {
          d_conv_w[u * Kl + j] = x;
        } else {
          d_conv_b[j] = x;
        }
      }
    }
  }
}

// the workspace's floats, the rows' partial vectors: ops/attention_step.py's
// backward_workspace_floats
size_t workspace_floats(bool cov, int B, int H) { return (size_t)B * n_vecs(cov) * H; }

// the arguments of one call, and launching its two passes at an instance
struct Launch {
  const void *enc, *enc_proj, *q, *mem, *conv_w, *conv_b, *w_loc, *b_loc, *w_score, *alpha,
      *g_ctx, *g_alpha;
  void *d_enc, *d_enc_proj, *d_q, *d_mem, *d_conv_w, *d_conv_b, *d_w_loc, *d_b_loc, *d_w_score;
  float* work;
  int B, S, Kl, taps, cluster, chunk, stages;
  cudaStream_t stream;

  template <typename T, int D, int H, bool COV>
  int run() const {
    auto kernel = b2_bwd_main_kernel<T, D, H, COV>;
    // once per instance, at its first launch (so outside any graph capture
    // that follows a warm-up call)
    static const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    const Layout L = make_layout(COV, chunk, stages, D, H, sizeof(T));
    if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
    float* rows = work;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, B, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = L.total;
    cfg.stream = stream;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    cudaError_t rc = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(enc), static_cast<const T*>(enc_proj),
        static_cast<const float*>(q), static_cast<const float*>(mem),
        static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
        static_cast<const float*>(w_loc), static_cast<const float*>(b_loc),
        static_cast<const float*>(w_score), static_cast<const float*>(alpha),
        static_cast<const float*>(g_ctx), static_cast<const float*>(g_alpha),
        static_cast<T*>(d_enc), static_cast<T*>(d_enc_proj), static_cast<float*>(d_q),
        static_cast<float*>(d_mem), rows, S, Kl, taps, chunk, stages);
    if (rc != cudaSuccess) return (int)rc;
    // the finish pass, launched while the main pass runs (its blocks wait);
    // in the coverage form each kFinish blocks along H are a cluster
    cudaLaunchConfig_t fin = {};
    fin.gridDim = dim3(kFinish, COV ? (Kl + kRows - 1) / kRows : 1, 1);
    fin.blockDim = dim3(kThreads, 1, 1);
    fin.stream = stream;
    cudaLaunchAttribute fat[2];
    fat[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    fat[0].val.programmaticStreamSerializationAllowed = 1;
    fat[1].id = cudaLaunchAttributeClusterDimension;
    fat[1].val.clusterDim.x = kFinish;
    fat[1].val.clusterDim.y = 1;
    fat[1].val.clusterDim.z = 1;
    fin.attrs = fat;
    fin.numAttrs = COV ? 2 : 1;
    rc = cudaLaunchKernelEx(
        &fin, b2_bwd_finish_kernel<H, COV>, static_cast<const float*>(rows),
        static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
        static_cast<const float*>(w_loc), static_cast<float*>(d_conv_w),
        static_cast<float*>(d_conv_b), static_cast<float*>(d_w_loc),
        static_cast<float*>(d_b_loc), static_cast<float*>(d_w_score), B, Kl, taps);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
  }
};

// how many clusters of the main pass's instance fit the card at once
struct Occupancy {
  int cluster, smem;
  int* out;

  template <typename T, int D, int H, bool COV>
  int run() const {
    auto kernel = b2_bwd_main_kernel<T, D, H, COV>;
    cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc == cudaSuccess && cluster > kMaxCluster) {
      rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (rc != cudaSuccess) return (int)rc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
  }
};

// op.run<T, D, H, COV>() at the instance of the memory's type, D, H and form
template <bool COV, typename T, typename Op>
int dispatch_dh(const Op& op, int D, int H) {
  if (H == 128) {
    if (D == 128) return op.template run<T, 128, 128, COV>();
    if (D == 256) return op.template run<T, 256, 128, COV>();
    return op.template run<T, 512, 128, COV>();
  }
  if (D == 128) return op.template run<T, 128, 256, COV>();
  if (D == 256) return op.template run<T, 256, 256, COV>();
  return op.template run<T, 512, 256, COV>();
}

template <typename Op>
int dispatch(const Op& op, bool cov, int dtype, int D, int H) {
  if (dtype == 0) {
    return cov ? dispatch_dh<true, float>(op, D, H) : dispatch_dh<false, float>(op, D, H);
  }
  return cov ? dispatch_dh<true, __nv_bfloat16>(op, D, H)
             : dispatch_dh<false, __nv_bfloat16>(op, D, H);
}

bool widths_ok(int form, int D, int H, int dtype) {
  return (form == kCoverage || form == kContent) && (D == 128 || D == 256 || D == 512) &&
         (H == 128 || H == 256) && (dtype == 0 || dtype == 2);
}

}  // namespace

// B2's backward at K = 1.  form: 1 = coverage, 2 = content.  enc (B,S,D)
// and enc_proj (B,S,H) in the memory's type (dtype 0 = float32, 2 =
// bfloat16), q (B,H), alpha, g_alpha (B,S), g_ctx (B,D), w_score (H)
// float32; in the coverage form also mem (B,S), conv_w (taps,1,Kl), conv_b
// (Kl), w_loc (Kl,H), b_loc (H), null in the content form with Kl = taps =
// 0, as are its d mem, d conv_w, d conv_b, d w_loc and d b_loc.  d enc and
// d enc_proj come out in the memory's type, the rest float32 in the shapes
// of their inputs.  work: `ws_floats` floats of scratch (workspace_floats).
// (cluster, chunk, stages): blocks per row along S, positions per block
// (the last ranks may own none: they fold their share of W' all the same),
// ring tiles (ops/attention_step.py's backward_plan).  D in {128, 256,
// 512}, H in {128, 256}, taps odd and at most 5; contiguous and 16-byte aligned.  Returns 0, the CUDA error of a launch,
// or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int d2t_attention_step_backward(
    int form, const void* enc, const void* enc_proj, const void* q, const void* mem,
    const void* conv_w, const void* conv_b, const void* w_loc, const void* w_score,
    const void* b_loc, const void* alpha, const void* g_ctx, const void* g_alpha, void* d_enc,
    void* d_enc_proj, void* d_q, void* d_mem, void* d_conv_w, void* d_conv_b, void* d_w_loc,
    void* d_b_loc, void* d_w_score, void* work, long long ws_floats, int B, int S, int D, int H,
    int Kl, int taps, int dtype, int cluster, int chunk, int stages, void* stream) {
  const bool cov = form == kCoverage;
  if (!widths_ok(form, D, H, dtype) || B <= 0 || B > 65535 || S <= 0 ||
      (cov ? (Kl <= 0 || taps < 1 || taps > kTaps || taps % 2 == 0)
           : (Kl != 0 || taps != 0)) ||
      cluster <= 0 || cluster > kMaxCluster || chunk < kHalo || chunk > kMaxChunk ||
      (long)cluster * chunk < S || stages < 2 ||
      stages > kMaxStages || ws_floats < 0 || (size_t)ws_floats < workspace_floats(cov, B, H)) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch op{enc,    enc_proj, q,        mem,        conv_w,   conv_b,  w_loc,
                  b_loc,  w_score,  alpha,    g_ctx,      g_alpha,  d_enc,   d_enc_proj,
                  d_q,    d_mem,    d_conv_w, d_conv_b,   d_w_loc,  d_b_loc, d_w_score,
                  static_cast<float*>(work), B, S, Kl, taps, cluster, chunk, stages,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(op, cov, dtype, D, H);
}

// The most clusters of `cluster` blocks, each with `smem` bytes of dynamic
// shared memory, of the main pass's instance at (form, D, H, dtype) that
// the card holds at once, into *out (cudaOccupancyMaxActiveClusters; above
// 8 blocks as a non-portable size).  Returns 0 or the CUDA error.
extern "C" int d2t_attention_step_backward_clusters(int form, int D, int H, int dtype,
                                                    int cluster, int smem, int* out) {
  if (!widths_ok(form, D, H, dtype) || cluster <= 0 || cluster > 16 || smem < 0 ||
      smem > kMaxSmem || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch(Occupancy{cluster, smem, out}, form == kCoverage, dtype, D, H);
}
