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
// in one of three forms of the location term, a template parameter:
//   - feature form, the TPU kernel's input for input:
//       locH[r,s,h] = sum_j loc_feat[r,s,j] * w_loc[j,h] + b_loc[h]     (j < Kl)
//   - coverage form, the location conv of the decoder folded in.  Conv then
//     w_loc is linear in the coverage mem (B*K, S), so with
//       W'[t,h] = sum_j loc_conv_w[t,0,j] * w_loc[j,h]                  (t < 2*ks+1)
//       b'[h]   = sum_j loc_conv_b[j] * w_loc[j,h] + b_loc[h]
//     locH[r,s,h] = sum_t mem[r, s+t-ks] * W'[t,h] + b'[h], mem zero outside
//     [0, S) (the conv's zero padding) and read at every position, those at
//     or past valid included.  Each block computes W' and b' in its prologue.
//   - content form, no location term (locH = 0): the bahdanau head, whose
//     reference step adds a location of 0.0.
// Every form takes the memory at sample rows: enc (Bs,S,D) and enc_proj
// (Bs,S,H) in float or bfloat16; q (Bs*K,H) and everything else float; ctx
// (Bs*K,D), alpha (Bs*K,S).  With K = 1 each form is the TPU kernel's
// contract, whose D and H are independent: H in {128, 256} (a template
// parameter), D in {128, 256, 512} (enc's rows stream through the same ring
// at D, and the context's threads split D).  Contiguous, 16-byte aligned.
//
// Two builds of this file.  The plain one holds the feature and coverage
// forms at D = H, with D a compile-time constant (the template parameter
// DT = H), and refuses D != H and the content form.  Built with
// -DD2T_ATTENTION_STEP_WIDE it holds the three forms with D a run-time
// width (DT = 0).  ops/attention_step.py loads the plain build for D = H
// and the wide one for D != H and for the content form; the two are
// compiled at once, each by its own nvcc.
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
//   - prologue: the weights first (the w_loc rows for W' into registers,
//     then one cp.async group of w_score, b_loc and the conv weights), then
//     the step's own inputs (q's rows, the coverage rows with their halo),
//     then the memory;
//   - the memory, by 16-byte cp.async, in one of two ways (stages):
//       whole chunk (stages 0, the plans of the content and int8 forms where
//       two such blocks fit an SM): every enc_proj tile and every enc row
//       of the block's chunk is issued in the prologue, so a block waits
//       one memory latency, not one a tile; each enc_proj tile is its own
//       group (the first with the prologue's), enc one group after them
//       (one bulk copy of enc's rows on an mbarrier measured slower);
//       ring (stages >= 2): enc_proj tiles (32 or 16 positions), then enc
//       tiles, stream through a ring of shared memory, the next issued as
//       the block takes one;
//   - scoring: an item is (position, G beams); HS lanes split its H, each a
//     float4 of h at a time, with the G beams' window taps (coverage) in
//     registers, so one float4 of W' serves G beams.  The same loop runs
//     over Kl feature rows in the feature form;
//   - one exchange, the split softmax of flash decoding: each block keeps
//     its positions' scores, then its row maxima m_r, p = exp(e - m_r) in
//     place, l_r = sum p and an unnormalised context c_r = sum p enc, so
//     enc needs no alpha and streams with enc_proj.  One cluster barrier;
//     then every rank reads the C ranks' (m, l) over distributed shared
//     memory: m = max m_c, l = sum_c l_c exp(m_c - m) in rank order.  Rank
//     r adds its share of the outputs, sum_c c_c exp(m_c - m) in rank order,
//     over l; each block writes its alpha = p exp(m_r - m) / l, correctly
//     rounded, while the exit barrier (split: arrive after the last remote
//     read) settles;
//   - context: threads own a float4 of D over a group of positions for every
//     beam; the groups meet in shared memory.  One launch, no workspace in
//     device memory, no atomics: two runs give equal bits.
//
// The int8 memory form (coverage and content forms; mem_dtype int8).
// The reference computes the LSTM step on int8 memory in XLA, not in its
// Pallas kernel (decoder_lstm.step under the decoder_mem part); this form
// replaces that step on this card.  enc and enc_proj are int8 with one f32
// scale per sample, enc_scale and proj_scale (Bs); RT, the model's compute
// type (float or bfloat16), is a template parameter:
//
//   P[s,h]  = round(round(proj_scale[b]) to RT * enc_proj8[b,s,h]) to RT
//   x, e, alpha as above with P for enc_proj
//   ctx[d]  = (sum_s alpha[s] * enc8[b,s,d]) * enc_scale[b]      (f32)
//
// The same grid, ring and loops: the int8 rows stream through shared memory
// (a quarter of float's, half of bfloat16's bytes) and are widened where
// they are read.  With bfloat16 compute, 4 bytes of enc_proj become two
// bf16 pairs exactly in 2 instructions an element (i8x4_to_bf16), and one
// bf16x2 multiply by the pair (round(ps), round(ps)) gives P rounded once,
// as the plain version rounds it; with float32 compute P = ps * x8, rounded
// once to f32.  The scale of enc is applied once per output.
//
// Measured on an H100 (PERF.md §6): the scoring loop issues about one
// instruction every two cycles per scheduler, with or without the MUFU work,
// the shared loads or more warps, and many of its float operations read
// two source registers from one bank.  At the slice's
// shapes a block's fixed chain (prologue, memory round trips, cluster
// barriers, output) dominates.

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

enum Form { kFeature = 0, kCoverage = 1, kContent = 2 };

#ifdef D2T_ATTENTION_STEP_WIDE
constexpr bool kWide = true;   // D a run-time width; the content form
#else
constexpr bool kWide = false;  // D = H, a compile-time constant
#endif

// Byte offsets of the dynamic shared memory.  ops/attention_step.py's
// smem_bytes() is the same arithmetic; the launcher refuses a plan whose
// bytes are fewer than this layout needs.
struct Layout {
  int w, cw, qb, ws, win, scores, oblk, red, misc, ring, stage, enc, total;
};

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// misc: each beam's sum l and factors exp(m_c - m) of the C ranks, and the
// (m_c, l_c) the C ranks pushed
constexpr int kMiscFloats = kMaxQ + 3 * kMaxQ * kMaxCluster;

__host__ __device__ inline Layout make_layout(int form, int Kz, int chunk, int tile, int stages,
                                              int D, int H, int Kl, int elem) {
  Layout L;
  int off = 0;
  const int depth = form == kCoverage ? kTaps : form == kFeature ? Kl : 0;
  L.w = off;      off += up16(depth * H * 4);                             // W' or w_loc, scaled
  L.cw = off;     off += up16(form == kCoverage ? (kTaps + 1) * Kl * 4 : 0);  // conv_w, conv_b
  L.qb = off;     off += up16(Kz * H * 4);                                // (q + b') scaled
  L.ws = off;     off += up16(H * 4);                                     // w_score
  L.win = off;    off += up16(form == kCoverage ? Kz * (chunk + 2 * kHalo) * 4 : 0);
  L.scores = off; off += up16(Kz * chunk * 4);                            // e, then p
  L.oblk = off;   off += up16((imax(Kz * D, H) + kMaxCluster) * 4);       // b_loc, then pushes
  L.red = off;    off += kRedFloats * 4;
  L.misc = off;   off += up16(kMiscFloats * 4);
  L.ring = off;
  if (stages == 0) {
    // the whole chunk: its enc_proj rows, then its enc rows, each padded
    // by 16 bytes
    L.stage = 0;
    L.enc = off + up16(chunk * (H * elem + 16));
    off = L.enc + up16(chunk * (D * elem + 16));
  } else {
    // a ring stage: tile enc_proj or enc rows, padded by 16 bytes, and in
    // the feature form the tile's loc_feat rows of every beam
    L.stage = up16(tile * (imax(D, H) * elem + 16)) +
              (form == kFeature ? Kz * tile * (Kl * 4 + 16) : 0);
    L.enc = 0;
    off += stages * L.stage;
  }
  L.total = off;
  return L;
}

// 4 consecutive elements of T, float, bfloat16 or int8 (16, 8 or 4 bytes,
// aligned) -> f32
template <typename T>
__device__ __forceinline__ float4 load4(const void* p) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else if constexpr (sizeof(T) == 1) {
    // without I2F (quarter rate on sm_90): byte i of x = b ^ 0x80 = b + 128
    // under the exponent of 2^23 is the float 2^23 + 128 + b, exactly
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
    return make_float4(
        __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u)) - 8388736.f,
        __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541u)) - 8388736.f,
        __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542u)) - 8388736.f,
        __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543u)) - 8388736.f);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
    return make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]), __bfloat162float(e[2]),
                       __bfloat162float(e[3]));
  }
}

// x rounded to RT (float or bfloat16), as a float
template <typename RT>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(RT) == 4) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// a * 1 + c, and a * b (+ -0: the product rounded once), on bf16 pairs
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// four int8 values (bytes 0..3 of w) -> bf16 pairs (0, 1) and (2, 3),
// exactly (as csrc/decode_attention.cu's).  With l the low 7 bits of a byte
// b and s its sign bit, b = (128 + l) - (128 + 128 s): 128 + l is bf16
// 0x4300 | l, and -(128 + 128 s) is bf16 0xC300 | (b & 0x80).  One byte
// permute places each term, one bf16x2 FMA subtracts exactly.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t l = w & 0x7f7f7f7fu, sgn = w & 0x80808080u;
  lo = bf16x2_add(__byte_perm(l, 0x43434343u, 0x5140u), __byte_perm(sgn, 0xC3C3C3C3u, 0x5140u));
  hi = bf16x2_add(__byte_perm(l, 0x43434343u, 0x5342u), __byte_perm(sgn, 0xC3C3C3C3u, 0x5342u));
}

// P of four int8 values of enc_proj (4 bytes, aligned) with the sample's
// scale ps (rounded to RT; ps2 the pair (ps, ps) as bf16 bits), as floats:
// round_RT(ps * x8), rounded once
template <typename RT>
__device__ __forceinline__ float4 dequant4(const void* p, float ps, uint32_t ps2) {
  if constexpr (sizeof(RT) == 4) {
    const float4 x = load4<int8_t>(p);
    return make_float4(x.x * ps, x.y * ps, x.z * ps, x.w * ps);
  } else {
    uint32_t lo, hi;
    i8x4_to_bf16(*reinterpret_cast<const uint32_t*>(p), lo, hi);
    lo = bf16x2_mul(lo, ps2);
    hi = bf16x2_mul(hi, ps2);
    return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u),
                       __uint_as_float(hi << 16), __uint_as_float(hi & 0xffff0000u));
  }
}

// the cluster barrier in two halves (PTX barrier.cluster): arrive, releasing
// the thread's writes and reads, then wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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
//   e += w / (1 + 2^x'),  score = sum_h w - 2 e
// with j over the 5 window taps (coverage; a_j in registers) or the Kl
// features (feature form; a_j from the tile's loc_feat rows): one loop.
// int8 memory (T int8_t): P = round_RT(enc_proj8 * ps), ps the sample's
// proj_scale already rounded to RT (ps2: as a bf16 pair).
template <typename T, typename RT, int H, int G, int FORM>
__device__ __forceinline__ void score_tile(const unsigned char* buf, const float* loc_tile,
                                           const float* w_s, const float* qb_s, const float* ws_s,
                                           const float* win_s, float* sc_s, float sum_ws,
                                           float ps, uint32_t ps2, int chunk, int p0, int np,
                                           int tile, int Kz, int Kl, int HS, int tid) {
  constexpr bool kCov = FORM == kCoverage;
  constexpr int RS = H * (int)sizeof(T) + 16;
  constexpr int NC = H / 4;  // float4 columns
  const int WL = chunk + 2 * kHalo;
  const int LRF = Kl + 4;    // floats of a padded loc_feat row
  const int items = tile * (Kz / G);
  const int slots = kThreads / HS;
  const int sub = tid % HS;
  const int depth = kCov ? kTaps : FORM == kFeature ? Kl : 0;
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
        float4 p;
        if constexpr (sizeof(T) == 1) {
          p = dequant4<RT>(prow + h0, ps, ps2);
        } else {
          p = load4<T>(prow + h0 * (int)sizeof(T));
        }
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
      for (int gg = 0; gg < G; ++gg) sc_s[(g * G + gg) * chunk + p0 + pl] = fmaf(-2.f, e[gg], sum_ws);
    }
  }
}

template <typename T, typename RT, int H, int DT, int G, int FORM>
__global__ void __launch_bounds__(kThreads)
attention_step_kernel(const T* __restrict__ enc, const T* __restrict__ enc_proj,
                      const float* __restrict__ q, const float* __restrict__ loc,
                      const float* __restrict__ conv_w, const float* __restrict__ conv_b,
                      const float* __restrict__ w_loc, const float* __restrict__ b_loc,
                      const float* __restrict__ w_score, const float* __restrict__ enc_scale,
                      const float* __restrict__ proj_scale, float* __restrict__ ctx,
                      float* __restrict__ alpha, int K, int Kz, int S, int d_width, int Kl,
                      int taps, int valid, int chunk, int tile, int stages) {
  constexpr bool kCov = FORM == kCoverage;
  constexpr bool kQ8 = sizeof(T) == 1;  // int8 memory with per-sample scales
  constexpr int ELEM = sizeof(T);
  constexpr int RS = H * ELEM + 16;   // bytes of a padded enc_proj row in shared memory
  constexpr int CPR = H * ELEM / 16;  // 16-byte pieces of an enc_proj row
  constexpr int VEC = 16 / ELEM;      // elements of a piece
  constexpr int NC = H / 4;           // float4 columns of H
  static_assert(H == 128 || H == 256, "widths");
  static_assert(DT == 0 || DT == H, "D is H or a run-time width");
  // enc's width: DT where the instance fixes it, so that every width below
  // and the loops over it are compile-time constants there
  const int D = DT > 0 ? DT : d_width;
  const int RSD = D * ELEM + 16;      // RS and CPR of an enc row in a ring tile
  const int CPRD = D * ELEM / 16;
  const bool full = stages == 0;      // the whole chunk in shared memory

  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;  // the cluster spans x
  const int rank = blockIdx.x;
  const int b = blockIdx.y;
  const long row0 = (long)b * K + (long)blockIdx.z * Kz;  // the block's first decode row
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float escale = kQ8 ? __ldg(enc_scale + b) : 1.f;
  const float pscale = kQ8 ? __ldg(proj_scale + b) : 1.f;

  const Layout L = make_layout(FORM, Kz, chunk, tile, stages, D, H, Kl, ELEM);
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  float* qb_s = reinterpret_cast<float*>(smem + L.qb);
  float* ws_s = reinterpret_cast<float*>(smem + L.ws);
  float* win_s = reinterpret_cast<float*>(smem + L.win);
  float* sc_s = reinterpret_cast<float*>(smem + L.scores);  // [Kz][chunk]: e, then p
  float* o_blk = reinterpret_cast<float*>(smem + L.oblk);   // b_loc, then the pushed sums
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* gsum = reinterpret_cast<float*>(smem + L.misc);     // l
  float* gfac = gsum + kMaxQ;                                // [Kz][kMaxCluster]: exp(m_c - m)
  float* xm = gfac + kMaxQ * kMaxCluster;                    // [Kz][kMaxCluster]: m_c pushed
  float* xl = xm + kMaxQ * kMaxCluster;                      // [Kz][kMaxCluster]: l_c pushed
  // rank c's copy of a shared-memory address, to push to (this block's own
  // in a cluster of one)
  auto to = [&](float* p, int c) -> float* { return C == 1 ? p : cluster.map_shared_rank(p, c); };
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
  // rows in the feature form), then enc tiles: in a ring slot, or (enc_proj)
  // at its rows of the whole chunk
  auto tile_buf = [&](int i) -> unsigned char* {
    if (!full) return ring + (i % stages) * L.stage;
    return i < nt_p ? ring + i * tile * RS : smem + L.enc + (i - nt_p) * tile * RSD;
  };
  auto issue_tile = [&](int i) {
    if (i < n_stream) {
      const bool proj = i < nt_p;
      const int p0 = (proj ? i : i - nt_p) * tile;
      const int np = min(tile, (proj ? n_sc : n_cx) - p0);
      unsigned char* dst = tile_buf(i);
      const int w = proj ? H : D, cpr = proj ? CPR : CPRD, rs = proj ? RS : RSD;
      const T* src = (proj ? proj_b : enc_b) + (long)p0 * w;
      const int lg = __ffs(cpr) - 1;  // cpr is a power of 2
      for (int piece = tid; piece < np * cpr; piece += kThreads) {
        const int r = piece >> lg, c = piece & (cpr - 1);
        cp_async16(dst + r * rs + c * 16, src + (long)r * w + c * VEC);
      }
      if constexpr (FORM == kFeature) {
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
  };
  // every call commits a group
  auto issue = [&](int i) {
    issue_tile(i);
    cp_async_commit();
  };
  // ---- prologue.  The weights first: the w_loc rows this thread sums for
  // W' (coverage form, registers), then one cp.async group of w_score, b_loc
  // (into o_blk until the exchange) and the conv weights or w_loc; then the
  // step's own inputs: q's rows, and the coverage rows of the block's beams
  // with a halo of kHalo positions each side, zero outside [0, S) and read
  // at every position, valid or not.  Then the memory: in the whole-chunk
  // form every tile (the first in the prologue's group), else the first
  // ring tiles.
  float* cw_s = reinterpret_cast<float*>(smem + L.cw);
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
  for (int i = tid; i < NC; i += kThreads) {
    cp_async16(ws_s + 4 * i, w_score + 4 * i);
    if constexpr (FORM != kContent) cp_async16(o_blk + 4 * i, b_loc + 4 * i);
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
  } else if constexpr (FORM == kFeature) {
    for (int i = tid; i < Kl * NC; i += kThreads) cp_async16(w_s + 4 * i, w_loc + 4 * i);
  }
  for (int i = tid; i < Kz * NC; i += kThreads) cp_async16(qb_s + 4 * i, q + row0 * H + 4 * i);
  if constexpr (kCov) {
    for (int k = 0; k < Kz; ++k) {
      for (int j = tid; j < WL; j += kThreads) {
        const int s = lo - kHalo + j;
        const bool live = s >= 0 && s < S;
        cp_async4(win_s + k * WL + j, live ? loc + (row0 + k) * S + s : loc, live);
      }
    }
  }
  int pro_pending;  // groups committed after the prologue's
  if (full) {
    if (nt_p > 0) issue_tile(0);
    cp_async_commit();
    for (int i = 1; i < nt_p; ++i) issue(i);
    for (int i = nt_p; i < n_stream; ++i) issue_tile(i);
    cp_async_commit();  // enc, one group
    pro_pending = max(nt_p, 1);
  } else {
    cp_async_commit();
    for (int i = 0; i < stages - 1; ++i) issue(i);
    pro_pending = stages - 1;
  }

  cp_async_wait(pro_pending);  // the prologue's group
  if constexpr (FORM == kContent) {
    // q's rows this thread copied, scaled: no other thread's copy is read
    // before the barrier below
    for (int i = tid; i < Kz * NC; i += kThreads) {
      float4* v = reinterpret_cast<float4*>(qb_s + 4 * i);
      *v = make_float4(v->x * kTwoOverLn2, v->y * kTwoOverLn2, v->z * kTwoOverLn2,
                       v->w * kTwoOverLn2);
    }
  }
  __syncthreads();
  if constexpr (kCov) {
    // W'[u] (window slot u = tap t - ks + kHalo; zero rows outside the
    // conv's taps) and b' = conv_b . w_loc + b_loc.  Thread (jp, h4) sums
    // rows j = jp, jp + NJP, ... of w_loc, a float4 of h, loaded 8 rows at
    // a time (the first 8 in flight since the prologue began); the shares
    // meet in red.
    float4 acc[kTaps + 1];
#pragma unroll
    for (int u = 0; u <= kTaps; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
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
    __syncthreads();
  } else if constexpr (FORM == kFeature) {
    for (int i = tid; i < Kl * H; i += kThreads) w_s[i] *= kTwoOverLn2;
  }
  if constexpr (FORM != kContent) {
    for (int i = tid; i < Kz * H; i += kThreads) qb_s[i] = (qb_s[i] + o_blk[i % H]) * kTwoOverLn2;
    __syncthreads();
  }
  // no rank pushes into another's o_blk before that one is done with b'
  // here: its reads of b' were consumed before the block barrier above, so
  // the arrival needs no release; each rank waits for it before its first
  // push
  if (C > 1) cluster_arrive_relaxed();
  // sum_h w_score, in every warp
  float sum_ws;
  {
    float sum = 0.f;
    for (int h = lane; h < H; h += 32) sum += ws_s[h];
    sum_ws = warp_sum(sum);
  }
  const float ps = kQ8 ? round_to<RT>(pscale) : 1.f;
  uint32_t ps2 = 0;
  if constexpr (kQ8 && sizeof(RT) == 2) {
    const uint32_t u = __bfloat16_as_ushort(__float2bfloat16_rn(pscale));
    ps2 = u | (u << 16);
  }

  // ---- scores, a tile at a time
  {
    const int items = tile * (Kz / G);
    int HS = kThreads / items;
    HS = HS >= 8 ? 8 : HS >= 4 ? 4 : HS >= 2 ? 2 : 1;
    for (int i = 0; i < nt_p; ++i) {
      if (!full) {
        cp_async_wait(stages - 2);
        __syncthreads();  // tile i landed for all; everyone is done with tile i - 1
        issue(i + stages - 1);
      } else if (i > 0) {
        cp_async_wait(nt_p - i);  // tile i's group; the later tiles and enc may be in flight
        __syncthreads();
      }
      const unsigned char* buf = tile_buf(i);
      const float* loc_tile = reinterpret_cast<const float*>(buf + up16(tile * RS));
      score_tile<T, RT, H, G, FORM>(buf, loc_tile, w_s, qb_s, ws_s, win_s, sc_s, sum_ws, ps, ps2,
                                    chunk, i * tile, min(tile, n_sc - i * tile), tile, Kz, Kl,
                                    HS, tid);
    }
  }
  for (int k = 0; k < Kz; ++k) {
    for (int s = n_sc + tid; s < n_local; s += kThreads) sc_s[k * chunk + s] = kNegInf;
  }
  __syncthreads();
  if (C > 1) cluster_wait();  // every rank is past its prologue: pushes may start

  // ---- the block's softmax, in f32: row maxima m_r, p = exp(e - m_r) in
  // place, row sums l_r, pushed to every rank (lane c to rank c)
  for (int k = warp; k < Kz; k += kWarps) {
    float m = -INFINITY;
    for (int s = lane; s < n_local; s += 32) m = fmaxf(m, sc_s[k * chunk + s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < n_local; s += 32) {
      const float x = expf(sc_s[k * chunk + s] - m);
      sc_s[k * chunk + s] = x;
      sum += x;
    }
    sum = warp_sum(sum);
    if (lane < C) {
      *to(xm + k * kMaxCluster + rank, lane) = m;
      *to(xl + k * kMaxCluster + rank, lane) = sum;
    }
  }

  // ---- context, unnormalised: thread (pg, d4) takes a float4 of D over
  // positions pg, pg + NPG, ... of the enc rows, for every beam
  const int NCD = D / 4;
  const int NPG = kThreads / NCD;
  const int d4 = tid % NCD, pg = tid / NCD;
  float acc[kMaxQ][4];
#pragma unroll
  for (int k = 0; k < kMaxQ; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
  auto accumulate = [&](const unsigned char* rows, int p0, int np) {
    for (int r = pg; r < np; r += NPG) {
      const float4 v = load4<T>(rows + r * RSD + d4 * 4 * ELEM);
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
  };
  if (full) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // enc's group
    __syncthreads();  // also orders p above before its reads
    accumulate(smem + L.enc, 0, n_cx);
  } else {
    for (int i = nt_p; i < n_stream; ++i) {
      cp_async_wait(stages - 2);
      __syncthreads();  // also orders p above before the first tile
      issue(i + stages - 1);
      const int p0 = (i - nt_p) * tile;
      accumulate(tile_buf(i), p0, min(tile, n_cx - p0));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();
  // the position groups' sums meet in red, KB beams at a time (NPG * D =
  // 4 * kThreads whatever D); each sum is pushed to the rank that writes
  // its output: rank c owns outputs [c * share, (c + 1) * share) of the Kz
  // x D and takes rank r's part of them at o_blk[r * share, ...)
  const int n_out = Kz * D;
  const int share = (n_out + C - 1) / C;
  constexpr int KB = kRedFloats / (4 * kThreads);
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
      if constexpr (DT > 0) {
#pragma unroll
        for (int p = 0; p < NPG; ++p) x += red[(p * KB + kk) * D + d];
      } else {
        for (int p = 0; p < NPG; ++p) x += red[(p * KB + kk) * D + d];
      }
      const int jo = (k0 + kk) * D + d, c = jo / share;
      *to(o_blk + rank * share + jo - c * share, c) = x;
    }
    __syncthreads();
  }

  // ---- the one exchange: every rank's (m_r, l_r) and its part of this
  // rank's outputs have been pushed here; after one cluster barrier every
  // read is local, and no rank reads another's shared memory again
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }
  if (tid < Kz * C) {  // thread (k, c): exp(m_c - m) of beam k
    const int k = tid / C, c = tid % C;
    float m = xm[k * kMaxCluster];
    for (int c2 = 1; c2 < C; ++c2) m = fmaxf(m, xm[k * kMaxCluster + c2]);
    gfac[k * kMaxCluster + c] = expf(xm[k * kMaxCluster + c] - m);
  }
  __syncthreads();
  if (tid < Kz) {
    float l = 0.f;
    for (int c = 0; c < C; ++c) {  // in rank order
      l = fmaf(xl[tid * kMaxCluster + c], gfac[tid * kMaxCluster + c], l);
    }
    gsum[tid] = l;
  }
  __syncthreads();
  // this rank's share of the outputs: sum_c c_c exp(m_c - m) in rank order,
  // over l
  for (int jj = tid; jj < min(share, n_out - rank * share); jj += kThreads) {
    const int j = rank * share + jj, k = j / D;
    float x = 0.f;
    for (int c = 0; c < C; ++c) x = fmaf(o_blk[c * share + jj], gfac[k * kMaxCluster + c], x);
    x = x / gsum[k];
    if constexpr (kQ8) x *= escale;
    ctx[(row0 + k) * D + j % D] = x;
  }
  // alpha = p exp(m_r - m) / l, correctly rounded in the normal range: q0 =
  // x * (1/l) and one FMA step on its remainder
  for (int k = 0; k < Kz; ++k) {
    const float g = gfac[k * kMaxCluster + rank];
    const float l = gsum[k];
    const float inv = 1.f / l;
    for (int s = tid; s < n_local; s += kThreads) {
      const float x = sc_s[k * chunk + s] * g;
      const float q0 = x * inv;
      alpha[(row0 + k) * S + lo + s] = fmaf(fmaf(-q0, l, x), inv, q0);
    }
  }
}

template <typename T, typename RT, int H, int DT, int G, int FORM>
int launch_g(const void* enc, const void* enc_proj, const void* q, const void* loc,
             const void* conv_w, const void* conv_b, const void* w_loc, const void* b_loc,
             const void* w_score, const void* enc_scale, const void* proj_scale, void* ctx,
             void* alpha, int Bs, int K, int Kz, int S, int D, int Kl, int taps, int valid,
             int cluster, int chunk, int zsplit, int tile, int stages, int smem_bytes,
             cudaStream_t stream) {
  auto kernel = attention_step_kernel<T, RT, H, DT, G, FORM>;
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
      static_cast<const float*>(w_score), static_cast<const float*>(enc_scale),
      static_cast<const float*>(proj_scale), static_cast<float*>(ctx), static_cast<float*>(alpha),
      K, Kz, S, D, Kl, taps, valid, chunk, tile, stages);
}

// G = beams an item holds: 5 where the block's beams come in fives (beam 5
// and 10), else 1.  DT: D = H fixed in the plain build, run-time in the wide
template <typename T, typename RT, int H, int FORM>
int launch_h(const void* enc, const void* enc_proj, const void* q, const void* loc,
             const void* conv_w, const void* conv_b, const void* w_loc, const void* b_loc,
             const void* w_score, const void* enc_scale, const void* proj_scale, void* ctx,
             void* alpha, int Bs, int K, int Kz, int S, int D, int Kl, int taps, int valid,
             int cluster, int chunk, int zsplit, int tile, int stages, int smem_bytes,
             cudaStream_t s) {
#define D2T_ARGS enc, enc_proj, q, loc, conv_w, conv_b, w_loc, b_loc, w_score, enc_scale, \
                 proj_scale, ctx, alpha, Bs, K, Kz, S, D, Kl, taps, valid, cluster, chunk, \
                 zsplit, tile, stages, smem_bytes, s
  constexpr int DT = kWide ? 0 : H;
  if (Kz % 5 == 0) return launch_g<T, RT, H, DT, 5, FORM>(D2T_ARGS);
  return launch_g<T, RT, H, DT, 1, FORM>(D2T_ARGS);
#undef D2T_ARGS
}

// mem: the memory's type, 0 = float32, 2 = bfloat16, 3 = int8 (coverage
// and content forms, with enc_scale and proj_scale); compute: the compute type,
// 0 = float32, 2 = bfloat16, the memory's own unless the memory is int8
template <int FORM>
int launch(const void* enc, const void* enc_proj, const void* q, const void* loc,
           const void* conv_w, const void* conv_b, const void* w_loc, const void* b_loc,
           const void* w_score, const void* enc_scale, const void* proj_scale, void* ctx,
           void* alpha, int Bs, int K, int S, int D, int H, int Kl, int taps, int valid, int mem,
           int compute, int cluster, int chunk, int zsplit, int tile, int stages, int smem_bytes,
           void* stream) {
  const bool q8 = mem == 3;
  const int elem = mem == 0 ? 4 : q8 ? 1 : 2;
  const int Kz = zsplit > 0 ? K / zsplit : 0;
  if (Bs <= 0 || Bs > 65535 || K <= 0 || S <= 0 || (FORM == kContent ? Kl != 0 : Kl <= 0) ||
      (D != 128 && D != 256 && D != 512) || (!kWide && (D != H || FORM == kContent)) ||
      (H != 128 && H != 256) || (mem != 0 && mem != 2 && !q8) ||
      (compute != 0 && compute != 2) || (!q8 && compute != mem) ||
      (q8 && (FORM == kFeature || enc_scale == nullptr || proj_scale == nullptr)) ||
      zsplit <= 0 ||
      zsplit > 65535 || K % zsplit != 0 || Kz > kMaxQ || cluster <= 0 ||
      cluster > kMaxCluster || chunk <= 0 || (long)cluster * chunk < S ||
      (long)(cluster - 1) * chunk >= S || (tile != 16 && tile != 32) ||
      (stages == 0 ? FORM == kFeature : stages < 2 || stages > kMaxStages) ||
      smem_bytes > kMaxSmem ||
      smem_bytes < make_layout(FORM, Kz, chunk, tile, stages, D, H, Kl, elem).total) {
    return (int)cudaErrorInvalidValue;
  }
  if (FORM == kCoverage ? (taps < 1 || taps > kTaps || taps % 2 == 0)
                        : FORM == kFeature && Kl % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
#define D2T_ARGS enc, enc_proj, q, loc, conv_w, conv_b, w_loc, b_loc, w_score, enc_scale, \
                 proj_scale, ctx, alpha, Bs, K, Kz, S, D, Kl, taps, valid, cluster, chunk, \
                 zsplit, tile, stages, smem_bytes, s
  if (mem == 0) {
    rc = H == 128 ? launch_h<float, float, 128, FORM>(D2T_ARGS)
                  : launch_h<float, float, 256, FORM>(D2T_ARGS);
  } else if (mem == 2) {
    rc = H == 128 ? launch_h<__nv_bfloat16, __nv_bfloat16, 128, FORM>(D2T_ARGS)
                  : launch_h<__nv_bfloat16, __nv_bfloat16, 256, FORM>(D2T_ARGS);
  } else if constexpr (FORM != kFeature) {
    if (compute == 0) {
      rc = H == 128 ? launch_h<int8_t, float, 128, FORM>(D2T_ARGS)
                    : launch_h<int8_t, float, 256, FORM>(D2T_ARGS);
    } else {
      rc = H == 128 ? launch_h<int8_t, __nv_bfloat16, 128, FORM>(D2T_ARGS)
                    : launch_h<int8_t, __nv_bfloat16, 256, FORM>(D2T_ARGS);
    }
  }
#undef D2T_ARGS
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The launch floor: an empty kernel on the grid, cluster and dynamic shared
// memory of a plan, what a launch of the step costs before any work
__global__ void __launch_bounds__(kThreads) floor_kernel() {}

}  // namespace

// (cluster, Bs, zsplit, smem_bytes) as a plan of the step gives them
extern "C" int d2t_attention_step_floor(int cluster, int Bs, int zsplit, int smem_bytes,
                                        void* stream) {
  if (cluster <= 0 || cluster > kMaxCluster || Bs <= 0 || Bs > 65535 || zsplit <= 0 ||
      zsplit > 65535 || smem_bytes < 0 || smem_bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  static const cudaError_t attr =
      cudaFuncSetAttribute(floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, Bs, zsplit);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, floor_kernel);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// valid < 0 means no mask.  K = beams per sample (rows of q / Bs).
// (cluster, chunk, zsplit, tile, stages, smem_bytes) is the wrapper's
// launch plan: blocks per cluster along S, positions per block, beam groups
// per sample, positions per tile (16 or 32), ring tiles (0: the whole
// chunk in shared memory; coverage and content forms), and dynamic shared
// memory per block.  Returns 0, or the CUDA error of the launch, or
// cudaErrorInvalidValue for what the kernel does not take.

// feature form: loc_feat (Bs*K, S, Kl), Kl a multiple of 4; dtype of enc
// and enc_proj, 0 = float32 or 2 = bfloat16
extern "C" int d2t_attention_step_features(const void* enc, const void* enc_proj, const void* q,
                                           const void* loc_feat, const void* w_loc,
                                           const void* b_loc, const void* w_score, void* ctx,
                                           void* alpha, int Bs, int K, int S, int D, int H, int Kl,
                                           int valid, int dtype, int cluster, int chunk,
                                           int zsplit, int tile, int stages, int smem_bytes,
                                           void* stream) {
  return launch<kFeature>(enc, enc_proj, q, loc_feat, nullptr, nullptr, w_loc, b_loc, w_score,
                          nullptr, nullptr, ctx, alpha, Bs, K, S, D, H, Kl, 0, valid, dtype,
                          dtype, cluster, chunk, zsplit, tile, stages, smem_bytes, stream);
}

// coverage form: mem (Bs*K, S), loc_conv_w (taps, 1, Kl), loc_conv_b (Kl),
// taps = 2 * kernel_size + 1 <= 5.  mem_dtype, the type of enc and
// enc_proj: 0 = float32, 2 = bfloat16, computing in that type; or 3 =
// int8, with enc_scale and proj_scale (Bs) float and compute_dtype the
// model's compute type (0 or 2) that enc_proj's dequantized values are
// rounded to.  The scales are null for float memory.
extern "C" int d2t_attention_step_coverage(
    const void* enc, const void* enc_proj, const void* q, const void* mem,
    const void* loc_conv_w, const void* loc_conv_b, const void* w_loc, const void* b_loc,
    const void* w_score, const void* enc_scale, const void* proj_scale, void* ctx, void* alpha,
    int Bs, int K, int S, int D, int H, int Kl, int taps, int valid, int mem_dtype,
    int compute_dtype, int cluster, int chunk, int zsplit, int tile, int stages, int smem_bytes,
    void* stream) {
  return launch<kCoverage>(enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, b_loc, w_score,
                           enc_scale, proj_scale, ctx, alpha, Bs, K, S, D, H, Kl, taps, valid,
                           mem_dtype, compute_dtype, cluster, chunk, zsplit, tile, stages,
                           smem_bytes, stream);
}

#ifdef D2T_ATTENTION_STEP_WIDE
// content form (no location term; the bahdanau head): enc (Bs,S,D),
// enc_proj (Bs,S,H), q (Bs*K,H), w_score (H); mem_dtype and compute_dtype
// and the int8 scales as in the coverage form.
extern "C" int d2t_attention_step_content(const void* enc, const void* enc_proj, const void* q,
                                          const void* w_score, const void* enc_scale,
                                          const void* proj_scale, void* ctx, void* alpha, int Bs,
                                          int K, int S, int D, int H, int valid, int mem_dtype,
                                          int compute_dtype, int cluster, int chunk, int zsplit,
                                          int tile, int stages, int smem_bytes, void* stream) {
  return launch<kContent>(enc, enc_proj, q, nullptr, nullptr, nullptr, nullptr, nullptr, w_score,
                          enc_scale, proj_scale, ctx, alpha, Bs, K, S, D, H, 0, 0, valid,
                          mem_dtype, compute_dtype, cluster, chunk, zsplit, tile, stages,
                          smem_bytes, stream);
}
#endif
