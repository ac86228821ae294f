// Backward of the coverage-attention step (the coverage form of
// csrc/attention_step.cu at K = 1), hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package trains the LSTM head by letting
// jax.grad differentiate its plain XLA step (doc2tex_tpu/models/
// decoder_lstm.py:196-304); its Pallas kernel (B2) has no backward.  The
// port's step runs the forward kernel on the card, which autograd cannot see
// through, so this kernel is the backward of ops/attention_step.py's
// CoverageAttentionStepFn.
//
// Per row b (one sample, K = 1) and position s, with the forward's fold of
// the location conv into w_loc,
//   W'[t,h] = sum_j conv_w[t,j] w_loc[j,h]     b'[h] = sum_j conv_b[j] w_loc[j,h] + b_loc[h]
//   m_t[s]  = mem[b, s + t - 2]                (zero outside [0, S); a conv of
//                                               fewer than 5 taps sits in the middle)
//   th[s,h] = tanh(enc_proj[b,s,h] + q[b,h] + sum_t m_t[s] W'[t,h] + b'[h])
// and the cotangents g_ctx (B, D) and g_alpha (B, S) of the outputs:
//   ga[s]   = g_alpha[s] + sum_d enc[b,s,d] g_ctx[d]
//   ge[s]   = alpha[s] (ga[s] - sum_s' alpha[s'] ga[s'])
//   gp[s,h] = ge[s] w_score[h] (1 - th[s,h]^2)
//   d enc[b,s,d] = alpha[s] g_ctx[d]    d enc_proj = gp   (the memory's type, rounded once)
//   d q[b,h] = sum_s gp                 d w_score[h] = sum_{b,s} ge th
//   M[t,h]   = sum_{b,s} m_t[s] gp      P[h] = sum_{b,s} gp = d b_loc
//   d w_loc[j,h]  = sum_t conv_w[t,j] M[t,h] + conv_b[j] P[h]
//   d conv_w[t,j] = sum_h M[t,h] w_loc[j,h]      d conv_b[j] = sum_h P[h] w_loc[j,h]
//   d mem[b,p]    = sum_t R_t[p - t + 2],  R_t[s] = sum_h gp[s,h] W'[t,h]
// The forward's alpha is the only activation it reads: scores, tanh and
// the location features are recomputed, and after the fold the per-position
// work is 5 taps of H, not Kl features.
//
// Four launches on the caller's stream.  Every sum is taken in a fixed
// order and there are no atomics, so two runs on the same inputs give the
// same bits:
//   1. ga     grid (chunk, row): d enc, ga, and the chunk's sum of alpha ga;
//   2. main   grid (chunk, row): the row's sum from its chunks' (in chunk
//             order), then per position th, gp -> d enc_proj and R; the
//             block's partial d q, d w_score and M (7 vectors of H) to a
//             workspace, its 8 warps' sums added in warp order;
//   3. reduce the partials' columns over every block in block order (P,
//             d w_score, M), d q of each row over its chunks, d mem of each
//             row from R;
//   4. finish (one block): d w_loc, d conv_w, d conv_b, d b_loc, d w_score.
//
// What bounds it.  At the synthetic recipe's largest bucket (32 samples, S
// 623, D = H = 128, bf16 memory) it must read enc, enc_proj, mem, alpha and
// g_alpha and write d enc, d enc_proj and d mem: ~21 MB, 6.3 us of HBM.  Its
// float work after the fold is ~50 H operations a position (~0.13 GFLOP,
// 2 us at 67 TFLOP/s), so it is bound by bytes.  A warp takes a position:
// its enc row (pass 1) and enc_proj row (pass 2) are read once, 16 bytes a
// lane, and the outputs are written the same way.  This first version
// spends nothing on overlapping the four launches or the two passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHalo = 2;              // the widest location conv: kernel_size 2
constexpr int kTaps = 2 * kHalo + 1;
constexpr int kVecs = 2 + kTaps;      // a block's partials: d q, d w_score, M[5]
constexpr int kMaxChunk = 1024;

// 4 consecutive elements of T, float or bfloat16 (16 or 8 bytes, aligned)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
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

// pass 1: ga = g_alpha + enc . g_ctx, d enc = alpha g_ctx, and the chunk's
// sum of alpha ga.  Lane l holds columns 4l.. of each 128 of D.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
b2_bwd_ga_kernel(const T* __restrict__ enc, const float* __restrict__ alpha,
                 const float* __restrict__ g_ctx, const float* __restrict__ g_alpha,
                 T* __restrict__ d_enc, float* __restrict__ ga,
                 float* __restrict__ chunk_sums, int S, int chunk) {
  constexpr int NV = D / 128;
  __shared__ float warp_sums[kWarps];
  const int c = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4 g[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    g[i] = *reinterpret_cast<const float4*>(g_ctx + (size_t)b * D + i * 128 + lane * 4);
  }
  const int s1 = min(S, (c + 1) * chunk);
  float acc = 0.f;
  for (int s = c * chunk + warp; s < s1; s += kWarps) {
    const size_t pos = (size_t)b * S + s;
    const float a = alpha[pos];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const size_t at = pos * D + i * 128 + lane * 4;
      dot += dot4(load4<T>(enc + at), g[i]);
      store4<T>(d_enc + at, make_float4(a * g[i].x, a * g[i].y, a * g[i].z, a * g[i].w));
    }
    const float v = g_alpha[pos] + warp_sum(dot);
    if (lane == 0) ga[pos] = v;
    acc = fmaf(a, v, acc);
  }
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += warp_sums[w];
    chunk_sums[(size_t)b * nchunk + c] = x;
  }
}

// pass 2: per position th and gp -> d enc_proj and R; the block's partial
// d q, d w_score and M.  Lane l holds columns 4l.. of each 128 of H.
template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
b2_bwd_main_kernel(const T* __restrict__ enc_proj, const float* __restrict__ q,
                   const float* __restrict__ mem, const float* __restrict__ conv_w,
                   const float* __restrict__ conv_b, const float* __restrict__ w_loc,
                   const float* __restrict__ b_loc, const float* __restrict__ w_score,
                   const float* __restrict__ alpha, const float* __restrict__ ga,
                   const float* __restrict__ chunk_sums, T* __restrict__ d_enc_proj,
                   float* __restrict__ R, float* __restrict__ partials, int S, int Kl, int taps,
                   int chunk) {
  constexpr int NV = H / 128;
  __shared__ __align__(16) float wp_s[kTaps * H];   // W', taps centred in 5
  __shared__ __align__(16) float bp_s[H];           // b'
  __shared__ __align__(16) float red_s[kWarps * H];
  __shared__ float row_sum_s;
  const int c = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int off = (kTaps - taps) / 2;
  // the fold, one thread a column h: W'[t,h], b'[h]
  for (int h = tid; h < H; h += kThreads) {
    float w[kTaps];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) w[t] = 0.f;
    float bb = b_loc[h];
    for (int j = 0; j < Kl; ++j) {
      const float wl = w_loc[(size_t)j * H + h];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        if (t >= off && t < off + taps) w[t] = fmaf(conv_w[(t - off) * Kl + j], wl, w[t]);
      }
      bb = fmaf(conv_b[j], wl, bb);
    }
#pragma unroll
    for (int t = 0; t < kTaps; ++t) wp_s[t * H + h] = w[t];
    bp_s[h] = bb;
  }
  if (tid == 0) {
    float x = 0.f;
    for (int cc = 0; cc < nchunk; ++cc) x += chunk_sums[(size_t)b * nchunk + cc];
    row_sum_s = x;
  }
  __syncthreads();
  float4 wp[kTaps][NV], qb[NV], ws[NV], dq[NV], dws[NV], M[kTaps][NV];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int h0 = i * 128 + lane * 4;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      wp[t][i] = *reinterpret_cast<const float4*>(wp_s + t * H + h0);
      M[t][i] = zero;
    }
    qb[i] = add4(*reinterpret_cast<const float4*>(q + (size_t)b * H + h0),
                 *reinterpret_cast<const float4*>(bp_s + h0));
    ws[i] = *reinterpret_cast<const float4*>(w_score + h0);
    dq[i] = zero;
    dws[i] = zero;
  }
  const float row_sum = row_sum_s;
  const float* mrow = mem + (size_t)b * S;
  const int s1 = min(S, (c + 1) * chunk);
  for (int s = c * chunk + warp; s < s1; s += kWarps) {
    const size_t pos = (size_t)b * S + s;
    float m[kTaps], r[kTaps];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int p = s + t - kHalo;
      m[t] = p >= 0 && p < S ? mrow[p] : 0.f;
      r[t] = 0.f;
    }
    const float ge = alpha[pos] * (ga[pos] - row_sum);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const size_t at = pos * H + i * 128 + lane * 4;
      float4 x = add4(load4<T>(enc_proj + at), qb[i]);
#pragma unroll
      for (int t = 0; t < kTaps; ++t) x = fma4(m[t], wp[t][i], x);
      const float4 th = make_float4(tanhf(x.x), tanhf(x.y), tanhf(x.z), tanhf(x.w));
      const float4 gp = make_float4(ge * ws[i].x * fmaf(-th.x, th.x, 1.f),
                                    ge * ws[i].y * fmaf(-th.y, th.y, 1.f),
                                    ge * ws[i].z * fmaf(-th.z, th.z, 1.f),
                                    ge * ws[i].w * fmaf(-th.w, th.w, 1.f));
      store4<T>(d_enc_proj + at, gp);
      dq[i] = add4(dq[i], gp);
      dws[i] = fma4(ge, th, dws[i]);
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        M[t][i] = fma4(m[t], gp, M[t][i]);
        r[t] += dot4(gp, wp[t][i]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTaps; ++t) r[t] = warp_sum(r[t]);
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < kTaps; ++t) R[pos * kTaps + t] = r[t];
    }
  }
  // the block's partials: each vector's 8 warp sums added in warp order
  float* out = partials + ((size_t)b * nchunk + c) * kVecs * H;
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 x = v == 0 ? dq[i] : v == 1 ? dws[i] : M[v < 2 ? 0 : v - 2][i];
      *reinterpret_cast<float4*>(red_s + warp * H + i * 128 + lane * 4) = x;
    }
    __syncthreads();
    for (int h = tid; h < H; h += kThreads) {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x += red_s[w * H + h];
      out[v * H + h] = x;
    }
    __syncthreads();
  }
}

// pass 3: blocks [0, col_blocks) sum 32 columns of the partials over every
// block of pass 2 (8 row groups, then the groups in order); the next B
// blocks take one row each: d q over its chunks, d mem from R.
template <int H>
__global__ void __launch_bounds__(kThreads)
b2_bwd_reduce_kernel(const float* __restrict__ partials, const float* __restrict__ R,
                     float* __restrict__ sums, float* __restrict__ d_q, float* __restrict__ d_mem,
                     int S, int nchunk, int rows, int col_blocks) {
  constexpr int NCOL = kVecs * H;
  __shared__ float red_s[kWarps][32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if ((int)blockIdx.x < col_blocks) {
    const int col = blockIdx.x * 32 + lane;
    float x = 0.f;
    if (col < NCOL) {
      for (int r = warp; r < rows; r += kWarps) x += partials[(size_t)r * NCOL + col];
    }
    red_s[warp][lane] = x;
    __syncthreads();
    if (warp == 0 && col < NCOL) {
      float y = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) y += red_s[w][lane];
      sums[col] = y;
    }
    return;
  }
  const int b = blockIdx.x - col_blocks;
  for (int h = tid; h < H; h += kThreads) {
    float x = 0.f;
    for (int cc = 0; cc < nchunk; ++cc) x += partials[((size_t)b * nchunk + cc) * NCOL + h];
    d_q[(size_t)b * H + h] = x;
  }
  for (int p = tid; p < S; p += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int s = p - t + kHalo;
      if (s >= 0 && s < S) x += R[((size_t)b * S + s) * kTaps + t];
    }
    d_mem[(size_t)b * S + p] = x;
  }
}

// pass 4, one block: the weights' gradients from P, d w_score and M
template <int H>
__global__ void __launch_bounds__(kThreads)
b2_bwd_finish_kernel(const float* __restrict__ sums, const float* __restrict__ conv_w,
                     const float* __restrict__ conv_b, const float* __restrict__ w_loc,
                     float* __restrict__ d_conv_w, float* __restrict__ d_conv_b,
                     float* __restrict__ d_w_loc, float* __restrict__ d_b_loc,
                     float* __restrict__ d_w_score, int Kl, int taps) {
  __shared__ float s_s[kVecs * H];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int off = (kTaps - taps) / 2;
  for (int i = tid; i < kVecs * H; i += kThreads) s_s[i] = sums[i];
  __syncthreads();
  const float* P = s_s;
  const float* M = s_s + 2 * H;
  for (int h = tid; h < H; h += kThreads) {
    d_b_loc[h] = P[h];
    d_w_score[h] = s_s[H + h];
  }
  for (int e = tid; e < Kl * H; e += kThreads) {
    const int j = e / H, h = e % H;
    float x = 0.f;
    for (int t = 0; t < taps; ++t) x = fmaf(conv_w[t * Kl + j], M[(t + off) * H + h], x);
    d_w_loc[e] = fmaf(conv_b[j], P[h], x);
  }
  // a warp an output: d conv_w[t, j] (t < taps), then d conv_b[j]
  for (int o = warp; o < (taps + 1) * Kl; o += kWarps) {
    const int t = o / Kl, j = o % Kl;
    const float* v = t < taps ? M + (t + off) * H : P;
    float x = 0.f;
    for (int h = lane; h < H; h += 32) x = fmaf(v[h], w_loc[(size_t)j * H + h], x);
    x = warp_sum(x);
    if (lane == 0) {
      if (t < taps) {
        d_conv_w[t * Kl + j] = x;
      } else {
        d_conv_b[j] = x;
      }
    }
  }
}

// the workspace's floats: ops/attention_step.py's backward_workspace_floats
size_t workspace_floats(int B, int S, int H, int chunk) {
  const size_t nchunk = (S + chunk - 1) / chunk;
  return (size_t)B * S + B * nchunk + (size_t)B * S * kTaps + (B * nchunk + 1) * kVecs * H;
}

template <typename T, int H>
int launch(const void* enc, const void* enc_proj, const void* q, const void* mem,
           const void* conv_w, const void* conv_b, const void* w_loc, const void* b_loc,
           const void* w_score, const void* alpha, const void* g_ctx, const void* g_alpha,
           void* d_enc, void* d_enc_proj, void* d_q, void* d_mem, void* d_conv_w,
           void* d_conv_b, void* d_w_loc, void* d_b_loc, void* d_w_score, float* work, int B,
           int S, int Kl, int taps, int chunk, cudaStream_t stream) {
  const int nchunk = (S + chunk - 1) / chunk;
  float* ga = work;
  float* chunk_sums = ga + (size_t)B * S;
  float* R = chunk_sums + (size_t)B * nchunk;
  float* partials = R + (size_t)B * S * kTaps;
  float* sums = partials + (size_t)B * nchunk * kVecs * H;
  const dim3 grid(nchunk, B);
  const float* f_alpha = static_cast<const float*>(alpha);
  b2_bwd_ga_kernel<T, H><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(enc), f_alpha, static_cast<const float*>(g_ctx),
      static_cast<const float*>(g_alpha), static_cast<T*>(d_enc), ga, chunk_sums, S, chunk);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  b2_bwd_main_kernel<T, H><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(enc_proj), static_cast<const float*>(q),
      static_cast<const float*>(mem), static_cast<const float*>(conv_w),
      static_cast<const float*>(conv_b), static_cast<const float*>(w_loc),
      static_cast<const float*>(b_loc), static_cast<const float*>(w_score), f_alpha, ga,
      chunk_sums, static_cast<T*>(d_enc_proj), R, partials, S, Kl, taps, chunk);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int col_blocks = (kVecs * H + 31) / 32;
  b2_bwd_reduce_kernel<H><<<col_blocks + B, kThreads, 0, stream>>>(
      partials, R, sums, static_cast<float*>(d_q), static_cast<float*>(d_mem), S, nchunk,
      B * nchunk, col_blocks);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  b2_bwd_finish_kernel<H><<<1, kThreads, 0, stream>>>(
      sums, static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
      static_cast<const float*>(w_loc), static_cast<float*>(d_conv_w),
      static_cast<float*>(d_conv_b), static_cast<float*>(d_w_loc), static_cast<float*>(d_b_loc),
      static_cast<float*>(d_w_score), Kl, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// The coverage form's backward at K = 1.  enc (B,S,D) and enc_proj (B,S,H)
// in the memory's type (dtype 0 = float32, 2 = bfloat16), q (B,H), mem,
// alpha, g_alpha (B,S), g_ctx (B,D), conv_w (taps,1,Kl), conv_b (Kl),
// w_loc (Kl,H), b_loc (H), w_score (H) float32; d enc and d enc_proj come
// out in the memory's type, the rest float32 in the shapes of their
// inputs.  work: `ws_floats` floats of scratch (workspace_floats).  chunk:
// positions per block of passes 1 and 2.  D = H in {128, 256}, taps odd
// and at most 5; contiguous and 16-byte aligned.  Returns 0, the CUDA error
// of a launch, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int d2t_attention_step_coverage_backward(
    const void* enc, const void* enc_proj, const void* q, const void* mem, const void* conv_w,
    const void* conv_b, const void* w_loc, const void* w_score, const void* b_loc,
    const void* alpha, const void* g_ctx, const void* g_alpha, void* d_enc, void* d_enc_proj,
    void* d_q, void* d_mem, void* d_conv_w, void* d_conv_b, void* d_w_loc, void* d_b_loc,
    void* d_w_score, void* work, long long ws_floats, int B, int S, int D, int H, int Kl,
    int taps, int dtype, int chunk, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Kl <= 0 || D != H || (H != 128 && H != 256) ||
      (dtype != 0 && dtype != 2) || taps < 1 || taps > kTaps || taps % 2 == 0 || chunk <= 0 ||
      chunk > kMaxChunk || (S + chunk - 1) / chunk > 65535 || ws_floats < 0 ||
      (size_t)ws_floats < workspace_floats(B, S, H, chunk)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(work);
#define D2T_ARGS enc, enc_proj, q, mem, conv_w, conv_b, w_loc, b_loc, w_score, alpha, g_ctx, \
                 g_alpha, d_enc, d_enc_proj, d_q, d_mem, d_conv_w, d_conv_b, d_w_loc, d_b_loc, \
                 d_w_score, ws, B, S, Kl, taps, chunk, s
  int rc;
  if (dtype == 0) {
    rc = H == 128 ? launch<float, 128>(D2T_ARGS) : launch<float, 256>(D2T_ARGS);
  } else {
    rc = H == 128 ? launch<__nv_bfloat16, 128>(D2T_ARGS) : launch<__nv_bfloat16, 256>(D2T_ARGS);
  }
#undef D2T_ARGS
  return rc;
}
