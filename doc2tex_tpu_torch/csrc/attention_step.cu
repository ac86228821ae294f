// Coverage-attention decode step of the LSTM head, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel doc2tex_tpu/ops/attention_step.py::_kernel
// (pl.pallas_call in fused_attention_step).  Same function, per row b of
// the decode batch (a sample's beam):
//
//   x[s,h]   = (enc_proj[b,s,h] + q[b,h]) + (sum_k loc[b,s,k] * w_loc[k,h] + b_loc[h])
//   e[s]     = sum_h tanh(x[s,h]) * w_score[h]       (s < valid; else -1e30)
//   alpha[s] = softmax_s(e)                           (f32, written normalised)
//   ctx[d]   = sum_s alpha[s] * enc[b,s,d]            (f32)
//
// enc (B,S,D) and enc_proj (B,S,H) in float or bfloat16 (the compute type);
// q (B,H), loc (B,S,Kl), w_loc (Kl,H), b_loc (H), w_score (H) in float; ctx
// (B,D) and alpha (B,S) in float.  All contiguous and 16-byte aligned.
//
// What bounds it.  At the release shape (B*K = 640 rows, S 623, D = H =
// 128, Kl 64, bf16 memory) one step reads ~306 MB (enc, enc_proj and the
// f32 loc) and does 3.3 G multiply-adds for loc.w_loc: ~0.09 ms of HBM
// time and ~0.1 ms of float32 CUDA-core time, so the two bounds are about
// equal.  The design reads every input once and keeps every intermediate
// on chip (the TPU kernel kept them in VMEM for a block of rows):
//   - one block per row; w_loc sits in dynamic shared memory (32 KB at the
//     release width, 128 KB at Kl 128 x H 256), each lane keeps its H/32
//     columns of q, b_loc and w_score in registers;
//   - each warp scores 8 positions at a time: it stages their loc rows in
//     shared memory, transposed, so one float4 broadcast gives a feature
//     for 4 positions, and multiplies them by its columns of w_loc (a
//     register tile of 8 positions x H/32 columns per lane); the enc_proj
//     loads of those positions are issued before that loop;
//   - a warp-shuffle sum over h gives e[s]; the S scores stay in shared
//     memory (S floats), so the softmax is exact and two-pass;
//   - the context is a second stream over enc: warps split positions,
//     lanes split D, and the 8 warps' partial sums meet in shared memory.
// Tensor cores for loc.w_loc, the location conv folded in, and enc read
// once per sample instead of once per beam are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPos = 8;             // positions a warp scores at a time
constexpr float kNegInf = -1e30f;   // the score of a position past valid

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive elements of type T (4, 8, 16 or 32 bytes, aligned) -> f32.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kPer16 = 16 / (int)sizeof(T);
  if constexpr (kBytes >= 16) {
    static_assert(kBytes % 16 == 0, "vector width");
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer16; ++j) out[i * kPer16 + j] = to_f32<T>(e[j]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32<T>(e[j]);
  } else {
    static_assert(kBytes == 4, "vector width");
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32<T>(e[j]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int D, int H>
__global__ void __launch_bounds__(kThreads)
attention_step_kernel(const T* __restrict__ enc, const T* __restrict__ enc_proj,
                      const float* __restrict__ q, const float* __restrict__ loc,
                      const float* __restrict__ w_loc, const float* __restrict__ b_loc,
                      const float* __restrict__ w_score, float* __restrict__ ctx,
                      float* __restrict__ alpha, int S, int Kl, int valid) {
  constexpr int HPL = H / 32;  // columns of H per lane
  constexpr int DPL = D / 32;  // columns of D per lane
  static_assert(H % 64 == 0 && D % 64 == 0 && H <= 256 && D <= 256, "widths");

  extern __shared__ __align__(16) float smem[];
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps];
  const int s_pad = (S + 3) & ~3;
  float* wl_s = smem;              // [Kl][H]
  float* e_s = wl_s + Kl * H;      // [s_pad]: scores, then alpha
  float* scratch = e_s + s_pad;    // [kWarps][Kl][kPos] loc tiles, then [kWarps][D] partial contexts

  const long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_score = valid < 0 ? S : min(valid, S);  // positions that get a score
  const int n_ctx = n_score > 0 ? n_score : S;        // positions whose alpha is not 0

  for (int i = 4 * tid; i < Kl * H; i += 4 * kThreads) {
    *reinterpret_cast<float4*>(wl_s + i) = *reinterpret_cast<const float4*>(w_loc + i);
  }
  float q_r[HPL], bl_r[HPL], ws_r[HPL];
  load_vec<float, HPL>(q + b * H + lane * HPL, q_r);
  load_vec<float, HPL>(b_loc + lane * HPL, bl_r);
  load_vec<float, HPL>(w_score + lane * HPL, ws_r);
  __syncthreads();

  // ---- scores: each warp takes kPos positions at a time ----
  const float* loc_b = loc + b * S * Kl;
  const T* proj_b = enc_proj + b * S * H + lane * HPL;
  float* tile = scratch + warp * Kl * kPos;  // [Kl][kPos]
  for (int s0 = warp * kPos; s0 < n_score; s0 += kWarps * kPos) {
    const int np = min(kPos, n_score - s0);
    const float4* src = reinterpret_cast<const float4*>(loc_b + (long)s0 * Kl);
    for (int i = lane; i < kPos * Kl / 4; i += 32) {
      const int p = 4 * i / Kl;
      const int k = 4 * i % Kl;
      const float4 v = p < np ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      tile[(k + 0) * kPos + p] = v.x;
      tile[(k + 1) * kPos + p] = v.y;
      tile[(k + 2) * kPos + p] = v.z;
      tile[(k + 3) * kPos + p] = v.w;
    }
    float pr[kPos][HPL];
#pragma unroll
    for (int p = 0; p < kPos; ++p) {
      if (p < np) {
        load_vec<T, HPL>(proj_b + (long)(s0 + p) * H, pr[p]);
      } else {
#pragma unroll
        for (int c = 0; c < HPL; ++c) pr[p][c] = 0.f;
      }
    }
    __syncwarp();

    float acc[kPos][HPL];
#pragma unroll
    for (int p = 0; p < kPos; ++p) {
#pragma unroll
      for (int c = 0; c < HPL; ++c) acc[p][c] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < Kl; ++k) {
      const float4 l0 = *reinterpret_cast<const float4*>(tile + k * kPos);
      const float4 l1 = *reinterpret_cast<const float4*>(tile + k * kPos + 4);
      const float lv[kPos] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      float w[HPL];
      load_vec<float, HPL>(wl_s + k * H + lane * HPL, w);
#pragma unroll
      for (int p = 0; p < kPos; ++p) {
#pragma unroll
        for (int c = 0; c < HPL; ++c) acc[p][c] = fmaf(lv[p], w[c], acc[p][c]);
      }
    }

#pragma unroll
    for (int p = 0; p < kPos; ++p) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < HPL; ++c) {
        part += tanhf((pr[p][c] + q_r[c]) + (acc[p][c] + bl_r[c])) * ws_r[c];
      }
      part = warp_sum(part);
      if (lane == 0 && p < np) e_s[s0 + p] = part;
    }
    __syncwarp();  // the tile is rewritten next round
  }
  for (int s = n_score + tid; s < S; s += kThreads) e_s[s] = kNegInf;
  __syncthreads();

  // ---- softmax over the S scores, in f32 ----
  float m = -INFINITY;
  for (int s = tid; s < S; s += kThreads) m = fmaxf(m, e_s[s]);
  m = warp_max(m);
  if (lane == 0) red_max[warp] = m;
  __syncthreads();
  m = red_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_max[w]);
  float sum = 0.f;
  for (int s = tid; s < S; s += kThreads) {
    const float x = expf(e_s[s] - m);
    e_s[s] = x;
    sum += x;
  }
  sum = warp_sum(sum);
  if (lane == 0) red_sum[warp] = sum;
  __syncthreads();
  sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += red_sum[w];
  float* alpha_b = alpha + b * S;
  for (int s = tid; s < S; s += kThreads) {
    const float a = e_s[s] / sum;
    e_s[s] = a;
    alpha_b[s] = a;
  }
  __syncthreads();

  // ---- context: warps split positions, lanes split D ----
  float acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.f;
  const T* enc_b = enc + b * S * D + lane * DPL;
  int s = warp;
  for (; s + 3 * kWarps < n_ctx; s += 4 * kWarps) {
    float v[4][DPL];
#pragma unroll
    for (int j = 0; j < 4; ++j) load_vec<T, DPL>(enc_b + (long)(s + j * kWarps) * D, v[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = e_s[s + j * kWarps];
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[c] = fmaf(a, v[j][c], acc[c]);
    }
  }
  for (; s < n_ctx; s += kWarps) {
    float v[DPL];
    load_vec<T, DPL>(enc_b + (long)s * D, v);
    const float a = e_s[s];
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] = fmaf(a, v[c], acc[c]);
  }
  float* part = scratch + warp * D + lane * DPL;
#pragma unroll
  for (int c = 0; c < DPL; ++c) part[c] = acc[c];
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += scratch[w * D + d];
    ctx[b * D + d] = t;
  }
}

template <typename T, int D>
int launch(const void* enc, const void* enc_proj, const void* q, const void* loc,
           const void* w_loc, const void* b_loc, const void* w_score, void* ctx, void* alpha,
           int B, int S, int Kl, int valid, cudaStream_t stream) {
  constexpr int H = D;
  const size_t s_pad = (size_t)((S + 3) & ~3);
  const size_t scratch = kWarps * (size_t)(Kl * kPos > D ? Kl * kPos : D);
  const size_t smem = sizeof(float) * ((size_t)Kl * H + s_pad + scratch);
  auto kernel = attention_step_kernel<T, D, H>;
  // fails (cudaErrorInvalidValue) when S and Kl need more shared memory
  // than a block may have
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it, so the next launch does not report it
    return (int)err;
  }
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(enc), static_cast<const T*>(enc_proj),
      static_cast<const float*>(q), static_cast<const float*>(loc),
      static_cast<const float*>(w_loc), static_cast<const float*>(b_loc),
      static_cast<const float*>(w_score), static_cast<float*>(ctx),
      static_cast<float*>(alpha), S, Kl, valid);
  return 0;
}

template <typename T>
int launch_d(const void* enc, const void* enc_proj, const void* q, const void* loc,
             const void* w_loc, const void* b_loc, const void* w_score, void* ctx, void* alpha,
             int B, int S, int D, int H, int Kl, int valid, cudaStream_t s) {
  if (H != D) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 128: return launch<T, 128>(enc, enc_proj, q, loc, w_loc, b_loc, w_score, ctx, alpha, B, S, Kl, valid, s);
    case 256: return launch<T, 256>(enc, enc_proj, q, loc, w_loc, b_loc, w_score, ctx, alpha, B, S, Kl, valid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of enc and enc_proj: 0 = float32, 2 = bfloat16.  valid < 0 means no
// mask.  D = H, 128 (the release width) or 256 (the common width); Kl a
// multiple of 4.  Returns 0, or the CUDA error of the launch
// (cudaGetLastError), or cudaErrorInvalidValue for what it does not take,
// S too long for shared memory included.
extern "C" int d2t_attention_step(const void* enc, const void* enc_proj, const void* q,
                                  const void* loc, const void* w_loc, const void* b_loc,
                                  const void* w_score, void* ctx, void* alpha, int B, int S,
                                  int D, int H, int Kl, int valid, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Kl <= 0 || Kl % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0: rc = launch_d<float>(enc, enc_proj, q, loc, w_loc, b_loc, w_score, ctx, alpha, B, S, D, H, Kl, valid, s); break;
    case 2: rc = launch_d<__nv_bfloat16>(enc, enc_proj, q, loc, w_loc, b_loc, w_score, ctx, alpha, B, S, D, H, Kl, valid, s); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
