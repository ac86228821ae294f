// Beam decode attention for the TFM head, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel doc2tex_tpu/ops/decode_attention.py::_kernel
// (pl.pallas_call in decode_attention).  Same function:
//
//   scores[b,k,h,m] = sum_d q[b,k,h,d] * k[b,m,h,d]     (q pre-scaled)
//   scores          = mask[b,k,m] ? scores : -inf        (mask optional)
//   attn            = softmax_m(scores)                  (f32)
//   out[b,k,h,d]    = sum_m attn[b,k,h,m] * v[b,m,h,d]   (out in v's type)
//
// q (B,K,nh,hd), k/v (B,M,nh,hd), mask (B,K,M) bool, out (B,K,nh,hd), all
// contiguous; element type float, half or bfloat16 (q, k, v and out alike).
//
// What bounds it: bytes.  K beam queries (1-16) of hd 32 against M keys do
// ~2*K flops per K/V element read, far under the ~295 flops/byte at which
// H100's tensor cores, not HBM, would limit.  So the design reads K and V
// exactly once and keeps everything else on chip:
//   - one block per (sample, head); the block's K (<= 16) queries stay in
//     shared memory, so every K/V tile serves all beams of the sample;
//   - K/V are streamed in tiles of TM positions through shared memory with
//     16-byte loads, converted to f32 once;
//   - an online softmax in f32 (running max and sum per query) means no
//     score or probability ever leaves the SM; the bool mask is read per
//     tile straight from global memory;
//   - the output is written (B,K,nh,hd) directly (the TPU kernel wrote it
//     head-major and transposed after).
// Inside the SM the limit is then shared-memory instructions, so each warp
// owns up to 4 query rows and reuses every shared load across them:
//   - scores: lanes split the tile's positions; a float4 of K (rows padded
//     by 4 floats, conflict-free) meets a float4 of each row's q;
//   - P.V: lanes split hd into float4 columns x the tile's positions; a
//     float4 of V meets each row's probabilities (read as float4), and the
//     position groups are summed by one shuffle reduction at the end.
// Splitting M across blocks when B*nh is small, TMA and double buffering
// are left for later.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 16;                      // beam queries per sample
constexpr int kRowsPerWarp = kMaxQ / kWarps;   // query rows owned by a warp

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int N>
__device__ __forceinline__ void store_f32(float* dst, const float* src) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    *reinterpret_cast<float4*>(dst + j) = make_float4(src[j], src[j + 1], src[j + 2], src[j + 3]);
  }
}

template <typename T, int HD, int TM>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const bool* __restrict__ mask,
                        T* __restrict__ out, int K, int M, int nh) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte global load
  constexpr int VPR = HD / VEC;         // 16-byte vectors per K/V row
  constexpr int KLD = HD + 4;           // padded K row: float4 reads across rows hit distinct banks
  constexpr int MPL = TM / 32;          // positions per lane for the scores
  constexpr int DG = HD / 4;            // lanes along hd for P.V (a float4 each)
  constexpr int PG = 32 / DG;           // lane groups along the tile's positions for P.V
  constexpr int PPL = TM / PG;          // positions per lane for P.V
  constexpr int R = kRowsPerWarp;
  static_assert(HD % 32 == 0 && HD <= 128 && TM % 32 == 0 && PPL % 4 == 0, "tile shape");

  __shared__ __align__(16) float q_s[kMaxQ][HD];
  __shared__ __align__(16) float k_s[TM][KLD];
  __shared__ __align__(16) float v_s[TM][HD];
  __shared__ __align__(16) float p_s[kWarps][R][TM];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int dg = lane % DG;
  const int pg = lane / DG;
  const long row = (long)nh * HD;  // elements between consecutive positions / queries
  const T* qb = q + ((long)b * K * nh + h) * HD;
  const T* kb = k + ((long)b * M * nh + h) * HD;
  const T* vb = v + ((long)b * M * nh + h) * HD;
  const bool* mb = mask ? mask + (long)b * K * M : nullptr;

  for (int i = tid; i < K * HD; i += kThreads) {
    q_s[i / HD][i % HD] = to_f32(qb[(long)(i / HD) * row + i % HD]);
  }

  float acc[R][4];
  float m_run[R];
  float l_run[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  for (int m0 = 0; m0 < M; m0 += TM) {
    __syncthreads();  // q_s is written / every warp is done with the previous tile
    for (int i = tid; i < TM * VPR; i += kThreads) {
      const int r = i / VPR;
      const int c = (i % VPR) * VEC;
      const int m = m0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) {  // the tile's tail stays zero: p = 0 there, and 0 * 0 adds nothing
        kv = *reinterpret_cast<const uint4*>(kb + (long)m * row + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long)m * row + c);
      }
      const T* ke = reinterpret_cast<const T*>(&kv);
      const T* ve = reinterpret_cast<const T*>(&vv);
      float kf[VEC], vf[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        kf[j] = to_f32(ke[j]);
        vf[j] = to_f32(ve[j]);
      }
      store_f32<VEC>(&k_s[r][c], kf);
      store_f32<VEC>(&v_s[r][c], vf);
    }
    __syncthreads();

    // scores of this warp's rows at positions lane + 32 j
    float s[R][MPL];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < MPL; ++j) s[r][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 kf[MPL];
#pragma unroll
      for (int j = 0; j < MPL; ++j) kf[j] = *reinterpret_cast<const float4*>(&k_s[lane + 32 * j][d]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (warp + kWarps * r < K) {  // warp-uniform
          const float4 qf = *reinterpret_cast<const float4*>(&q_s[warp + kWarps * r][d]);
#pragma unroll
          for (int j = 0; j < MPL; ++j) {
            s[r][j] = fmaf(qf.x, kf[j].x, s[r][j]);
            s[r][j] = fmaf(qf.y, kf[j].y, s[r][j]);
            s[r][j] = fmaf(qf.z, kf[j].z, s[r][j]);
            s[r][j] = fmaf(qf.w, kf[j].w, s[r][j]);
          }
        }
      }
    }

    // online softmax per row; probabilities to p_s
    float corr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = warp + kWarps * r;
      corr[r] = 1.f;
      if (qi < K) {  // warp-uniform
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < MPL; ++j) {
          const int m = m0 + lane + 32 * j;
          const bool keep = m < M && (mb == nullptr || mb[(long)qi * M + m]);
          s[r][j] = keep ? s[r][j] : -INFINITY;
          tmax = fmaxf(tmax, s[r][j]);
        }
        tmax = warp_max(tmax);
        const float m_new = fmaxf(m_run[r], tmax);
        // all positions masked so far: keep every exp at exp(-inf) = 0
        const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
        corr[r] = expf(m_run[r] - m_use);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < MPL; ++j) {
          const float p = expf(s[r][j] - m_use);
          p_s[warp][r][lane + 32 * j] = p;
          psum += p;
        }
        psum = warp_sum(psum);
        l_run[r] = l_run[r] * corr[r] + psum;
        m_run[r] = m_new;
      }
    }
    __syncwarp();

    // P.V: this lane's float4 of hd over its PPL positions of the tile
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= corr[r];
#pragma unroll
    for (int i = 0; i < PPL; i += 4) {
      const int m = pg * PPL + i;
      float4 pf[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pf[r] = (warp + kWarps * r < K) ? *reinterpret_cast<const float4*>(&p_s[warp][r][m])
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const float4 vf = *reinterpret_cast<const float4*>(&v_s[m + mm][4 * dg]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = lane_of(pf[r], mm);
          acc[r][0] = fmaf(p, vf.x, acc[r][0]);
          acc[r][1] = fmaf(p, vf.y, acc[r][1]);
          acc[r][2] = fmaf(p, vf.z, acc[r][2]);
          acc[r][3] = fmaf(p, vf.w, acc[r][3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = warp + kWarps * r;
    if (qi < K) {  // warp-uniform: every lane joins the shuffles
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int o = DG; o < 32; o <<= 1) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
      }
      if (pg == 0) {
        // a row with every position masked gives 0/0 = NaN, as softmax does
        const float inv = 1.f / l_run[r];
        T* ob = out + (((long)b * K + qi) * nh + h) * HD + 4 * dg;
#pragma unroll
        for (int c = 0; c < 4; ++c) ob[c] = from_f32<T>(acc[r][c] * inv);
      }
    }
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const void* mask, void* out,
            int B, int K, int M, int nh, cudaStream_t stream) {
  constexpr int TM = HD >= 128 ? 32 : 64;  // keeps static shared memory under 48 KB
  decode_attention_kernel<T, HD, TM><<<dim3(nh, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const bool*>(mask), static_cast<T*>(out), K, M, nh);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* mask, void* out,
              int B, int K, int M, int nh, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: launch<T, 32>(q, k, v, mask, out, B, K, M, nh, stream); break;
    case 64: launch<T, 64>(q, k, v, mask, out, B, K, M, nh, stream); break;
    case 128: launch<T, 128>(q, k, v, mask, out, B, K, M, nh, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  mask may be null.
// Returns 0, or the CUDA error of the launch (cudaGetLastError).
extern "C" int d2t_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int K, int M,
                                    int nh, int hd, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || K <= 0 || K > kMaxQ || M <= 0 || nh <= 0 || nh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0: rc = launch_hd<float>(q, k, v, mask, out, B, K, M, nh, hd, s); break;
    case 1: rc = launch_hd<__half>(q, k, v, mask, out, B, K, M, nh, hd, s); break;
    case 2: rc = launch_hd<__nv_bfloat16>(q, k, v, mask, out, B, K, M, nh, hd, s); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
