// Beam decode attention for the TFM head, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel doc2tex_tpu/ops/decode_attention.py::_kernel
// (pl.pallas_call in decode_attention).  Same function, in the same order
// of rounding as that kernel and its reference (_reference):
//
//   s[b,k,h,m]   = sum_d q[b,k,h,d] * k[b,m,h,d]               f32 (q pre-scaled)
//   s            = mask[b,k,m] ? s : -inf                      (mask optional)
//   p            = exp(s - max_m s) / sum_m exp(s - max_m s)   f32, over ALL M
//   p            = round(p) to v's type
//   out[b,k,h,d] = round(sum_m p * v[b,m,h,d])                 f32 sum, one rounding
//
// q (B,K,nh,hd), k/v (B,M,nh,hd), mask (B,K,M) bool, out (B,K,nh,hd), all
// contiguous and 16-byte aligned; one element type for q, k, v and out:
// float, half or bfloat16.  A row whose every position is masked gives NaN,
// as softmax does.
//
// What bounds it: bytes.  K <= 16 beam queries of hd 32..128 against M keys
// do ~2*K flops per K/V element read, far under the ~295 flops/byte at which
// the H100's tensor cores, not HBM, would limit.  So the design moves only
// the bytes the function needs and keeps everything else on chip:
//   - grid: a cluster of C <= 8 blocks of 8 warps per (sample, head); block
//     r owns positions [r*chunk, (r+1)*chunk).  The wrapper's launch_plan
//     chooses C, chunk and the ring depth: C > 1 where B*nh blocks would
//     leave SMs idle, or where one block cannot hold the scores of M;
//   - only attended rows: the block stages its positions' mask rows with
//     16-byte cp.async and folds them into one bit-set per position.  A K/V
//     row no beam attends is never read (cp.async with a source size of 0
//     writes zeros), and a 128-position tile without an attended row is
//     neither read nor computed.  The first K tiles are in flight with the
//     mask, read whole;
//   - loads overlap math: K tiles, then V tiles, stream through one ring of
//     `stages` 128-position buffers in shared memory filled by cp.async; the
//     next tiles' bytes fly while the current one is used, and the first V
//     tiles' bytes fly during the softmax;
//   - tensor cores (bf16/f16): Q.K and P.V through mma.sync m16n8k16 with
//     f32 accumulation, the queries padded to 16 rows; a warp owns 16
//     positions of a tile.  float32 stays float32 on the CUDA cores (no
//     TF32);
//   - the reference's rounding point: the f32 scores of the block's
//     positions stay in shared memory.  Row maxima (kept while scoring) and
//     then row sums are combined over the cluster through distributed shared
//     memory; every probability is normalised with the global values, with a
//     correctly rounded quotient, and rounded to v's type in place before
//     P.V;
//   - the blocks' f32 partial P.V sums are added in rank order through
//     distributed shared memory; rank 0 rounds once and writes (B,K,nh,hd)
//     directly.  One launch, no workspace in device memory, no second pass.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 16;          // beam queries per sample (one m16 tile)
constexpr int kTile = 128;         // positions per ring buffer: 16 per warp
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;   // 227 KB: the most a block may use on sm_90

// Byte offsets of the dynamic shared memory.  ops/decode_attention.py's
// smem_bytes() is the same arithmetic; the launcher refuses a plan whose
// bytes are fewer than this layout needs.
struct Layout {
  int ring, q, oblk, red, psum, tflag, mbits, scores, total;
};

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int K, int chunk, int stages, int hd, int elem) {
  const int rs = hd * elem + 16;  // a K/V or Q row in shared memory, padded by 16 bytes
  Layout L;
  int off = 0;
  const int ring = stages * kTile * rs;
  const int ored = kWarps * kMaxQ * hd * 4;  // partial outputs, in the ring at the end
  L.ring = off;   off += up16(ring > ored ? ring : ored);
  L.q = off;      off += up16(kMaxQ * rs);
  L.oblk = off;   off += up16(kMaxQ * hd * 4);
  L.red = off;    off += up16((kWarps + 4) * kMaxQ * 4);
  L.psum = off;   off += up16(kMaxQ * kWarps * 4);
  L.tflag = off;  off += up16(chunk / kTile * 4);
  L.mbits = off;  off += up16(chunk * 2);
  L.scores = off; off += up16(K * (chunk + 4) * 4);
  L.total = off;
  return L;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// two f32 rounded to T and packed, the first in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
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
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
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

// ---- Q.K of one tile: f32 scores of rows < K into s (row stride SS) -----
// Each thread also keeps the running maximum of the rows it scores.

// tensor cores: warp w scores positions 16w..16w+15 of the tile (two n8
// tiles) against the 16 (padded) query rows held as A fragments; the thread
// holds rows g and g + 8
template <typename T, int HD>
__device__ __forceinline__ void score_tile_mma(const unsigned char* buf,
                                               const uint32_t (&qa)[HD / 16][4], float* s, int SS,
                                               const uint16_t* mbits, int m0, int n_local, int K,
                                               int warp, int lane, float (&rmax)[2]) {
  constexpr int RS = HD * 2 + 16;
  float acc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t b[4];
    const int pos = 16 * warp + (lane & 7) + 8 * (lane >> 4);
    ldmatrix_x4(b, buf + pos * RS + (kk * 16 + 8 * ((lane >> 3) & 1)) * 2);
    mma16816<T>(acc[0], qa[kk], b[0], b[1]);
    mma16816<T>(acc[1], qa[kk], b[2], b[3]);
  }
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int m = m0 + 16 * warp + 8 * nt + 2 * c;  // even: a float2 of two positions
    const unsigned bits0 = m < n_local ? mbits[m] : 0u;
    const unsigned bits1 = m + 1 < n_local ? mbits[m + 1] : 0u;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      float2 v;
      v.x = (bits0 >> r) & 1u ? acc[nt][2 * half] : -INFINITY;
      v.y = (bits1 >> r) & 1u ? acc[nt][2 * half + 1] : -INFINITY;
      rmax[half] = fmaxf(rmax[half], fmaxf(v.x, v.y));
      if (r < K) *reinterpret_cast<float2*>(s + r * SS + m) = v;
    }
  }
}

// float32 on the CUDA cores: thread scores one position of the tile against
// every other query row (rows half, half + 2, ...)
template <int HD>
__device__ __forceinline__ void score_tile_f32(const unsigned char* buf, const float* q_s, float* s,
                                               int SS, const uint16_t* mbits, int m0, int n_local,
                                               int K, int tid, float (&rmax)[kMaxQ / 2]) {
  constexpr int RSF = HD + 4;  // floats per padded row
  const int p = tid % kTile;
  const int half = tid / kTile;  // warp-uniform
  const float* kr = reinterpret_cast<const float*>(buf) + p * RSF;
  float acc[kMaxQ / 2] = {};
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
    for (int j = 0; j < kMaxQ / 2; ++j) {
      const int r = half + 2 * j;
      if (r < K) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + r * RSF + d);
        acc[j] = fmaf(qv.x, kv.x, acc[j]);
        acc[j] = fmaf(qv.y, kv.y, acc[j]);
        acc[j] = fmaf(qv.z, kv.z, acc[j]);
        acc[j] = fmaf(qv.w, kv.w, acc[j]);
      }
    }
  }
  const int m = m0 + p;
  const unsigned bits = m < n_local ? mbits[m] : 0u;
#pragma unroll
  for (int j = 0; j < kMaxQ / 2; ++j) {
    const int r = half + 2 * j;
    if (r < K) {
      const float x = (bits >> r) & 1u ? acc[j] : -INFINITY;
      rmax[j] = fmaxf(rmax[j], x);
      s[r * SS + m] = x;
    }
  }
}

// ---- P.V of one tile into per-thread f32 partial outputs --------------

// tensor cores: warp w takes positions 16w..16w+15 of the tile as one k16
// step over all of hd; P (rounded to T; tile t of row r at p + r*PS +
// 2*kTile*t) is the A operand.  Rows >= K read row K-1: their outputs are
// dropped.
template <typename T, int HD>
__device__ __forceinline__ void pv_tile_mma(const unsigned char* buf, const T* p, int PS, int t,
                                            int K, int warp, int lane, float (&o)[HD / 8][4]) {
  constexpr int RS = HD * 2 + 16;
  uint32_t a[4];
  const int prow = min((lane & 7) + 8 * ((lane >> 3) & 1), K - 1);
  ldmatrix_x4(a, p + prow * PS + 2 * kTile * t + 16 * warp + 8 * (lane >> 4));
  const int pos = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, buf + pos * RS + (np * 16 + 8 * (lane >> 4)) * 2);
    mma16816<T>(o[2 * np], a, b[0], b[1]);
    mma16816<T>(o[2 * np + 1], a, b[2], b[3]);
  }
}

// float32: thread owns a float4 of hd (qd) for every row over a group of
// the tile's positions; p is normalised in place in s
template <int HD>
__device__ __forceinline__ void pv_tile_f32(const unsigned char* buf, const float* s, int SS,
                                            int m0, int K, int tid, float (&acc)[kMaxQ][4]) {
  constexpr int RSF = HD + 4;
  constexpr int QD = HD / 4;                   // float4 columns
  constexpr int PPG = kTile * QD / kThreads;   // positions per thread and tile
  const int qd = tid % QD;
  const int grp = tid / QD;
#pragma unroll
  for (int i = 0; i < PPG; ++i) {
    const int mt = grp * PPG + i;
    const float4 vv = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(buf) +
                                                       mt * RSF + 4 * qd);
#pragma unroll
    for (int r = 0; r < kMaxQ; ++r) {
      if (r < K) {
        const float pr = s[r * SS + m0 + mt];
        acc[r][0] = fmaf(pr, vv.x, acc[r][0]);
        acc[r][1] = fmaf(pr, vv.y, acc[r][1]);
        acc[r][2] = fmaf(pr, vv.z, acc[r][2]);
        acc[r][3] = fmaf(pr, vv.w, acc[r][3]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const unsigned char* __restrict__ mask,
                        T* __restrict__ out, int K, int M, int nh, int chunk, int stages) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int ELEM = sizeof(T);
  constexpr int RS = HD * ELEM + 16;     // bytes of a padded row in shared memory
  constexpr int CPR = HD * ELEM / 16;    // 16-byte pieces of a row
  constexpr int VEC = 16 / ELEM;
  constexpr int PIECES = kTile * CPR / kThreads;  // 16-byte copies per thread and tile
  static_assert(HD % 32 == 0 && HD <= 128 && PIECES >= 1, "head dim");

  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x / nh;  // the cluster: blocks h*C .. h*C + C-1 along x
  const int rank = blockIdx.x % C;
  const int h = blockIdx.x / C;
  // a cluster of one block needs only the block's barrier
  auto cluster_sync = [&]() {
    if (C == 1) {
      __syncthreads();
    } else {
      cluster.sync();
    }
  };
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const Layout L = make_layout(K, chunk, stages, HD, ELEM);
  unsigned char* ring = smem + L.ring;
  unsigned char* q_s = smem + L.q;
  float* o_blk = reinterpret_cast<float*>(smem + L.oblk);
  float* wmax = reinterpret_cast<float*>(smem + L.red);  // [warp][row]
  float* blk_max = wmax + kWarps * kMaxQ;
  float* blk_sum = blk_max + kMaxQ;
  float* gmax = blk_max + 2 * kMaxQ;
  float* gsum = blk_max + 3 * kMaxQ;
  float* psum = reinterpret_cast<float*>(smem + L.psum);  // [row][warp]
  int* tflag = reinterpret_cast<int*>(smem + L.tflag);
  uint16_t* mbits = reinterpret_cast<uint16_t*>(smem + L.mbits);
  float* s = reinterpret_cast<float*>(smem + L.scores);
  // score rows 4 mod 32 words apart: the ldmatrix rows of P hit distinct banks
  const int SS = chunk + 4;

  const int m_lo = rank * chunk;
  const int n_local = max(0, min(M - m_lo, chunk));
  const int n_tiles = (n_local + kTile - 1) / kTile;
  const long row = (long)nh * HD;  // elements between consecutive positions / queries
  const T* qb = q + ((long)b * K * nh + h) * HD;
  const T* kb = k + ((long)b * M * nh + h) * HD + (long)m_lo * row;
  const T* vb = v + ((long)b * M * nh + h) * HD + (long)m_lo * row;

  // tile i of the stream: K tiles 0..n_tiles-1, then V tiles.  Thread tid
  // copies pieces tid, tid + kThreads, ... of every tile.  Until the mask
  // is `known`, only K tiles go, whole (a K row no beam attends only gets
  // a score of -inf); after, a row no beam attends is not read, nor a tile
  // without an attended row.
  auto issue = [&](int i, bool known) {
    if (i < 2 * n_tiles && (known || i < n_tiles)) {
      const int tt = i < n_tiles ? i : i - n_tiles;
      if (!known || tflag[tt]) {
        const T* src = (i < n_tiles ? kb : vb) + (long)tt * kTile * row;
        unsigned char* dst = ring + (i % stages) * (kTile * RS);
#pragma unroll
        for (int j = 0; j < PIECES; ++j) {
          const int piece = tid + j * kThreads;
          const int r = piece / CPR, c = piece % CPR;
          const int m = tt * kTile + r;
          const bool live = m < n_local && (!known || mbits[m] != 0);
          cp_async16(dst + r * RS + c * 16, live ? src + r * row + c * VEC : src, live ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // the mask of this block's positions, as raw bytes into the scores region
  // (free until pass 1): 16-byte cp.async of the aligned pieces that cover
  // each row, all in flight at once
  int* moff = reinterpret_cast<int*>(gmax);  // where each staged row starts
  unsigned char* stage = reinterpret_cast<unsigned char*>(s);
  const int MSB = chunk + 16;                // bytes of a staged row
  if (mask != nullptr) {
    const unsigned char* mb = mask + (long)b * K * M + m_lo;
    const unsigned char* mask_end = mask + (long)gridDim.y * K * M;
    for (int r = warp; r < K; r += kWarps) {
      const unsigned char* row_start = mb + (long)r * M;
      const unsigned char* w0 = reinterpret_cast<const unsigned char*>(
          reinterpret_cast<uintptr_t>(row_start) & ~uintptr_t(15));
      const int pieces = static_cast<int>((row_start + n_local - w0 + 15) / 16);
      for (int w = lane; w < pieces; w += 32) {
        const long left = mask_end - (w0 + 16 * w);
        const int bytes = left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0);
        cp_async16(stage + r * MSB + 16 * w, bytes ? w0 + 16 * w : mask, bytes);
      }
      if (lane == 0) moff[r] = r * MSB + static_cast<int>(row_start - w0);
    }
    cp_async_commit();
    for (int i = 0; i < stages - 1; ++i) issue(i, false);  // the first K tiles fly with it
  }
  // queries, zero-padded to 16 rows
  for (int i = tid; i < kMaxQ * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < K) x = *reinterpret_cast<const uint4*>(qb + (long)r * row + c * VEC);
    *reinterpret_cast<uint4*>(q_s + r * RS + c * 16) = x;
  }
  for (int t = tid; t < n_tiles; t += kThreads) tflag[t] = mask == nullptr;
  if (mask != nullptr) {
    cp_async_wait(stages - 1);  // the mask's group: the oldest
    __syncthreads();
    int off[kMaxQ];
#pragma unroll
    for (int r = 0; r < kMaxQ; ++r) off[r] = r < K ? moff[r] : 0;
    for (int m = tid; m < n_local; m += kThreads) {
      unsigned bits = 0;
#pragma unroll
      for (int r = 0; r < kMaxQ; ++r) {
        if (r < K) bits |= (unsigned)(stage[off[r] + m] != 0) << r;
      }
      mbits[m] = static_cast<uint16_t>(bits);
      if (bits) tflag[m / kTile] = 1;
    }
  } else {
    for (int m = tid; m < n_local; m += kThreads) mbits[m] = 0xffffu;
  }
  __syncthreads();
  // the rest of the first stages - 1 tiles: V tiles when there are fewer K
  // tiles (pass 2 waits for all of these)
  for (int i = mask != nullptr ? n_tiles : 0; i < stages - 1; ++i) issue(i, true);

  uint32_t qa[HD / 16][4];
  if constexpr (!kF32) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      ldmatrix_x4(qa[kk], q_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                              (kk * 16 + 8 * (lane >> 4)) * 2);
    }
  }

  // pass 1: scores, and each thread's running row maxima
  float rmax[kF32 ? kMaxQ / 2 : 2];
#pragma unroll
  for (int j = 0; j < (kF32 ? kMaxQ / 2 : 2); ++j) rmax[j] = -INFINITY;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait(stages - 2);
    __syncthreads();  // tile i landed for all; everyone is done with tile i - 1
    issue(i + stages - 1, true);
    if (tflag[i]) {
      const unsigned char* buf = ring + (i % stages) * (kTile * RS);
      if constexpr (kF32) {
        score_tile_f32<HD>(buf, reinterpret_cast<const float*>(q_s), s, SS, mbits, i * kTile,
                           n_local, K, tid, rmax);
      } else {
        score_tile_mma<T, HD>(buf, qa, s, SS, mbits, i * kTile, n_local, K, warp, lane, rmax);
      }
    }
  }

  // row maxima: warp, then block, then cluster
  if constexpr (kF32) {
    const int half = tid / kTile;
#pragma unroll
    for (int j = 0; j < kMaxQ / 2; ++j) {
      const float mx = warp_max(rmax[j]);
      if (lane == 0) {
        wmax[warp * kMaxQ + half + 2 * j] = mx;
        wmax[warp * kMaxQ + 1 - half + 2 * j] = -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = rmax[half];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if ((lane & 3) == 0) wmax[warp * kMaxQ + (lane >> 2) + 8 * half] = mx;
    }
  }
  __syncthreads();
  if (tid < K) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wmax[w * kMaxQ + tid]);
    blk_max[tid] = mx;
  }
  cluster_sync();
  if (tid < K) {
    float g = -INFINITY;
    for (int c = 0; c < C; ++c) g = fmaxf(g, cluster.map_shared_rank(blk_max, c)[tid]);
    gmax[tid] = g;
  }
  __syncthreads();

  // e = exp(s - max) in place, then p = e / sum.  Warp w takes the w-th
  // eighth of the (row, tile) pairs in row order, a float4 of positions per
  // lane.  It sums each row it meets into psum[row][w]; a row's sum is then
  // taken over w in order.
  static_assert(kTile == 4 * 32, "a tile is a float4 per lane");
  const int n_tasks = K * n_tiles;
  const int first = warp * n_tasks / kWarps, last = (warp + 1) * n_tasks / kWarps;
  const int r_first = n_tiles ? first / n_tiles : 0, t_first = n_tiles ? first % n_tiles : 0;
  if (lane < K) psum[lane * kWarps + warp] = 0.f;
  __syncwarp();
  {
    int r = r_first, t = t_first;
    float lane_sum = 0.f;
    for (int task = first; task < last; ++task) {
      if (tflag[t]) {
        const float g = gmax[r];  // -inf for a row masked everywhere: exp gives NaN, as softmax
        float4* e = reinterpret_cast<float4*>(s + r * SS + t * kTile) + lane;
        float4 x = *e;
        x.x = expf(x.x - g);
        x.y = expf(x.y - g);
        x.z = expf(x.z - g);
        x.w = expf(x.w - g);
        *e = x;
        lane_sum += (x.x + x.y) + (x.z + x.w);
      }
      const bool row_end = ++t == n_tiles;
      if (row_end || task + 1 == last) {
        lane_sum = warp_sum(lane_sum);
        if (lane == 0) psum[r * kWarps + warp] = lane_sum;
        lane_sum = 0.f;
      }
      if (row_end) {
        t = 0;
        ++r;
      }
    }
  }
  __syncthreads();
  if (tid < K) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += psum[tid * kWarps + w];
    blk_sum[tid] = sum;
  }
  cluster_sync();
  if (tid < K) {
    float sum = 0.f;
    for (int c = 0; c < C; ++c) sum += cluster.map_shared_rank(blk_sum, c)[tid];
    gsum[tid] = sum;
  }
  __syncthreads();

  // p = e / sum with the cluster's sum, rounded to T, over the same
  // pairs.  The quotient is correctly rounded: q = e * (1/sum), then one
  // FMA step on its exact remainder.  Below float32 a tile's rounded values
  // go to the first half of its own f32 values, after the warp has read
  // them all.
  T* p_s = reinterpret_cast<T*>(s);
  const int PS = kF32 ? SS : 2 * SS;  // P's row stride in elements of T
  {
    int r = r_first, t = t_first;
    for (int task = first; task < last; ++task) {
      if (tflag[t]) {
        const float sum = gsum[r];
        const float inv = 1.f / sum;
        float4* e = reinterpret_cast<float4*>(s + r * SS + t * kTile) + lane;
        const float4 x = *e;
        float p[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float q0 = p[j] * inv;
          p[j] = fmaf(fmaf(-q0, sum, p[j]), inv, q0);
        }
        if constexpr (kF32) {
          *e = make_float4(p[0], p[1], p[2], p[3]);
        } else {
          __syncwarp();
          reinterpret_cast<uint2*>(p_s + r * PS + 2 * kTile * t)[lane] =
              make_uint2(pack2<T>(p[0], p[1]), pack2<T>(p[2], p[3]));
        }
      }
      if (++t == n_tiles) {
        t = 0;
        ++r;
      }
    }
  }
  __syncthreads();

  // pass 2: P.V
  float o_mma[HD / 8][4] = {};
  float o_f32[kF32 ? kMaxQ : 1][4] = {};
  for (int i = n_tiles; i < 2 * n_tiles; ++i) {
    cp_async_wait(i < stages - 1 ? 0 : stages - 2);
    __syncthreads();
    issue(i + stages - 1, true);
    const int tt = i - n_tiles;
    if (tflag[tt]) {
      const unsigned char* buf = ring + (i % stages) * (kTile * RS);
      if constexpr (kF32) {
        pv_tile_f32<HD>(buf, s, SS, tt * kTile, K, tid, o_f32);
      } else {
        pv_tile_mma<T, HD>(buf, p_s, PS, tt, K, warp, lane, o_mma);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free: it takes the warps' partial outputs

  float* o_red = reinterpret_cast<float*>(ring);  // [warp][16][HD]
  if constexpr (kF32) {
    constexpr int QD = HD / 4;
    const int qd = tid % QD;
#pragma unroll
    for (int r = 0; r < kMaxQ; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int o = QD; o < 32; o <<= 1) o_f32[r][c] += __shfl_xor_sync(0xffffffffu, o_f32[r][c], o);
      }
      if (lane < QD) {
        *reinterpret_cast<float4*>(o_red + (warp * kMaxQ + r) * HD + 4 * qd) =
            make_float4(o_f32[r][0], o_f32[r][1], o_f32[r][2], o_f32[r][3]);
      }
    }
  } else {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      *reinterpret_cast<float2*>(o_red + (warp * kMaxQ + g) * HD + nt * 8 + 2 * c) =
          make_float2(o_mma[nt][0], o_mma[nt][1]);
      *reinterpret_cast<float2*>(o_red + (warp * kMaxQ + g + 8) * HD + nt * 8 + 2 * c) =
          make_float2(o_mma[nt][2], o_mma[nt][3]);
    }
  }
  __syncthreads();
  for (int j = tid; j < K * HD; j += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += o_red[w * kMaxQ * HD + j];
    o_blk[j] = x;
  }
  cluster_sync();
  if (rank == 0) {
    for (int j = tid; j < K * HD; j += kThreads) {
      float x = 0.f;
      for (int c = 0; c < C; ++c) x += cluster.map_shared_rank(o_blk, c)[j];
      const int r = j / HD;
      if (gmax[r] == -INFINITY) x = NAN;  // every position masked: softmax gives NaN
      out[(((long)b * K + r) * nh + h) * HD + j % HD] = from_f32<T>(x);
    }
  }
  cluster_sync();  // no block leaves while rank 0 reads its shared memory
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
           int K, int M, int nh, int cluster, int chunk, int stages, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, HD>;
  // once per instance, before any launch (so never inside a graph capture)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  if (smem_bytes < make_layout(K, chunk, stages, HD, (int)sizeof(T)).total) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nh * cluster, B, 1);
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
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                                 static_cast<const T*>(v),
                                 static_cast<const unsigned char*>(mask), static_cast<T*>(out), K,
                                 M, nh, chunk, stages);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
              int K, int M, int nh, int hd, int cluster, int chunk, int stages, int smem_bytes,
              cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, mask, out, B, K, M, nh, cluster, chunk, stages, smem_bytes, s);
    case 64: return launch<T, 64>(q, k, v, mask, out, B, K, M, nh, cluster, chunk, stages, smem_bytes, s);
    case 128: return launch<T, 128>(q, k, v, mask, out, B, K, M, nh, cluster, chunk, stages, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  mask may be null.
// (cluster, chunk, stages, smem_bytes) is the wrapper's launch plan: blocks
// per (sample, head), positions per block (a multiple of 64, cluster *
// chunk >= M), ring buffers, and dynamic shared memory per block.
// Returns 0, or the CUDA error of the launch.
extern "C" int d2t_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int K, int M, int nh,
                                    int hd, int dtype, int cluster, int chunk, int stages,
                                    int smem_bytes, void* stream) {
  if (B <= 0 || B > 65535 || K <= 0 || K > kMaxQ || M <= 0 || nh <= 0 ||
      cluster <= 0 || cluster > kMaxCluster || (long)nh * cluster > 65535 || chunk <= 0 ||
      chunk % kTile != 0 || (long)cluster * chunk < M || stages < 2 || stages > kMaxStages ||
      smem_bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0: rc = launch_hd<float>(q, k, v, mask, out, B, K, M, nh, hd, cluster, chunk, stages, smem_bytes, s); break;
    case 1: rc = launch_hd<__half>(q, k, v, mask, out, B, K, M, nh, hd, cluster, chunk, stages, smem_bytes, s); break;
    case 2: rc = launch_hd<__nv_bfloat16>(q, k, v, mask, out, B, K, M, nh, hd, cluster, chunk, stages, smem_bytes, s); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
