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
//
// The int8 K/V form (d2t_decode_attention_int8; the K/V element type TK is
// a template parameter, T or int8_t).  The reference computes int8 K/V in
// XLA, not in its Pallas kernel (decode_attention skips pallas_call when
// k_scale/v_scale are given and runs _reference's int8 branch); this form
// replaces that branch on this card.  K/V int8 (B,M,nh,hd) with per-vector
// scales k_scale, v_scale (B,M,nh) float, q and out float or bfloat16:
//
//   s[b,k,h,m]   = (sum_d q[b,k,h,d] * k8[b,m,h,d]) * k_scale[b,m,h]   f32
//   s            = mask ? s : -inf;  p = softmax_m(s)                  f32
//   p            = round(p) to T
//   a            = round(p * round(v_scale[b,m,h]) to T) to T          (f32: p * v_scale)
//   out[b,k,h,d] = round(sum_m a * v8[b,m,h,d])                        f32 sum
//
// The same grid and passes, with what an int8 row saves spent on depth:
//   - bf16 q: a ring buffer holds 256 positions (kTile8), the bytes of a
//     bf16 form's 128, so each tile step (one wait and one barrier) moves
//     twice the positions, and launch_plan may take a ring of up to 8 of
//     them; rows are unpadded (at hd 32 the Q.K fragment loads below are
//     conflict-free, P.V's two-way).  A block's chunk stays a multiple of
//     128: a last tile of which only the first 128 positions are the
//     block's gives its 8 warps 16 positions each, not 32.  float32 q
//     keeps 128-position tiles and its CUDA-core passes (4 bytes widened
//     at a time);
//   - fragments from packed loads (bf16 q): the mma's k index is permuted
//     so that a thread's Q.K B fragments of every k step come from one
//     load of HD/4 consecutive bytes of its position's row (Q's A
//     fragments, read once, take the same permutation); for P.V a thread
//     reads one 4-byte word of each of its 4 rows a k step, and byte t of
//     the word is the B fragment of n tile t (d = 4g + t: the output's
//     columns are permuted back in its final write).  Four int8 bytes go
//     to two bf16 pairs exactly in two instructions an element (byte
//     permutes place 128 + the low 7 bits and -(128 + 128 x the sign bit)
//     as bf16 values, one bf16x2 FMA subtracts: i8x4_to_bf16); float32 q
//     widens a byte as 2^23 + (b ^ 0x80) under a magic exponent, less
//     2^23 + 128;
//   - the scales travel with their tile (bf16 q): the K tile's cp.async
//     group carries k_scale and v_scale of its positions (strided by nh),
//     only of those a beam attends, into the block's per-position arrays
//     (float32 q reads them all ahead of the mask, as before).
//     k_scale multiplies each f32 score after the dot, v_scale is folded
//     into P at its two rounding points, so the cluster's partial P.V sums
//     carry it.

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
constexpr int kTile8 = 256;        // int8 K/V with bf16 q: 32 per warp
constexpr int kSeg = 128;          // positions per task of the softmax passes: a float4 a lane
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;   // 227 KB: the most a block may use on sm_90

// Byte offsets of the dynamic shared memory.  ops/decode_attention.py's
// smem_bytes() is the same arithmetic; the launcher refuses a plan whose
// bytes are fewer than this layout needs.
struct Layout {
  int ring, q, oblk, red, psum, tflag, mbits, scores, ksc, vsc, total;
};

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

// elem: bytes of q's type; kelem: of K/V's (elem, or 1 for int8 K/V).
// int8 K/V with bf16 q (elem 2) streams 256-position tiles of unpadded rows
__host__ __device__ constexpr bool packed_int8(int elem, int kelem) {
  return kelem == 1 && elem == 2;
}
__host__ __device__ constexpr int tile_of(int elem, int kelem) {
  return packed_int8(elem, kelem) ? kTile8 : kTile;
}
__host__ __device__ constexpr int ring_row(int hd, int elem, int kelem) {
  return packed_int8(elem, kelem) ? hd : hd * kelem + 16;
}

__host__ __device__ inline Layout make_layout(int K, int chunk, int stages, int hd, int elem,
                                              int kelem) {
  const int rs = hd * elem + 16;   // a Q row, padded by 16 bytes
  const int tile = tile_of(elem, kelem);
  Layout L;
  int off = 0;
  const int ring = stages * tile * ring_row(hd, elem, kelem);
  const int ored = kWarps * kMaxQ * hd * 4;  // partial outputs, in the ring at the end
  L.ring = off;   off += up16(ring > ored ? ring : ored);
  L.q = off;      off += up16(kMaxQ * rs);
  L.oblk = off;   off += up16(kMaxQ * hd * 4);
  L.red = off;    off += up16((kWarps + 4) * kMaxQ * 4);
  L.psum = off;   off += up16(kMaxQ * kWarps * 4);
  L.tflag = off;  off += up16((chunk + tile - kTile) / tile * 4);  // chunk: whole kTile
  L.mbits = off;  off += up16(chunk * 2);
  L.scores = off; off += up16(K * (chunk + 4) * 4);
  L.ksc = L.vsc = off;
  if (kelem != elem) {  // int8 K/V: the positions' scales
    L.ksc = off;  off += up16(chunk * 4);
    L.vsc = off;  off += up16(chunk * 4);
  }
  L.total = off;
  return L;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, as a float
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half_rn(x));
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// 4 bytes global -> shared; src_bytes 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
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

// ---- int8 K/V to float without I2F (a quarter-rate instruction on sm_90):
// byte i of x = b ^ 0x80 = b + 128 under the exponent of 2^23 is the float
// 2^23 + 128 + b, exactly; one byte permute and one add a value
__device__ __forceinline__ float i8_to_f32(uint32_t x, uint32_t i) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + i)) - 8388736.f;
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
// exactly.  With l the low 7 bits of a byte b and s its sign bit, b = (128
// + l) - (128 + 128 s): 128 + l is bf16 0x4300 | l, and -(128 + 128 s) is
// bf16 0xC300 | (b & 0x80) (the sign bit lands in the exponent's lowest
// bit).  One byte permute places each term, one bf16x2 FMA subtracts
// exactly: two instructions an element.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t l = w & 0x7f7f7f7fu, sgn = w & 0x80808080u;
  lo = bf16x2_add(__byte_perm(l, 0x43434343u, 0x5140u), __byte_perm(sgn, 0xC3C3C3C3u, 0x5140u));
  hi = bf16x2_add(__byte_perm(l, 0x43434343u, 0x5342u), __byte_perm(sgn, 0xC3C3C3C3u, 0x5342u));
}

// four consecutive int8 values (4-byte aligned) -> float4, exactly
__device__ __forceinline__ float4 load4_i8(const unsigned char* p) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  return make_float4(i8_to_f32(x, 0), i8_to_f32(x, 1), i8_to_f32(x, 2), i8_to_f32(x, 3));
}

// HD/4 consecutive bytes (HD/16 words) of an int8 row, aligned to their size
template <int HD>
__device__ __forceinline__ void load_row_quarter(const unsigned char* p, uint32_t (&w)[HD / 16]) {
  if constexpr (HD == 32) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < HD / 64; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z; w[4 * i + 3] = x.w;
    }
  }
}

// the scores of one n8 tile of int8 K with bf16 q into s: the thread's
// positions m, m + 1 (m even), rows g and g + 8 in acc[0..1] and acc[2..3];
// scaled by ks after the dot, masked to -inf, and the row maxima kept.
// mbits is zero past the block's positions, so the pair of masks is one
// load, and rows g, g + 8 of both positions are bits 0, 8, 16, 24 of it
// shifted by g
__device__ __forceinline__ void store_scores8(const float (&acc)[4], float* s, int SS,
                                              const uint16_t* mbits, const float* ks, int m,
                                              int K, int g, float (&rmax)[2]) {
  const uint32_t b = *reinterpret_cast<const uint32_t*>(mbits + m) >> g;
  const float2 sc = *reinterpret_cast<const float2*>(ks + m);
  const float2 v0 = make_float2(b & 1u ? acc[0] * sc.x : -INFINITY,
                                b & 0x10000u ? acc[1] * sc.y : -INFINITY);
  const float2 v1 = make_float2(b & 0x100u ? acc[2] * sc.x : -INFINITY,
                                b & 0x1000000u ? acc[3] * sc.y : -INFINITY);
  rmax[0] = fmaxf(rmax[0], fmaxf(v0.x, v0.y));
  rmax[1] = fmaxf(rmax[1], fmaxf(v1.x, v1.y));
  if (g < K) *reinterpret_cast<float2*>(s + g * SS + m) = v0;
  if (g + 8 < K) *reinterpret_cast<float2*>(s + (g + 8) * SS + m) = v1;
}

// ---- Q.K of one tile: f32 scores of rows < K into s (row stride SS) -----
// Each thread also keeps the running maximum of the rows it scores.  With
// int8 K each score is multiplied by its position's k scale (ks) after the
// dot.

// tensor cores: warp w scores positions 16w..16w+15 of the tile (two n8
// tiles) against the 16 (padded) query rows held as A fragments; the thread
// holds rows g and g + 8
template <typename T, int HD>
__device__ __forceinline__ void score_tile_mma(const unsigned char* buf,
                                               const uint32_t (&qa)[HD / 16][4], float* s, int SS,
                                               const uint16_t* mbits, int m0, int n_local, int K,
                                               int warp, int lane, float (&rmax)[2]) {
  constexpr int RS = HD * 2 + 16;
  const int g = lane >> 2, c = lane & 3;
  float acc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t b[4];
    const int pos = 16 * warp + (lane & 7) + 8 * (lane >> 4);
    ldmatrix_x4(b, buf + pos * RS + (kk * 16 + 8 * ((lane >> 3) & 1)) * 2);
    mma16816<T>(acc[0], qa[kk], b[0], b[1]);
    mma16816<T>(acc[1], qa[kk], b[2], b[3]);
  }
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

// int8 K, bf16 q: warp w scores positions 8NT*w .. 8NT*w + 8NT-1 of a kTile8
// tile (NT n8 tiles: 4, or 2 where only the tile's first kSeg positions
// are the block's).  The k index is permuted: thread (g, c) of n tile nt
// reads bytes [c*HD/4, (c+1)*HD/4) of row 8NT*w + 8nt + g in one load, and
// k step kk takes their bytes 4kk..4kk+3 as its slots 2c, 2c+1 (b0) and 2c+8,
// 2c+9 (b1).  qa holds Q in the same permutation.
template <int HD, int NT>
__device__ __forceinline__ void score_tile_mma8(const unsigned char* buf,
                                                const uint32_t (&qa)[HD / 16][4], float* s, int SS,
                                                const uint16_t* mbits, const float* ks, int m0,
                                                int K, int warp, int lane, float (&rmax)[2]) {
  const int g = lane >> 2, c = lane & 3;
  float acc[NT][4] = {};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t w[HD / 16];
    load_row_quarter<HD>(buf + (8 * NT * warp + 8 * nt + g) * HD + c * (HD / 4), w);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b0, b1;
      i8x4_to_bf16(w[kk], b0, b1);
      mma16816<__nv_bfloat16>(acc[nt], qa[kk], b0, b1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    store_scores8(acc[nt], s, SS, mbits, ks, m0 + 8 * NT * warp + 8 * nt + 2 * c, K, g, rmax);
  }
}

// float32 on the CUDA cores: thread scores one position of the tile against
// every other query row (rows half, half + 2, ...)
template <int HD, bool kQ8>
__device__ __forceinline__ void score_tile_f32(const unsigned char* buf, const float* q_s, float* s,
                                               int SS, const uint16_t* mbits, const float* ks,
                                               int m0, int n_local, int K, int tid,
                                               float (&rmax)[kMaxQ / 2]) {
  constexpr int RSF = HD + 4;  // floats per padded q row (and K row, float32 K)
  constexpr int RSK = HD + 16; // bytes per padded int8 K row
  const int p = tid % kTile;
  const int half = tid / kTile;  // warp-uniform
  const float* kr = reinterpret_cast<const float*>(buf) + p * RSF;
  float acc[kMaxQ / 2] = {};
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 kv = kQ8 ? load4_i8(buf + p * RSK + d)
                          : *reinterpret_cast<const float4*>(kr + d);
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
  const float sc = kQ8 ? ks[m] : 1.f;
#pragma unroll
  for (int j = 0; j < kMaxQ / 2; ++j) {
    const int r = half + 2 * j;
    if (r < K) {
      const float x = (bits >> r) & 1u ? (kQ8 ? acc[j] * sc : acc[j]) : -INFINITY;
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

// int8 V, bf16 q: warp w takes positions 8NT*w .. 8NT*w + 8NT-1 of a kTile8
// tile (as score_tile_mma8) as NT/2 k16 steps.  P (its row r of the warp's
// positions at p + r*PS) is the A operand, read as the bf16 form reads it.  Thread (g, c) reads word g + 8h
// of rows 2c, 2c+1, 2c+8, 2c+9 of the step (its k slots): byte t of the four
// words is its B fragment of n tile 4h + t, whose column g is d = 32h + 4g +
// t.  One byte permute gathers bytes t and t + 1 of two rows.
template <int HD, int NT>
__device__ __forceinline__ void pv_tile_mma8(const unsigned char* buf, const __nv_bfloat16* p,
                                             int PS, int K, int warp, int lane,
                                             float (&o)[HD / 8][4]) {
  const int g = lane >> 2, c = lane & 3;
  const int prow = min((lane & 7) + 8 * ((lane >> 3) & 1), K - 1);
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t a[4];
    ldmatrix_x4(a, p + prow * PS + 16 * j + 8 * (lane >> 4));
    const unsigned char* vp = buf + (8 * NT * warp + 16 * j + 2 * c) * HD + 4 * g;
#pragma unroll
    for (int h = 0; h < HD / 32; ++h) {
      uint32_t x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = *reinterpret_cast<const uint32_t*>(vp + (i & 1) * HD + (i >> 1) * 8 * HD + 32 * h);
      }
      uint32_t b0[4], b1[4];  // n tile t: rows (2c, 2c+1) and (2c+8, 2c+9) of byte t
      i8x4_to_bf16(__byte_perm(x[0], x[1], 0x5140u), b0[0], b0[1]);
      i8x4_to_bf16(__byte_perm(x[0], x[1], 0x7362u), b0[2], b0[3]);
      i8x4_to_bf16(__byte_perm(x[2], x[3], 0x5140u), b1[0], b1[1]);
      i8x4_to_bf16(__byte_perm(x[2], x[3], 0x7362u), b1[2], b1[3]);
#pragma unroll
      for (int t = 0; t < 4; ++t) mma16816<__nv_bfloat16>(o[4 * h + t], a, b0[t], b1[t]);
    }
  }
}

// float32: thread owns a float4 of hd (qd) for every row over a group of
// the tile's positions; p is normalised in place in s
template <int HD, bool kQ8>
__device__ __forceinline__ void pv_tile_f32(const unsigned char* buf, const float* s, int SS,
                                            int m0, int K, int tid, float (&acc)[kMaxQ][4]) {
  constexpr int RSF = HD + 4;
  constexpr int RSK = HD + 16;                 // bytes per padded int8 V row
  constexpr int QD = HD / 4;                   // float4 columns
  constexpr int PPG = kTile * QD / kThreads;   // positions per thread and tile
  const int qd = tid % QD;
  const int grp = tid / QD;
#pragma unroll
  for (int i = 0; i < PPG; ++i) {
    const int mt = grp * PPG + i;
    const float4 vv = kQ8 ? load4_i8(buf + mt * RSK + 4 * qd)
                          : *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(buf) +
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

template <typename T, typename TK, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const TK* __restrict__ k,
                        const TK* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const unsigned char* __restrict__ mask,
                        T* __restrict__ out, int K, int M, int nh, int chunk, int stages) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr bool kQ8 = sizeof(TK) == 1;   // int8 K/V with per-vector scales
  constexpr int ELEM = sizeof(T);
  constexpr int KELEM = sizeof(TK);
  constexpr bool kMma8 = packed_int8(ELEM, KELEM);  // int8 K/V, bf16 q: packed fragments
  constexpr int TILE = tile_of(ELEM, KELEM);        // positions per ring buffer
  constexpr int SEGS = TILE / kSeg;                 // softmax tasks per tile and row
  constexpr int RS = HD * ELEM + 16;     // bytes of a padded Q row
  constexpr int RSK = ring_row(HD, ELEM, KELEM);  // bytes of a K/V row of the ring
  constexpr int QCPR = HD * ELEM / 16;   // 16-byte pieces of a Q row
  constexpr int QVEC = 16 / ELEM;
  constexpr int CPR = HD * KELEM / 16;   // 16-byte pieces of a K/V row
  constexpr int VEC = 16 / KELEM;
  constexpr int PIECES = TILE * CPR / kThreads;  // 16-byte copies per thread and tile
  static_assert(HD % 32 == 0 && HD <= 128 && PIECES >= 1, "head dim");
  static_assert(!kQ8 || sizeof(T) != 1, "q is float, half or bfloat16");
  static_assert(!kMma8 || sizeof(T) == 2, "int8 K/V takes float or bfloat16 q");

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

  const Layout L = make_layout(K, chunk, stages, HD, ELEM, KELEM);
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
  float* ks_s = reinterpret_cast<float*>(smem + L.ksc);  // int8 K/V: scales per position
  float* vs_s = reinterpret_cast<float*>(smem + L.vsc);
  // score rows 4 mod 32 words apart: the ldmatrix rows of P hit distinct banks
  const int SS = chunk + 4;

  const int m_lo = rank * chunk;
  const int n_local = max(0, min(M - m_lo, chunk));
  const int n_tiles = (n_local + TILE - 1) / TILE;
  // the block's positions in kSeg steps (a last int8 tile may have one)
  const int n_segs = kMma8 ? (n_local + kSeg - 1) / kSeg : n_tiles * SEGS;
  const long row = (long)nh * HD;  // elements between consecutive positions / queries
  const T* qb = q + ((long)b * K * nh + h) * HD;
  const TK* kb = k + ((long)b * M * nh + h) * HD + (long)m_lo * row;
  const TK* vb = v + ((long)b * M * nh + h) * HD + (long)m_lo * row;
  const float* ksb = kQ8 ? k_scale + ((long)b * M + m_lo) * nh + h : nullptr;
  const float* vsb = kQ8 ? v_scale + ((long)b * M + m_lo) * nh + h : nullptr;

  // tile i of the stream: K tiles 0..n_tiles-1, then V tiles.  Thread tid
  // copies pieces tid, tid + kThreads, ... of every tile.  Until the mask
  // is `known`, only K tiles go, whole (a K row no beam attends only gets
  // a score of -inf); after, a row no beam attends is not read, nor a tile
  // without an attended row.  int8 K/V with bf16 q: a K tile's group also
  // carries the k and v scales of its positions (zeros where a row is not
  // read).
  auto issue = [&](int i, bool known) {
    if (i < 2 * n_tiles && (known || i < n_tiles)) {
      const int tt = i < n_tiles ? i : i - n_tiles;
      if (!known || tflag[tt]) {
        const TK* src = (i < n_tiles ? kb : vb) + (long)tt * TILE * row;
        unsigned char* dst = ring + (i % stages) * (TILE * RSK);
#pragma unroll
        for (int j = 0; j < PIECES; ++j) {
          const int piece = tid + j * kThreads;
          const int r = piece / CPR, c = piece % CPR;
          const int m = tt * TILE + r;
          const bool live = m < n_local && (!known || mbits[m] != 0);
          cp_async16(dst + r * RSK + c * 16, live ? src + r * row + c * VEC : src, live ? 16 : 0);
        }
        if constexpr (kMma8) {
          if (i < n_tiles) {
            static_assert(2 * TILE % kThreads == 0, "whole scale copies per thread");
#pragma unroll
            for (int jj = 0; jj < 2 * TILE / kThreads; ++jj) {
              const int j = tid + jj * kThreads;
              const int m = tt * TILE + j % TILE;
              const bool live = m < n_local && (!known || mbits[m] != 0);
              const float* from = j < TILE ? ksb : vsb;
              if (m < n_segs * kSeg) {  // the last tile may reach past the chunk
                cp_async4((j < TILE ? ks_s : vs_s) + m, live ? from + (long)m * nh : from,
                          live ? 4 : 0);
              }
            }
          }
        }
      }
    }
    cp_async_commit();
  };

  // int8 K/V with float32 q: the scales of this block's positions for this
  // head (zeros past them, to the last tile's end), the oldest cp.async
  // group: every wait below that covers a later group covers it
  if constexpr (kQ8 && !kMma8) {
    for (int m = tid; m < n_tiles * kTile; m += kThreads) {
      const bool live = m < n_local;
      cp_async4(ks_s + m, live ? ksb + (long)m * nh : k_scale, live ? 4 : 0);
      cp_async4(vs_s + m, live ? vsb + (long)m * nh : v_scale, live ? 4 : 0);
    }
    cp_async_commit();
  }
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
  } else if constexpr (kMma8) {
    for (int i = 0; i < stages - 1; ++i) issue(i, false);  // all rows: no wait for the queries
  }
  // queries, zero-padded to 16 rows
  for (int i = tid; i < kMaxQ * QCPR; i += kThreads) {
    const int r = i / QCPR, c = i % QCPR;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < K) x = *reinterpret_cast<const uint4*>(qb + (long)r * row + c * QVEC);
    *reinterpret_cast<uint4*>(q_s + r * RS + c * 16) = x;
  }
  for (int t = tid; t < n_tiles; t += kThreads) tflag[t] = mask == nullptr;
  if (mask != nullptr) {
    cp_async_wait(stages - 1);  // the mask's group (after float32 q's int8 scales)
    __syncthreads();
    // kMma8: rows past K read row K - 1, and are masked off after, so that
    // the loads of a position are independent of K
    int off[kMaxQ];
#pragma unroll
    for (int r = 0; r < kMaxQ; ++r) off[r] = r < K ? moff[r] : (kMma8 ? moff[K - 1] : 0);
    for (int m = tid; m < n_local; m += kThreads) {
      unsigned bits = 0;
#pragma unroll
      for (int r = 0; r < kMaxQ; ++r) {
        if constexpr (kMma8) {
          bits |= (unsigned)(stage[off[r] + m] != 0) << r;
        } else {
          if (r < K) bits |= (unsigned)(stage[off[r] + m] != 0) << r;
        }
      }
      if constexpr (kMma8) bits &= (2u << (K - 1)) - 1u;
      mbits[m] = static_cast<uint16_t>(bits);
      if (bits) tflag[m / TILE] = 1;
    }
  } else {
    for (int m = tid; m < n_local; m += kThreads) mbits[m] = 0xffffu;
  }
  if constexpr (kMma8) {  // store_scores8 reads the masks of the last segment whole
    for (int m = n_local + tid; m < n_segs * kSeg; m += kThreads) mbits[m] = 0;
  }
  __syncthreads();
  // the rest of the first stages - 1 tiles: V tiles when there are fewer K
  // tiles (pass 2 waits for all of these)
  for (int i = kMma8 || mask != nullptr ? n_tiles : 0; i < stages - 1; ++i) issue(i, true);

  uint32_t qa[HD / 16][4];
  if constexpr (kMma8) {
    // in score_tile_mma8's permutation: k step kk of thread (g, c) takes
    // d = c*HD/4 + 4kk + (0, 1) as slots 2c, 2c+1 and + (2, 3) as 2c+8, 2c+9
    const int g = lane >> 2, c = lane & 3;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q_s + g * RS) + c * (HD / 8);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(q_s + (g + 8) * RS) + c * (HD / 8);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = q0[2 * kk];
      qa[kk][1] = q1[2 * kk];
      qa[kk][2] = q0[2 * kk + 1];
      qa[kk][3] = q1[2 * kk + 1];
    }
  } else if constexpr (!kF32) {
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
      const unsigned char* buf = ring + (i % stages) * (TILE * RSK);
      if constexpr (kF32) {
        score_tile_f32<HD, kQ8>(buf, reinterpret_cast<const float*>(q_s), s, SS, mbits, ks_s,
                                i * TILE, n_local, K, tid, rmax);
      } else if constexpr (kMma8) {
        if (i * TILE + kSeg == n_segs * kSeg) {  // a last tile with one segment of the chunk
          score_tile_mma8<HD, 2>(buf, qa, s, SS, mbits, ks_s, i * TILE, K, warp, lane, rmax);
        } else {
          score_tile_mma8<HD, 4>(buf, qa, s, SS, mbits, ks_s, i * TILE, K, warp, lane, rmax);
        }
      } else {
        score_tile_mma<T, HD>(buf, qa, s, SS, mbits, i * TILE, n_local, K, warp, lane, rmax);
      }
    }
  }

  // kMma8: v's scales rounded to T once per position (every K tile's
  // group, which carried them, has landed)
  if constexpr (kMma8) {
    for (int m = tid; m < n_segs * kSeg; m += kThreads) vs_s[m] = round_to<T>(vs_s[m]);
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
  // eighth of the (row, segment) pairs in row order, a segment being kSeg
  // positions, a float4 of them per lane.  It sums each row it meets into
  // psum[row][w]; a row's sum is then taken over w in order.
  static_assert(kSeg == 4 * 32, "a segment is a float4 per lane");
  const int n_tasks = K * n_segs;
  const int first = warp * n_tasks / kWarps, last = (warp + 1) * n_tasks / kWarps;
  const int r_first = n_segs ? first / n_segs : 0, t_first = n_segs ? first % n_segs : 0;
  if (lane < K) psum[lane * kWarps + warp] = 0.f;
  __syncwarp();
  {
    int r = r_first, t = t_first;
    float lane_sum = 0.f;
    for (int task = first; task < last; ++task) {
      if (tflag[t / SEGS]) {
        const float g = gmax[r];  // -inf for a row masked everywhere: exp gives NaN, as softmax
        float4* e = reinterpret_cast<float4*>(s + r * SS + t * kSeg) + lane;
        float4 x = *e;
        x.x = expf(x.x - g);
        x.y = expf(x.y - g);
        x.z = expf(x.z - g);
        x.w = expf(x.w - g);
        *e = x;
        lane_sum += (x.x + x.y) + (x.z + x.w);
      }
      const bool row_end = ++t == n_segs;
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
  // FMA step on its exact remainder.  Below float32 a segment's rounded
  // values go to the first half of its own f32 values, after the warp has
  // read them all.
  T* p_s = reinterpret_cast<T*>(s);
  const int PS = kF32 ? SS : 2 * SS;  // P's row stride in elements of T
  {
    int r = r_first, t = t_first;
    for (int task = first; task < last; ++task) {
      if (tflag[t / SEGS]) {
        const float sum = gsum[r];
        const float inv = 1.f / sum;
        float4* e = reinterpret_cast<float4*>(s + r * SS + t * kSeg) + lane;
        const float4 x = *e;
        float p[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float q0 = p[j] * inv;
          p[j] = fmaf(fmaf(-q0, sum, p[j]), inv, q0);
        }
        if constexpr (kMma8) {
          // v's scale folded into P at the reference's rounding points, on
          // bf16 pairs: round(p) (the pack) times round(v_scale) (rounded
          // once a position), the exact product rounded once by one FMA
          const float4 vs = reinterpret_cast<const float4*>(vs_s + t * kSeg)[lane];
          __syncwarp();
          reinterpret_cast<uint2*>(p_s + r * PS + 2 * kTile * t)[lane] =
              make_uint2(bf16x2_mul(pack2<T>(p[0], p[1]), pack2<T>(vs.x, vs.y)),
                         bf16x2_mul(pack2<T>(p[2], p[3]), pack2<T>(vs.z, vs.w)));
        } else {
          if constexpr (kQ8) {  // v's scale folded into P at the reference's rounding points
            const float4 vs = reinterpret_cast<const float4*>(vs_s + t * kSeg)[lane];
            const float sc[4] = {vs.x, vs.y, vs.z, vs.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) p[j] = round_to<T>(p[j]) * round_to<T>(sc[j]);
          }
          if constexpr (kF32) {
            *e = make_float4(p[0], p[1], p[2], p[3]);
          } else {
            __syncwarp();
            reinterpret_cast<uint2*>(p_s + r * PS + 2 * kTile * t)[lane] =
                make_uint2(pack2<T>(p[0], p[1]), pack2<T>(p[2], p[3]));
          }
        }
      }
      if (++t == n_segs) {
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
      const unsigned char* buf = ring + (i % stages) * (TILE * RSK);
      if constexpr (kF32) {
        pv_tile_f32<HD, kQ8>(buf, s, SS, tt * TILE, K, tid, o_f32);
      } else if constexpr (kMma8) {
        // P of the warp's positions q (as score_tile_mma8's): segment tt*SEGS + q/kSeg
        if (tt * TILE + kSeg == n_segs * kSeg) {
          pv_tile_mma8<HD, 2>(buf, p_s + 2 * kSeg * tt * SEGS + 16 * warp, PS, K, warp, lane,
                              o_mma);
        } else {
          pv_tile_mma8<HD, 4>(buf, p_s + 2 * kSeg * (tt * SEGS + warp / 4) + 32 * (warp % 4), PS,
                              K, warp, lane, o_mma);
        }
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
  } else if constexpr (kMma8) {
    // n tile 4h + t: columns 2c, 2c + 1 are d = 32h + 8c + t and that + 4
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int d = 32 * (nt / 4) + 8 * c + nt % 4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* dst = o_red + (warp * kMaxQ + g + 8 * half) * HD + d;
        dst[0] = o_mma[nt][2 * half];
        dst[4] = o_mma[nt][2 * half + 1];
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

template <typename T, typename TK, int HD>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* mask, void* out, int B, int K, int M, int nh, int cluster, int chunk,
           int stages, int smem_bytes, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, TK, HD>;
  // once per instance, before any launch (so never inside a graph capture)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  if (smem_bytes < make_layout(K, chunk, stages, HD, (int)sizeof(T), (int)sizeof(TK)).total) {
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
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const TK*>(k),
                                 static_cast<const TK*>(v), static_cast<const float*>(k_scale),
                                 static_cast<const float*>(v_scale),
                                 static_cast<const unsigned char*>(mask), static_cast<T*>(out), K,
                                 M, nh, chunk, stages);
}

template <typename T, typename TK>
int launch_hd(const void* q, const void* k, const void* v, const void* ks, const void* vs,
              const void* mask, void* out, int B, int K, int M, int nh, int hd, int cluster,
              int chunk, int stages, int smem_bytes, cudaStream_t s) {
#define D2T_ARGS q, k, v, ks, vs, mask, out, B, K, M, nh, cluster, chunk, stages, smem_bytes, s
  switch (hd) {
    case 32: return launch<T, TK, 32>(D2T_ARGS);
    case 64: return launch<T, TK, 64>(D2T_ARGS);
    case 128: return launch<T, TK, 128>(D2T_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef D2T_ARGS
}

bool bad_plan(int B, int K, int M, int nh, int cluster, int chunk, int stages, int smem_bytes) {
  return B <= 0 || B > 65535 || K <= 0 || K > kMaxQ || M <= 0 || nh <= 0 || cluster <= 0 ||
         cluster > kMaxCluster || (long)nh * cluster > 65535 || chunk <= 0 ||
         chunk % kTile != 0 || (long)cluster * chunk < M || stages < 2 || stages > kMaxStages ||
         smem_bytes > kMaxSmem;
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
  if (bad_plan(B, K, M, nh, cluster, chunk, stages, smem_bytes)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
#define D2T_ARGS q, k, v, nullptr, nullptr, mask, out, B, K, M, nh, hd, cluster, chunk, stages, \
                 smem_bytes, s
  switch (dtype) {
    case 0: rc = launch_hd<float, float>(D2T_ARGS); break;
    case 1: rc = launch_hd<__half, __half>(D2T_ARGS); break;
    case 2: rc = launch_hd<__nv_bfloat16, __nv_bfloat16>(D2T_ARGS); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
#undef D2T_ARGS
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The int8 K/V form: k, v int8 (B,M,nh,hd), k_scale, v_scale float
// (B,M,nh); q and out of `dtype` (0 = float32, 2 = bfloat16).  The rest as
// d2t_decode_attention; smem_bytes covers make_layout(..., kelem = 1).
extern "C" int d2t_decode_attention_int8(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* mask, void* out, int B, int K, int M,
                                         int nh, int hd, int dtype, int cluster, int chunk,
                                         int stages, int smem_bytes, void* stream) {
  if (bad_plan(B, K, M, nh, cluster, chunk, stages, smem_bytes) || k_scale == nullptr ||
      v_scale == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
#define D2T_ARGS q, k, v, k_scale, v_scale, mask, out, B, K, M, nh, hd, cluster, chunk, stages, \
                 smem_bytes, s
  switch (dtype) {
    case 0: rc = launch_hd<float, int8_t>(D2T_ARGS); break;
    case 2: rc = launch_hd<__nv_bfloat16, int8_t>(D2T_ARGS); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
#undef D2T_ARGS
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
