// Multi-head attention for CLIP's towers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of benchmarks/probe_mosaic_attn.py
// (`attn_kernel` in `main`), which computed softmax(Q K^T / sqrt(64)) V per
// (crop, head) for CLIP ViT-B/32's vision attention over the 280 tiles of an
// 8-frame chunk, and the plain XLA attention of the JAX CLIP
// (spatially_aware_ai_tpu/models/clip/model.py, Attention). For each (b, h)
// and query row i:
//
//   s[j]  = (q[b,h,i,:] . k[b,h,j,:]) / sqrt(64), f32 accumulation
//           (bf16: s rounded to bf16 before the scale, as the JAX CLIP's and
//           the probe's XLA einsum store it), j > i masked when causal
//   p[j]  = exp(s[j] - max s) / sum exp(...)        f32, expf
//           (bf16: p rounded to bf16 before P V)
//   o[b, i, h*64 + d] = sum_j p[j] v[b,h,j,d]       f32, stored in q's type
//
// q, k, v are [B, H, T, 64] views with any strides but a contiguous last
// axis (the views of CLIP's fused qkv projection); o is [B, T, H*64]
// contiguous, the layout out_proj reads.
//
// What bounds it on this card: at the vision shape (B=280, H=12, T=50) the
// inputs and output are 172 MB in f32 (0.051 ms at 3.35 TB/s) and 86 MB in
// bf16 (0.026 ms): bytes. On the tensor cores the products are small beside
// that: padded to 64 keys, 3,360 heads of two 64x64x64 products are 3.5
// GFLOP, 10.6 as 3xTF32 (0.021 ms at 495 TFLOP/s) and 0.004 ms in bf16. So
// the design keeps loads in flight while the products run. Measured, the
// loads alone run near the bound and the rest is instruction issue: the
// 3xTF32 splits, the fragment loads and the softmax, which therefore uses
// ex2 and one reciprocal a row, and tests its masks only on the key tiles
// that reach T or the diagonal.
//
// Design. A work item is one head and a block of up to 64 query rows (a
// head of T <= 64 is one item). A CTA of 4 warps walks items on a persistent
// grid (as many CTAs as fit on the card); while it computes one item, the
// next item's Q, K and V are on their way into the other of two shared
// memory buffers by 16-byte cp.async (zero fill past T, which pads the rows
// to a multiple of 16; a plain load path takes views that are not 16-byte
// aligned). Each warp owns 16 query rows:
//   Q K^T   mma.sync m16n8k8 TF32 (f32: 3xTF32, v = big + small, big with
//           its low 13 mantissa bits zero and small the TF32 rounding of the
//           rest; the product as small*big + big*small + big*big) or
//           m16n8k16 bf16, Q and K fragments from shared memory (rows padded
//           so that the 32 lanes of a fragment load hit 32 banks); every
//           key tile up to round16(T) is computed, with no branch between
//           the products, so that the tiles' mma chains interleave (a
//           branch per tile measured slower than the CUDA-core design this
//           kernel replaced).
//   softmax the whole score row stays in the accumulator registers (T <=
//           128): masked keys to -inf, max and sum across the 4 lanes of a
//           quad, p normalised before P V as the plain version rounds it.
//   P V     the Q K^T accumulator is P V's A operand as it is, with no data
//           movement. In bf16 the accumulator's (row g / g+8, keys 2t, 2t+1)
//           pairs of two key tiles are exactly the m16n8k16 A fragment; V's B
//           fragments come by ldmatrix.trans from V as stored. In f32 the
//           m16n8k8 A fragment wants keys t and t+4 where the accumulator
//           holds keys 2t and 2t+1, so V's rows are staged in the permuted
//           order (within each group of 8 keys, stored row s holds key 2s for
//           s < 4 and key 2(s - 4) + 1 above; models/attention.py
//           `v_stage_order` mirrors it) and the accumulator pair is read as
//           A columns t and t+4.
// The output leaves from the P V accumulators as 8-byte stores (a quad
// writes 32 contiguous bytes of a row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <algorithm>
#include <stdint.h>

namespace {

constexpr int kHd = 64;
constexpr int kMaxT = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kItemRows = kWarps * 16;  // query rows of one work item
// shared-memory buffers: while a CTA computes one item, the next
// kStages - 1 items' loads are in flight
constexpr int kStages = 2;

// shared-memory row strides in elements: the fragment loads of 32 lanes
// (8 rows x 4 columns, or 4 rows x 8 columns for f32 V) fall in 32 banks
template <typename T>
struct Strides;
template <>
struct Strides<float> {
  static constexpr int qk = 68, v = 72;
};
template <>
struct Strides<__nv_bfloat16> {
  static constexpr int qk = 72, v = 72;
};

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) / 16 * 16;
}

// elements of one buffer: Q [64][qk], K [kp][qk], V [kp][v]
template <typename T>
__host__ __device__ __forceinline__ int buffer_elems(int kp) {
  return kItemRows * Strides<T>::qk + kp * (Strides<T>::qk + Strides<T>::v);
}

template <typename T>
size_t smem_bytes(int T_) {
  return kStages * sizeof(T) * (size_t)buffer_elems<T>(round16(T_));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // until at most N groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one 16-byte chunk (4 f32 or 8 bf16) of a row, or zeros; the plain path
// for views that are not 16-byte aligned
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, const T* base,
                                       bool valid, bool aligned) {
  if (aligned) {
    cp_async16(dst, valid ? src : base, valid ? 16 : 0);
  } else {
    constexpr int n = 16 / sizeof(T);
    alignas(16) T tmp[n];
#pragma unroll
    for (int e = 0; e < n; ++e) tmp[e] = valid ? src[e] : T(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tmp);
  }
}

struct Item {
  int b, h, r0, nq;  // head, first query row, rows
};

__device__ __forceinline__ Item item_of(int item, int H, int Tn,
                                        int blocks) {
  Item it;
  const int bh = item / blocks;
  it.b = bh / H;
  it.h = bh % H;
  it.r0 = (item % blocks) * kItemRows;
  it.nq = min(kItemRows, Tn - it.r0);
  return it;
}

struct Views {
  const void *q, *k, *v;
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt;
};

// Issue the loads of one item into buffer buf: Q rows r0.. (zero past nq,
// up to the next 16), K and V rows 0..kp = round16(T) (zero past T), V in
// the staged key order in f32.
template <typename T>
__device__ __forceinline__ void load_item(T* buf, const Item& it,
                                          const Views& w, int Tn, int kp,
                                          bool aligned) {
  constexpr int chunks = kHd * sizeof(T) / 16;  // per row
  constexpr int per = 16 / sizeof(T);
  T* Qs = buf;
  T* Ks = Qs + kItemRows * Strides<T>::qk;
  T* Vs = Ks + kp * Strides<T>::qk;
  const T* q = static_cast<const T*>(w.q) + it.b * w.qb + it.h * w.qh;
  const T* k = static_cast<const T*>(w.k) + it.b * w.kb + it.h * w.kh;
  const T* v = static_cast<const T*>(w.v) + it.b * w.vb + it.h * w.vh;
  // this thread's 16-byte column of every rstep-th row
  constexpr int rstep = kThreads / chunks;
  const int c = (threadIdx.x % chunks) * per, r0 = threadIdx.x / chunks;
  const int nqp = round16(it.nq);
  const T* src = q + (it.r0 + r0) * w.qt + c;
  for (int r = r0; r < nqp; r += rstep, src += rstep * w.qt)
    copy16(Qs + r * Strides<T>::qk + c, src, q, r < it.nq, aligned);
  const T* ks = k + r0 * w.kt + c;
  const T* vs = v + r0 * w.vt + c;
  for (int j = r0; j < kp; j += rstep, ks += rstep * w.kt,
           vs += rstep * w.vt) {
    copy16(Ks + j * Strides<T>::qk + c, ks, k, j < Tn, aligned);
    int s = j;  // stored row of key j
    if (sizeof(T) == 4) s = (j & ~7) + ((j & 7) >> 1) + ((j & 1) << 2);
    copy16(Vs + s * Strides<T>::v + c, vs, v, j < Tn, aligned);
  }
}

// ---- tensor-core operations

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 3xTF32 split: big = x with its low 13 mantissa bits zero, small = the
// rest rounded to TF32 (big + small == x to within TF32 of the rest)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(x - __uint_as_float(big)));
}

// d += a b as 3xTF32: small*big + big*small + big*big
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ab,
                                           const uint32_t* as,
                                           const uint32_t* bb,
                                           const uint32_t* bs) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// ---- one warp's 16 query rows of an item
//
// Lane (g, t) = (lane / 4, lane % 4) holds, in accumulator tile n (8 keys or
// 8 output dims), columns 8n + 2t, 8n + 2t + 1 of rows g (regs 0, 1) and
// g + 8 (regs 2, 3).

template <int KT>  // key tiles of 8 (KT = round16(T) / 8)
__device__ __forceinline__ void scores(float (&s)[KT][4], const float* Qs,
                                       const float* Ks, int g, int t) {
  constexpr int ld = Strides<float>::qk;
#pragma unroll
  for (int kk = 0; kk < kHd / 8; ++kk) {
    uint32_t ab[4], as[4];
    const int c = 8 * kk + t;
    split(Qs[g * ld + c], ab[0], as[0]);
    split(Qs[(g + 8) * ld + c], ab[1], as[1]);
    split(Qs[g * ld + c + 4], ab[2], as[2]);
    split(Qs[(g + 8) * ld + c + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      uint32_t bb[2], bs[2];
      split(Ks[(8 * n + g) * ld + c], bb[0], bs[0]);
      split(Ks[(8 * n + g) * ld + c + 4], bb[1], bs[1]);
      mma_3xtf32(s[n], ab, as, bb, bs);
    }
  }
}

template <int KT>
__device__ __forceinline__ void scores(float (&s)[KT][4],
                                       const __nv_bfloat16* Qs,
                                       const __nv_bfloat16* Ks, int g,
                                       int t) {
  constexpr int ld = Strides<__nv_bfloat16>::qk / 2;  // in 32-bit words
  const uint32_t* Q = reinterpret_cast<const uint32_t*>(Qs);
  const uint32_t* K = reinterpret_cast<const uint32_t*>(Ks);
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    const int c = 8 * kk + t;
    const uint32_t a[4] = {Q[g * ld + c], Q[(g + 8) * ld + c],
                           Q[g * ld + c + 4], Q[(g + 8) * ld + c + 4]};
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      const uint32_t b[2] = {K[(8 * n + g) * ld + c],
                             K[(8 * n + g) * ld + c + 4]};
      mma_bf16(s[n], a, b);
    }
  }
}

template <int KT>
__device__ __forceinline__ void values(float (&o)[8][4],
                                       const float (&p)[KT][4],
                                       const float* Vs, int g, int t) {
  constexpr int ld = Strides<float>::v;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    // A columns t, t + 4 are the keys 2t, 2t + 1 this lane holds
    uint32_t ab[4], as[4];
    split(p[kk][0], ab[0], as[0]);
    split(p[kk][2], ab[1], as[1]);
    split(p[kk][1], ab[2], as[2]);
    split(p[kk][3], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bb[2], bs[2];
      split(Vs[(8 * kk + t) * ld + 8 * n + g], bb[0], bs[0]);
      split(Vs[(8 * kk + t + 4) * ld + 8 * n + g], bb[1], bs[1]);
      mma_3xtf32(o[n], ab, as, bb, bs);
    }
  }
}

template <int KT>
__device__ __forceinline__ void values(float (&o)[8][4],
                                       const float (&p)[KT][4],
                                       const __nv_bfloat16* Vs, int g,
                                       int t) {
  constexpr int ld = Strides<__nv_bfloat16>::v;
  const int lane = 4 * g + t;
  // ldmatrix rows: lanes 0-7 keys 0-7 and lanes 8-15 keys 8-15 of the
  // k16 step at dims 16 np; lanes 16-31 the same at dims 16 np + 8
  const __nv_bfloat16* vrow =
      Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vrow + 16 * kk * ld + 16 * np);
      mma_bf16(o[2 * np], a, b);
      mma_bf16(o[2 * np + 1], a, b + 2);
    }
  }
}

template <typename T, int KT>
__device__ __forceinline__ void warp_rows(const T* buf, int kp,
                                          const Item& it, int row0,
                                          T* __restrict__ out, int H,
                                          int Tn, int causal, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* Qs = buf + row0 * Strides<T>::qk;
  const T* Ks = buf + kItemRows * Strides<T>::qk;
  const T* Vs = Ks + kp * Strides<T>::qk;
  const int i0 = it.r0 + row0;  // query row of fragment row 0

  // every key tile of the head, with no branch between the products: the
  // tiles' mma chains interleave (a key past T, or past a row under
  // `causal`, is masked below)
  float s[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  scores<KT>(s, Qs, Ks, g, t);

  // scores: bf16 rounds them before the scale. Keys past T and, under
  // `causal`, past the row are masked; only tiles that reach T or the
  // diagonal test their keys (a warp-uniform branch outside the products)
  const int ia = i0 + g, ib = i0 + g + 8;
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int n = 0; n < KT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = round_to(s[n][e], T()) * scale;
    if (8 * n + 8 > Tn || (causal && 8 * n + 7 > i0)) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * n + 2 * t + e;
        if (j >= Tn || (causal && j > ia)) s[n][e] = -INFINITY;
        if (j >= Tn || (causal && j > ib)) s[n][2 + e] = -INFINITY;
      }
    }
    ma = fmaxf(ma, fmaxf(s[n][0], s[n][1]));
    mb = fmaxf(mb, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
  }
  // exp as exp2 of the log2e-scaled difference (one multiply and the
  // special-function unit's ex2); key 0 is seen by every row, so ma and mb
  // are finite
  constexpr float kLog2e = 1.4426950408889634f;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int n = 0; n < KT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[n][e] = exp2f((s[n][e] - ma) * kLog2e);
      s[n][2 + e] = exp2f((s[n][2 + e] - mb) * kLog2e);
      sa += s[n][e];
      sb += s[n][2 + e];
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }
  const float ra = 1.f / sa, rb = 1.f / sb;
#pragma unroll
  for (int n = 0; n < KT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[n][e] = round_to(s[n][e] * ra, T());
      s[n][2 + e] = round_to(s[n][2 + e] * rb, T());
    }
  }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  values<KT>(o, s, Vs, g, t);

  T* oa = out + (((size_t)it.b * Tn + ia) * H + it.h) * kHd + 2 * t;
  T* ob = out + (((size_t)it.b * Tn + ib) * H + it.h) * kHd + 2 * t;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (ia < Tn) store2(oa + 8 * n, o[n][0], o[n][1]);
    if (ib < Tn) store2(ob + 8 * n, o[n][2], o[n][3]);
  }
}

template <typename T, int KT>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(Views w, T* __restrict__ out, int B, int H, int Tn,
                     int causal, float scale, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);
  const int kp = round16(Tn);
  const int buf_elems = buffer_elems<T>(kp);
  const int blocks = (Tn + kItemRows - 1) / kItemRows;
  const int n_items = B * H * blocks;
  const int warp = threadIdx.x >> 5;

  int item = blockIdx.x;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    const int ahead = item + st * gridDim.x;
    if (ahead < n_items)
      load_item<T>(bufs + st * buf_elems, item_of(ahead, H, Tn, blocks), w,
                   Tn, kp, aligned);
    cp_async_commit();
  }
  for (int i = 0; item < n_items; ++i, item += gridDim.x) {
    const int ahead = item + (kStages - 1) * gridDim.x;
    if (ahead < n_items)
      load_item<T>(bufs + (i + kStages - 1) % kStages * buf_elems,
                   item_of(ahead, H, Tn, blocks), w, Tn, kp, aligned);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this item's group has landed
    __syncthreads();
    const Item it = item_of(item, H, Tn, blocks);
    if (16 * warp < it.nq)
      warp_rows<T, KT>(bufs + i % kStages * buf_elems, kp, it, 16 * warp,
                       out, H, Tn, causal, scale);
    __syncthreads();  // the buffer is refilled kStages items on
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T, int KT>
int launch(const Views& w, void* o, int B, int H, int Tn, int causal,
           float scale, int aligned, cudaStream_t stream) {
  auto kernel = attention_kernel<T, KT>;
  const size_t smem = smem_bytes<T>(Tn);
  static bool opted_in = false;  // above 48 KB only after opting in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T>(kMaxT));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      (long long)B * H * ((Tn + kItemRows - 1) / kItemRows);
  const int grid =
      (int)std::min(items, (long long)std::max(per_sm, 1) * sm_count());
  kernel<<<grid, kThreads, smem, stream>>>(w, static_cast<T*>(o), B, H, Tn,
                                           causal, scale, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const Views& w, void* o, int B, int H, int Tn, int causal,
             float scale, int aligned, cudaStream_t stream) {
  // the score row's key tiles of 8, round16(T) / 8, fixed at compile time
  switch (round16(Tn) / 16) {
#define SAI_CASE(n)                                                       \
  case n:                                                                 \
    return launch<T, 2 * n>(w, o, B, H, Tn, causal, scale, aligned, stream);
    SAI_CASE(1) SAI_CASE(2) SAI_CASE(3) SAI_CASE(4)
    SAI_CASE(5) SAI_CASE(6) SAI_CASE(7) SAI_CASE(8)
#undef SAI_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype 0 = f32, 1 = bf16. strides: q, k, v's (batch, head, token) strides in
// elements (the last axis is contiguous). Returns a cudaError_t.
extern "C" int sai_attention(int dtype, const void* q, const void* k,
                             const void* v, void* o, int B, int H, int T,
                             int hd, const long long* strides, int causal,
                             float scale, void* stream) {
  if (hd != kHd || T < 1 || T > kMaxT || B < 1 || H < 1 ||
      (long long)B * H * ((T + kItemRows - 1) / kItemRows) > 2147483647ll ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Views w{q,          k,          v,          strides[0], strides[1],
                strides[2], strides[3], strides[4], strides[5], strides[6],
                strides[7], strides[8]};
  // 16-byte cp.async needs every row start 16-byte aligned
  const int per = dtype == 0 ? 4 : 8;
  int aligned = 1;
  for (const void* p : {q, k, v})
    aligned &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; i < 9; ++i) aligned &= strides[i] % per == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_t<float>(w, o, B, H, T, causal, scale, aligned,
                                      s)
                    : launch_t<__nv_bfloat16>(w, o, B, H, T, causal, scale,
                                              aligned, s);
}
