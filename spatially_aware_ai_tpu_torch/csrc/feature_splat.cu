// Chunk-batched bilinear CLIP-feature splat for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spatially_aware_ai_tpu/grid/pallas_fusion.py
// (`fused_feature_splat`, kernel `_splat_kernel`) and, since it computes the
// same function, the XLA `einsum_feature_splat` of grid/fusion.py:
//
//   feat_sum[dst(k), :] += sum_f sum_{4 corners} w * valid * feat_imgs[f, cy*Px+cx, :]
//
// with w the bilinear weight built exactly as the JAX expression
// (x0 = floor(px), fx = px - x0, w = wx * wy * valid) and corners outside the
// Py x Px patch grid adding 0 (grid_sample zero padding).
//
// What bounds it on this card: bytes. Each touched feat_sum row is read and
// written once (2 * C * 4 bytes), plus the uvw rows; the arithmetic is at
// most 4F multiply-adds per channel. The corner rows are another matter:
// every in-grid corner of a touched row reads C floats of a feature image,
// on the path's scatter inputs (F=8, 5x7 patches, C=512) about 5x the bytes
// the bound counts. Read from L2 (the first design, one warp per row) they
// held the kernel at L2's rate, about 3x its bound.
//
// Design, two launches:
// 1. compact: one thread per candidate row (4 rows a thread, every load in
//    flight at once) tests it: some frame valid and, for the scatter entry,
//    a destination in [0, n_buf). Ballots and a prefix over the CTA's warps
//    in shared memory compact the live rows, and one atomic a CTA places
//    them, as (uvw row, destination) pairs, in a list. The list's order
//    varies from run to run; the result does not (rows are unique and each
//    is summed on its own).
// 2. splat: the chunk's feature images stay in shared memory. A CTA owns a
//    channel slice of 32 VEC channels (VEC = 4, 2 or 1 floats a lane: 128,
//    64 or 32 channels, the widest slice whose F * P rows and staging ring
//    fit in shared memory and that C needs), loads F * P rows of it once
//    by cp.async, and then walks the list on a persistent grid, the CTAs
//    of one group (one per slice) over the same rows. A warp takes the
//    live rows 4 at a time: while it sums one group, the next group's
//    destination slices are on their way into registers, its uvw rows into
//    the other slot of a two-slot ring in shared memory (cp.async), and the
//    list entries of the group after into registers, so no latency waits
//    in line behind another. Lane p computes the weight and image row of
//    (frame p / 4, corner p % 4) of a row once; a ballot compacts the
//    pairs with a weight, in order, into the warp's list in shared memory,
//    and every lane reads them back (one broadcast read a pair, where
//    shfl took two) while it accumulates its VEC channels from shared
//    memory in the plain version's order (frames, then corners).
//    The splat is bound by the SM's shared-memory pipe: the corner reads
//    (C floats a weighted corner, 730 MB on the scatter inputs above) take
//    about 24 us of it at 128 bytes a clock on 132 SMs, beside the list
//    and uvw reads; the feat_sum traffic (the bound) runs under it.
// Where even a 32-channel slice does not fit (F * P * 128 bytes and the
// ring over the opt-in limit), the same kernel reads the corner rows from
// global memory (L2) with 128-channel slices: the L2 route. Indices outside
// [0, n_buf) are dead slots and are dropped, as JAX's `mode="drop"` scatter
// drops them (ROADMAP trap C2); active indices are unique, so no atomics
// touch feat_sum.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// ---- compact

constexpr int kCompactThreads = 256;
constexpr int kPerThread = 4;  // candidate rows a thread tests
constexpr int kCompactRows = kCompactThreads * kPerThread;

__global__ void __launch_bounds__(kCompactThreads)
    compact_kernel(long long n_buf, const long long* __restrict__ rows,
                   int k_rows, const float* __restrict__ uvw, int F,
                   int2* __restrict__ list, int* __restrict__ count) {
  __shared__ int offsets[kCompactThreads / 32 * kPerThread];
  __shared__ int base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kCompactRows + threadIdx.x;
  // every load issued before any is used; addresses clamped into the
  // arrays, since a guarded load may be issued
  long long dst[kPerThread];
  bool any[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int k = min(k0 + e * kCompactThreads, k_rows - 1);
    dst[e] = rows ? rows[k] : (long long)k;
    any[e] = false;
  }
  for (int f0 = 0; f0 < F; f0 += 8) {
    float v[kPerThread][8];
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int k = min(k0 + e * kCompactThreads, k_rows - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[e][j] = f0 + j < F
                      ? uvw[((size_t)k * F + min(f0 + j, F - 1)) * 3 + 2]
                      : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kPerThread; ++e)
#pragma unroll
      for (int j = 0; j < 8; ++j) any[e] |= v[e][j] != 0.f;
  }
  unsigned mask[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const bool live = k0 + e * kCompactThreads < k_rows && any[e] &&
                      dst[e] >= 0 && dst[e] < n_buf;
    mask[e] = __ballot_sync(0xffffffffu, live);
    if (lane == 0) offsets[warp * kPerThread + e] = __popc(mask[e]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kCompactThreads / 32 * kPerThread; ++i) {
      const int n = offsets[i];
      offsets[i] = total;  // exclusive prefix, in place
      total += n;
    }
    base = total ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kPerThread; ++e)
    if (mask[e] >> lane & 1)
      list[base + offsets[warp * kPerThread + e] +
           __popc(mask[e] & ((1u << lane) - 1))] =
          make_int2(k0 + e * kCompactThreads, (int)dst[e]);
}

// ---- splat

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // live rows a warp sums at once

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void fma(T& a, float w, const T& v) {
    a.x += w * v.x;
    a.y += w * v.y;
    a.z += w * v.z;
    a.w += w * v.w;
  }
  __device__ static void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static void fma(T& a, float w, const T& v) {
    a.x += w * v.x;
    a.y += w * v.y;
  }
  __device__ static void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void fma(T& a, float w, const T& v) { a += w * v; }
  __device__ static void add(T& a, const T& b) { a += b; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes (4, 8 or 16) global -> shared
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // until at most N groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// floats of one ring slot: kGroup uvw rows
__host__ __device__ __forceinline__ int slot_floats(int F) {
  return kGroup * 3 * F;
}
// the warps' lists of a row's weighted pairs (32 float2 a warp)
constexpr int kPairBytes = kWarps * 32 * 8;

// weight and image row (f * P + cy * Px + cx) of pair p = 4 f + 2 dy + dx
// from its frame's (x, y, validity) at u; weight 0 for invalid frames and
// out-of-grid corners
__device__ __forceinline__ void corner(const float* u, int p, int Py,
                                       int Px, float& w, int& row) {
  w = 0.f;
  row = 0;
  const int f = p >> 2, dy = (p >> 1) & 1, dx = p & 1;
  const float px = u[0], py = u[1], val = u[2];
  if (val == 0.f) return;
  const float x0 = floorf(px), y0 = floorf(py);
  // both corners of an axis lie outside the grid unless
  // -1 <= floor < extent; the test also rejects NaN before the cast
  if (!(x0 >= -1.f && x0 < (float)Px && y0 >= -1.f && y0 < (float)Py))
    return;
  const int cx = (int)x0 + dx, cy = (int)y0 + dy;
  if (cx < 0 || cx >= Px || cy < 0 || cy >= Py) return;
  const float fx = px - x0, fy = py - y0;
  const float wx = dx ? fx : 1.f - fx;
  const float wy = dy ? fy : 1.f - fy;
  w = wx * wy * val;
  row = f * Py * Px + cy * Px + cx;
}

// kShared: the slice's images in shared memory (row stride 32 VEC);
// otherwise read from feat_imgs in global memory (row stride C)
template <int VEC, bool kShared>
__global__ void __launch_bounds__(kThreads)
    splat_kernel(float* __restrict__ feat_sum,
                 const float* __restrict__ uvw,
                 const float* __restrict__ feat_imgs, int F, int Py, int Px,
                 int C, int slices, const int2* __restrict__ list,
                 const int* __restrict__ count) {
  using V = Vec<VEC>;
  using VT = typename V::T;
  constexpr int CS = 32 * VEC;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int slice = blockIdx.x % slices;
  const int group = blockIdx.x / slices, groups = gridDim.x / slices;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = slice * CS;       // the slice's first channel
  const int cl = c0 + lane * VEC;  // this lane's first channel
  const bool c_ok = cl < C;
  const int P = Py * Px;
  const int n_live = *count;

  const float* img = feat_imgs + cl;
  int img_ld = C;
  float* ring = smem;
  if (kShared) {
    const int chunks = min(CS, C - c0) / 4;  // 16-byte pieces a row
    for (int i = threadIdx.x; i < F * P * chunks; i += kThreads) {
      const int r = i / chunks, c = 4 * (i % chunks);
      cp_async<16>(smem + r * CS + c, feat_imgs + (size_t)r * C + c0 + c);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    img = smem + lane * VEC;
    img_ld = CS;
    ring = smem + F * P * CS;
  }
  const int slot = slot_floats(F);
  float2* pairs =
      reinterpret_cast<float2*>(ring + kWarps * 2 * slot) + warp * 32;
  ring += warp * 2 * slot;

  // the warp's groups of list entries: g0, g0 + stride, ...
  const int stride = groups * kWarps;
  const int g0 = group * kWarps + warp;
  if (g0 * kGroup >= n_live) return;
  auto fetch = [&](int g, int2 (&to)[kGroup]) {
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int e = g * kGroup + r;
      to[r] = e < n_live ? list[e] : make_int2(-1, 0);
    }
  };
  // stage a group's uvw rows into ring slot s
  auto stage = [&](const int2 (&ent)[kGroup], int s) {
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      if (ent[r].x < 0) continue;
      const float* u = uvw + (size_t)ent[r].x * F * 3;
      for (int i = lane; i < 3 * F; i += 32)
        cp_async<4>(ring + s * slot + r * 3 * F + i, u + i);
    }
  };
  // a group's destination slices, into registers
  auto slices_of = [&](const int2 (&ent)[kGroup], VT (&to)[kGroup]) {
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (ent[r].x >= 0 && c_ok)
        to[r] = *reinterpret_cast<const VT*>(feat_sum +
                                             (size_t)ent[r].y * C + cl);
  };

  int2 cur[kGroup], next[kGroup];
  VT cur_v[kGroup], next_v[kGroup];
  fetch(g0, cur);
  slices_of(cur, cur_v);
  stage(cur, 0);
  cp_async_commit();
  fetch(g0 + stride, next);
  for (int i = 0, g = g0; g * kGroup < n_live; ++i, g += stride) {
    // the next group's loads go out before this group is summed
    stage(next, (i + 1) & 1);
    cp_async_commit();
    slices_of(next, next_v);
    int2 after[kGroup];
    fetch(g + 2 * stride, after);
    cp_async_wait<1>();  // this group's uvw rows have landed
    __syncwarp();
    const float* data = ring + (i & 1) * slot;
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      if (cur[r].x < 0) continue;  // warp-uniform
      VT acc = V::zero();
      for (int p0 = 0; p0 < 4 * F; p0 += 32) {
        const int p = p0 + lane;
        float w = 0.f;
        int row = 0;
        if (p < 4 * F)
          corner(data + r * 3 * F + 3 * (p >> 2), p, Py, Px, w, row);
        // the pairs with a weight, compacted in order into the warp's
        // list (weight, image offset), then read back 4 at a time: one
        // broadcast read a pair, and the image reads issue back to back
        const unsigned nz = __ballot_sync(0xffffffffu, w != 0.f);
        if (w != 0.f)
          pairs[__popc(nz & ((1u << lane) - 1))] =
              make_float2(w, __int_as_float(row * img_ld));
        __syncwarp();
        const int n = __popc(nz);
        for (int q = 0; q < n; q += 4) {
          float2 pr[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) pr[b] = pairs[min(q + b, 31)];
          VT im[4];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (q + b < n && c_ok)
              im[b] = *reinterpret_cast<const VT*>(
                  img + __float_as_int(pr[b].y));
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (q + b < n && c_ok) V::fma(acc, pr[b].x, im[b]);
        }
        __syncwarp();  // the list is rewritten by the next row
      }
      if (c_ok) {
        V::add(cur_v[r], acc);
        *reinterpret_cast<VT*>(feat_sum + (size_t)cur[r].y * C + cl) =
            cur_v[r];
      }
    }
    __syncwarp();  // the slot is restaged two groups on
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      cur[r] = next[r];
      next[r] = after[r];
      cur_v[r] = next_v[r];
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// Channels of one shared-memory slice for F frames of P patches and C
// channels under a shared-memory limit of smem_limit bytes: the widest of
// 128, 64, 32 whose images and staging ring fit and that C needs, or 0 for
// the L2 route.
extern "C" int sai_feature_splat_slice(int F, int P, int C,
                                       long long smem_limit) {
  for (int cs = 128; cs >= 32; cs /= 2) {
    if (cs > 32 && cs / 2 >= C) continue;  // a narrower slice covers C
    const long long bytes = 4ll * F * P * cs +
                            4ll * kWarps * 2 * slot_floats(F) + kPairBytes;
    if (bytes <= smem_limit) return cs;
  }
  return 0;
}

namespace {

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

template <int VEC, bool kShared>
int launch(float* feat_sum, int k_rows, const float* uvw,
           const float* feat_imgs, int F, int Py, int Px, int C,
           const int2* list, const int* count, cudaStream_t stream) {
  auto kernel = splat_kernel<VEC, kShared>;
  constexpr int CS = 32 * VEC;
  const size_t smem = 4 * ((kShared ? (size_t)F * Py * Px * CS : 0) +
                           (size_t)kWarps * 2 * slot_floats(F)) +
                      kPairBytes;
  static int opted_in = -1;  // dynamic shared memory above 48 KB
  if (opted_in < 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = 1;
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (C + CS - 1) / CS;
  // no more groups than fit at once, nor than all rows live would need
  const int need = (k_rows + kGroup * kWarps - 1) / (kGroup * kWarps);
  int groups = std::max(
      1, per_sm * device_attr(cudaDevAttrMultiProcessorCount) / slices);
  groups = std::min(groups, need);
  kernel<<<groups * slices, kThreads, smem, stream>>>(
      feat_sum, uvw, feat_imgs, F, Py, Px, C, slices, list, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat_sum [n_buf, C] f32 (updated in place, n_buf < 2^31); rows [k_rows]
// int64 or NULL (NULL: row k of uvw is grid row k); uvw [k_rows, F, 3] f32
// patch-space x, y and validity; feat_imgs [F, Py, Px, C] f32; scratch
// 2 k_rows + 2 int32, 8-byte aligned (the live count, then the list). C % 4
// == 0 and feat_sum, feat_imgs 16-byte aligned (the wrapper checks).
// Returns a cudaError_t.
extern "C" int sai_feature_splat(float* feat_sum, long long n_buf,
                                 const long long* rows, int k_rows,
                                 const float* uvw, const float* feat_imgs,
                                 int F, int Py, int Px, int C, int* scratch,
                                 void* stream) {
  if (k_rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* count = scratch;
  int2* list = reinterpret_cast<int2*>(scratch + 2);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_kernel<<<(k_rows + kCompactRows - 1) / kCompactRows,
                   kCompactThreads, 0, s>>>(n_buf, rows, k_rows, uvw, F,
                                            list, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (sai_feature_splat_slice(
      F, Py * Px, C, device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))) {
    case 128:
      return launch<4, true>(feat_sum, k_rows, uvw, feat_imgs, F, Py, Px, C,
                             list, count, s);
    case 64:
      return launch<2, true>(feat_sum, k_rows, uvw, feat_imgs, F, Py, Px, C,
                             list, count, s);
    case 32:
      return launch<1, true>(feat_sum, k_rows, uvw, feat_imgs, F, Py, Px, C,
                             list, count, s);
    default:
      return launch<4, false>(feat_sum, k_rows, uvw, feat_imgs, F, Py, Px, C,
                              list, count, s);
  }
}
