// Sequential panoptic mask paint (claim resolution) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spatially_aware_ai_tpu/models/kmax/
// pallas_paint.py (`paint_masks`, kernel `_paint_kernel`). For each frame f
// it walks the N query masks in paint order j = 0..N-1 (query order[f, j]):
//
//   m   = mask_probs[f, order[f, j]] > pixel_threshold
//   new = m & (claim < 0)
//   accept iff keep[f, j] && |m| > 0 && |new| / max(|m|, 1) >= overlap_threshold
//   claim[new] = j  when accepted
//
// and writes claim [F, h, w] int32 (-1 where no accepted query painted) and
// accepted [F, N] (1 where step j's query was accepted). An accepted query
// may paint nothing when overlap_threshold <= 0, so the claims alone do not
// say which queries were accepted.
//
// What bounds it on this card: bytes. Each kept query's probability plane
// is read once (4 * h * w bytes), the claim map and the accepted flags
// written once; a step with keep == 0 cannot be accepted and reads nothing.
// The arithmetic is one compare and a few bit operations per pixel.
//
// Design. Only the accept decision depends on the order of the steps, and
// it needs only the binarised masks. So the work is split in three
// launches on the caller's stream:
//
// 1. pack (one CTA per step, every SM): a kept step's plane is read once,
//    coalesced and streamed (a warp's 32 lanes read 32 neighbouring pixels,
//    32 loads in flight per lane), and `__ballot_sync` turns each 32 pixels
//    into one word: bits [F, N, nwp] uint32 in paint order, bit i of word k
//    the pixel 32k + i, zero past the last pixel; nwp is ceil(hw / 32)
//    rounded up to 4 words, so each step's row is 16-byte aligned. |m| goes
//    to area [F, N] as an exact int32. Steps with keep == 0 exit at once.
// 2. resolve (one CTA of 256 threads per frame): walks the frame's kept
//    steps in order. One thread streams their rows into shared memory, G
//    rows (4; 3 above 131,072 pixels) per bulk (TMA) group on an mbarrier,
//    two groups in flight, so a step finds its 9.7 KB of bits (241 x 321)
//    on chip instead of a 309 KB plane in HBM. Each thread owns the 16-byte
//    chunks t, t + 256, ... of every row and keeps its part of the claimed
//    mask in registers. The accept rule needs no division in the walk:
//    before it, each kept step's least accepted |new| is found by a binary
//    search on the plain version's IEEE f32 division of the counts, which
//    is monotone in |new|, so `|new| >= need` decides exactly as the
//    division would. The walk guesses that the steps of a group decide as
//    the last decided step did: each row's |new| = sum of popc(bits &
//    ~claimed), with the claimed mask grown by every row before it when
//    the guess is accept and by none when it is reject, for all the
//    group's rows, then one `__reduce_add_sync` per row and one barrier.
//    Every thread decides the rows alike, in order, up to the first step
//    with a non-empty mask that decides otherwise: the counts after it
//    assumed the other outcome, so the walk restarts after it with the
//    guess flipped. The counts up to it are exact, so the decisions are
//    the sequential ones; a change of outcome costs one more barrier. The
//    walk is bound by the SM's popc and integer rate (12 popc per row and
//    thread at 241 x 321), not by the barrier. The accepted flags and the
//    accepted steps' list acc_list [F, 1 + N] (count, then paint indices)
//    are written after the walk.
// 3. stamp (every SM): claim[f, p] is the first accepted step, in paint
//    order, whose bit is set at p, else -1; this equals the sequential
//    stamp because a claimed pixel never changes. A CTA takes 32 words of a
//    frame, one a lane; its four warps each walk a quarter of the accepted
//    list (8 coalesced loads in flight), keeping each pixel's first index
//    bit-sliced (7 planes of 32 bits and a claimed mask), merge the quarters
//    in list order in shared memory, and write the claims coalesced.
//
// Counts are exact int32 and the accept rule is the plain version's f32
// division of their f32 values (exact below 2^24 pixels), so the claims and
// the accepted flags equal the plain version's and the JAX package's bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxQueries = 128;        // warps 0..3 build the step lists
constexpr int kIndexBits = 7;           // paint indices < kMaxQueries

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;

constexpr int kResolveThreads = 256;
constexpr int kResolveWarps = kResolveThreads / 32;
constexpr int kMaxChunksPerThread = 7;  // 16-byte chunks of a row
constexpr int kMaxPixels = kMaxChunksPerThread * kResolveThreads * 4 * 32;
constexpr int kNever = 0x7fffffff;      // the least |new| of an empty step

constexpr int kStampThreads = 128;
constexpr int kStampWarps = kStampThreads / 32;
constexpr int kStampBatch = 8;          // loads in flight per lane

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one contiguous row of `bytes` (a multiple of 16, 16-byte aligned) into
// shared memory; its bytes count towards `bar`'s expected transactions
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(kPackThreads)
paint_pack_kernel(const float* __restrict__ probs,
                  const int* __restrict__ order,
                  const int* __restrict__ keep, uint32_t* __restrict__ bits,
                  int* __restrict__ area, int N, int hw, int nwp,
                  float pixel_thr) {
  const int step = blockIdx.x;  // f * N + j
  if (keep[step] == 0) return;  // never read by resolve or stamp
  const int f = step / N;
  const float* plane = probs + ((size_t)f * N + order[step]) * hw;
  uint32_t* out = bits + (size_t)step * nwp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // a warp packs 32 words a round, lane k keeping word k
  int count = 0;
  for (int w0 = warp * 32; w0 < nwp; w0 += 32 * kPackWarps) {
    float x[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int p = (w0 + k) * 32 + lane;
      x[k] = p < hw ? __ldcs(plane + p) : 0.f;  // streamed: read once
    }
    uint32_t mine = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int p = (w0 + k) * 32 + lane;
      const uint32_t word = __ballot_sync(kFull, p < hw && x[k] > pixel_thr);
      if (lane == k) mine = word;
    }
    if (w0 + lane < nwp) {
      out[w0 + lane] = mine;
      count += __popc(mine);
    }
  }
  __shared__ int partial[kPackWarps];
  count = __reduce_add_sync(kFull, count);
  if (lane == 0) partial[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0;
#pragma unroll
    for (int i = 0; i < kPackWarps; ++i) a += partial[i];
    area[step] = a;
  }
}

// The least |new| a step of area `a` is accepted with: the first n in
// [0, a] with fdiv_rn(n, max(a, 1)) >= thr (monotone in n), a + 1 when
// there is none, and kNever for a == 0.
__device__ int least_accepted(int a, float overlap_thr) {
  if (a <= 0) return kNever;
  const float d = (float)a;
  int lo = 0, hi = a + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__fdiv_rn((float)mid, d) >= overlap_thr)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

__device__ __forceinline__ int popc_new(uint4 b, uint4 c) {
  return __popc(b.x & ~c.x) + __popc(b.y & ~c.y) + __popc(b.z & ~c.z) +
         __popc(b.w & ~c.w);
}

// Builds the list of the frame's steps whose flag is set, in paint order
// (warps 0..3 cover N <= 128; flag false for t >= N). Returns the count.
__device__ __forceinline__ int step_list(bool flag, int* list, int* warp_count,
                                         int t) {
  const int lane = t & 31, warp = t >> 5;
  const unsigned ballot = __ballot_sync(kFull, flag);
  if (warp < 4 && lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int total = 0, offset = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    offset += i < warp ? warp_count[i] : 0;
    total += warp_count[i];
  }
  if (flag) list[offset + __popc(ballot & ((1u << lane) - 1u))] = t;
  return total;
}

// Group g of G kept steps (its rows) into ring half g & 1, completing on
// full[g & 1].
template <int G>
__device__ __forceinline__ void fetch_group(uint4* ring, uint64_t* full,
                                            const uint32_t* fbits,
                                            const int* kept, int g, int K,
                                            int nwp) {
  const int chunks = nwp / 4;
  const int rows = min(G, K - g * G);
  const uint32_t row_bytes = (uint32_t)nwp * 4u;
  uint64_t* bar = &full[g & 1];
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(row_bytes * rows)
      : "memory");
  for (int i = 0; i < rows; ++i)
    bulk_copy(ring + ((g & 1) * G + i) * chunks,
              fbits + (size_t)kept[g * G + i] * nwp, row_bytes, bar);
}

template <int Q, int G>
__global__ void __launch_bounds__(kResolveThreads, 1)
paint_resolve_kernel(const uint32_t* __restrict__ bits,
                     const int* __restrict__ area,
                     const int* __restrict__ keep,
                     uint8_t* __restrict__ accepted_out,
                     int* __restrict__ acc_list, int N, int nwp,
                     float overlap_thr) {
  extern __shared__ __align__(128) uint4 ring[];  // [2][G][nwp / 4]
  __shared__ int kept[kMaxQueries];
  __shared__ int need[kMaxQueries];
  __shared__ int acc[kMaxQueries];
  __shared__ int warp_count[2][4];
  __shared__ __align__(16) int partial[2][G][kResolveWarps];
  __shared__ __align__(8) uint64_t full[2];
  const int f = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int chunks = nwp / 4;

  if (t == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the frame's kept steps in paint order and the least |new| each is
  // accepted with
  const bool is_kept = t < N && keep[f * N + t] != 0;
  const int K = step_list(is_kept, kept, warp_count[0], t);
  __syncthreads();
  if (t < K) need[t] = least_accepted(area[f * N + kept[t]], overlap_thr);
  __syncthreads();

  const uint32_t* fbits = bits + (size_t)f * N * nwp;
  const int groups = (K + G - 1) / G;
  if (t == 0 && chunks > 0)
    for (int g = 0; g < 2 && g < groups; ++g)
      fetch_group<G>(ring, full, fbits, kept, g, K, nwp);
  uint4 claimed[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) claimed[i] = make_uint4(0u, 0u, 0u, 0u);
  bool mine = false;  // thread q's record of step q's decision
  bool guess = true;  // the next steps decide as the last decided one
  int batch = 0;
  for (int g = 0; g < groups; ++g) {
    const int g0 = g * G, g_end = min(K, g0 + G);
    if (chunks > 0) mbar_wait(&full[g & 1], (g >> 1) & 1);
    const uint4* rows = ring + (g & 1) * G * chunks;
    // Speculate that every step from q0 on decides as `guess`: each row's
    // |new| against the claimed mask grown by all rows before it (guess
    // accept) or by none (guess reject). The counts are exact up to the
    // first non-empty step that decides otherwise; the walk restarts after
    // it with the guess flipped.
    for (int q0 = g0; q0 < g_end; ++batch) {
      uint4 r[G][Q];
      uint4 grown[Q];
#pragma unroll
      for (int k = 0; k < Q; ++k) grown[k] = claimed[k];
      int n[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        n[i] = 0;
#pragma unroll
        for (int k = 0; k < Q; ++k) {
          const int c = t + k * kResolveThreads;
          r[i][k] = q0 + i < g_end && c < chunks
                        ? rows[(q0 + i - g0) * chunks + c]
                        : make_uint4(0u, 0u, 0u, 0u);
          n[i] += popc_new(r[i][k], grown[k]);
          if (guess) {
            grown[k].x |= r[i][k].x;
            grown[k].y |= r[i][k].y;
            grown[k].z |= r[i][k].z;
            grown[k].w |= r[i][k].w;
          }
        }
      }
      const int b = batch & 1;
#pragma unroll
      for (int i = 0; i < G; ++i) {  // independent warp sums, back to back
        const int sum = __reduce_add_sync(kFull, n[i]);
        if (lane == 0) partial[b][i][warp] = sum;
      }
      __syncthreads();  // also: every thread has read its rows
      int decided = g_end - q0;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (i < decided) {
          const int q = q0 + i;
          int n_new = 0;
#pragma unroll
          for (int w = 0; w < kResolveWarps; ++w) n_new += partial[b][i][w];
          const bool accept = n_new >= need[q];
          if (t == q) mine = accept;
          if (accept) {
#pragma unroll
            for (int k = 0; k < Q; ++k) {
              claimed[k].x |= r[i][k].x;
              claimed[k].y |= r[i][k].y;
              claimed[k].z |= r[i][k].z;
              claimed[k].w |= r[i][k].w;
            }
          }
          if (accept != guess && need[q] != kNever) {
            decided = i + 1;  // the rows after it were counted wrongly
            guess = accept;
          }
        }
      }
      q0 += decided;
    }
    // every thread has read group g's rows (before the last barrier)
    if (t == 0 && g + 2 < groups && chunks > 0)
      fetch_group<G>(ring, full, fbits, kept, g + 2, K, nwp);
  }

  // the accepted flags in paint order and the accepted steps' list
  if (t < N && !is_kept) accepted_out[f * N + t] = 0;
  if (t < K) accepted_out[f * N + kept[t]] = mine ? 1 : 0;
  const int A = step_list(t < K && mine, acc, warp_count[1], t);
  __syncthreads();
  int* list = acc_list + f * (N + 1);
  if (t < A) list[1 + t] = kept[acc[t]];
  if (t == 0) list[0] = A;
}

__global__ void __launch_bounds__(kStampThreads)
paint_stamp_kernel(const uint32_t* __restrict__ bits,
                   const int* __restrict__ acc_list, int* __restrict__ claim,
                   int N, int hw, int nwp) {
  __shared__ int steps[kMaxQueries];
  // per warp and word: the claimed mask, then the index's bit planes
  __shared__ uint32_t part[kStampWarps][kIndexBits + 1][32];
  const int f = blockIdx.y;
  const int* list = acc_list + f * (N + 1);
  const int A = __ldg(list);
  for (int i = threadIdx.x; i < A; i += kStampThreads)
    steps[i] = __ldg(list + 1 + i);
  __syncthreads();

  // warp w walks its quarter of the accepted list for words w0 + lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * 32;
  const bool have = w0 + lane < nwp;
  const uint32_t* src = bits + (size_t)f * N * nwp + w0 + lane;
  const int per = (A + kStampWarps - 1) / kStampWarps;
  const int i_end = min(A, (warp + 1) * per);
  uint32_t done = 0u, plane[kIndexBits];
#pragma unroll
  for (int b = 0; b < kIndexBits; ++b) plane[b] = 0u;
  for (int i0 = warp * per; i0 < i_end; i0 += kStampBatch) {
    uint32_t word[kStampBatch];
    int j[kStampBatch];
#pragma unroll
    for (int k = 0; k < kStampBatch; ++k) {
      j[k] = i0 + k < i_end ? steps[i0 + k] : 0;
      word[k] = (have && i0 + k < i_end) ? __ldg(src + (size_t)j[k] * nwp)
                                         : 0u;
    }
#pragma unroll
    for (int k = 0; k < kStampBatch; ++k) {
      const uint32_t fresh = word[k] & ~done;
      done |= word[k];
#pragma unroll
      for (int b = 0; b < kIndexBits; ++b)
        plane[b] |= (j[k] >> b) & 1 ? fresh : 0u;
    }
  }
  part[warp][0][lane] = done;
#pragma unroll
  for (int b = 0; b < kIndexBits; ++b) part[warp][1 + b][lane] = plane[b];
  __syncthreads();
  if (warp == 0) {  // merge the quarters in list order into part[0]
#pragma unroll
    for (int w = 1; w < kStampWarps; ++w) {
      const uint32_t fresh = part[w][0][lane] & ~done;
      done |= part[w][0][lane];
#pragma unroll
      for (int b = 0; b < kIndexBits; ++b)
        plane[b] |= part[w][1 + b][lane] & fresh;
    }
    part[0][0][lane] = done;
#pragma unroll
    for (int b = 0; b < kIndexBits; ++b) part[0][1 + b][lane] = plane[b];
  }
  __syncthreads();
  // warp w writes 8 of the 32 words, a pixel a lane, coalesced
  int* out = claim + (size_t)f * hw;
#pragma unroll
  for (int k = warp * 8; k < warp * 8 + 8; ++k) {
    int c = 0;
#pragma unroll
    for (int b = 0; b < kIndexBits; ++b)
      c |= (int)((part[0][1 + b][k] >> lane) & 1u) << b;
    const int p = (w0 + k) * 32 + lane;
    if (p < hw) out[p] = (part[0][0][k] >> lane) & 1u ? c : -1;
  }
}

template <int Q, int G>
int launch_resolve(int F, cudaStream_t stream, const uint32_t* bits,
                   const int* area, const int* keep, uint8_t* accepted,
                   int* acc_list, int N, int nwp, float overlap_thr) {
  const int smem = 2 * G * nwp * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      paint_resolve_kernel<Q, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paint_resolve_kernel<Q, G><<<F, kResolveThreads, smem, stream>>>(
      bits, area, keep, accepted, acc_list, N, nwp, overlap_thr);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int F, int N, int hw) {
  return F < 0 || N < 0 || N > kMaxQueries || hw < 0 || hw > kMaxPixels;
}

// words of a step's row: ceil(hw / 32) rounded up to 16 bytes
int row_words(int hw) { return (hw + 127) / 128 * 4; }

}  // namespace

// The three steps, launched in this order on one stream. Shapes: probs
// [F, N, hw] f32 (contiguous); order, keep [F, N] int32 (order a permutation
// of 0..N-1 per frame, keep in paint order); workspace bits [F, N, nwp]
// uint32 (nwp = 4 * ceil(hw / 128), 16-byte aligned), area [F, N] int32,
// acc_list [F, N + 1] int32 (only kept steps' bits and areas are written,
// and only they are read); claim [F, hw] int32 and accepted [F, N] uint8
// (paint order) out. N <= 128 and hw <= kMaxPixels (the wrapper checks
// both). Each returns a cudaError_t (0 on success).
extern "C" int sai_paint_pack(const float* probs, const int* order,
                              const int* keep, uint32_t* bits, int* area,
                              int F, int N, int hw, float pixel_thr,
                              void* stream) {
  if (bad_shape(F, N, hw)) return static_cast<int>(cudaErrorInvalidValue);
  if (F > 0 && N > 0)
    paint_pack_kernel<<<F * N, kPackThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        probs, order, keep, bits, area, N, hw, row_words(hw), pixel_thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sai_paint_resolve(const uint32_t* bits, const int* area,
                                 const int* keep, uint8_t* accepted,
                                 int* acc_list, int F, int N, int hw,
                                 float overlap_thr, void* stream) {
  if (bad_shape(F, N, hw)) return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0) return static_cast<int>(cudaGetLastError());
  const int nwp = row_words(hw);
  const int per_thread = (nwp / 4 + kResolveThreads - 1) / kResolveThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_thread <= 1)
    return launch_resolve<1, 4>(F, s, bits, area, keep, accepted, acc_list, N,
                             nwp, overlap_thr);
  if (per_thread <= 2)
    return launch_resolve<2, 4>(F, s, bits, area, keep, accepted, acc_list, N,
                             nwp, overlap_thr);
  if (per_thread <= 3)
    return launch_resolve<3, 4>(F, s, bits, area, keep, accepted, acc_list, N,
                             nwp, overlap_thr);
  if (per_thread <= 4)
    return launch_resolve<4, 4>(F, s, bits, area, keep, accepted, acc_list, N,
                             nwp, overlap_thr);
  return launch_resolve<kMaxChunksPerThread, 3>(
      F, s, bits, area, keep, accepted, acc_list, N, nwp, overlap_thr);
}

extern "C" int sai_paint_stamp(const uint32_t* bits, const int* acc_list,
                               int* claim, int F, int N, int hw,
                               void* stream) {
  if (bad_shape(F, N, hw)) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (hw + 31) / 32;
  if (F > 0 && words > 0) {
    const dim3 grid((words + 31) / 32, F);
    paint_stamp_kernel<<<grid, kStampThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        bits, acc_list, claim, N, hw, row_words(hw));
  }
  return static_cast<int>(cudaGetLastError());
}
