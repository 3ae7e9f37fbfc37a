// Fused LayerNorm -> Dense(H) -> activation -> Dense(D) -> residual block
// for Hopper (sm_90a):
//
//   out = residual + gamma * (act(LN(x) @ W1 + b1) @ W2 + b2)
//
// Replaces the Pallas TPU kernel spatially_aware_ai_tpu/models/pallas_mlp.py
// (`fused_ln_mlp`, kernel `_ln_mlp_kernel`), used by the CLIP transformer
// MLP (quick_gelu, eps 1e-5, no gamma) and the ConvNeXt block (exact-erf
// gelu, eps 1e-6, layer-scale gamma). LN and every accumulation run in f32;
// the matmul operands are rounded to the activation type T (f32 or bf16),
// as the JAX kernel feeds its MXU in the activation dtype.
//
// One call is 4 * M * D * H flops (H = 4D: 16 M D^2). Two routes by
// width: D <= 256 one fused kernel that keeps the hidden on chip (route 1),
// D > 256 two products with the hidden h [M, H] in device memory (route 2).
// Each dtype has its own kernels.
//
// f32 (3xTF32). What bounds it: operations. f32 products run as 3xTF32
// (v = big + small, the product as small*big + big*small + big*big, the
// dropped small*small term below 2^-22 of it), so the tensor-core floor is
// 3 * 4 M D H / 495 TFLOP/s. The earlier design (warp-level mma.sync, the
// whole [TM, D] output tile in registers) was held back by three things,
// and this one answers each:
// 1. The weight stream from L2. A block of TM = 16-64 rows read both weight
//    matrices, 32 D^2 M / TM bytes a launch. Here a CTA owns 128 rows (two
//    consumer warpgroups of 64) and a producer warpgroup (one thread
//    issues the copies; its registers go to the consumers) streams the weights
//    through a ring of shared-memory stages with TMA (cp.async.bulk.tensor,
//    128-byte swizzle) and mbarriers; both warpgroups read each stage.
// 2. mma.sync and re-split fragments. Products are wgmma.mma_async
//    (m64n64k8 tf32) with the weights (B) read from shared memory by
//    descriptor and A from registers. The weights are split into big / small
//    TF32 planes once per call by sai_ln_mlp_split, K-major, so no B
//    fragment is split in the mainloop; each A value is split once per use
//    in registers.
// 3. A weight copy per call. The planes are written from the callers'
//    nn.Linear layout ([H, D] and [D, H], any strides), which is the K-major
//    layout wgmma takes for TF32; the split pass replaces the copy.
// Where the hidden lives (a warpgroup's [64, D] f32 accumulator costs D / 2
// registers a thread): route 1 normalises a CTA's 128 rows once into shared
// memory (f32), then walks the hidden in chunks of 64: GEMM1 gives h =
// act(LN(x) W1[:, chunk] + b1) in registers, and GEMM2 adds h W2[chunk, :]
// into the [64, D] accumulator; h goes from the GEMM1 accumulator straight
// into GEMM2's A registers (the split pass permutes W2's K within each group
// of 8 to match the accumulator's column order: position s holds hidden 2s
// for s < 4, 2(s-4)+1 after). Route 2: phase 1 writes h = act(LN(x) W1 +
// b1) [M, H], phase 2 computes residual + gamma (h W2 + b2), both with
// 128-row x 256-column output tiles; each thread reads its A values as
// contiguous 16-byte vectors from device memory (the split pass permutes K
// within each slab of 32 so that a thread's fragment columns are
// contiguous), and a pre-pass (ln_stats) computes each row's mean and 1/std.
//
// bf16. What bounds it: operations, 4 M D H / 989 TFLOP/s (0.388 ms at each
// ConvNeXt-L stage of the kMaX path), with route 2's hidden write and read
// (4 M H bytes) beside it. bf16 has a third of f32's tensor-core products
// at twice the rate, so the CUDA-core work, the waits and the L2 stream
// that 3xTF32 hid now decide the time. The earlier bf16 route swapped the
// operand type in the f32 mainloop and lost to two cuBLAS products by
// 2.6-6.0x. This route is its own, and answers each of its six causes:
// 1. Serialised products (a wait_group 0 after every group of four
//    k-steps). Products stay in flight: route 2 waits with wait_group 1, so
//    slab s + 1 is queued while slab s runs; route 1 issues GEMM1 of hidden
//    chunk c + 1 and GEMM2 of chunk c back to back and computes the
//    activation of chunk c + 1 while GEMM2 of chunk c runs, with the
//    activation's bf16 A registers double-buffered.
// 2. A built on CUDA cores at every k-step. A is read from shared memory by
//    descriptor (128-byte swizzle, K-major). Route 1: the consumers write
//    LN(x), rounded to bf16, once per tile into a swizzled bf16 tile (half
//    the earlier f32 tile); GEMM2 keeps h in registers, since the
//    accumulator and A-fragment layouts agree for bf16. Route 2: a pre-pass
//    (ln_mlp_norm_bf16) writes LN(x) in bf16 and both phases bring A in by
//    TMA, so the two phases share one pure-TMA mainloop. The pre-pass
//    costs 2 M D 2 bytes (10% of the bound at D = 768, 19% at 384); LN'd
//    tiles written by the consumers would cost every column tile of a row
//    tile the normalisation again on CUDA cores, in the warpgroups that
//    issue the products.
// 3. Narrow products. Route 2 issues one m64n256k16 a k-step (n128 / n64 /
//    n32 where the tile choice needs it); route 1 one m64nDk16 a k-step for
//    GEMM2. GEMM1 stays m64n64k16: a 128-wide hidden chunk with two A
//    buffers would need 96 + 64 + 64 accumulator and A registers a thread
//    at D = 192, past the 168 ptxas gives a thread of a 384-thread block.
// 4. Route 1's weight stream from L2 (both weights for every 128-row tile,
//    3.0 GB a call at the os4 shape). CTAs run in clusters of two: each
//    weight box is read from L2 once per cluster and multicast to both
//    CTAs' shared memory (cp.async.bulk.tensor .multicast::cluster), each
//    CTA issuing half of every stage; a stage is refilled once the
//    consumers of both CTAs release it (remote mbarrier arrives). Route 2
//    does the same for the weight tile of each pair of row tiles.
// 5. Small M. Route 2 chooses its tile by M and N (tile_for): 128-row
//    tiles with the warpgroups one above the other where they give at
//    least one tile an SM, else 64-row tiles with the warpgroups side by
//    side and 64- or 32-column warpgroup tiles, so that at M = 231 (the
//    CLIP text tower) phase 1 runs 128 CTAs. The choice moves rows between
//    CTAs only: every output sums K in the same slabs of 64 and k-steps of
//    16, in order, and rounds at the same points, whatever M is (no split
//    of K or H).
// 6. Two split passes a call. A bf16 call makes its planes with one launch
//    for both weights (sai_ln_mlp_cast), in the callers' K order: no route
//    permutes K in bf16 any more.
// What the card showed (clock64 counters in a copy of route 1, variants
// timed by kernel_ab.py --variant; PERF.md section 6): with those six
// answered, route 1's consumers hardly wait on the tensor cores or on their
// stages; route 1 is bound by its CUDA-core work, the exact-erf gelu first,
// then LN and the epilogue. So the bf16 kernels take erf and the logistic
// on the hardware's exp2 and reciprocal (activate_bf16), and LN reads a row
// by two threads in 16-byte pieces. Route 2's phase 1 has the activation
// in its epilogue, which the next tile's products do not overlap. A stage
// is released with a CTA-scope arrive: a cluster-scope release on every
// stage made every shape 1.7-2.4x slower.
// Both routes run a persistent grid of clusters; rows past M compute on
// zeros (TMA fills them) and are not stored. Every output row's arithmetic
// is independent of M and of its place in the batch, and no sum uses
// atomics, so a call is bitwise repeatable.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace {

constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 128;     // + the producer warpgroup
constexpr int kRows = 128;                     // rows of a CTA tile
constexpr int kBox = 64;                       // weight rows of a TMA box
constexpr int kBoxBytes = kBox * 128;          // one 64 x 128 B box
constexpr int kSmemMax = 227 * 1024;
constexpr int kMaxStages = 6;
constexpr int kMaxSub = 4;                     // 64-column subtiles
constexpr int kLnPad = 4;                      // LN tile row padding (floats)

// ---------------------------------------------------------------- PTX

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// one TMA box (k0 = inner coordinate, r0 = row) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int k0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(r0),
      "r"(smem_u32(bar))
      : "memory");
}

// the producer warpgroup gives registers to the two consumer warpgroups
// (3 x 128 x 168 = 40 x 128 + 2 x 232 x 128)
__device__ __forceinline__ void regs_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void regs_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma reads its A registers after it issues: holding them live until
// after the wait keeps the compiler from reusing them (for the next slab's
// loads) while the products run
template <int N, int F>
__device__ __forceinline__ void hold(uint32_t (&a)[N][F]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < F; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// K-major operand, 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

#define SAI_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define SAI_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d[64 x 64] += a[64 x 8] (registers, tf32) * B[8 x 64] (shared, K-major)
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SAI_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SAI_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// ---------------------------------------------------------------- types

template <typename T>
struct Op;

// f32: 3xTF32. A k-step fragment is 8 registers: big a0..a3, small a0..a3.
template <>
struct Op<float> {
  static constexpr int kK = 32;       // K of a slab (128 bytes a row)
  static constexpr int kStep = 8;     // K of one wgmma
  static constexpr int kPlanes = 2;
  static constexpr int kFrag = 8;
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  // values at fragment slots a0..a3
  static __device__ __forceinline__ void frag(uint32_t* a, float v0,
                                              float v1, float v2, float v3) {
    const float v[4] = {v0, v1, v2, v3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = tf32_bits(v[i]);
      a[4 + i] = tf32_bits(v[i] - __uint_as_float(a[i]));
    }
  }
  // one k-step: B big at b, small at b + plane bytes
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint32_t b, uint32_t plane) {
    wgmma_tf32(d, a + 4, desc_sw128(b));          // small * big
    wgmma_tf32(d, a, desc_sw128(b + plane));      // big * small
    wgmma_tf32(d, a, desc_sw128(b));              // big * big
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

// a bf16 weight read by the split and cast passes
template <>
struct Op<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <int ACT>
__device__ __forceinline__ float activate(float h) {
  if (ACT == 0) return h * (1.f / (1.f + expf(-1.702f * h)));  // quick_gelu
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));     // exact gelu
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- the ring

// Stages of weight boxes: `full` completes when the producer's TMA bytes
// land, `empty` when the 8 consumer warps are done with the stage.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int stage_bytes;
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  // consumer side
  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(&full[slot], phase);
    return smem_u32(base + (size_t)slot * stage_bytes);
  }
  __device__ __forceinline__ void release(int lane) {
    if (lane == 0) mbar_arrive(&empty[slot]);
    next();
  }
  // producer side: the stage's shared-memory pointer once it is free
  __device__ __forceinline__ uint8_t* produce(uint32_t bytes) {
    mbar_wait(&empty[slot], phase ^ 1);
    mbar_expect_tx(&full[slot], bytes);
    return base + (size_t)slot * stage_bytes;
  }
};

// Carve the dynamic shared memory: `lead` bytes first (1024-aligned), then
// the ring, then the barriers. Thread 0 initialises the barriers.
__device__ Ring make_ring(uint8_t* smem, size_t lead, int stages,
                          int stage_bytes, uint8_t** lead_ptr) {
  uint8_t* p = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  *lead_ptr = p;
  Ring r;
  r.base = p + lead;
  r.full = reinterpret_cast<uint64_t*>(r.base + (size_t)stages * stage_bytes);
  r.empty = r.full + stages;
  r.stages = stages;
  r.stage_bytes = stage_bytes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&r.full[i], 1);
      mbar_init(&r.empty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

size_t smem_total(size_t lead, int stages, int stage_bytes) {
  return 1024 + lead + (size_t)stages * stage_bytes + 16 * stages;
}

int stages_for(size_t lead, int stage_bytes) {
  int s = kMaxStages;
  while (s > 2 && smem_total(lead, s, stage_bytes) > (size_t)kSmemMax) --s;
  return s;
}

// ---------------------------------------------------------------- route 1

// The fused kernel, D <= 256. Stage = one 64-row box per plane of W1 planes
// [P][H][D] (rows: hidden) or W2 planes [P][D][H] (rows: output columns).
// Per row tile and hidden chunk c of 64 the producer loads, in order:
// GEMM1: D / kK slabs of W1 rows [64c, 64c + 64); GEMM2: for each of the
// 64 / kK hidden slabs, D / 64 boxes of W2 (one per output subtile).
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_fused(const __grid_constant__ CUtensorMap w1map,
             const __grid_constant__ CUtensorMap w2map,
             const T* __restrict__ x, const T* __restrict__ res,
             const float* __restrict__ lns, const float* __restrict__ lnb,
             const float* __restrict__ b1, const float* __restrict__ b2,
             const float* __restrict__ gamma, T* __restrict__ out, int M,
             int D, int H, float eps, int stages) {
  using O = Op<T>;
  extern __shared__ uint8_t smem[];
  const int ld = D + kLnPad;
  uint8_t* lead;
  Ring ring = make_ring(smem, (size_t)kRows * ld * sizeof(float), stages,
                        O::kPlanes * kBoxBytes, &lead);
  float* lnt = reinterpret_cast<float*>(lead);
  const int tiles = (M + kRows - 1) / kRows;
  const int nsub = D / 64;
  const int chunks = H / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= kConsumers / 32) {  // ---- producer: one thread issues TMA
    regs_producer();
    if (warp == kConsumers / 32 && lane == 0) {
      const uint32_t bytes = O::kPlanes * kBoxBytes;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int c = 0; c < chunks; ++c) {
          for (int s = 0; s < D / O::kK; ++s) {
            uint8_t* dst = ring.produce(bytes);
            for (int p = 0; p < O::kPlanes; ++p)
              tma_load(dst + p * kBoxBytes, &w1map, s * O::kK, p * H + c * 64,
                       &ring.full[ring.slot]);
            ring.next();
          }
          for (int s = 0; s < 64 / O::kK; ++s)
            for (int n = 0; n < nsub; ++n) {
              uint8_t* dst = ring.produce(bytes);
              for (int p = 0; p < O::kPlanes; ++p)
                tma_load(dst + p * kBoxBytes, &w2map, c * 64 + s * O::kK,
                         p * D + n * 64, &ring.full[ring.slot]);
              ring.next();
            }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile,
  // warp w of it rows 16 w .. 16 w + 15 (the wgmma fragment rows)
  regs_consumer();
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int lrow = wg * 64 + w * 16;  // the warp's first row in the tile
  const float* a0 = lnt + (size_t)(lrow + g) * ld;
  const float* a1 = a0 + 8 * ld;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRows + lrow;
    // LN of the warp's 16 rows into its rows of the tile (D <= 256: at most
    // 8 values a lane), rounded to T; four rows' loads in flight at a time
    for (int r0 = 0; r0 < 16; r0 += 4) {
      float v[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int d = lane + 32 * i, gm = row0 + r0 + r;
          v[r][i] = (d < D && gm < M) ? O::load(x + (size_t)gm * D + d) : 0.f;
        }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += v[r][i];
        const float mu = warp_sum(s) / D;
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (lane + 32 * i < D) q += (v[r][i] - mu) * (v[r][i] - mu);
        const float rs = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int d = lane + 32 * i;
          if (d < D)
            lnt[(size_t)(lrow + r0 + r) * ld + d] =
                O::round((v[r][i] - mu) * rs * lns[d] + lnb[d]);
        }
      }
    }
    __syncwarp();

    float acc[kMaxSub][32];
#pragma unroll
    for (int n = 0; n < kMaxSub; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;

    for (int c = 0; c < chunks; ++c) {
      // ---- GEMM1: h = LN(x) W1[:, 64c : 64c + 64]
      float h[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h[i] = 0.f;
      for (int s = 0; s < D / O::kK; ++s) {
        uint32_t a[4][O::kFrag];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k0 = s * O::kK + kk * O::kStep;
          O::frag(a[kk], a0[k0 + t], a1[k0 + t], a0[k0 + t + 4],
                  a1[k0 + t + 4]);
        }
        const uint32_t b = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) O::mma(h, a[kk], b + 32 * kk, kBoxBytes);
        wgmma_commit();
        wgmma_wait0();
        hold(a);
        ring.release(lane);
      }
      // bias, activation, rounding to T; h[4j + e] is row g + 8 (e / 2),
      // hidden column 64c + 8j + 2t + e % 2
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(
            b1 + c * 64 + 8 * j + 2 * t);
        h[4 * j] = O::round(activate<ACT>(h[4 * j] + bb.x));
        h[4 * j + 1] = O::round(activate<ACT>(h[4 * j + 1] + bb.y));
        h[4 * j + 2] = O::round(activate<ACT>(h[4 * j + 2] + bb.x));
        h[4 * j + 3] = O::round(activate<ACT>(h[4 * j + 3] + bb.y));
      }
      // ---- GEMM2: acc += h W2[64c : 64c + 64, :]
#pragma unroll
      for (int s = 0; s < 64 / O::kK; ++s) {
        uint32_t a[4][O::kFrag];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // k-step j = 4s + kk takes the accumulator's n8 tile j; slot t
          // holds hidden 8j + 2t, slot t + 4 hidden 8j + 2t + 1 (W2's
          // planes are permuted to match)
          const int j = 4 * s + kk;
          O::frag(a[kk], h[4 * j], h[4 * j + 2], h[4 * j + 1], h[4 * j + 3]);
        }
#pragma unroll
        for (int n = 0; n < kMaxSub; ++n) {
          if (n < nsub) {
            const uint32_t b = ring.acquire();
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              O::mma(acc[n], a[kk], b + 32 * kk, kBoxBytes);
            wgmma_commit();
            wgmma_wait0();
            hold(a);
            ring.release(lane);
          }
        }
      }
    }

    // ---- epilogue: residual + gamma * (acc + b2)
#pragma unroll
    for (int n = 0; n < kMaxSub; ++n) {
      if (n >= nsub) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n * 64 + 8 * j + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
        const float2 gg = gamma ? *reinterpret_cast<const float2*>(gamma + col)
                                : make_float2(1.f, 1.f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gm = row0 + g + 8 * half;
          if (gm >= M) continue;
          const size_t at = (size_t)gm * D + col;
          const float2 rr = O::load2(res + at);
          O::store2(out + at,
                    rr.x + gg.x * (acc[n][4 * j + 2 * half] + bb.x),
                    rr.y + gg.y * (acc[n][4 * j + 2 * half + 1] + bb.y));
        }
      }
    }
  }
}

// ---------------------------------------------------------------- route 2

// Each row's LayerNorm mean and 1/std (two passes over the row), one warp
// a row: phase 1 reads them once per tile row instead of recomputing them
// for every column tile.
template <typename T>
__global__ void __launch_bounds__(256)
ln_stats(const T* __restrict__ x, int M, int D, float eps,
         float2* __restrict__ stats) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += Op<T>::load(xr + d);
  const float mu = warp_sum(s) / D;
  float q = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float c = Op<T>::load(xr + d) - mu;
    q += c * c;
  }
  const float rs = rsqrtf(warp_sum(q) / D + eps);
  if (lane == 0) stats[row] = make_float2(mu, rs);
}

// One phase of the two-phase route: C [M, N] = A [M, K] @ B, B from planes
// [P][N][K] with K permuted within each slab (mode 2 of the split pass), so
// that thread t's A values of a slab are the contiguous columns
// [slab + 8t, slab + 8t + 8).
// Output tiles are 128 rows x 64 * nsub columns.
// PHASE1: A = LN(x) (each row's mean and 1/std from ln_stats), C = h =
//         act(C + b1) in T.
// else:   A = h, out = residual + gamma * (C + b2).
template <typename T, int ACT, bool PHASE1>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_phase(const __grid_constant__ CUtensorMap bmap,
             const T* __restrict__ A, const T* __restrict__ res,
             const float* __restrict__ lns, const float* __restrict__ lnb,
             const float* __restrict__ bias, const float* __restrict__ gamma,
             const float2* __restrict__ stats, T* __restrict__ C, int M, int K,
             int N, int nsub, int stages) {
  using O = Op<T>;
  extern __shared__ uint8_t smem[];
  uint8_t* lead;
  Ring ring = make_ring(smem, 0, stages, nsub * O::kPlanes * kBoxBytes, &lead);
  const int mtiles = (M + kRows - 1) / kRows;
  const int ntiles = N / (64 * nsub);
  const int tiles = mtiles * ntiles;
  const int slabs = K / O::kK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // phase 1 walks the row tiles of one weight slab together (the slab stays
  // in L2); phase 2 the column tiles of one row tile (its rows of h do)
  auto tile_mn = [&](int tile, int& m, int& n) {
    if (PHASE1) {
      m = tile % mtiles;
      n = tile / mtiles;
    } else {
      m = tile / ntiles;
      n = tile % ntiles;
    }
  };

  if (warp >= kConsumers / 32) {  // ---- producer: one thread issues TMA
    regs_producer();
    if (warp == kConsumers / 32 && lane == 0) {
      const uint32_t bytes = nsub * O::kPlanes * kBoxBytes;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m, n;
        tile_mn(tile, m, n);
        for (int s = 0; s < slabs; ++s) {
          uint8_t* dst = ring.produce(bytes);
          for (int p = 0; p < O::kPlanes; ++p)
            for (int j = 0; j < nsub; ++j)
              tma_load(dst + (p * nsub + j) * kBoxBytes, &bmap, s * O::kK,
                       p * N + (n * nsub + j) * 64, &ring.full[ring.slot]);
          ring.next();
        }
      }
    }
    return;
  }

  regs_consumer();
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  constexpr int kV = 32 / sizeof(T);  // A values a row a slab: 32 bytes
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m, n;
    tile_mn(tile, m, n);
    const int r0 = m * kRows + wg * 64 + w * 16;  // the warp's first row
    const int rows[2] = {r0 + g, r0 + g + 8};
    float2 st[2] = {make_float2(0.f, 1.f), make_float2(0.f, 1.f)};
    if (PHASE1) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (rows[h] < M) st[h] = stats[rows[h]];
    }

    float acc[kMaxSub][32];
#pragma unroll
    for (int j = 0; j < kMaxSub; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

    // the thread's 32 bytes of each of its two rows in slab s, raw; the
    // next slab's are loaded while this slab's products run
    uint4 u[2][2];
    auto fetch = [&](int s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4* src = reinterpret_cast<const uint4*>(
            A + (size_t)rows[h] * K + s * O::kK + kV * t);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          u[h][q] = rows[h] < M ? __ldg(src + q) : make_uint4(0, 0, 0, 0);
      }
    };
    fetch(0);
    for (int s = 0; s < slabs; ++s) {
      const int c0 = s * O::kK + kV * t;  // the thread's first column
      float v[2][kV];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint32_t wds[4] = {u[h][q].x, u[h][q].y, u[h][q].z,
                                   u[h][q].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) v[h][4 * q + e] = __uint_as_float(wds[e]);
        }
      }
      if (PHASE1) {
#pragma unroll
        for (int i = 0; i < kV; i += 4) {
          const float4 sc = *reinterpret_cast<const float4*>(lns + c0 + i);
          const float4 sh = *reinterpret_cast<const float4*>(lnb + c0 + i);
          const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
          const float shv[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[h][i + e] = rows[h] < M
                                ? O::round((v[h][i + e] - st[h].x) * st[h].y *
                                               scv[e] +
                                           shv[e])
                                : 0.f;
        }
      }
      uint32_t a[4][O::kFrag];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // slot t <- column 8t + 2kk, slot t + 4 <- 8t + 2kk + 1
        O::frag(a[kk], v[0][2 * kk], v[1][2 * kk], v[0][2 * kk + 1],
                v[1][2 * kk + 1]);
      }
      const uint32_t b = ring.acquire();
      const uint32_t plane = nsub * kBoxBytes;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kMaxSub; ++j) {
        if (j < nsub) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            O::mma(acc[j], a[kk], b + j * kBoxBytes + 32 * kk, plane);
        }
      }
      wgmma_commit();
      if (s + 1 < slabs) fetch(s + 1);
      wgmma_wait0();
      hold(a);
      ring.release(lane);
    }

    // ---- epilogue
#pragma unroll
    for (int j = 0; j < kMaxSub; ++j) {
      if (j >= nsub) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = (n * nsub + j) * 64 + 8 * q + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(bias + col);
        float2 gg = make_float2(1.f, 1.f);
        if (!PHASE1 && gamma) gg = *reinterpret_cast<const float2*>(gamma + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (rows[h] >= M) continue;
          const float c0v = acc[j][4 * q + 2 * h] + bb.x;
          const float c1v = acc[j][4 * q + 2 * h + 1] + bb.y;
          const size_t at = (size_t)rows[h] * N + col;
          if (PHASE1) {
            O::store2(C + at, activate<ACT>(c0v), activate<ACT>(c1v));
          } else {
            const float2 rr = O::load2(res + at);
            O::store2(C + at, rr.x + gg.x * c0v, rr.y + gg.y * c1v);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- split

// Source K index of stored position p of an f32 weight row (modes of the
// split pass): 0 as it is; 1 the fused GEMM2's order (within groups of 8,
// position s < 4 holds 2s, s >= 4 holds 2(s - 4) + 1); 2 the two-phase
// order (within slabs of 32: position 8kk + s holds 8(s % 4) + 2kk + s / 4).
__device__ __forceinline__ int src_k(int p, int mode) {
  if (mode == 1) {
    const int s = p & 7;
    return (p & ~7) + (s < 4 ? 2 * s : 2 * (s - 4) + 1);
  }
  if (mode == 2) {
    const int q = p & 31, kk = q >> 3, s = q & 7;
    return (p & ~31) + 8 * (s & 3) + 2 * kk + (s >> 2);
  }
  return p;
}

// planes[n][p] from src (n, src_k(p)) at src[n * sn + k * sk], as big /
// small TF32 planes [2][N][K] (big = v rounded to TF32, small = v - big
// exactly, so big + small == v).
template <typename S>
__global__ void split_kernel(const S* __restrict__ src, long long sn,
                             long long sk, int N, int K, int mode,
                             float* __restrict__ planes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * K) return;
  const int n = (int)(i / K), p = (int)(i % K);
  const float v = Op<S>::load(src + n * sn + (long long)src_k(p, mode) * sk);
  const uint32_t big = tf32_bits(v);
  planes[i] = __uint_as_float(big);
  // the exact remainder: the tensor cores read its top 19 bits
  planes[(long long)N * K + i] = v - __uint_as_float(big);
}

// ================================================================ bf16

using bf16 = __nv_bfloat16;

constexpr int kCluster = 2;           // CTAs a cluster (weight multicast)
constexpr int kBf16MaxStages = 8;
constexpr int kSw = 128;              // bytes of a swizzled row (64 bf16)

// A wait that traps instead of hanging if a barrier is never completed
// (about 20 s of clock), so a fault surfaces as a launch error.
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// arrive on the barrier at `bar`'s offset in CTA `cta` of the cluster (the
// default .release.cta: a cluster-scope release on every stage serialised
// the products)
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// one TMA box into the same offset of every CTA in `mask`, each completing
// the barrier at `bar`'s offset in its own shared memory
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   int k0, int r0,
                                                   uint64_t* bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(r0),
      "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// a box shared by the cluster's CTAs: multicast, or a plain load alone
__device__ __forceinline__ void tma_load_shared(void* dst,
                                                const CUtensorMap* map, int k0,
                                                int r0, uint64_t* bar) {
  if (kCluster == 1)
    tma_load(dst, map, k0, r0, bar);
  else
    tma_load_multicast(dst, map, k0, r0, bar,
                       static_cast<uint16_t>((1u << kCluster) - 1));
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of in-flight wgmma
// registers across the issue or the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// eight accumulator operands d[i .. i + 7]
#define SAI_F8(d, i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),                \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x N] (+)= A[64 x 16] * B[16 x N], both read from shared memory by
// descriptor (K-major); scale_d = 0 overwrites d

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SAI_F8(d, 0), SAI_F8(d, 8)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SAI_F8(d, 0), SAI_F8(d, 8), SAI_F8(d, 16), SAI_F8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SAI_F8(d, 0), SAI_F8(d, 8), SAI_F8(d, 16), SAI_F8(d, 24),
        SAI_F8(d, 32), SAI_F8(d, 40), SAI_F8(d, 48), SAI_F8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115,"
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126,"
      "%127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : SAI_F8(d, 0), SAI_F8(d, 8), SAI_F8(d, 16), SAI_F8(d, 24),
        SAI_F8(d, 32), SAI_F8(d, 40), SAI_F8(d, 48), SAI_F8(d, 56),
        SAI_F8(d, 64), SAI_F8(d, 72), SAI_F8(d, 80), SAI_F8(d, 88),
        SAI_F8(d, 96), SAI_F8(d, 104), SAI_F8(d, 112), SAI_F8(d, 120)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x N] (+)= a[64 x 16] (registers, bf16 pairs) * B[16 x N] (shared
// memory by descriptor, K-major); scale_d = 0 overwrites d

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SAI_F8(d, 0), SAI_F8(d, 8), SAI_F8(d, 16), SAI_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : SAI_F8(d, 0), SAI_F8(d, 8), SAI_F8(d, 16), SAI_F8(d, 24),
        SAI_F8(d, 32), SAI_F8(d, 40), SAI_F8(d, 48), SAI_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t* a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      "%93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : SAI_F8(d, 0), SAI_F8(d, 8), SAI_F8(d, 16), SAI_F8(d, 24),
        SAI_F8(d, 32), SAI_F8(d, 40), SAI_F8(d, 48), SAI_F8(d, 56),
        SAI_F8(d, 64), SAI_F8(d, 72), SAI_F8(d, 80), SAI_F8(d, 88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115,"
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126,"
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : SAI_F8(d, 0), SAI_F8(d, 8), SAI_F8(d, 16), SAI_F8(d, 24),
        SAI_F8(d, 32), SAI_F8(d, 40), SAI_F8(d, 48), SAI_F8(d, 56),
        SAI_F8(d, 64), SAI_F8(d, 72), SAI_F8(d, 80), SAI_F8(d, 88),
        SAI_F8(d, 96), SAI_F8(d, 104), SAI_F8(d, 112), SAI_F8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The stage cursor of a ring (a stage's barriers: `full` completes when all
// its TMA bytes have landed, `empty` when the consumer warps of every CTA of
// the cluster have released it).
struct Cursor {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ int take(int stages) {
    const int s = slot;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
    return s;
  }
};

struct Bf16Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int stage_bytes;
  __device__ __forceinline__ uint8_t* stage(int s) const {
    return base + (size_t)s * stage_bytes;
  }
  // consumer: the next stage's index once its bytes have landed
  __device__ __forceinline__ int acquire(Cursor& c) const {
    const uint32_t ph = c.phase;
    const int s = c.take(stages);
    mbar_wait_bounded(&full[s], ph);
    return s;
  }
  // consumer warp: done with stage s, in every CTA of the cluster
  __device__ __forceinline__ void release(int s, int lane) const {
    if (lane == 0)
#pragma unroll
      for (uint32_t cta = 0; cta < kCluster; ++cta)
        mbar_arrive_cta(&empty[s], cta);
  }
  // producer: the next stage once free, expecting `bytes` from the cluster
  __device__ __forceinline__ int produce(Cursor& c, uint32_t bytes) const {
    const uint32_t ph = c.phase;
    const int s = c.take(stages);
    mbar_wait_bounded(&empty[s], ph ^ 1);
    mbar_expect_tx(&full[s], bytes);
    return s;
  }
};

// Carve the dynamic shared memory (1024-aligned): `lead` bytes, the ring,
// its barriers. Thread 0 initialises them; every thread of the cluster
// syncs before any CTA may multicast into another.
__device__ Bf16Ring make_bf16_ring(uint8_t* smem, size_t lead, int stages,
                                   int stage_bytes, uint8_t** lead_ptr) {
  uint8_t* p = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  *lead_ptr = p;
  Bf16Ring r;
  r.base = p + lead;
  r.full = reinterpret_cast<uint64_t*>(r.base + (size_t)stages * stage_bytes);
  r.empty = r.full + stages;
  r.stages = stages;
  r.stage_bytes = stage_bytes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&r.full[i], 1);
      mbar_init(&r.empty[i], (kConsumers / 32) * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  return r;
}

size_t bf16_smem(size_t lead, int stages, int stage_bytes) {
  return 1024 + lead + (size_t)stages * stage_bytes + 16 * stages;
}

int bf16_stages(size_t lead, int stage_bytes) {
  int s = kBf16MaxStages;
  while (s > 2 && bf16_smem(lead, s, stage_bytes) > (size_t)kSmemMax) --s;
  return s;
}

// byte offset of element (row, col) in a K-major bf16 tile of 64-column
// blocks, each [rows][128 B] with the 128-byte swizzle TMA writes (16-byte
// chunk j of row r at chunk j ^ (r % 8)); mirrored by swizzle_offset in
// models/ln_mlp.py
__device__ __forceinline__ uint32_t sw128_offset(int row, int col, int rows) {
  const int block = col / 64, c = col % 64;
  return block * rows * kSw + row * kSw + (((c / 8) ^ (row % 8)) * 16) +
         (c % 8) * 2;
}

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// The activations of the bf16 kernels, whose results are rounded to bf16
// (8 bits): quick_gelu h / (1 + e^(-1.702 h)), and the exact gelu as
// 0.5 h erfc(-h / sqrt 2) with erfc from Numerical Recipes' erfcc (Chebyshev
// fit, fractional error below 1.2e-7), each on the hardware's exp2 and
// reciprocal: a fraction of the instructions of erff, which bounded route 1.
template <int ACT>
__device__ __forceinline__ float activate_bf16(float h) {
  constexpr float kLog2e = 1.4426950408889634f;
  if (ACT == 0)
    return h *
           rcp_approx(1.f + ex2_approx(fminf(-1.702f * kLog2e * h, 126.f)));
  const float z = fabsf(h) * 0.7071067811865476f;
  const float t = rcp_approx(fmaf(0.5f, z, 1.f));
  float p = fmaf(t, 0.17087277f, -0.82215223f);
  p = fmaf(t, p, 1.48851587f);
  p = fmaf(t, p, -1.13520398f);
  p = fmaf(t, p, 0.27886807f);
  p = fmaf(t, p, -0.18628806f);
  p = fmaf(t, p, 0.09678418f);
  p = fmaf(t, p, 0.37409196f);
  p = fmaf(t, p, 1.00002368f);
  p = fmaf(t, p, -1.26551223f);
  const float e = 0.5f * t * ex2_approx(fmaf(-z, z, p) * kLog2e);
  return h >= 0.f ? fmaf(-h, e, h) : h * e;  // e = erfc(|h| / sqrt 2) / 2
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// out[r][c] = residual + gamma * (acc + bias) for a warpgroup's [64, 8 J]
// accumulator (acc[4j + e] is row r0 + 8 (e / 2), column c0 + 8j + 2t +
// e % 2; the warp's rows r0 and r0 + 8), N columns a row. The residual
// loads go out eight column groups at a time.
template <int J>
__device__ __forceinline__ void residual_epilogue(
    const float* acc, const bf16* __restrict__ res,
    const float* __restrict__ bias, const float* __restrict__ gamma,
    bf16* __restrict__ out, int r0, int c0, int N, int M, int t) {
#pragma unroll
  for (int j0 = 0; j0 < J; j0 += 8) {
    float2 rr[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = r0 + 8 * half;
        rr[jj][half] = j0 + jj < J && gm < M
                           ? load_bf16x2(res + (size_t)gm * N + c0 +
                                         8 * (j0 + jj) + 2 * t)
                           : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j0 + jj;
      if (j >= J) continue;
      const int col = c0 + 8 * j + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(bias + col);
      const float2 gg = gamma ? *reinterpret_cast<const float2*>(gamma + col)
                              : make_float2(1.f, 1.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = r0 + 8 * half;
        if (gm >= M) continue;
        store_bf16x2(out + (size_t)gm * N + col,
                     rr[jj][half].x + gg.x * (acc[4 * j + 2 * half] + bb.x),
                     rr[jj][half].y +
                         gg.y * (acc[4 * j + 2 * half + 1] + bb.y));
      }
    }
  }
}

// ---------------------------------------------------------------- route 1

// The fused bf16 kernel, D <= 256 (a template parameter: GEMM2's product is
// one m64nDk16 a k-step). A CTA owns 128 rows, consumer warpgroup wg rows
// [64 wg, 64 wg + 64). A stage is 128 D bytes: W1 chunk c (D / 64 boxes of
// [64 hidden rows][64 K], the GEMM1 B operand) or W2 chunk c ([D rows][64
// hidden], GEMM2's B). Stages go in the order the consumers take them:
// W1(0), then for each chunk c: W1(c + 1), W2(c). In a cluster of n CTAs
// every CTA computes its own row tile and issues 1/n of the rows of every
// box, multicast to all.
template <int ACT, int D>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_fused_bf16(const __grid_constant__ CUtensorMap w1map,
                  const __grid_constant__ CUtensorMap w2map,
                  const bf16* __restrict__ x, const bf16* __restrict__ res,
                  const float* __restrict__ lns,
                  const float* __restrict__ lnb,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  const float* __restrict__ gamma, bf16* __restrict__ out,
                  int M, int H, float eps, int stages) {
  constexpr int kStage = 128 * D;
  constexpr int kTile = kRows * kSw;  // one 64-column block of the LN tile
  extern __shared__ uint8_t smem[];
  uint8_t* lnt;
  const Bf16Ring ring = make_bf16_ring(smem, (size_t)(D / 64) * kTile,
                                       stages, kStage, &lnt);
  const int rank = cluster_rank();
  const int tiles = (M + kRows - 1) / kRows;
  const int steps = (tiles + kCluster - 1) / kCluster;  // a cluster's steps
  const int cid = blockIdx.x / kCluster, nclusters = gridDim.x / kCluster;
  const int chunks = H / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= kConsumers / 32) {  // ---- producer: one thread issues TMA
    regs_producer();
    if (warp == kConsumers / 32 && lane == 0) {
      Cursor cur;
      constexpr int w1rows = 64 / kCluster, w2rows = D / kCluster;
      auto put_w1 = [&](int c) {
        const int s = ring.produce(cur, kStage);
        for (int kb = 0; kb < D / 64; ++kb)
          tma_load_shared(ring.stage(s) + kb * 64 * kSw + rank * w1rows * kSw,
                          &w1map, kb * 64, c * 64 + rank * w1rows,
                          &ring.full[s]);
      };
      auto put_w2 = [&](int c) {
        const int s = ring.produce(cur, kStage);
        tma_load_shared(ring.stage(s) + rank * w2rows * kSw, &w2map, c * 64,
                        rank * w2rows, &ring.full[s]);
      };
      for (int q = cid; q < steps; q += nclusters) {
        put_w1(0);
        for (int c = 0; c < chunks; ++c) {
          if (c + 1 < chunks) put_w1(c + 1);
          put_w2(c);
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: warp w of warpgroup wg owns rows 16 w .. 16 w + 15 of
    // the warpgroup's 64 (the wgmma fragment rows g and g + 8)
    regs_consumer();
    const int wg = warp / 4, w = warp % 4;
    const int g = lane / 4, t = lane % 4;
    const int lrow = wg * 64 + w * 16;  // the warp's first row in the tile
    const uint32_t a_base = smem_u32(lnt) + wg * 64 * kSw;
    Cursor rd;
    for (int q = cid; q < steps; q += nclusters) {
      const int row0 = (q * kCluster + rank) * kRows;  // past M: zero rows
      // LN of the warpgroup's 64 rows, rounded to bf16, into the swizzled
      // tile: two threads a row (the pair's lanes 2r, 2r + 1 of the warp's
      // 16 rows), each reading and writing its half in 16-byte pieces
      {
        const int row = lrow + lane / 2, half = lane % 2;
        const int gm = row0 + row;
        constexpr int kPieces = D / 16;  // 8 values each, a half row
        uint4 xv[kPieces];
#pragma unroll
        for (int i = 0; i < kPieces; ++i)
          xv[i] = gm < M ? *reinterpret_cast<const uint4*>(
                               x + (size_t)gm * D + (D / 2) * half + 8 * i)
                         : make_uint4(0, 0, 0, 0);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          const uint32_t wds[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&wds[e]));
            part[e] += f.x + f.y;
          }
        }
        float sum = (part[0] + part[1]) + (part[2] + part[3]);
        const float mu = (sum + __shfl_xor_sync(0xffffffffu, sum, 1)) / D;
        float qp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          const uint32_t wds[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&wds[e]));
            qp[e] += (f.x - mu) * (f.x - mu) + (f.y - mu) * (f.y - mu);
          }
        }
        float q = (qp[0] + qp[1]) + (qp[2] + qp[3]);
        const float rs =
            rsqrtf((q + __shfl_xor_sync(0xffffffffu, q, 1)) / D + eps);
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          const int col = (D / 2) * half + 8 * i;
          const uint32_t wds[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
          uint32_t o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&wds[e]));
            const float2 sc =
                *reinterpret_cast<const float2*>(lns + col + 2 * e);
            const float2 sh =
                *reinterpret_cast<const float2*>(lnb + col + 2 * e);
            const __nv_bfloat162 y = __floats2bfloat162_rn(
                (f.x - mu) * rs * sc.x + sh.x, (f.y - mu) * rs * sc.y + sh.y);
            o[e] = *reinterpret_cast<const uint32_t*>(&y);
          }
          *reinterpret_cast<uint4*>(lnt + sw128_offset(row, col, kRows)) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
      fence_async_smem();
      bar_sync(1 + wg, 128);  // the warpgroup's 64 rows are written

      float acc[D / 2];  // [64, D] output of the warpgroup
      float hacc[32];    // GEMM1's [64, 64] hidden chunk
      uint32_t hpk0[16], hpk1[16];  // act(h) as GEMM2's bf16 A, two buffers

      // GEMM1: hacc = LN(x) W1[:, 64c : 64c + 64] (stage s)
      auto gemm1 = [&](int s) {
        const uint32_t b = smem_u32(ring.stage(s));
#pragma unroll
        for (int kb = 0; kb < D / 64; ++kb)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<64>(hacc, desc_sw128(a_base + kb * kTile + kk * 32),
                         desc_sw128(b + kb * 64 * kSw + kk * 32),
                         (kb | kk) != 0);
      };
      // bias, activation, bf16: hacc[4j + e] is row g + 8 (e / 2), hidden
      // column 8j + 2t + e % 2 of the chunk; k16 step kk of GEMM2 takes n8
      // tiles 2kk and 2kk + 1 (the accumulator and A layouts agree)
      auto activate_chunk = [&](int c, uint32_t(&hp)[16]) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
            const float2 bb = *reinterpret_cast<const float2*>(
                b1 + c * 64 + 8 * j + 2 * t);
            const __nv_bfloat162 lo = __floats2bfloat162_rn(
                activate_bf16<ACT>(hacc[4 * j] + bb.x),
                activate_bf16<ACT>(hacc[4 * j + 1] + bb.y));
            const __nv_bfloat162 hi = __floats2bfloat162_rn(
                activate_bf16<ACT>(hacc[4 * j + 2] + bb.x),
                activate_bf16<ACT>(hacc[4 * j + 3] + bb.y));
            hp[4 * kk + 2 * jj] = *reinterpret_cast<const uint32_t*>(&lo);
            hp[4 * kk + 2 * jj + 1] = *reinterpret_cast<const uint32_t*>(&hi);
          }
      };
      // GEMM2: acc += act(h) W2[64c : 64c + 64, :] (stage s)
      auto gemm2 = [&](int s, const uint32_t(&hp)[16], bool first) {
        const uint32_t b = smem_u32(ring.stage(s));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<D>(acc, hp + 4 * kk, desc_sw128(b + kk * 32),
                      !(first && kk == 0));
      };

      // prologue: chunk 0's hidden
      int s1 = ring.acquire(rd);
      wgmma_fence();
      gemm1(s1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(hacc);
      ring.release(s1, lane);
      activate_chunk(0, hpk0);
      // chunk c: issue GEMM1(c + 1) and GEMM2(c); once GEMM1(c + 1) is done
      // (and with it GEMM2(c - 1)), release their stages and compute chunk
      // c + 1's activation into the other buffer while GEMM2(c) runs
      int pend = -1;  // the stage of the GEMM2 in flight
      auto step = [&](int c, uint32_t(&cur)[16], uint32_t(&nxt)[16]) {
        const bool next = c + 1 < chunks;
        int s_next = -1;
        fence_regs(hacc);
        fence_regs(cur);
        wgmma_fence();
        if (next) {
          s_next = ring.acquire(rd);
          gemm1(s_next);
          wgmma_commit();
        }
        const int s2 = ring.acquire(rd);
        gemm2(s2, cur, c == 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(hacc);
        fence_regs(nxt);
        if (pend >= 0) ring.release(pend, lane);
        pend = s2;
        if (next) {
          ring.release(s_next, lane);
          activate_chunk(c + 1, nxt);
        }
      };
      for (int c = 0; c < chunks; c += 2) {
        step(c, hpk0, hpk1);
        if (c + 1 < chunks) step(c + 1, hpk1, hpk0);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hpk0);
      fence_regs(hpk1);
      ring.release(pend, lane);

      // ---- epilogue: residual + gamma * (acc + b2)
      residual_epilogue<D / 8>(acc, res, b2, gamma, out, row0 + lrow + g, 0,
                               D, M, t);
      // the next tile's LN overwrites the warpgroup's rows of the tile:
      // every warp of it is past this tile's GEMM1 reads (wait_group 0)
      bar_sync(1 + wg, 128);
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still signal it
}

// ---------------------------------------------------------------- route 2

// LN(x) rounded to bf16 [M, D] (route 2's A of phase 1), one warp a row:
// lane l holds the 8-column groups 8 (l + 32 i), D <= 1536
__global__ void __launch_bounds__(256)
ln_mlp_norm_bf16(const bf16* __restrict__ x, const float* __restrict__ lns,
                 const float* __restrict__ lnb, int M, int D, float eps,
                 bf16* __restrict__ y) {
  constexpr int kGroups = 6;  // 1536 / 256
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * D;
  float v[kGroups][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int d = 8 * (lane + 32 * i);
    uint4 u = make_uint4(0, 0, 0, 0);
    if (d < D) u = *reinterpret_cast<const uint4*>(xr + d);
    const uint32_t wds[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&wds[e]));
      v[i][2 * e] = f.x;
      v[i][2 * e + 1] = f.y;
      s += f.x + f.y;
    }
  }
  const float mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i)
    if (8 * (lane + 32 * i) < D)
#pragma unroll
      for (int e = 0; e < 8; ++e) q += (v[i][e] - mu) * (v[i][e] - mu);
  const float rs = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int d = 8 * (lane + 32 * i);
    if (d >= D) continue;
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 sc = *reinterpret_cast<const float2*>(lns + d + 2 * e);
      const float2 sh = *reinterpret_cast<const float2*>(lnb + d + 2 * e);
      const __nv_bfloat162 p = __floats2bfloat162_rn(
          (v[i][2 * e] - mu) * rs * sc.x + sh.x,
          (v[i][2 * e + 1] - mu) * rs * sc.y + sh.y);
      o[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(y + (size_t)row * D + d) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// One phase of route 2: C [M, N] from A [M, K] (bf16, TMA) and B [N, K]
// (the weight plane, K-major). Tile BM x BN: `wide` = 0 BM = 128, BN = WN
// (warpgroup wg rows [64 wg, 64 wg + 64)); wide = 1 BM = 64, BN = 2 WN
// (warpgroup wg columns [WN wg, WN wg + WN)). A stage is the A box [BM][64]
// then the B box [BN][64]. A cluster of n CTAs takes n row tiles of one
// column tile at a time (the column tile fastest, so each row tile's A
// stays in L2 while its column tiles run), each CTA loading its own A and
// 1/n of B, multicast to all.
// EPI 0 (phase 1): C = h = act(acc + bias) in bf16.
// EPI 1 (phase 2): C = out = residual + gamma * (acc + bias).
template <int EPI, int ACT, int WN>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_gemm_bf16(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap,
                 const bf16* __restrict__ res, const float* __restrict__ bias,
                 const float* __restrict__ gamma, bf16* __restrict__ C, int M,
                 int K, int N, int wide, int stages) {
  const int BM = wide ? 64 : 128, BN = wide ? 2 * WN : WN;
  const int a_bytes = BM * kSw, b_bytes = BN * kSw;
  extern __shared__ uint8_t smem[];
  uint8_t* lead;
  const Bf16Ring ring =
      make_bf16_ring(smem, 0, stages, a_bytes + b_bytes, &lead);
  const int rank = cluster_rank();
  const int mtiles = (M + BM - 1) / BM, ntiles = N / BN;
  const int items = (mtiles + kCluster - 1) / kCluster * ntiles;
  const int cid = blockIdx.x / kCluster, nclusters = gridDim.x / kCluster;
  const int slabs = K / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= kConsumers / 32) {  // ---- producer: one thread issues TMA
    regs_producer();
    if (warp == kConsumers / 32 && lane == 0) {
      Cursor cur;
      const int brows = BN / kCluster;
      for (int q = cid; q < items; q += nclusters) {
        const int n = q % ntiles, m = (q / ntiles) * kCluster + rank;
        for (int s = 0; s < slabs; ++s) {
          const int st = ring.produce(cur, a_bytes + b_bytes);
          uint8_t* dst = ring.stage(st);
          tma_load(dst, &amap, s * 64, m * BM, &ring.full[st]);
          tma_load_shared(dst + a_bytes + rank * brows * kSw, &bmap, s * 64,
                          n * BN + rank * brows, &ring.full[st]);
        }
      }
    }
    __syncwarp();
  } else {
    regs_consumer();
    const int wg = warp / 4, w = warp % 4;
    const int g = lane / 4, t = lane % 4;
    const int row_off = wide ? 0 : 64 * wg, col_off = wide ? WN * wg : 0;
    Cursor rd;
    for (int q = cid; q < items; q += nclusters) {
      const int n = q % ntiles, m = (q / ntiles) * kCluster + rank;
      const int r0 = m * BM + row_off + w * 16 + g;  // the thread's first row
      float acc[WN / 2];
      int prev = -1;
      for (int s = 0; s < slabs; ++s) {
        const int st = ring.acquire(rd);
        const uint32_t a = smem_u32(ring.stage(st)) + row_off * kSw;
        const uint32_t b = smem_u32(ring.stage(st)) + a_bytes + col_off * kSw;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<WN>(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32),
                       (s | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // slab s - 1 done, slab s in flight
        if (prev >= 0) ring.release(prev, lane);
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      ring.release(prev, lane);

      // ---- epilogue: acc[4j + e] is row g + 8 (e / 2), column 8j + 2t +
      // e % 2 of the warpgroup's tile
      if (EPI == 1) {
        residual_epilogue<WN / 8>(acc, res, bias, gamma, C, r0,
                                  n * BN + col_off, N, M, t);
        continue;
      }
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = n * BN + col_off + 8 * j + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gm = r0 + 8 * half;
          if (gm < M)
            store_bf16x2(C + (size_t)gm * N + col,
                         activate_bf16<ACT>(acc[4 * j + 2 * half] + bb.x),
                         activate_bf16<ACT>(acc[4 * j + 2 * half + 1] + bb.y));
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still signal it
}

// ---------------------------------------------------------------- cast

// Both bf16 planes in one launch, in the callers' K order: p1[n][k] (n < H,
// k < D) from w1 (n, k) at w1[n * sn1 + k * sk1], p2[n][k] (n < D, k < H)
// from w2; four elements a thread (K is a multiple of 64).
template <typename S1, typename S2>
__global__ void ln_mlp_cast(const S1* __restrict__ w1, long long sn1,
                            long long sk1, const S2* __restrict__ w2,
                            long long sn2, long long sk2, int D, int H,
                            bf16* __restrict__ p1, bf16* __restrict__ p2) {
  const long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const long long n1 = (long long)H * D;
  if (i >= 2 * n1) return;
  float v[4];
  bf16* dst;
  if (i < n1) {
    const long long n = i / D, k = i % D;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = Op<S1>::load(w1 + n * sn1 + (k + e) * sk1);
    dst = p1 + i;
  } else {
    const long long j = i - n1, n = j / H, k = j % H;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = Op<S2>::load(w2 + n * sn2 + (k + e) * sk2);
    dst = p2 + j;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over f32 planes [rows][K] (rows = P * N) with 64-row boxes of 128
// bytes
bool plane_map(CUtensorMap* map, void* planes, int rows, int K) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)kBox};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, planes, dims, strides,
             box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem, int tiles, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  *grid = tiles < sm_count() ? tiles : sm_count();
  return err;
}

// the f32 routes (T = float)
template <typename T, int ACT>
int run(const void* x, const void* res, const float* lns, const float* lnb,
        void* planes1, const float* b1, void* planes2, const float* b2,
        const float* gamma, void* out, void* hidden, void* stats, int M,
        int D, int H, float eps, cudaStream_t stream) {
  using O = Op<T>;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  CUtensorMap m1, m2;
  if (!plane_map(&m1, planes1, O::kPlanes * H, D) ||
      !plane_map(&m2, planes2, O::kPlanes * D, H))
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  cudaError_t err;
  if (D <= 256) {
    const size_t lead = (size_t)kRows * (D + kLnPad) * sizeof(float);
    const int stage = O::kPlanes * kBoxBytes;
    const int S = stages_for(lead, stage);
    const size_t smem = smem_total(lead, S, stage);
    auto kernel = ln_mlp_fused<T, ACT>;
    err = prepare(kernel, smem, (M + kRows - 1) / kRows, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(m1, m2, xt, rt, lns, lnb, b1, b2,
                                             gamma, ot, M, D, H, eps, S);
    return static_cast<int>(cudaGetLastError());
  }
  T* ht = static_cast<T*>(hidden);
  float2* st = static_cast<float2*>(stats);
  const int mtiles = (M + kRows - 1) / kRows;
  auto nsub_for = [](int n) { return n % 256 == 0 ? 4 : n % 128 == 0 ? 2 : 1; };
  {
    const int nsub = nsub_for(H);
    const int stage = nsub * O::kPlanes * kBoxBytes;
    const int S = stages_for(0, stage);
    const size_t smem = smem_total(0, S, stage);
    auto kernel = ln_mlp_phase<T, ACT, true>;
    err = prepare(kernel, smem, mtiles * (H / (64 * nsub)), &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    ln_stats<T><<<(M + 7) / 8, 256, 0, stream>>>(xt, M, D, eps, st);
    kernel<<<grid, kThreads, smem, stream>>>(m1, xt, nullptr, lns, lnb, b1,
                                             nullptr, st, ht, M, D, H, nsub,
                                             S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nsub = nsub_for(D);
  const int stage = nsub * O::kPlanes * kBoxBytes;
  const int S = stages_for(0, stage);
  const size_t smem = smem_total(0, S, stage);
  auto kernel = ln_mlp_phase<T, 0, false>;
  err = prepare(kernel, smem, mtiles * (D / (64 * nsub)), &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(m2, ht, rt, nullptr, nullptr, b2,
                                           gamma, nullptr, ot, M, H, D, nsub,
                                           S);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 host

// A bf16 map over [rows][K] with boxes of [box_rows][64] (128 bytes a row,
// 128-byte swizzle); rows past `rows` read as zeros
bool bf16_map(CUtensorMap* map, const void* base, int rows, int K,
              int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch `kernel` on a persistent grid of clusters of kCluster CTAs, as many
// as can be resident at once (cudaOccupancyMaxActiveClusters, asked once per
// kernel) and no more than `items` (a cluster's units of work).
template <typename... P, typename... A>
cudaError_t launch_clusters(void (*kernel)(P...), int items, size_t smem,
                            cudaStream_t stream, A&&... args) {
  static std::mutex mu;
  static std::map<const void*, int> resident;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = resident.find(reinterpret_cast<const void*>(kernel));
    if (it == resident.end()) {
      cfg.gridDim = dim3(sm_count() / kCluster * kCluster);
      int n = 0;
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (n <= 0) return cudaErrorInvalidConfiguration;
      it = resident.emplace(reinterpret_cast<const void*>(kernel), n).first;
    }
    clusters = it->second;
  }
  if (items < clusters) clusters = items;
  cfg.gridDim = dim3(kCluster * clusters);
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
}

// Route 2's tile for C [M, N]:
// 128-row tiles, the warpgroups one above the other, WN the widest of
// 256 / 128 / 64 dividing N, where they give at least one tile an SM; else
// 64-row tiles with the warpgroups side by side (BN = 2 WN), WN = 64 where
// that gives at least half as many tiles as SMs, else 32.
struct Tile {
  int wide;
  int wn;
};
Tile tile_for(int M, int N, int sms) {
  const int wn = N % 256 == 0 ? 256 : N % 128 == 0 ? 128 : 64;
  if ((long long)((M + 127) / 128) * (N / wn) >= sms) return {0, wn};
  const long long mt = (M + 63) / 64;
  if (N % 128 == 0 && 2 * mt * (N / 128) >= sms) return {1, 64};
  return {1, 32};
}

template <int EPI, int ACT>
cudaError_t gemm_phase(const CUtensorMap& amap, const CUtensorMap& bmap,
                       Tile tile, const bf16* res, const float* bias,
                       const float* gamma, bf16* C, int M, int K, int N,
                       cudaStream_t stream) {
  const int BM = tile.wide ? 64 : 128;
  const int BN = tile.wide ? 2 * tile.wn : tile.wn;
  const int stage = (BM + BN) * kSw;
  const int S = bf16_stages(0, stage);
  const size_t smem = bf16_smem(0, S, stage);
  const int items = ((M + BM - 1) / BM + kCluster - 1) / kCluster * (N / BN);
  switch (tile.wn) {
    case 256:
      return launch_clusters(ln_mlp_gemm_bf16<EPI, ACT, 256>, items, smem,
                             stream, amap, bmap, res, bias, gamma, C, M, K, N,
                             tile.wide, S);
    case 128:
      return launch_clusters(ln_mlp_gemm_bf16<EPI, ACT, 128>, items, smem,
                             stream, amap, bmap, res, bias, gamma, C, M, K, N,
                             tile.wide, S);
    case 64:
      return launch_clusters(ln_mlp_gemm_bf16<EPI, ACT, 64>, items, smem,
                             stream, amap, bmap, res, bias, gamma, C, M, K, N,
                             tile.wide, S);
    default:
      return launch_clusters(ln_mlp_gemm_bf16<EPI, ACT, 32>, items, smem,
                             stream, amap, bmap, res, bias, gamma, C, M, K, N,
                             tile.wide, S);
  }
}

template <int ACT, int D>
cudaError_t fused_bf16(const CUtensorMap& m1, const CUtensorMap& m2,
                       const bf16* x, const bf16* res, const float* lns,
                       const float* lnb, const float* b1, const float* b2,
                       const float* gamma, bf16* out, int M, int H, float eps,
                       cudaStream_t stream) {
  const size_t lead = (size_t)(D / 64) * kRows * kSw;
  const int S = bf16_stages(lead, 128 * D);
  const size_t smem = bf16_smem(lead, S, 128 * D);
  const int items = ((M + kRows - 1) / kRows + kCluster - 1) / kCluster;
  return launch_clusters(ln_mlp_fused_bf16<ACT, D>, items, smem, stream, m1,
                         m2, x, res, lns, lnb, b1, b2, gamma, out, M, H, eps,
                         S);
}

template <int ACT>
int run_bf16(const void* x, const void* res, const float* lns,
             const float* lnb, const void* planes1, const float* b1,
             const void* planes2, const float* b2, const float* gamma,
             void* out, void* hidden, void* lnx, int M, int D, int H,
             float eps, cudaStream_t stream) {
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* rt = static_cast<const bf16*>(res);
  bf16* ot = static_cast<bf16*>(out);
  CUtensorMap m1, m2;
  if (D <= 256) {
    if (!bf16_map(&m1, planes1, H, D, 64 / kCluster) ||
        !bf16_map(&m2, planes2, D, H, D / kCluster))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    switch (D) {
      case 64:
        err = fused_bf16<ACT, 64>(m1, m2, xt, rt, lns, lnb, b1, b2, gamma, ot,
                                  M, H, eps, stream);
        break;
      case 128:
        err = fused_bf16<ACT, 128>(m1, m2, xt, rt, lns, lnb, b1, b2, gamma,
                                   ot, M, H, eps, stream);
        break;
      case 192:
        err = fused_bf16<ACT, 192>(m1, m2, xt, rt, lns, lnb, b1, b2, gamma,
                                   ot, M, H, eps, stream);
        break;
      default:
        err = fused_bf16<ACT, 256>(m1, m2, xt, rt, lns, lnb, b1, b2, gamma,
                                   ot, M, H, eps, stream);
    }
    return static_cast<int>(err);
  }
  bf16* ht = static_cast<bf16*>(hidden);
  bf16* yt = static_cast<bf16*>(lnx);
  const int sms = sm_count();
  const Tile t1 = tile_for(M, H, sms), t2 = tile_for(M, D, sms);
  const int bn1 = t1.wide ? 2 * t1.wn : t1.wn;
  const int bn2 = t2.wide ? 2 * t2.wn : t2.wn;
  CUtensorMap a1, a2;
  if (!bf16_map(&a1, yt, M, D, t1.wide ? 64 : 128) ||
      !bf16_map(&m1, planes1, H, D, bn1 / kCluster) ||
      !bf16_map(&a2, ht, M, H, t2.wide ? 64 : 128) ||
      !bf16_map(&m2, planes2, D, H, bn2 / kCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  ln_mlp_norm_bf16<<<(M + 7) / 8, 256, 0, stream>>>(xt, lns, lnb, M, D, eps,
                                                     yt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gemm_phase<0, ACT>(a1, m1, t1, nullptr, b1, nullptr, ht, M, D, H,
                           stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gemm_phase<1, 0>(a2, m2, t2, rt, b2, gamma, ot, M,
                                           H, D, stream));
}

}  // namespace

// 1 = fused (D <= 256), 2 = two phases (D > 256), 0 = not supported: D a
// multiple of 64 up to 1536, H a multiple of 64. The wrapper asks before it
// splits the weights (the route decides the f32 planes' order).
extern "C" int sai_ln_mlp_route(int D, int H) {
  if (D <= 0 || D % 64 != 0 || D > 1536 || H <= 0 || H % 64 != 0) return 0;
  return D <= 256 ? 1 : 2;
}

// Route 2's bf16 tile for C [M, N] on a card of `sms` SMs, as
// 65536 * wide + WN (tile_for): for chip_smoke.py's L2 byte counts and the
// card tests' pin of the tile at the path shapes.
extern "C" int sai_ln_mlp_tile(int M, int N, int sms) {
  const Tile t = tile_for(M, N, sms);
  return 65536 * t.wide + t.wn;
}

// The f32 split pass: big / small TF32 planes [2][N][K] from a weight with
// element (n, k) at src[n * sn + k * sk] (src_bf16: bf16, else f32), N rows
// of K, K in the order of `mode` (src_k). Returns a cudaError_t.
extern "C" int sai_ln_mlp_split(const void* src, int src_bf16, long long sn,
                                long long sk, int N, int K, int mode,
                                void* planes, void* stream) {
  const long long n = (long long)N * K;
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(planes);
  if (src_bf16)
    split_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src), sn, sk, N, K, mode, p);
  else
    split_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(src), sn, sk, N, K, mode, p);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 planes of both weights in one launch, in the callers' K order:
// planes1 [H][D] from w1 (element (n, k) at w1[n * sn1 + k * sk1]) and
// planes2 [D][H] from w2; w*_bf16: the source is bf16, else f32. D and H
// multiples of 64. Returns a cudaError_t.
extern "C" int sai_ln_mlp_cast(const void* w1, int w1_bf16, long long sn1,
                               long long sk1, const void* w2, int w2_bf16,
                               long long sn2, long long sk2, int D, int H,
                               void* planes1, void* planes2, void* stream) {
  if (D <= 0 || D % 64 != 0 || H <= 0 || H % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = (long long)H * D / 2;  // 2 H D elements, 4 a thread
  const int threads = 256;
  const unsigned blocks = (unsigned)((quads + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* p1 = static_cast<bf16*>(planes1);
  bf16* p2 = static_cast<bf16*>(planes2);
  const float* f1 = static_cast<const float*>(w1);
  const float* f2 = static_cast<const float*>(w2);
  const bf16* h1 = static_cast<const bf16*>(w1);
  const bf16* h2 = static_cast<const bf16*>(w2);
  if (!w1_bf16 && !w2_bf16)
    ln_mlp_cast<<<blocks, threads, 0, s>>>(f1, sn1, sk1, f2, sn2, sk2, D, H,
                                           p1, p2);
  else if (!w1_bf16)
    ln_mlp_cast<<<blocks, threads, 0, s>>>(f1, sn1, sk1, h2, sn2, sk2, D, H,
                                           p1, p2);
  else if (!w2_bf16)
    ln_mlp_cast<<<blocks, threads, 0, s>>>(h1, sn1, sk1, f2, sn2, sk2, D, H,
                                           p1, p2);
  else
    ln_mlp_cast<<<blocks, threads, 0, s>>>(h1, sn1, sk1, h2, sn2, sk2, D, H,
                                           p1, p2);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 = f32, 1 = bf16 (x, residual, out, hidden); act 0 = quick_gelu,
// 1 = exact gelu. planes1 from W1 as [H, D] (N = H, K = D), planes2 from W2
// as [D, H]: f32 as the split pass made them for the route (route 1 W1
// mode 0 and W2 mode 1, route 2 both mode 2), bf16 from the cast pass. lns,
// lnb, b1, b2, gamma f32 (gamma may be NULL: ones). x, residual, out [M, D]
// contiguous. Route 2's scratch: hidden [M, H] (T) and lnx, each row's LN
// mean and 1/std [M, 2] (f32) or LN(x) [M, D] (bf16); NULL for route 1.
// Returns a cudaError_t (0 on success).
extern "C" int sai_ln_mlp(int dtype, int act, const void* x, const void* res,
                          const float* lns, const float* lnb, void* planes1,
                          const float* b1, void* planes2, const float* b2,
                          const float* gamma, void* out, void* hidden,
                          void* lnx, int M, int D, int H, float eps,
                          void* stream) {
  const int route = sai_ln_mlp_route(D, H);
  if (route == 0 || (route == 2 && (hidden == nullptr || lnx == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return act == 0 ? run<float, 0>(x, res, lns, lnb, planes1, b1, planes2, b2,
                                    gamma, out, hidden, lnx, M, D, H, eps, s)
                    : run<float, 1>(x, res, lns, lnb, planes1, b1, planes2, b2,
                                    gamma, out, hidden, lnx, M, D, H, eps, s);
  return act == 0 ? run_bf16<0>(x, res, lns, lnb, planes1, b1, planes2, b2,
                                gamma, out, hidden, lnx, M, D, H, eps, s)
                  : run_bf16<1>(x, res, lns, lnb, planes1, b1, planes2, b2,
                                gamma, out, hidden, lnx, M, D, H, eps, s);
}
