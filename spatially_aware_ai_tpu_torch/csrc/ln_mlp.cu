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
// What bounds it on this card: operations. One call is 4 * M * D * H flops
// (H = 4D: 16 M D^2); f32 products run as 3xTF32 (v = big + small, the
// product as small*big + big*small + big*big, the dropped small*small term
// below 2^-22 of it), so the tensor-core floor is 3 * 4 M D H / 495 TFLOP/s.
// The earlier design (warp-level mma.sync, the whole [TM, D] output tile in
// registers) was held back by three things, and this one answers each:
//
// 1. The weight stream from L2. A block of TM = 16-64 rows read both weight
//    matrices, 32 D^2 M / TM bytes a launch. Here a CTA owns 128 rows (two
//    consumer warpgroups of 64) and a producer warpgroup (one thread
//    issues the copies; its registers go to the consumers) streams the weights
//    through a ring of shared-memory stages with TMA (cp.async.bulk.tensor,
//    128-byte swizzle) and mbarriers; both warpgroups read each stage.
// 2. mma.sync and re-split fragments. Products are wgmma.mma_async
//    (m64n64k8 tf32, m64n64k16 bf16) with the weights (B) read from shared
//    memory by descriptor and A from registers. The weights are split into
//    big / small TF32 planes once per call by sai_ln_mlp_split (bf16: one
//    plane), K-major, so no B fragment is split in the mainloop; each A
//    value is split once per use in registers.
// 3. A weight copy per call. The planes are written from the callers'
//    nn.Linear layout ([H, D] and [D, H], any strides), which is the K-major
//    layout wgmma takes for TF32; the split pass replaces the copy.
//
// Where the hidden lives (a warpgroup's [64, D] f32 accumulator costs D / 2
// registers a thread):
// - D <= 256, one fused kernel (route 1). A CTA normalises its 128 rows
//   once into shared memory, then walks the hidden in chunks of 64: GEMM1
//   gives h = act(LN(x) W1[:, chunk] + b1) in registers, and GEMM2 adds
//   h W2[chunk, :] into the [64, D] accumulator. h goes from the GEMM1
//   accumulator straight into GEMM2's A registers: for TF32 the split pass
//   permutes W2's K within each group of 8 to match the accumulator's
//   column order (position s holds hidden 2s for s < 4, 2(s-4)+1 after);
//   for bf16 the two layouts already agree. The hidden never reaches
//   device memory, as in the TPU kernel.
// - D > 256, two kernels sharing the mainloop (route 2): phase 1 writes
//   h = act(LN(x) W1 + b1) [M, H] in T; phase 2 computes residual +
//   gamma (h W2 + b2), both with 128-row x 256-column output tiles. Each
//   thread reads its A values as contiguous 16-byte vectors from device
//   memory: the split pass permutes K within each slab (32 f32 / 64 bf16)
//   so that a thread's fragment columns are contiguous; the next slab's
//   values load while this slab's products run. A pre-pass (ln_stats)
//   computes each row's mean and 1/std once, and phase 1 applies LN to its
//   A values in registers.
// The grid is persistent: one CTA an SM walks the output tiles. Rows past M
// compute on zeros and are not stored. The 2-CTA cluster multicast of
// weight tiles is not done here (each CTA reads its stages from L2).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// d[64 x 64] += a[64 x 16] (registers, bf16) * B[16 x 64] (shared, K-major)
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a,
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SAI_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SAI_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
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

// bf16: one product. A k-step fragment is 4 registers of bf16 pairs.
template <>
struct Op<__nv_bfloat16> {
  static constexpr int kK = 64;
  static constexpr int kStep = 16;
  static constexpr int kPlanes = 1;
  static constexpr int kFrag = 4;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint32_t b, uint32_t) {
    wgmma_bf16(d, a, desc_sw128(b));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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
          if constexpr (sizeof(T) == 4) {
            O::frag(a[kk], a0[k0 + t], a1[k0 + t], a0[k0 + t + 4],
                    a1[k0 + t + 4]);
          } else {
            a[kk][0] = pack_bf16(a0[k0 + 2 * t], a0[k0 + 2 * t + 1]);
            a[kk][1] = pack_bf16(a1[k0 + 2 * t], a1[k0 + 2 * t + 1]);
            a[kk][2] = pack_bf16(a0[k0 + 2 * t + 8], a0[k0 + 2 * t + 9]);
            a[kk][3] = pack_bf16(a1[k0 + 2 * t + 8], a1[k0 + 2 * t + 9]);
          }
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
          if constexpr (sizeof(T) == 4) {
            // k-step j = 4s + kk takes the accumulator's n8 tile j; slot t
            // holds hidden 8j + 2t, slot t + 4 hidden 8j + 2t + 1 (W2's
            // planes are permuted to match)
            const int j = 4 * s + kk;
            O::frag(a[kk], h[4 * j], h[4 * j + 2], h[4 * j + 1],
                    h[4 * j + 3]);
          } else {
            const int j = 2 * kk;  // k16 step kk: n8 tiles 2kk, 2kk + 1
            a[kk][0] = pack_bf16(h[4 * j], h[4 * j + 1]);
            a[kk][1] = pack_bf16(h[4 * j + 2], h[4 * j + 3]);
            a[kk][2] = pack_bf16(h[4 * j + 4], h[4 * j + 5]);
            a[kk][3] = pack_bf16(h[4 * j + 6], h[4 * j + 7]);
          }
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
// [slab + 8t, slab + 8t + 8) (f32) or [slab + 16t, slab + 16t + 16) (bf16).
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
          for (int e = 0; e < 4; ++e) {
            if constexpr (sizeof(T) == 4) {
              v[h][4 * q + e] = __uint_as_float(wds[e]);
            } else {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&wds[e]));
              v[h][8 * q + 2 * e] = f.x;
              v[h][8 * q + 2 * e + 1] = f.y;
            }
          }
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
        if constexpr (sizeof(T) == 4) {
          // slot t <- column 8t + 2kk, slot t + 4 <- 8t + 2kk + 1
          O::frag(a[kk], v[0][2 * kk], v[1][2 * kk], v[0][2 * kk + 1],
                  v[1][2 * kk + 1]);
        } else {
          // slots 2t, 2t + 1 <- 16t + 4kk + {0, 1}; 2t + 8, 2t + 9 <- + {2, 3}
          a[kk][0] = pack_bf16(v[0][4 * kk], v[0][4 * kk + 1]);
          a[kk][1] = pack_bf16(v[1][4 * kk], v[1][4 * kk + 1]);
          a[kk][2] = pack_bf16(v[0][4 * kk + 2], v[0][4 * kk + 3]);
          a[kk][3] = pack_bf16(v[1][4 * kk + 2], v[1][4 * kk + 3]);
        }
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

// Source K index of stored position p of a weight row (modes of the split
// pass): 0 as it is; 1 the fused GEMM2's order (f32: within groups of 8,
// position s < 4 holds 2s, s >= 4 holds 2(s - 4) + 1; bf16: as it is);
// 2 the two-phase order (within slabs of 32 f32: position 8kk + s holds
// 8(s % 4) + 2kk + s / 4; of 64 bf16: position 16kk + 8j + 2t + e holds
// 16t + 4kk + 2j + e).
__device__ __forceinline__ int src_k(int p, int mode, bool bf16) {
  if (mode == 1 && !bf16) {
    const int s = p & 7;
    return (p & ~7) + (s < 4 ? 2 * s : 2 * (s - 4) + 1);
  }
  if (mode == 2 && !bf16) {
    const int q = p & 31, kk = q >> 3, s = q & 7;
    return (p & ~31) + 8 * (s & 3) + 2 * kk + (s >> 2);
  }
  if (mode == 2 && bf16) {
    const int q = p & 63, kk = q >> 4, j = (q >> 3) & 1, t = (q >> 1) & 3,
              e = q & 1;
    return (p & ~63) + 16 * t + 4 * kk + 2 * j + e;
  }
  return p;
}

// planes[n][p] from src (n, src_k(p)) at src[n * sn + k * sk]: f32 out as
// big / small planes [2][N][K] (big = v rounded to TF32, small = v - big
// exactly, so big + small == v), bf16 out as one plane [N][K].
template <typename S, bool BF16_OUT>
__global__ void split_kernel(const S* __restrict__ src, long long sn,
                             long long sk, int N, int K, int mode,
                             void* __restrict__ planes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * K) return;
  const int n = (int)(i / K), p = (int)(i % K);
  const float v = Op<S>::load(src + n * sn + (long long)src_k(p, mode, BF16_OUT) * sk);
  if (BF16_OUT) {
    static_cast<__nv_bfloat16*>(planes)[i] = __float2bfloat16(v);
  } else {
    const uint32_t big = tf32_bits(v);
    float* f = static_cast<float*>(planes);
    f[i] = __uint_as_float(big);
    // the exact remainder: the tensor cores read its top 19 bits
    f[(long long)N * K + i] = v - __uint_as_float(big);
  }
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

// A map over planes [rows][K] (rows = P * N) with 64-row boxes of 128 bytes
bool plane_map(CUtensorMap* map, void* planes, bool bf16, int rows, int K) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const int esize = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)kBox};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map,
             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, planes, dims, strides, box, estr,
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

template <typename T, int ACT>
int run(const void* x, const void* res, const float* lns, const float* lnb,
        void* planes1, const float* b1, void* planes2, const float* b2,
        const float* gamma, void* out, void* hidden, void* stats, int M,
        int D, int H, float eps, cudaStream_t stream) {
  using O = Op<T>;
  const bool bf16 = sizeof(T) == 2;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  CUtensorMap m1, m2;
  if (!plane_map(&m1, planes1, bf16, O::kPlanes * H, D) ||
      !plane_map(&m2, planes2, bf16, O::kPlanes * D, H))
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

}  // namespace

// 1 = fused (D <= 256), 2 = two phases (D > 256), 0 = not supported: D a
// multiple of 64 up to 1536, H a multiple of 64. The wrapper asks before it
// splits the weights (the route decides their order).
extern "C" int sai_ln_mlp_route(int D, int H) {
  if (D <= 0 || D % 64 != 0 || D > 1536 || H <= 0 || H % 64 != 0) return 0;
  return D <= 256 ? 1 : 2;
}

// The split pass: planes from a weight with element (n, k) at
// src[n * sn + k * sk] (src_bf16: bf16, else f32), N rows of K; out_bf16:
// one bf16 plane [N][K], else big / small TF32 planes [2][N][K] (f32);
// mode as src_k. Returns a cudaError_t.
extern "C" int sai_ln_mlp_split(const void* src, int src_bf16, long long sn,
                                long long sk, int N, int K, int out_bf16,
                                int mode, void* planes, void* stream) {
  const long long n = (long long)N * K;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(src);
    if (out_bf16)
      split_kernel<__nv_bfloat16, true><<<blocks, threads, 0, s>>>(
          p, sn, sk, N, K, mode, planes);
    else
      split_kernel<__nv_bfloat16, false><<<blocks, threads, 0, s>>>(
          p, sn, sk, N, K, mode, planes);
  } else {
    const float* p = static_cast<const float*>(src);
    if (out_bf16)
      split_kernel<float, true><<<blocks, threads, 0, s>>>(p, sn, sk, N, K,
                                                           mode, planes);
    else
      split_kernel<float, false><<<blocks, threads, 0, s>>>(p, sn, sk, N, K,
                                                            mode, planes);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 = f32, 1 = bf16 (x, residual, out, hidden; planes as the split
// pass made them for this dtype and route: route 1 W1 mode 0 and W2 mode
// 1, route 2 both mode 2); act 0 = quick_gelu, 1 = exact gelu. planes1
// from W1 as [H, D] (N = H, K = D), planes2 from W2 as [D, H]. lns, lnb,
// b1, b2, gamma f32 (gamma may be NULL: ones). x, residual, out [M, D]
// contiguous; hidden [M, H] (T) and stats [M, 2] (f32) scratch for route 2
// (NULL for route 1).
// Returns a cudaError_t (0 on success).
extern "C" int sai_ln_mlp(int dtype, int act, const void* x, const void* res,
                          const float* lns, const float* lnb, void* planes1,
                          const float* b1, void* planes2, const float* b2,
                          const float* gamma, void* out, void* hidden,
                          void* stats, int M, int D, int H, float eps,
                          void* stream) {
  const int route = sai_ln_mlp_route(D, H);
  if (route == 0 || (route == 2 && (hidden == nullptr || stats == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return act == 0 ? run<float, 0>(x, res, lns, lnb, planes1, b1, planes2, b2,
                                    gamma, out, hidden, stats, M, D, H, eps, s)
                    : run<float, 1>(x, res, lns, lnb, planes1, b1, planes2, b2,
                                    gamma, out, hidden, stats, M, D, H, eps, s);
  return act == 0
             ? run<__nv_bfloat16, 0>(x, res, lns, lnb, planes1, b1, planes2,
                                     b2, gamma, out, hidden, stats, M, D, H, eps, s)
             : run<__nv_bfloat16, 1>(x, res, lns, lnb, planes1, b1, planes2,
                                     b2, gamma, out, hidden, stats, M, D, H, eps, s);
}
