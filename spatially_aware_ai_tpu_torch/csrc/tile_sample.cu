// Nearest-pixel sampling of brick voxels inside an image tile, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel spatially_aware_ai_tpu/grid/pallas_tiledma.py
// (`tile_sample_nearest`, kernel `_tile_sample_kernel`). For each (brick b,
// frame f, voxel v) with pixel coordinates (u, v) and the brick's tile origin
// (y0, x0):
//
//   px = round_half_even(u), py = round_half_even(v)
//   in_tile = x0 <= px < x0 + TW  and  y0 <= py < y0 + TH  (and inside the image)
//   samples[b, f, c, v] = in_tile ? img[f, c, py, px] : 0
//
// Non-finite coordinates are out of every tile. The TPU kernel never read
// outside the image because its tile was clamped into it; here the pixel is
// tested against the image as well, so a bbox from elsewhere cannot make the
// kernel read out of bounds (with bboxes from brick_tile_bboxes the test
// changes nothing).
//
// What bounds it on this card: bytes. Per (b, f, v) it reads 8 bytes of uv and
// at most C pixels, and writes C samples and one flag; there is no
// arithmetic to speak of. At the probe's shape (392 bricks of 8^3, F=8, C=2,
// 768x1024) that is 32.9 MB counting each distinct in-tile pixel once,
// 0.0098 ms at 3.35 TB/s.
//
// Design: the TPU DMA'd each brick's tile into VMEM and gathered through
// one-hot matmuls on the MXU, because its vector unit has no gather. A
// 256x256x2 f32 tile is 512 KB, more than an SM's shared memory, and Hopper
// has a real gather, so the kernel reads the pixels directly. The image is
// 50.3 MB at the probe's shape, about the size of the 50 MB L2; what stays
// there between the voxels that share a pixel is the part the tiles touch,
// about 5.5 MB (693,474 distinct in-tile pixels x 2 channels; more in
// 32-byte sectors).
// One CTA per (brick, frame) row, b from blockIdx.x and f from blockIdx.y,
// so no thread divides; the row's tile origin is one uniform load per warp.
// Each thread takes 4 consecutive voxels: x and y as one float4 each when
// the rows are 16-byte aligned (V % 4 == 0), else element by element. All
// of its 4 * C pixel reads are issued before any store, so the gathers are
// in flight together; samples go out as one float4 per channel and in_tile
// as one uchar4.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
// |round(u)| above this is out of every tile (and keeps the int cast defined)
constexpr float kMaxCoord = 1073741824.f;  // 2^30

// The voxel's pixel index in its channel plane, or -1 when its nearest
// pixel is out of the tile or the image.
__device__ __forceinline__ int pixel_index(float u, float v, int y0, int x0,
                                           int TH, int TW, int H, int W) {
  const float rx = rintf(u);  // half to even
  const float ry = rintf(v);
  if (!(fabsf(rx) <= kMaxCoord && fabsf(ry) <= kMaxCoord)) return -1;  // NaN
  const int px = (int)rx, py = (int)ry;
  const bool inb = px >= x0 && px < x0 + TW && py >= y0 && py < y0 + TH &&
                   px >= 0 && px < W && py >= 0 && py < H;
  return inb ? py * W + px : -1;
}

// kVox consecutive voxels per thread, CG channels per group of loads; VEC:
// the rows are 16-byte aligned
constexpr int kVox = 4;

template <int CG, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
tile_sample_kernel(const float* __restrict__ img,
                   const float* __restrict__ uv,
                   const int* __restrict__ bbox,
                   float* __restrict__ samples,
                   uint8_t* __restrict__ in_tile, int F, int C, int H, int W,
                   int V, int TH, int TW) {
  const size_t row = (size_t)blockIdx.x * F + blockIdx.y;  // b * F + f
  const int y0 = __ldg(bbox + 2 * row);
  const int x0 = __ldg(bbox + 2 * row + 1);
  const float* ux = uv + row * 2 * V;
  const float* uy = ux + V;
  const size_t plane = (size_t)H * W;
  const float* fimg = img + (size_t)blockIdx.y * C * plane;
  float* out = samples + row * C * V;
  uint8_t* flag = in_tile + row * V;

  for (int v0 = kVox * threadIdx.x; v0 < V; v0 += kVox * blockDim.x) {
    float x[kVox], y[kVox];
    if (VEC) {
#pragma unroll
      for (int q = 0; q < kVox; q += 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(ux + v0 + q));
        const float4 b = __ldg(reinterpret_cast<const float4*>(uy + v0 + q));
        x[q] = a.x; x[q + 1] = a.y; x[q + 2] = a.z; x[q + 3] = a.w;
        y[q] = b.x; y[q + 1] = b.y; y[q + 2] = b.z; y[q + 3] = b.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVox; ++k) {
        const bool in = v0 + k < V;
        x[k] = in ? __ldg(ux + v0 + k) : __int_as_float(0x7fc00000);  // NaN
        y[k] = in ? __ldg(uy + v0 + k) : 0.f;
      }
    }
    int idx[kVox];
#pragma unroll
    for (int k = 0; k < kVox; ++k)
      idx[k] = pixel_index(x[k], y[k], y0, x0, TH, TW, H, W);

    for (int c0 = 0; c0 < C; c0 += CG) {
      float s[CG][kVox];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float* src = fimg + (size_t)(c0 + g) * plane;
#pragma unroll
        for (int k = 0; k < kVox; ++k)
          s[g][k] = (c0 + g < C && idx[k] >= 0) ? __ldg(src + idx[k]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        if (c0 + g >= C) break;
        float* dst = out + (size_t)(c0 + g) * V + v0;
        if (VEC) {
#pragma unroll
          for (int q = 0; q < kVox; q += 4)
            *reinterpret_cast<float4*>(dst + q) = make_float4(
                s[g][q], s[g][q + 1], s[g][q + 2], s[g][q + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < kVox; ++k)
            if (v0 + k < V) dst[k] = s[g][k];
        }
      }
    }
    if (VEC) {
#pragma unroll
      for (int q = 0; q < kVox; q += 4)
        *reinterpret_cast<uchar4*>(flag + v0 + q) =
            make_uchar4(idx[q] >= 0, idx[q + 1] >= 0, idx[q + 2] >= 0,
                        idx[q + 3] >= 0);
    } else {
#pragma unroll
      for (int k = 0; k < kVox; ++k)
        if (v0 + k < V) flag[v0 + k] = idx[k] >= 0;
    }
  }
}

template <int CG>
void launch(bool vec, dim3 grid, int threads, cudaStream_t stream,
            const float* img, const float* uv, const int* bbox,
            float* samples, uint8_t* in_tile, int F, int C, int H, int W,
            int V, int TH, int TW) {
  if (vec)
    tile_sample_kernel<CG, true><<<grid, threads, 0, stream>>>(
        img, uv, bbox, samples, in_tile, F, C, H, W, V, TH, TW);
  else
    tile_sample_kernel<CG, false><<<grid, threads, 0, stream>>>(
        img, uv, bbox, samples, in_tile, F, C, H, W, V, TH, TW);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// img [F, C, H, W] f32; uv [NB, F, 2, V] f32 pixel (x; y); bbox [NB, F, 2]
// int32 tile origins (y0, x0); samples [NB, F, C, V] f32 and in_tile
// [NB, F, V] bool are written. F <= 65535 and H * W < 2^31 (the wrapper
// checks both). Returns cudaGetLastError().
extern "C" int sai_tile_sample(const float* img, const float* uv,
                               const int* bbox, float* samples,
                               bool* in_tile, int NB, int F, int C, int H,
                               int W, int V, int TH, int TW, void* stream) {
  if (NB < 0 || F < 0 || F > 65535 || C < 0 || V < 0 ||
      (long long)H * W >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)NB * F * V > 0) {
    uint8_t* flags = reinterpret_cast<uint8_t*>(in_tile);
    const bool vec = V % kVox == 0 && aligned16(uv) && aligned16(samples) &&
                     aligned16(flags);
    const int groups = (V + kVox - 1) / kVox;
    int threads = (groups + 31) / 32 * 32;
    threads = threads < kMaxThreads ? threads : kMaxThreads;
    const dim3 grid(NB, F);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C == 1)
      launch<1>(vec, grid, threads, s, img, uv, bbox, samples, flags, F, C,
                H, W, V, TH, TW);
    else if (C == 2)
      launch<2>(vec, grid, threads, s, img, uv, bbox, samples, flags, F, C,
                H, W, V, TH, TW);
    else
      launch<4>(vec, grid, threads, s, img, uv, bbox, samples, flags, F, C,
                H, W, V, TH, TW);
  }
  return static_cast<int>(cudaGetLastError());
}
