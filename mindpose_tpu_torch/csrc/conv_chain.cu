// Chain of L x (3x3 SAME conv, stride 1, no bias, ReLU) on NHWC activations, for Hopper (sm_90a).
//
// Replaces the TPU kernel mindpose_tpu/ops/pallas/conv_chain.py:_chain_kernel
// (wrapper fused_conv_chain). The Pallas kernel kept a whole padded image
// and its ping-pong partner in VMEM and fed the MXU (9C x C) im2col blocks,
// so no intermediate left the chip. An H100 SM cannot hold that (one padded
// 66x50x32 bf16 image is 211,200 B, two are 422 KB, against 227 KB of shared
// memory per block), so each launch here owns spatial tiles and fuses a
// group of layers on chip with a recomputed halo. Two kernels, chosen by
// dtype alone, one for each:
//
// bfloat16: tensor cores, implicit GEMM (conv3x3_relu_tc_kernel).
//   Bound: compute. Depth 8, C=32 is 58.0 GFLOP at B128 64x48 and at B24
//   128x128 (0.0586 ms at 989 TFLOP/s dense bf16) and 231.9 GFLOP at B24
//   256x256 (0.2345 ms); one read and one write of the activations take a
//   quarter of that at 3.35 TB/s, a read and a write per layer twice it.
//   Design: persistent blocks of 256 threads, two per SM, each walking 16x16
//   tiles of output pixels of one image, all output channels, through a
//   group of g consecutive layers. A block stages the group's weights once,
//   as HWIO rows [tap * Cp + C_in][C_out] zero-padded to Cp, a multiple of
//   16 (cp.async). A tile's (16+2g)^2-pixel input patch comes by one TMA
//   load into one of two buffers while the block computes the tile before
//   it; TMA's out-of-bounds fill gives the zero halo of SAME padding and the
//   zero channels C..Cp-1. Each warp runs the GEMM M = pixels of the layer's
//   output region, N = Cp, K = 9 taps x Cp as mma.sync.m16n8k16 bf16 -> f32,
//   two 16-pixel row tiles per B fragment. The A fragments come from
//   ldmatrix with one pixel's channel vector per lane, shifted by the tap,
//   so the im2col costs nothing; B loads with ldmatrix.trans. Every buffer
//   is dense rows of Cp bf16 with TMA's 32/64/128 B swizzle, so the 8 rows
//   of an ldmatrix hit distinct banks. The epilogue applies ReLU (NaN kept),
//   rounds to bf16 once, and writes the next layer's input in shared memory:
//   layer j of the group computes a (16 + 2(g-1-j))^2 region and writes 0 at
//   every pixel outside the image, because SAME padding applies again at the
//   next layer. The tile leaves by one TMA store, which drops what lies
//   outside the tensor. Where TMA cannot take the tensor (C % 8 != 0, or a
//   base not 16 B aligned) the same kernel stages and stores element by
//   element. Every output pixel sums its taps and channels in the same order
//   whatever g is, so a fused group gives the bits of g one-layer launches.
//   Measured on an H100 (PERF.md), g = 1 is fastest at every probe geometry,
//   so the wrapper fuses nothing: HBM is not what binds the kernel, and a
//   fused group adds recomputed halo and uneven row tiles to the loop that is.
//   mma.sync, not wgmma: timed with the staging left out, the MMA loop is
//   bound by shared-memory reads (ldmatrix of A and B, 2 MMAs per 512 B
//   ldmatrix at N = C = 32), not by the tensor cores' issue rate; wgmma with
//   A from registers would read A through the same ldmatrix.
//   Still holding it back, at about a fifth of the bound: those
//   shared-memory reads (N = 32 is thin); the MMAs of one tile do not overlap
//   its epilogue, only the other block's work.
//
// float32: CUDA cores (conv3x3_relu_kernel), one launch per layer. The
//   tensor cores would run it in TF32, a different result, so float32 keeps
//   the simple kernel: one block of 256 threads per 16x16 output tile, input
//   with its zero halo and the weights staged as float32 in shared memory
//   (odd word stride, so a warp's reads hit distinct banks), each thread one
//   output pixel accumulating up to 32 output channels in float32 registers.
//   It is bound by the FMA and shared-memory issue rate, well below the
//   67 TFLOP/s float32 peak.
//
// Both sum each layer in float32 and round to the activation dtype once,
// after the ReLU, where the Pallas kernel rounds.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;  // the float32 kernel: one output pixel per thread
constexpr int kPatchW = kTileW + 2;
constexpr int kPatchPixels = (kTileH + 2) * kPatchW;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTcChannels = 64;

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// ReLU that keeps NaN, as jnp.maximum(x, 0) and torch.relu do.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// ---------------------------------------------------------------- float32, CUDA cores

// Shared memory of one block: float32 weights [9][C][C], then the input
// patch [kPatchPixels][stride] with an odd word stride.
__host__ __device__ __forceinline__ int patch_stride(int channels) { return channels | 1; }

size_t smem_bytes(int channels) {
  return sizeof(float) *
         (static_cast<size_t>(9) * channels * channels +
          static_cast<size_t>(kPatchPixels) * patch_stride(channels));
}

// G: output channels accumulated at once (a power of two dividing C, <= 32).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
conv3x3_relu_kernel(const T* __restrict__ in, const T* __restrict__ weight, T* __restrict__ out,
                    int height, int width, int channels, int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  const int c = channels;
  const int cs = patch_stride(c);
  float* s_w = smem;
  float* s_in = smem + 9 * c * c;

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int tx0 = (blockIdx.x % tiles_x) * kTileW;
  const T* img = in + static_cast<size_t>(b) * height * width * c;

  for (int i = threadIdx.x; i < 9 * c * c; i += kThreads) s_w[i] = to_float(weight[i]);
  // the patch in NHWC order, so consecutive threads read consecutive addresses
  for (int i = threadIdx.x; i < kPatchPixels * c; i += kThreads) {
    const int pix = i / c;
    const int ci = i - pix * c;
    const int iy = ty0 - 1 + pix / kPatchW;
    const int ix = tx0 - 1 + pix % kPatchW;
    float v = 0.0f;  // SAME zero padding
    if (iy >= 0 && iy < height && ix >= 0 && ix < width) {
      v = to_float(img[(static_cast<size_t>(iy) * width + ix) * c + ci]);
    }
    s_in[pix * cs + ci] = v;
  }
  __syncthreads();

  const int py = threadIdx.x / kTileW;
  const int px = threadIdx.x % kTileW;
  const int oy = ty0 + py;
  const int ox = tx0 + px;
  if (oy >= height || ox >= width) return;  // the ragged edge, after the only barrier
  T* dst = out + ((static_cast<size_t>(b) * height + oy) * width + ox) * c;

  for (int co0 = 0; co0 < c; co0 += G) {
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap - 3 * dy;
      const float* a = s_in + ((py + dy) * kPatchW + px + dx) * cs;
      const float* wt = s_w + tap * c * c + co0;
      for (int ci = 0; ci < c; ++ci) {
        const float v = a[ci];
        const float* wr = wt + ci * c;
        if constexpr (G % 4 == 0) {
          // 16-byte aligned: C and co0 are multiples of G
          const float4* w4 = reinterpret_cast<const float4*>(wr);
#pragma unroll
          for (int q = 0; q < G / 4; ++q) {
            const float4 w = w4[q];
            acc[4 * q] = fmaf(v, w.x, acc[4 * q]);
            acc[4 * q + 1] = fmaf(v, w.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v, w.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v, w.w, acc[4 * q + 3]);
          }
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g] = fmaf(v, wr[g], acc[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) dst[co0 + g] = from_float<T>(relu(acc[g]));
  }
}

template <int G>
int run_f32(const float* x, const float* weights, float* out, float* scratch, int batch,
            int height, int width, int channels, int depth, cudaStream_t stream) {
  const size_t smem = smem_bytes(channels);
  auto kernel = conv3x3_relu_kernel<float, G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kTileH - 1) / kTileH;
  const dim3 grid(tiles_x * tiles_y, batch);
  const size_t layer_weights = static_cast<size_t>(9) * channels * channels;
  const float* src = x;
  for (int layer = 0; layer < depth; ++layer) {
    // the last layer writes `out`; the ones before alternate so that they do too
    float* dst = ((depth - 1 - layer) % 2 == 0) ? out : scratch;
    kernel<<<grid, kThreads, smem, stream>>>(src, weights + layer * layer_weights, dst, height,
                                             width, channels, tiles_x);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

int dispatch_f32(const float* x, const float* weights, float* out, float* scratch, int batch,
                 int height, int width, int channels, int depth, cudaStream_t stream) {
#define MP_RUN(G) run_f32<G>(x, weights, out, scratch, batch, height, width, channels, depth, stream)
  if (channels % 32 == 0) return MP_RUN(32);
  if (channels % 16 == 0) return MP_RUN(16);
  if (channels % 8 == 0) return MP_RUN(8);
  if (channels % 4 == 0) return MP_RUN(4);
  if (channels % 2 == 0) return MP_RUN(2);
  return MP_RUN(1);
#undef MP_RUN
}

// ---------------------------------------------------------------- bfloat16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcBlocksPerSm = 2;

// channels padded to the MMA's K step
__host__ __device__ constexpr int padded_channels(int channels) { return (channels + 15) / 16 * 16; }
// pixels of a layer's output region that keeps `halo` pixels of halo
__host__ __device__ constexpr int region_pixels(int halo) {
  return (kTileH + 2 * halo) * (kTileW + 2 * halo);
}
__host__ __device__ constexpr size_t align_1k(size_t n) { return (n + 1023) / 1024 * 1024; }

// Shared memory of one block, in bytes from a 1 KB aligned base (TMA's
// 128 B swizzle repeats every 1 KB): the group's weights, two input patches
// (the tile's and the next tile's, loading), and the first layer's output.
struct TcLayout {
  size_t patch0, patch1, mid, bars, total;
};
__host__ __device__ inline TcLayout tc_layout(int cp, int group) {
  const size_t weights = align_1k(sizeof(bf16) * group * 9 * cp * cp);
  const size_t patch = align_1k(sizeof(bf16) * region_pixels(group) * cp);
  TcLayout l;
  l.patch0 = weights;
  l.patch1 = l.patch0 + patch;
  l.mid = l.patch1 + patch;
  l.bars = l.mid + align_1k(sizeof(bf16) * region_pixels(group - 1) * cp);
  l.total = l.bars + 2 * sizeof(uint64_t) + 1024;  // + room to align the base
  return l;
}
size_t tc_smem_bytes(int channels, int group) {
  return tc_layout(padded_channels(channels), group).total;
}

// Every buffer is rows of Cp bf16 (a pixel's channels, or a weight row's
// output channels) whose 16 B chunks are XOR-swizzled by the row, as TMA's
// 32/64/128 B swizzle writes them at Cp = 16/32/64 (Cp = 48 is not
// swizzled). 8 consecutive rows of one chunk then lie in 8 distinct bank
// groups, so an ldmatrix reads them in one pass.
template <int CP>
__device__ __forceinline__ int swizzle(int row) {
  if constexpr (CP == 16) return (row >> 2) & 1;
  else if constexpr (CP == 32) return (row >> 1) & 3;
  else if constexpr (CP == 64) return row & 7;
  else return 0;
}
// offset in bf16 of 16 B chunk `chunk` of row `row`
template <int CP>
__device__ __forceinline__ int chunk_at(int row, int chunk) {
  return row * CP + ((chunk ^ swizzle<CP>(row)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B global -> shared without a register round trip; `valid` false
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// TMA: the box at (channel 0, x, y, image b) of `map` into shared memory,
// elements outside the tensor as zeros; completion counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, int b,
                                         uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(x), "r"(y),
         "r"(b), "r"(smem_addr(bar)) : "memory");
}
// TMA: shared memory to the box at (0, x, y, b); elements outside the tensor are dropped
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int x, int y,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
      "cp.async.bulk.commit_group;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(x), "r"(y), "r"(b),
         "r"(smem_addr(src)) : "memory");
}

__device__ __forceinline__ bool inside(int y, int x, int height, int width) {
  return y >= 0 && y < height && x >= 0 && x < width;
}

// One layer's HWIO weights [9][C][C] into shared rows tap * Cp + ci of Cp
// output channels, zero-padded.
template <int CP>
__device__ __forceinline__ void stage_weights(bf16* s_w, const bf16* wl, int channels, bool vec) {
  if (vec) {
    constexpr int chunks = CP / 8;
    for (int i = threadIdx.x; i < 9 * CP * chunks; i += kThreads) {
      const int row = i / chunks;
      const int ch = i - row * chunks;
      const int tap = row / CP;
      const int ci = row - tap * CP;
      const bool valid = ci < channels && ch * 8 < channels;
      cp_async_16(s_w + chunk_at<CP>(row, ch),
                  valid ? wl + (tap * channels + ci) * channels + ch * 8 : wl, valid);
    }
  } else {
    for (int i = threadIdx.x; i < 9 * CP * CP; i += kThreads) {
      const int row = i / CP;
      const int co = i - row * CP;
      const int tap = row / CP;
      const int ci = row - tap * CP;
      s_w[chunk_at<CP>(row, co >> 3) + (co & 7)] =
          (ci < channels && co < channels) ? wl[(tap * channels + ci) * channels + co]
                                           : __float2bfloat16_rn(0.0f);
    }
  }
}

// Without TMA (C % 8 != 0, or a base that is not 16 B aligned): the patch
// element by element, zero outside the image and in channels C..Cp-1.
template <int CP>
__device__ __forceinline__ void stage_patch(bf16* dst, const bf16* in, size_t image, int y0,
                                            int x0, int height, int width, int channels,
                                            int group) {
  const int pw = kTileW + 2 * group;
  for (int i = threadIdx.x; i < region_pixels(group) * CP; i += kThreads) {
    const int pix = i / CP;
    const int ci = i - pix * CP;
    const int iy = y0 + pix / pw;
    const int ix = x0 + pix % pw;
    dst[chunk_at<CP>(pix, ci >> 3) + (ci & 7)] =
        (ci < channels && inside(iy, ix, height, width))
            ? in[(image + static_cast<size_t>(iy) * width + ix) * channels + ci]
            : __float2bfloat16_rn(0.0f);
  }
}

template <int CP>
__device__ __forceinline__ void store_tile(const bf16* s, bf16* out, size_t image, int ty0,
                                           int tx0, int height, int width, int channels) {
  for (int i = threadIdx.x; i < kTileH * kTileW * channels; i += kThreads) {
    const int pix = i / channels;
    const int ci = i - pix * channels;
    const int oy = ty0 + pix / kTileW;
    const int ox = tx0 + pix % kTileW;
    if (inside(oy, ox, height, width)) {
      out[(image + static_cast<size_t>(oy) * width + ox) * channels + ci] =
          s[chunk_at<CP>(pix, ci >> 3) + (ci & 7)];
    }
  }
}

// One layer of a tile: s_src, the input region ((16 + 2 halo + 2)^2 pixels,
// row-major), to s_dst, the output region ((16 + 2 halo)^2), through the
// layer's weights s_wl. Each warp takes two 16-pixel row tiles at a time,
// sharing the B fragments.
template <int CP>
__device__ __forceinline__ void conv_layer(const bf16* s_src, bf16* s_dst, const bf16* s_wl,
                                           int halo, int ty0, int tx0, int height, int width) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // ldmatrix rows of this lane. A (16 pixels x 16 channels): lanes 0-15
  // point at pixels 0-15, channels 0-7; lanes 16-31 at channels 8-15.
  // B (k16 x two n8 tiles, stored k-major, loaded transposed): lane l points
  // at input channel ((l / 8) % 2) * 8 + l % 8, output channels (l / 16) * 8 on.
  const int a_row = lane & 15;
  const int a_chunk = lane >> 4;
  const int b_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_chunk = lane >> 4;
  // accumulator rows of this lane: r and r + 8; columns 2 * (lane % 4) + {0, 1}
  const int c_row = lane >> 2;
  const int c_col = 2 * (lane & 3);
  const int ow = kTileW + 2 * halo;
  const int m = (kTileH + 2 * halo) * ow;
  const int rw = ow + 2;  // width of the input region
  const int oy0 = ty0 - halo;
  const int ox0 = tx0 - halo;
  const int mtiles = (m + 15) / 16;
  for (int mt = 2 * warp; mt < mtiles; mt += 2 * kWarps) {
    int a_pix[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      // rows past the region's end repeat its last pixel; their sums are dropped
      const int p = min((mt + t) * 16 + a_row, m - 1);
      const int py = p / ow;
      a_pix[t] = py * rw + p - py * ow;
    }
    float acc[2][CP / 8][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int n = 0; n < CP / 8; ++n) acc[t][n][0] = acc[t][n][1] = acc[t][n][2] = acc[t][n][3] = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * rw + tap % 3;
#pragma unroll
      for (int ks = 0; ks < CP / 16; ++ks) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, s_src + chunk_at<CP>(a_pix[0] + shift, 2 * ks + a_chunk));
        ldmatrix_x4(a1, s_src + chunk_at<CP>(a_pix[1] + shift, 2 * ks + a_chunk));
#pragma unroll
        for (int np = 0; np < CP / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, s_wl + chunk_at<CP>(tap * CP + ks * 16 + b_row, 2 * np + b_chunk));
          mma_bf16(acc[0][2 * np], a0, b[0], b[1]);
          mma_bf16(acc[0][2 * np + 1], a0, b[2], b[3]);
          mma_bf16(acc[1][2 * np], a1, b[0], b[1]);
          mma_bf16(acc[1][2 * np + 1], a1, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = (mt + t) * 16 + c_row + 8 * half;
        if (q >= m) continue;
        const int qy = q / ow;
        // SAME padding at the next layer: a pixel outside the image is 0
        const bool in_image = inside(oy0 + qy, ox0 + q - qy * ow, height, width);
#pragma unroll
        for (int n = 0; n < CP / 8; ++n) {
          const float v0 = in_image ? relu(acc[t][n][2 * half]) : 0.0f;
          const float v1 = in_image ? relu(acc[t][n][2 * half + 1]) : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(s_dst + chunk_at<CP>(q, n) + c_col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// Persistent: block i takes tiles i, i + gridDim.x, ... of 16x16 output
// pixels of one image (`tiles` in all), each through `group` layers; see
// the note above. With use_tma, the patches come and the tiles go by TMA
// (in_map's box is the patch, out_map's the tile); else element by element.
template <int CP>
__global__ void __launch_bounds__(kThreads, kTcBlocksPerSm)
conv3x3_relu_tc_kernel(const __grid_constant__ CUtensorMap in_map,
                       const __grid_constant__ CUtensorMap out_map, const bf16* __restrict__ in,
                       const bf16* __restrict__ weight, bf16* __restrict__ out, int height,
                       int width, int channels, int group, int tiles_x, int tiles_per_image,
                       int tiles, int use_tma) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tc_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  const TcLayout lay = tc_layout(CP, group);
  bf16* const s_w = reinterpret_cast<bf16*>(base);
  bf16* const mid = reinterpret_cast<bf16*>(base + lay.mid);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(base + lay.bars);
  const uint32_t patch_bytes = sizeof(bf16) * CP * region_pixels(group);
  auto patch = [&](int buf) { return reinterpret_cast<bf16*>(base + (buf ? lay.patch1 : lay.patch0)); };
  auto locate = [&](int t, int& b, int& ty0, int& tx0) {
    b = t / tiles_per_image;
    const int r = t - b * tiles_per_image;
    ty0 = (r / tiles_x) * kTileH;
    tx0 = (r % tiles_x) * kTileW;
  };
  auto load_patch = [&](int t, int buf) {
    int b, ty0, tx0;
    locate(t, b, ty0, tx0);
    if (use_tma) {
      if (threadIdx.x == 0) {
        tma_load(patch(buf), &in_map, tx0 - group, ty0 - group, b, &bars[buf], patch_bytes);
      }
    } else {
      stage_patch<CP>(patch(buf), in, static_cast<size_t>(b) * height * width, ty0 - group,
                      tx0 - group, height, width, channels, group);
    }
  };

  if (threadIdx.x == 0) {
    mbarrier_init(&bars[0]);
    mbarrier_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool vec_w = channels % 8 == 0 && (reinterpret_cast<uintptr_t>(weight) & 15) == 0;
  for (int j = 0; j < group; ++j) {
    stage_weights<CP>(s_w + j * 9 * CP * CP, weight + static_cast<size_t>(j) * 9 * channels * channels,
                      channels, vec_w);
  }
  if (blockIdx.x < tiles) load_patch(blockIdx.x, 0);

  int k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const int buf = k & 1;
    // the previous tile's store has read its buffer, which the next patch may overwrite
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    if (t + static_cast<int>(gridDim.x) < tiles) load_patch(t + gridDim.x, buf ^ 1);
    cp_async_wait_all();  // the weights, on the first tile
    if (use_tma) mbarrier_wait(&bars[buf], (k >> 1) & 1);
    __syncthreads();  // this tile's patch and the weights are in place

    int b, ty0, tx0;
    locate(t, b, ty0, tx0);
    const bf16* src = patch(buf);
    bf16* dst = mid;
    for (int j = 0; j < group; ++j) {
      conv_layer<CP>(src, dst, s_w + j * 9 * CP * CP, group - 1 - j, ty0, tx0, height, width);
      // the tile's output is read by TMA, another proxy: order the writes before it
      if (j + 1 == group && use_tma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      bf16* const done = dst;
      dst = (dst == mid) ? patch(buf) : mid;
      src = done;
    }
    if (use_tma) {
      if (threadIdx.x == 0) tma_store(&out_map, src, tx0, ty0, b);
    } else {
      store_tile<CP>(src, out, static_cast<size_t>(b) * height * width, ty0, tx0, height, width,
                     channels);
    }
    __syncthreads();  // this tile's buffers are read before the next tile writes them
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found) == cudaSuccess &&
                    found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// NHWC bf16 [batch, height, width, channels] with a box of Cp channels x
// box_w x box_h pixels of one image, swizzled as chunk_at reads it.
template <int CP>
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int height, int width, int channels,
                int box_w, int box_h) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(channels), static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(height), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {sizeof(bf16) * channels, sizeof(bf16) * channels * width,
                                 sizeof(bf16) * channels * width * height};
  const cuuint32_t box[4] = {CP, static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = CP == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                 : CP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CP == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CP>
int run_tc(const bf16* x, const bf16* weights, bf16* out, bf16* scratch, int batch, int height,
           int width, int channels, const int* groups, int n_groups, cudaStream_t stream) {
  auto kernel = conv3x3_relu_tc_kernel<CP>;
  int max_group = 1;
  for (int k = 0; k < n_groups; ++k) max_group = groups[k] > max_group ? groups[k] : max_group;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(tc_smem_bytes(channels, max_group)));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0;
  int sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kTileH - 1) / kTileH;
  const int tiles = tiles_x * tiles_y * batch;
  // TMA needs 16 B aligned bases and row strides (C % 8 == 0)
  const bool tma_ok = channels % 8 == 0 &&
                      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                        reinterpret_cast<uintptr_t>(scratch)) & 15) == 0;
  const size_t layer_weights = static_cast<size_t>(9) * channels * channels;
  const bf16* src = x;
  int layer = 0;
  for (int k = 0; k < n_groups; ++k) {
    const int g = groups[k];
    const size_t smem = tc_smem_bytes(channels, g);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
    // the last launch writes `out`; the ones before alternate so that it does
    bf16* dst = ((n_groups - 1 - k) % 2 == 0) ? out : scratch;
    CUtensorMap in_map = {};
    CUtensorMap out_map = {};
    const int use_tma =
        tma_ok &&
        encode_map<CP>(&in_map, src, batch, height, width, channels, kTileW + 2 * g,
                       kTileH + 2 * g) &&
        encode_map<CP>(&out_map, dst, batch, height, width, channels, kTileW, kTileH);
    kernel<<<grid, kThreads, smem, stream>>>(in_map, out_map, src, weights + layer * layer_weights,
                                             dst, height, width, channels, g, tiles_x,
                                             tiles_x * tiles_y, tiles, use_tma);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
    layer += g;
  }
  return 0;
}

int dispatch_tc(const bf16* x, const bf16* weights, bf16* out, bf16* scratch, int batch,
                int height, int width, int channels, const int* groups, int n_groups,
                cudaStream_t stream) {
#define MP_RUN(CP) \
  run_tc<CP>(x, weights, out, scratch, batch, height, width, channels, groups, n_groups, stream)
  switch (padded_channels(channels)) {
    case 16: return MP_RUN(16);
    case 32: return MP_RUN(32);
    case 48: return MP_RUN(48);
    case 64: return MP_RUN(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MP_RUN
}

}  // namespace

// Bytes of dynamic shared memory one block needs: dtype 0 (float32, the
// CUDA-core kernel; `group` must be 1) or 1 (bfloat16, the tensor-core
// kernel fusing `group` layers). The wrapper refuses what exceeds the card's
// per-block limit.
extern "C" long long mp_conv_chain_smem_bytes(int dtype, int channels, int group) {
  if (dtype == 0 && group == 1) return static_cast<long long>(smem_bytes(channels));
  if (dtype == 1 && group >= 1) return static_cast<long long>(tc_smem_bytes(channels, group));
  return -1;
}

// x: [batch, height, width, channels]; weights: [depth, 3, 3, channels, channels] HWIO;
// out: like x; scratch: like x, used when there is more than one launch. All
// contiguous, on the current device, of one dtype: 0 = float32, 1 = bfloat16.
// groups[0..n_groups): layers fused per launch, in order, summing to depth;
// float32 takes only groups of 1, bfloat16 only channels <= 64. Launches
// n_groups kernels on `stream` and returns the first CUDA error (0 on success).
extern "C" int mp_fused_conv_chain(int dtype, const void* x, const void* weights, void* out,
                                   void* scratch, int batch, int height, int width, int channels,
                                   int depth, const int* groups, int n_groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int total = 0;
  for (int k = 0; k < n_groups; ++k) {
    if (groups[k] < 1 || (dtype == 0 && groups[k] != 1)) return static_cast<int>(cudaErrorInvalidValue);
    total += groups[k];
  }
  if (total != depth || channels < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return dispatch_f32(static_cast<const float*>(x), static_cast<const float*>(weights),
                        static_cast<float*>(out), static_cast<float*>(scratch), batch, height,
                        width, channels, depth, s);
  }
  if (dtype == 1 && channels <= kMaxTcChannels) {
    return dispatch_tc(static_cast<const bf16*>(x), static_cast<const bf16*>(weights),
                       static_cast<bf16*>(out), static_cast<bf16*>(scratch), batch, height, width,
                       channels, groups, n_groups, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
