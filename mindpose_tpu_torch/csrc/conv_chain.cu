// Chain of L x (3x3 SAME conv, stride 1, no bias, ReLU) on NHWC activations, for Hopper (sm_90a).
//
// Replaces the TPU kernel mindpose_tpu/ops/pallas/conv_chain.py:_chain_kernel
// (wrapper fused_conv_chain). The Pallas kernel kept a whole padded image
// and its ping-pong partner in VMEM and fed the MXU (9C x C) im2col blocks,
// so no intermediate left the chip. An H100 SM cannot hold that: one padded
// 66x50x32 bf16 image is 211,200 B, two are 422 KB, against 227 KB of shared
// memory per block. So this first kernel is one launch per layer, and the
// intermediates go through two global ping-pong buffers (L2 holds much of
// them at the probe's sizes).
//
// Design, per layer: one block of 256 threads per 16x16 output tile of one
// image. The block stages the tile's input with its 1-pixel zero halo
// (SAME padding), converted to float32, and the layer's 3x3xCxC HWIO
// weights, also float32, in shared memory. Each thread owns one output
// pixel and accumulates up to 32 output channels at a time in float32
// registers: per tap and input channel, one shared-memory read of the input
// and G/4 float4 reads of weights that every lane of the warp shares
// (a broadcast), then G fused multiply-adds. The input's per-pixel stride
// is odd (in 4-byte words), so the lanes of a warp read distinct banks. The
// epilogue applies ReLU and rounds to the activation dtype, exactly where
// the Pallas kernel rounds (after the ReLU, once per layer).
//
// Bound: CUDA-core float32 FMAs. At the probe's B128 64x48 C32 depth 8 the
// chain is 58.0 GFLOP against 25.2 MB of bf16 activations per layer read and
// written, so on the tensor cores it would be compute-light; on the CUDA
// cores at one shared-memory read per four FMAs it is bound by the FMA and
// shared-memory issue rate, well below the 67 TFLOP/s float32 peak. Tensor
// cores (mma/wgmma on an im2col tile in shared memory) and fusing layers on
// chip (an L-pixel recomputed halo, or a cluster sharing distributed shared
// memory) are the redesign's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;  // one output pixel per thread
constexpr int kPatchW = kTileW + 2;
constexpr int kPatchPixels = (kTileH + 2) * kPatchW;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ReLU that keeps NaN, as jnp.maximum(x, 0) and torch.relu do.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

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

template <typename T, int G>
int run_chain(const T* x, const T* weights, T* out, T* scratch, int batch, int height,
              int width, int channels, int depth, cudaStream_t stream) {
  const size_t smem = smem_bytes(channels);
  auto kernel = conv3x3_relu_kernel<T, G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kTileH - 1) / kTileH;
  const dim3 grid(tiles_x * tiles_y, batch);
  const size_t layer_weights = static_cast<size_t>(9) * channels * channels;
  const T* src = x;
  for (int layer = 0; layer < depth; ++layer) {
    // the last layer writes `out`; the ones before alternate so that they do too
    T* dst = ((depth - 1 - layer) % 2 == 0) ? out : scratch;
    conv3x3_relu_kernel<T, G><<<grid, kThreads, smem, stream>>>(
        src, weights + layer * layer_weights, dst, height, width, channels, tiles_x);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

template <typename T>
int dispatch(const void* x, const void* weights, void* out, void* scratch, int batch, int height,
             int width, int channels, int depth, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(weights);
  T* op = static_cast<T*>(out);
  T* sp = static_cast<T*>(scratch);
#define MP_RUN(G) run_chain<T, G>(xp, wp, op, sp, batch, height, width, channels, depth, stream)
  if (channels % 32 == 0) return MP_RUN(32);
  if (channels % 16 == 0) return MP_RUN(16);
  if (channels % 8 == 0) return MP_RUN(8);
  if (channels % 4 == 0) return MP_RUN(4);
  if (channels % 2 == 0) return MP_RUN(2);
  return MP_RUN(1);
#undef MP_RUN
}

}  // namespace

// Bytes of dynamic shared memory a block needs at `channels` (the wrapper
// refuses what exceeds the card's per-block limit).
extern "C" long long mp_conv_chain_smem_bytes(int channels) {
  return static_cast<long long>(smem_bytes(channels));
}

// x: [batch, height, width, channels]; weights: [depth, 3, 3, channels, channels] HWIO;
// out: like x; scratch: like x, used when depth > 1. All contiguous, on the
// current device, of one dtype: 0 = float32, 1 = bfloat16. Launches `depth`
// kernels on `stream` and returns the first CUDA error (0 on success).
extern "C" int mp_fused_conv_chain(int dtype, const void* x, const void* weights, void* out,
                                   void* scratch, int batch, int height, int width, int channels,
                                   int depth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(x, weights, out, scratch, batch, height, width, channels, depth, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(x, weights, out, scratch, batch, height, width, channels,
                                   depth, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
