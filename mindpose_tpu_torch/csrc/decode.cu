// Fused heatmap argmax + quarter-pixel shift decode for Hopper (sm_90a).
//
// Replaces the TPU kernel mindpose_tpu/ops/pallas/decode.py:_decode_kernel
// (wrapper argmax_shift_decode). The Pallas kernel needed the NHWC heatmap
// transposed into [N*K, H*W] rows padded to a multiple of 8 and wrote a
// 128-lane output tile per row. Here the port's heatmap is NCHW [N, K, H, W]
// and contiguous, so each (n, k) row of H*W floats is already contiguous: no
// transpose, no padding, and the outputs are written in their final layout.
//
// Design: one block per row. Each thread strides over the row with
// coalesced loads and keeps its best (value, index) pair; warps reduce with
// shuffles and warp 0 reduces the per-warp winners. The smaller index wins a
// tie, so the result is the first index of the maximum (torch.argmax and
// jnp.argmax both do this). A NaN beats every number, and the first NaN wins,
// as in torch.argmax. Thread 0 then reads the four taps and writes
// coords[n, k, 0:2] and maxvals[n, k].
//
// Bound: the heatmap is read once. At the flagship shape, 32 crops x 17 joints
// x 64*48 floats = 6.7 MB per batch: about 2 us of HBM traffic on an H100,
// which is less than one launch costs. The design keeps it to one launch with
// no transpose or padding pass before it and no gather pass after it; the
// remaining cost is the launch itself, which a CUDA graph over the whole
// forward could hide (later work).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Whether (v, i) should replace (bv, bi) as the row's best element.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// jnp.sign, which the plain version keeps: -1, 0 or 1, and NaN for NaN (a
// NaN tap, or -inf on both sides of the maximum, makes the coordinate NaN).
__device__ __forceinline__ float sign_of(float d) {
  return isnan(d) ? d : static_cast<float>((d > 0.0f) - (d < 0.0f));
}

__global__ void __launch_bounds__(kThreads)
argmax_shift_kernel(const float* __restrict__ heatmap, float* __restrict__ coords,
                    float* __restrict__ maxvals, int height, int width, int shift) {
  const int p = height * width;
  const long long row = blockIdx.x;
  const float* x = heatmap + row * p;

  float bv = -INFINITY;
  int bi = p;  // sentinel: any real index wins a tie against it
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const float v = __ldg(x + i);
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }

  __shared__ float s_v[kWarps];
  __shared__ int s_i[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_v[warp] = bv;
    s_i[warp] = bi;
  }
  __syncthreads();
  if (warp != 0) return;

  bv = lane < kWarps ? s_v[lane] : -INFINITY;
  bi = lane < kWarps ? s_i[lane] : p;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane != 0) return;

  const int xi = bi % width;
  const int yi = bi / width;
  float off_x = 0.0f, off_y = 0.0f;
  if (shift) {
    // taps clamped to the row, as the reference does; a tap on the border is
    // masked out below, so the clamp only keeps the reads in bounds
    const float left = x[max(bi - 1, 0)];
    const float right = x[min(bi + 1, p - 1)];
    const float up = x[max(bi - width, 0)];
    const float down = x[min(bi + width, p - 1)];
    const float dx = (xi >= 1 && xi <= width - 2) ? right - left : 0.0f;
    const float dy = (yi >= 1 && yi <= height - 2) ? down - up : 0.0f;
    off_x = sign_of(dx) * 0.25f;
    off_y = sign_of(dy) * 0.25f;
  }
  coords[2 * row] = static_cast<float>(xi) + off_x;
  coords[2 * row + 1] = static_cast<float>(yi) + off_y;
  maxvals[row] = bv;
}

}  // namespace

// heatmap: [rows, height*width] float32, contiguous, on the current device.
// coords: [rows, 2]; maxvals: [rows]. Launches on `stream` and returns
// cudaGetLastError() (0 on success). rows must be > 0.
extern "C" int mp_argmax_shift_decode(const float* heatmap, float* coords, float* maxvals,
                                      int rows, int height, int width, int shift,
                                      void* stream) {
  argmax_shift_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      heatmap, coords, maxvals, height, width, shift);
  return static_cast<int>(cudaGetLastError());
}
