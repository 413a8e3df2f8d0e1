// Heatmap decode for Hopper (sm_90a): per (crop, joint) row the maximum, its
// first index, the optional quarter-pixel shift, and, fused behind them, the
// decoder's back-projection to the original frame and its boxes row.
//
// Replaces the TPU kernel mindpose_tpu/ops/pallas/decode.py:_decode_kernel
// (wrapper argmax_shift_decode). The Pallas kernel needed the NHWC heatmap
// transposed into [N*K, H*W] rows padded to a multiple of 8 and wrote a
// 128-lane output tile per row. Here the heatmap is NCHW [N, K, H, W] and
// contiguous, so each row of H*W floats is already contiguous, and the
// outputs are written in their final layout: the decoder's preds [N, K, 3]
// and boxes [N, 6], or argmax_shift_decode's coords [N, K, 2] and maxvals.
//
// Bound: one read of the heatmap. At the serving chunk, [32, 17, 64, 48]
// float32, that is 6.7 MB: 0.00200 ms at 3.35 TB/s. Under it lies the launch
// floor. On an NVIDIA H100 80GB HBM3 at 700.00 W, device times with the
// launches queued (chip_smoke.py phase 3): an empty kernel takes 0.00187 ms
// and this kernel on a [1, 1, 1, 1] heatmap 0.00268 ms, against 0.00417 ms
// on the chunk warm in L2 and 0.00612 ms cold. So most of a chunk's time is
// the floor, which only fewer launches (a CUDA graph) can cut.
// What the design does about each:
// - Bytes in flight: one block of 128 threads per row; each thread issues
//   all its loads for the row (6 float4 at 64x48) before its first compare,
//   so the 544 rows of a chunk (one wave: at most 16 such blocks per SM) put
//   the whole 6.7 MB in flight at once, well above what 3.35 TB/s times a
//   DRAM round trip needs. Rows that are not 16-byte aligned, or whose
//   length is not a multiple of 4, take the scalar loads of the same kernel
//   (8 in flight per thread); the wrapper picks from the pointer and shape.
// - Order: a thread scans its elements in index order and keeps the first
//   of its maximum; threads and warps then reduce with `better`, a total
//   order on (value, index) in which a NaN beats every number, the first
//   NaN wins and a tie goes to the smaller index. So any reduction tree
//   gives the first index of the maximum, as torch.argmax does.
// - Tail: warp 0 reduces the four warp winners; lanes 0-3 read the four taps
//   at once (one round trip, mostly in L1), and the outputs go out in
//   parallel lanes. The crop's center, scale and score are read at the start,
//   under the row's loads.
// - Launches: the decoder's back-projection, preds concatenation and boxes
//   row run here, so a serving chunk decodes in this one launch instead of
//   this kernel and 16 small PyTorch ops.
//
// Rounding equals the plain version (ops/cuda/decode.py:decode_heatmap_plain)
// run by PyTorch on the card, bit for bit: each op is rounded on its own, as
// PyTorch's one-op elementwise kernels do, by __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA. PyTorch's CUDA division
// of a tensor by a Python number multiplies by the float reciprocal
// (div_true_kernel_cuda, the CPU-scalar branch), so scale / w is
// S * (1.0f / w) here; the CPU divides, so the plain version on the CPU may
// differ from the card in the last bit of x and y.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // threads per row, one row per block
constexpr int kWarps = kThreads / 32;
constexpr int kVectorLoads = 6;  // float4 in flight per thread (768 per 64x48 row)
constexpr int kScalarLoads = 8;  // floats in flight per thread on the scalar path

constexpr int kShift = 1;       // quarter-pixel shift toward the larger neighbour
constexpr int kToOriginal = 2;  // map x, y back to the original image frame
constexpr int kUseUdp = 4;      // scale / (size - 1) instead of scale / size
constexpr int kVector = 8;      // 16-byte loads (row 16-byte aligned, H*W % 4 == 0)

// Whether (v, i) should replace (bv, bi) as the row's best element.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// One element of a thread's scan, which goes in index order: a later element
// replaces the best only if it is greater, or the first NaN. An element equal
// to -inf is never taken, so a thread that saw only -inf keeps the sentinel
// index (the row length), which loses to any index under `better`.
__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (!isnan(bv) && !(v <= bv)) {
    bv = v;
    bi = i;
  }
}

// jnp.sign, which the plain version keeps: -1, 0 or 1, and NaN for NaN (a
// NaN tap, or -inf on both sides of the maximum, makes the coordinate NaN).
__device__ __forceinline__ float sign_of(float d) {
  return isnan(d) ? d : static_cast<float>((d > 0.0f) - (d < 0.0f));
}

// A thread's scan of its elements of the row, all its loads of a pass issued
// before the compares. Two accumulators take alternate elements (so each
// still sees its elements in index order) and halve the chain of dependent
// compares; `better` merges them.
template <bool kVec>
__device__ __forceinline__ void scan_row(const float* __restrict__ x, int p, float& bv, int& bi) {
  float v2[2] = {-INFINITY, -INFINITY};
  int i2[2] = {p, p};
  if constexpr (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = p >> 2;
    for (int base = threadIdx.x; base < n4; base += kThreads * kVectorLoads) {
      float4 r[kVectorLoads];
#pragma unroll
      for (int j = 0; j < kVectorLoads; ++j) {
        const int q = base + j * kThreads;
        r[j] = q < n4 ? __ldg(x4 + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < kVectorLoads; ++j) {
        const int q = base + j * kThreads;
        if (q < n4) {
          take(r[j].x, 4 * q, v2[0], i2[0]);
          take(r[j].y, 4 * q + 1, v2[1], i2[1]);
          take(r[j].z, 4 * q + 2, v2[0], i2[0]);
          take(r[j].w, 4 * q + 3, v2[1], i2[1]);
        }
      }
    }
  } else {
    for (int base = threadIdx.x; base < p; base += kThreads * kScalarLoads) {
      float r[kScalarLoads];
#pragma unroll
      for (int j = 0; j < kScalarLoads; ++j) {
        const int i = base + j * kThreads;
        r[j] = i < p ? __ldg(x + i) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kScalarLoads; ++j) {
        const int i = base + j * kThreads;
        if (i < p) take(r[j], i, v2[j & 1], i2[j & 1]);
      }
    }
  }
  const bool second = better(v2[1], i2[1], v2[0], i2[0]);
  bv = second ? v2[1] : v2[0];
  bi = second ? i2[1] : i2[0];
}

__device__ __forceinline__ void warp_reduce(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

struct Args {
  const float* heatmap;  // [rows, height*width]
  const float* center;   // [crops, 2], or null without boxes and to_original
  const float* scale;    // [crops, 2]
  const float* score;    // [crops]
  float* xy;             // x of row r at xy[r * xy_stride], y after it
  float* maxvals;        // maxval of row r at maxvals[r * maxvals_stride]
  float* boxes;          // [crops, 6] or null
  int xy_stride, maxvals_stride, joints, height, width, flags;
  float pixel_std;
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads) heatmap_decode_kernel(const Args a) {
  const int p = a.height * a.width;
  const int row = blockIdx.x;
  const float* x = a.heatmap + static_cast<long long>(row) * p;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int crop = row / a.joints;
  const bool want_crop = a.boxes != nullptr || (a.flags & kToOriginal);

  // the crop's inputs, read by warp 0 under the row's loads
  float c0 = 0.0f, c1 = 0.0f, s0 = 0.0f, s1 = 0.0f, sc = 0.0f;
  if (warp == 0 && want_crop) {
    c0 = __ldg(a.center + 2LL * crop);
    c1 = __ldg(a.center + 2LL * crop + 1);
    s0 = __ldg(a.scale + 2LL * crop);
    s1 = __ldg(a.scale + 2LL * crop + 1);
    if (a.boxes != nullptr) sc = __ldg(a.score + crop);
  }

  float bv;
  int bi;  // the row length while no element is taken: any real index wins against it
  scan_row<kVec>(x, p, bv, bi);
  warp_reduce(bv, bi);

  __shared__ float s_v[kWarps];
  __shared__ int s_i[kWarps];
  if (lane == 0) {
    s_v[warp] = bv;
    s_i[warp] = bi;
  }
  __syncthreads();
  if (warp != 0) return;

  // every lane of warp 0 reduces the warp winners in the same order
  bv = s_v[0];
  bi = s_i[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    if (better(s_v[w], s_i[w], bv, bi)) {
      bv = s_v[w];
      bi = s_i[w];
    }
  }
  if (bi == p) bi = 0;  // no element taken: the row is all -inf, and index 0 is first

  const int xi = bi % a.width;
  const int yi = bi / a.width;
  float hx = static_cast<float>(xi), hy = static_cast<float>(yi);
  if (a.flags & kShift) {
    // lanes 0-3 read left, right, up, down at once; taps are clamped to the
    // row as the reference does, and one on the border is masked out below
    int t = 0;
    if (lane == 0) t = max(bi - 1, 0);
    if (lane == 1) t = min(bi + 1, p - 1);
    if (lane == 2) t = max(bi - a.width, 0);
    if (lane == 3) t = min(bi + a.width, p - 1);
    const float tap = lane < 4 ? __ldg(x + t) : 0.0f;
    const float left = __shfl_sync(0xffffffffu, tap, 0);
    const float right = __shfl_sync(0xffffffffu, tap, 1);
    const float up = __shfl_sync(0xffffffffu, tap, 2);
    const float down = __shfl_sync(0xffffffffu, tap, 3);
    const float dx = (xi >= 1 && xi <= a.width - 2) ? __fsub_rn(right, left) : 0.0f;
    const float dy = (yi >= 1 && yi <= a.height - 2) ? __fsub_rn(down, up) : 0.0f;
    hx = __fadd_rn(hx, __fmul_rn(sign_of(dx), 0.25f));
    hy = __fadd_rn(hy, __fmul_rn(sign_of(dy), 0.25f));
  }

  // scale * pixel_std, then, as PyTorch on the card: coord * (S * (1 / w))
  // + center - S * 0.5, every op rounded on its own
  const float big0 = __fmul_rn(s0, a.pixel_std);
  const float big1 = __fmul_rn(s1, a.pixel_std);
  if (a.flags & kToOriginal) {
    const bool udp = a.flags & kUseUdp;
    const float inv_w = __frcp_rn(static_cast<float>(udp ? a.width - 1 : a.width));
    const float inv_h = __frcp_rn(static_cast<float>(udp ? a.height - 1 : a.height));
    hx = __fsub_rn(__fadd_rn(__fmul_rn(hx, __fmul_rn(big0, inv_w)), c0), __fmul_rn(big0, 0.5f));
    hy = __fsub_rn(__fadd_rn(__fmul_rn(hy, __fmul_rn(big1, inv_h)), c1), __fmul_rn(big1, 0.5f));
  }
  const long long r = row;
  if (lane == 0) a.xy[r * a.xy_stride] = hx;
  if (lane == 1) a.xy[r * a.xy_stride + 1] = hy;
  if (lane == 2) a.maxvals[r * a.maxvals_stride] = bv;
  if (a.boxes != nullptr && row % a.joints == 0 && lane < 6) {
    // (cx, cy, sx, sy, area, score), one lane each
    const float v = lane == 0 ? c0 : lane == 1 ? c1 : lane == 2 ? s0 : lane == 3 ? s1
                  : lane == 4 ? __fmul_rn(big0, big1) : sc;
    a.boxes[6LL * crop + lane] = v;
  }
}

}  // namespace

// heatmap: [crops * joints, height*width] float32, contiguous, on the current
// device; 16-byte aligned with height*width % 4 == 0 when flags has kVector.
// Writes x, y of row r at xy[r * xy_stride] and xy[r * xy_stride + 1] and its
// maximum at maxvals[r * maxvals_stride]; with boxes, also boxes[crops, 6]
// (center, scale, area, score), which needs center, scale and score; with
// kToOriginal, x and y in the original frame, which needs center and scale.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
// crops * joints must be > 0.
extern "C" int mp_heatmap_decode(const float* heatmap, const float* center, const float* scale,
                                 const float* score, float* xy, int xy_stride, float* maxvals,
                                 int maxvals_stride, float* boxes, int crops, int joints,
                                 int height, int width, int flags, float pixel_std,
                                 void* stream) {
  const Args a{heatmap, center, scale, score, xy, maxvals, boxes, xy_stride, maxvals_stride,
               joints, height, width, flags, pixel_std};
  const unsigned rows = static_cast<unsigned>(crops) * static_cast<unsigned>(joints);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flags & kVector) {
    heatmap_decode_kernel<true><<<rows, kThreads, 0, s>>>(a);
  } else {
    heatmap_decode_kernel<false><<<rows, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
