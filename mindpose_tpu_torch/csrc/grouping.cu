// Fixed-capacity associative-embedding tag matcher for Hopper (sm_90a): the
// whole bottom-up grouping of a batch in one launch, one block per image.
//
// Replaces mindpose_tpu/ops/grouping.py:match_by_tag_device (:109), with its
// assignment _lsap (:31), which the JAX package runs under jit on the
// accelerator (no Pallas kernel: lax.while_loop and fori_loop over a
// fixed-size state). Per image, joints are visited in joint_order; each
// joint's candidates above vis_thr are assigned to the live groups by a
// Jonker-Volgenant shortest-augmenting-path LSAP over the padded
// [M, G + M] cost (tag distance to each group's mean tag, rounded with the
// unrounded distance as a tie-break; one spawn column per candidate); an
// assigned candidate closer than tag_thr joins its group, the others start
// new groups in candidate order, up to the capacity G.
//
// Bound: the bytes are tiny (at batch 32, K=17, M=30, L=1: 0.26 MB of
// candidates in, 0.26 MB of groups out, 0.00016 ms at 3.35 TB/s). The work
// is a chain of dependent steps: 17 joints x 30 rows x the augmenting
// path's iterations, each an argmin over the row's G + M columns that the
// next iteration needs. So one image is one block of one warp, and a batch
// fills as many SMs as it has images. Design:
// - the image's state lives in shared memory: the cost matrix, the
//   distances, the potentials u, v, minv, the matching p and way, the
//   groups' tag sums and counts (12 KB at M = G = 30); the groups
//   themselves are written straight to their output rows;
// - lanes stride the columns of a row, and the argmin is a warp shuffle
//   reduction on (value, index) that keeps the lowest index on ties, as
//   jnp.argmin does; the rows, the augmenting path and the spawns run in
//   order, as in the JAX loops;
// - a joint with no candidate above vis_thr changes nothing and is skipped
//   (the JAX loop assigns its masked rows and then joins and spawns none).
//
// Rounding equals the plain version (ops/grouping.py) bit for bit: every
// operation rounds on its own (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn,
// __fsqrt_rn, which nvcc never contracts), except the two that XLA on the
// CPU fuses into one multiply-add, which are __fmaf_rn here as there: the
// squared distance's terms after the first, and round(d) + eps * d; rintf
// rounds half to even, as jnp.round does; the INF of 1e30 is JAX's.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#ifndef MP_LANES
#define MP_LANES 32  // a warp; built at 1 lane on a host, the same steps run in order
#endif

namespace {

constexpr int kLanes = MP_LANES;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 1e30f;  // JAX's _INF
constexpr int kMaxJoints = 64;

constexpr int kRoundedNorm = 1;    // round the distances, the unrounded ones breaking ties
constexpr int kIgnoreTooMuch = 2;  // skip a joint once M groups exist

constexpr int kCandidate = 1;  // above vis_thr
constexpr int kSpawn = 2;      // a candidate that joins no group

struct JointOrder {
  int n;
  int idx[kMaxJoints];
};

// The first index of the minimum across the warp, given each lane's first
// index of its own minimum: on equal values the lower index wins.
__device__ __forceinline__ void warp_argmin(float& value, int& index) {
  for (int offset = kLanes / 2; offset > 0; offset >>= 1) {
    const float v = __shfl_down_sync(kFull, value, offset);
    const int i = __shfl_down_sync(kFull, index, offset);
    if (v < value || (v == value && i < index)) {
      value = v;
      index = i;
    }
  }
  value = __shfl_sync(kFull, value, 0);
  index = __shfl_sync(kFull, index, 0);
}

__device__ __forceinline__ float warp_max(float value) {
  for (int offset = kLanes / 2; offset > 0; offset >>= 1)
    value = fmaxf(value, __shfl_down_sync(kFull, value, offset));
  return __shfl_sync(kFull, value, 0);
}

// Words of shared memory an image needs (floats and ints, 4 bytes each).
inline size_t smem_words(int m, int l, int g) {
  const size_t cols = (size_t)g + m + 1;
  return (size_t)m * (g + m) + (size_t)m * g + (size_t)g * l + g + (m + 1) + 5 * cols + 2 * m;
}

__global__ void __launch_bounds__(MP_LANES)
    match_kernel(const float* __restrict__ val_k, const float* __restrict__ tag_k,
                 const float* __restrict__ ind_k, float* __restrict__ groups,
                 unsigned char* __restrict__ valid, int K, int M, int L, int G, float vis_thr,
                 float tag_thr, int flags, JointOrder order) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int img = blockIdx.x;
  const int ncol = G + M;  // a cost row: G group columns, then M spawn columns
  const int C = ncol + 1;  // the LSAP's 1-based columns, with column 0
  const int F = 3 + L;     // a joint's row: x, y, score, tags

  float* cost = smem;             // [M, G + M]
  float* dist = cost + M * ncol;  // [M, G], unrounded
  float* gsum = dist + M * G;     // [G, L]
  float* gcnt = gsum + G * L;     // [G]
  float* u = gcnt + G;            // [M + 1]
  float* v = u + (M + 1);         // [C]
  float* minv = v + C;            // [C]
  int* p = reinterpret_cast<int*>(minv + C);  // [C]: the row (1-based) on a column, 0 if none
  int* way = p + C;                           // [C]
  int* used = way + C;                        // [C]
  int* assign = used + C;                     // [M]: the column of each row
  int* cand = assign + M;                     // [M]: kCandidate, kSpawn

  const float* val = val_k + (size_t)img * K * M;
  const float* tag = tag_k + (size_t)img * K * M * L;
  const float* ind = ind_k + (size_t)img * K * M * 2;
  float* out = groups + (size_t)img * G * K * F;

  for (int i = lane; i < G * K * F; i += kLanes) out[i] = 0.0f;
  for (int i = lane; i < G * L; i += kLanes) gsum[i] = 0.0f;
  for (int i = lane; i < G; i += kLanes) gcnt[i] = 0.0f;
  int n_groups = 0;  // the same in every lane
  __syncwarp();

  for (int o = 0; o < order.n; ++o) {
    const int jidx = order.idx[o];
    const float* vj = val + jidx * M;
    const float* tj = tag + (size_t)jidx * M * L;
    const float* ij = ind + jidx * M * 2;

    int any = 0;
    for (int m = lane; m < M; m += kLanes) {
      cand[m] = vj[m] > vis_thr ? kCandidate : 0;
      any |= cand[m];
    }
    any = __any_sync(kFull, any);
    if (!any || ((flags & kIgnoreTooMuch) && n_groups >= M)) continue;  // nothing changes
    __syncwarp();

    // the L2 distance from each candidate's tag to each group's mean tag
    float dmax = 0.0f;  // over the candidates and live groups
    for (int e = lane; e < M * G; e += kLanes) {
      const int m = e / G, g = e % G;
      const float count = fmaxf(gcnt[g], 1.0f);
      float acc = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float d = __fsub_rn(tj[m * L + l], __fdiv_rn(gsum[g * L + l], count));
        acc = l == 0 ? __fmul_rn(d, d) : __fmaf_rn(d, d, acc);
      }
      const float dd = __fsqrt_rn(acc);
      dist[e] = dd;
      cost[m * ncol + g] = dd;
      if (cand[m] && g < n_groups) dmax = fmaxf(dmax, dd);
    }
    dmax = warp_max(dmax);
    if (flags & kRoundedNorm) {
      const float eps = __fdiv_rn(0.5f, __fmul_rn((float)M, __fadd_rn(dmax, 1.0f)));
      dmax = 0.0f;
      for (int e = lane; e < M * G; e += kLanes) {
        const int m = e / G, g = e % G;
        const float d = dist[e];
        const float c = __fmaf_rn(eps, d, rintf(d));
        cost[m * ncol + g] = c;
        if (cand[m] && g < n_groups) dmax = fmaxf(dmax, c);
      }
      dmax = warp_max(dmax);
    }
    const float pad_c = __fadd_rn(__fmul_rn(dmax, 2.0f), 10.0f);   // a candidate's spawn cost
    const float inval = __fadd_rn(__fmul_rn(dmax, 4.0f), 100.0f);  // never chosen
    __syncwarp();
    for (int e = lane; e < M * ncol; e += kLanes) {
      const int m = e / ncol, c = e % ncol;
      if (c >= G)
        cost[e] = cand[m] ? pad_c : 0.0f;
      else if (!cand[m] || c >= n_groups)
        cost[e] = inval;
    }
    for (int c = lane; c < C; c += kLanes) {
      v[c] = 0.0f;
      p[c] = 0;
    }
    for (int r = lane; r <= M; r += kLanes) u[r] = 0.0f;
    __syncwarp();

    // the LSAP, row by row: Dijkstra over the reduced costs, then the augmenting path
    for (int i1 = 1; i1 <= M; ++i1) {
      for (int c = lane; c < C; c += kLanes) {
        way[c] = 0;
        minv[c] = kInf;
        used[c] = 0;
      }
      if (lane == 0) p[0] = i1;
      __syncwarp();
      int j0 = 0;
      for (;;) {
        const int i0 = p[j0];
        if (i0 == 0) break;
        __syncwarp();
        if (lane == 0) used[j0] = 1;
        __syncwarp();
        const float ui = u[i0];
        const float* row = cost + (i0 - 1) * ncol;
        float best = INFINITY;
        int best_j = INT_MAX;
        for (int c = 1 + lane; c < C; c += kLanes) {
          float mv = minv[c];
          if (!used[c]) {
            const float cur = __fsub_rn(__fsub_rn(row[c - 1], ui), v[c]);
            if (cur < mv) {
              mv = cur;
              minv[c] = cur;
              way[c] = j0;
            }
          }
          const float masked = used[c] ? kInf : mv;
          if (masked < best) {
            best = masked;
            best_j = c;
          }
        }
        warp_argmin(best, best_j);
        __syncwarp();
        for (int c = lane; c < C; c += kLanes) {
          if (used[c]) {
            u[p[c]] = __fadd_rn(u[p[c]], best);  // the used columns' rows are distinct
            v[c] = __fsub_rn(v[c], best);
          } else {
            minv[c] = __fsub_rn(minv[c], best);
          }
        }
        __syncwarp();
        j0 = best_j;
      }
      if (lane == 0) {
        while (j0 != 0) {
          const int j1 = way[j0];
          p[j0] = p[j1];
          j0 = j1;
        }
      }
      __syncwarp();
    }
    for (int c = 1 + lane; c < C; c += kLanes)
      if (p[c] > 0) assign[p[c] - 1] = c - 1;
    __syncwarp();

    // joins: each group receives at most one candidate, so lanes apply them at once
    for (int m = lane; m < M; m += kLanes) {
      if (!cand[m]) continue;
      const int a = assign[m];
      const int gcol = min(a, G - 1);
      if (a < G && gcol < n_groups && dist[m * G + gcol] < tag_thr) {
        float* row = out + ((size_t)a * K + jidx) * F;
        row[0] = ij[m * 2];
        row[1] = ij[m * 2 + 1];
        row[2] = vj[m];
        for (int l = 0; l < L; ++l) {
          row[3 + l] = tj[m * L + l];
          gsum[a * L + l] = __fadd_rn(gsum[a * L + l], tj[m * L + l]);
        }
        gcnt[a] = __fadd_rn(gcnt[a], 1.0f);
      } else {
        cand[m] = kSpawn;
      }
    }
    __syncwarp();
    // spawns, in candidate order, up to the capacity
    if (lane == 0) {
      for (int m = 0; m < M && n_groups < G; ++m) {
        if (cand[m] != kSpawn) continue;
        float* row = out + ((size_t)n_groups * K + jidx) * F;
        row[0] = ij[m * 2];
        row[1] = ij[m * 2 + 1];
        row[2] = vj[m];
        for (int l = 0; l < L; ++l) {
          row[3 + l] = tj[m * L + l];
          gsum[n_groups * L + l] = tj[m * L + l];
        }
        gcnt[n_groups] = 1.0f;
        ++n_groups;
      }
    }
    n_groups = __shfl_sync(kFull, n_groups, 0);
    __syncwarp();
  }
  for (int g = lane; g < G; g += kLanes) valid[(size_t)img * G + g] = g < n_groups;
}

}  // namespace

// Groups N images' candidates: val_k [N, K, M], tag_k [N, K, M, L], ind_k
// [N, K, M, 2] (float32, contiguous) -> groups [N, G, K, 3 + L] float32 and
// valid [N, G] (bytes 0 / 1). joint_order is a host array of n_order joint
// indices. Returns the CUDA error of the launch (0 on success): sizes whose
// state exceeds a block's 227 KB of shared memory fail at the attribute.
extern "C" int mp_match_by_tag(const float* val_k, const float* tag_k, const float* ind_k,
                               float* groups, unsigned char* valid, int n, int k, int m, int l,
                               int g, const int* joint_order, int n_order, float vis_thr,
                               float tag_thr, int flags, cudaStream_t stream) {
  if (n_order > kMaxJoints || n_order < 0) return cudaErrorInvalidValue;
  JointOrder order;
  order.n = n_order;
  for (int i = 0; i < n_order; ++i) order.idx[i] = joint_order[i];
  const size_t bytes = smem_words(m, l, g) * 4;
  cudaError_t err = cudaFuncSetAttribute(match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    match_kernel<<<n, kLanes, bytes, stream>>>(val_k, tag_k, ind_k, groups, valid, k, m, l, g,
                                                vis_thr, tag_thr, flags, order);
  }
  return cudaGetLastError();
}
