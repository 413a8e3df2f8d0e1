// Fixed-capacity associative-embedding tag matcher for Hopper (sm_90a): the
// whole bottom-up grouping of a batch in one launch, one warp per image.
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
// candidates in, 0.26 MB of groups out, 0.00016 ms at 3.35 TB/s). The time
// is the latency of one chain of dependent steps: per joint, per row, the
// Dijkstra iterations of the LSAP, each an argmin over the row's G + M
// columns whose winner names the row that the next iteration scans (2,100
// to 6,900 iterations an image, on average, on the phase-16 sets of
// chip_smoke.py). No iteration can do less than one shared-memory load
// that depends on the last winner, one warp reduction, one ballot and one
// shuffle: mp_grouping_step_floor times that chain, and the bound of a
// batch is its largest image's iteration count (the plain version counts
// them) times that floor; one warp per image, the images side by side. The
// design cuts each iteration down to about that chain:
// - lane l owns the columns c0 + k, c0 = 1 + kSlots * l, k < kSlots =
//   kCols / 32 (kCols, a compile-time bound on G + M + 1: 64, 128 or 256),
//   and keeps their LSAP state in registers: minv, v, way, a state (absent,
//   open, used), p, and the potential u of the row on each column (a row's
//   u moves with it along the augmenting path); the Dijkstra row's own u,
//   new in that row's pass, is a uniform register. The only shared-memory
//   access of an iteration is one vector load of the scanned row's costs,
//   and the scan has no branch;
// - the argmin: each lane's first minimum over its slots of an
//   order-preserving key of the masked value (-0.0 mapped to +0.0, as
//   jnp.argmin compares them), one __reduce_min_sync (redux.sync) over the
//   lanes, one ballot of the lanes that hold it and __ffs: the columns lie
//   in lane order, so the lowest such lane holds the first column of the
//   minimum, as jnp.argmin takes it. That lane has picked its column's own
//   float (delta), column and row, row offset and u while the warp reduced,
//   and broadcasts them in four independent shuffles;
// - the augmenting path is a loop of shuffles along way (each column's way
//   holds the column and the row it was reached from);
// - per joint: the image's candidates are prefetched into L1 at the start,
//   and a joint's tags staged in shared memory; each live group's mean tag
//   is divided once (G x L divisions); the distances are taken only for
//   candidates and live groups, with one warp max (redux.sync) and no
//   integer division; the largest rounded cost is the largest distance's
//   (the rounding never decreases with d), so one pass of vector stores
//   rounds the distances and fills the rest of the cost; the unrounded
//   distance of an assigned pair is taken again at the join, by the same
//   operations; the spawns are ranked by a ballot, in candidate order.
//
// Rounding equals the plain version (ops/grouping.py) bit for bit: every
// operation rounds on its own (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn,
// __fsqrt_rn, which nvcc never contracts), except the two that XLA on the
// CPU fuses into one multiply-add, which are __fmaf_rn here as there: the
// squared distance's terms after the first, and round(d) + eps * d; rintf
// rounds half to even, as jnp.round does; the INF of 1e30 is JAX's. The
// potentials take the same additions in the same order as in the plain
// version, and the iterations come in the same sequence.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <string.h>

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

constexpr int kAbsent = 0, kOpen = 1, kUsed = 2;  // an LSAP column's state

constexpr int kCandidate = 1;  // above vis_thr
constexpr int kSpawn = 2;      // a candidate that joins no group

struct JointOrder {
  int n;
  int idx[kMaxJoints];
};

// An unsigned key that orders as the float does (NaN aside), with -0.0 and
// +0.0 on one key (adding +0.0 turns -0.0 into +0.0 and leaves every other
// value as it is): the masked values' argmin is the first minimum key.
__host__ __device__ inline unsigned order_key(float x) {
  unsigned b;
#ifdef __CUDA_ARCH__
  b = __float_as_uint(__fadd_rn(x, 0.0f));
#else
  x = x + 0.0f;
  memcpy(&b, &x, sizeof b);
#endif
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);  // negatives reversed, below positives
}

// The float of a key (a zero comes back as +0.0).
[[maybe_unused]] __host__ __device__ inline float key_value(unsigned key) {
  const unsigned b = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  float x;
#ifdef __CUDA_ARCH__
  x = __uint_as_float(b);
#else
  memcpy(&x, &b, sizeof x);
#endif
  return x;
}

// The largest of the lanes' values, all non-negative (distances and their
// rounded costs): their bits order as the floats do.
__device__ __forceinline__ float warp_max_nonneg(float value) {
  return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(value)));
}

// Start loads of [at, at + n) into L1 (a line of 128 bytes a lane and step),
// so that the joints' loops find their candidates there.
__device__ __forceinline__ void prefetch_l1(const float* at, int n) {
#ifdef __CUDA_ARCH__
  for (int i = threadIdx.x * 32; i < n; i += kLanes * 32)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(at + i));
#endif
}

// The L2 distance from a candidate's tag to a group's mean tag.
__device__ __forceinline__ float tag_distance(const float* tag, const float* mean, int L) {
  float acc = 0.0f;
  for (int l = 0; l < L; ++l) {
    const float d = __fsub_rn(tag[l], mean[l]);
    acc = l == 0 ? __fmul_rn(d, d) : __fmaf_rn(d, d, acc);
  }
  return __fsqrt_rn(acc);
}

// Words of shared memory an image needs (floats and ints, 4 bytes each),
// with cost rows of `cols` words.
inline size_t smem_words(int m, int l, int g, int cols) {
  return (size_t)m * cols + 2 * (size_t)g * l + g + (size_t)m * l + 2 * (size_t)m;
}

// Four consecutive floats of shared memory (16-byte aligned), as one vector
// access on the card.
__device__ __forceinline__ void load4(const float* at, float (&q)[4]) {
#ifdef __CUDA_ARCH__
  const float4 x = *reinterpret_cast<const float4*>(at);
  q[0] = x.x;
  q[1] = x.y;
  q[2] = x.z;
  q[3] = x.w;
#else
  for (int j = 0; j < 4; ++j) q[j] = at[j];
#endif
}

__device__ __forceinline__ void store4(float* at, const float (&q)[4]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(at) = make_float4(q[0], q[1], q[2], q[3]);
#else
  for (int j = 0; j < 4; ++j) at[j] = q[j];
#endif
}

// A lane's kSlots consecutive costs of a row, in vector loads on the card.
template <int kSlots>
__device__ __forceinline__ void load_slots(const float* at, float (&out)[kSlots]) {
#ifdef __CUDA_ARCH__
  if constexpr (kSlots % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kSlots; q += 4) {
      float x[4];
      load4(at + q, x);
      for (int j = 0; j < 4; ++j) out[q + j] = x[j];
    }
  } else if constexpr (kSlots == 2) {
    const float2 x = *reinterpret_cast<const float2*>(at);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    for (int k = 0; k < kSlots; ++k) out[k] = at[k];
  }
#else
  for (int k = 0; k < kSlots; ++k) out[k] = at[k];
#endif
}

template <int kCols>
__global__ void __launch_bounds__(MP_LANES)
    match_kernel(const float* __restrict__ val_k, const float* __restrict__ tag_k,
                 const float* __restrict__ ind_k, float* __restrict__ groups,
                 unsigned char* __restrict__ valid, int K, int M, int L, int G, float vis_thr,
                 float tag_thr, int flags, JointOrder order) {
  constexpr int kSlots = kCols / kLanes;  // the columns a lane owns: 1 + kSlots * lane + k
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int img = blockIdx.x;
  const int ncol = G + M;  // a cost row: G group columns, then M spawn columns
  const int C = ncol + 1;  // the LSAP's 1-based columns, with column 0
  const int F = 3 + L;     // a joint's row: x, y, score, tags

  float* cost = smem;              // [M, kCols]: a row's G + M columns, then padding
  float* gsum = cost + M * kCols;  // [G, L]
  float* gmean = gsum + G * L;     // [G, L], the live groups' this joint
  float* gcnt = gmean + G * L;     // [G]
  float* jtag = gcnt + G;          // [M, L]: this joint's candidates' tags
  int* assign = reinterpret_cast<int*>(jtag + M * L);  // [M]: the column of each row
  int* cand = assign + M;                          // [M]: kCandidate, kSpawn

  const float* val = val_k + (size_t)img * K * M;
  const float* tag = tag_k + (size_t)img * K * M * L;
  const float* ind = ind_k + (size_t)img * K * M * 2;
  float* out = groups + (size_t)img * G * K * F;

  prefetch_l1(val, K * M);
  prefetch_l1(tag, K * M * L);
  prefetch_l1(ind, K * M * 2);
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
      const float x = vj[m];
      for (int l = 0; l < L; ++l) jtag[m * L + l] = tj[m * L + l];
      cand[m] = x > vis_thr ? kCandidate : 0;
      any |= cand[m];
    }
    any = __any_sync(kFull, any);
    if (!any || ((flags & kIgnoreTooMuch) && n_groups >= M)) continue;  // nothing changes
    const int live = n_groups;
    for (int e = lane; e < live * L; e += kLanes)
      gmean[e] = __fdiv_rn(gsum[e], fmaxf(gcnt[e / L], 1.0f));
    __syncwarp();

    // the distances of the candidates to the live groups (entry e = m * live
    // + g: a lane steps kLanes entries at a time), and their largest
    const int step_m = live > 0 ? kLanes / live : 0, step_g = live > 0 ? kLanes % live : 0;
    float dmax = 0.0f;
#pragma unroll 4
    for (int e = lane, m = live > 0 ? lane / live : 0, g = live > 0 ? lane % live : 0;
         e < M * live; e += kLanes, m += step_m, g += step_g) {
      if (g >= live) {
        g -= live;
        ++m;
      }
      if (!cand[m]) continue;
      const float d = tag_distance(jtag + m * L, gmean + g * L, L);
      cost[m * kCols + g] = d;
      dmax = fmaxf(dmax, d);
    }
    dmax = warp_max_nonneg(dmax);
    const bool rounded = flags & kRoundedNorm;
    float eps = 0.0f;
    if (rounded) {
      eps = __fdiv_rn(0.5f, __fmul_rn((float)M, __fadd_rn(dmax, 1.0f)));
      // the largest rounded cost: round(d) + eps * d, rounded once, never
      // decreases with d, so it is the largest distance's
      dmax = __fmaf_rn(eps, dmax, rintf(dmax));
    }
    const float pad_c = __fadd_rn(__fmul_rn(dmax, 2.0f), 10.0f);   // a candidate's spawn cost
    const float inval = __fadd_rn(__fmul_rn(dmax, 4.0f), 100.0f);  // never chosen
    __syncwarp();
    // the whole cost, four columns at a time: the candidates' (rounded)
    // distances to the live groups, inval at the other group columns, the
    // spawn columns (the padding past G + M takes their value, unread)
    constexpr int kQuads = kCols / 4;
#pragma unroll 4
    for (int e = lane; e < M * kQuads; e += kLanes) {
      const int m = e / kQuads, c = (e % kQuads) * 4;
      const bool cm = cand[m] != 0;
      const float spawn = cm ? pad_c : 0.0f;
      float q[4];
      load4(cost + m * kCols + c, q);
      for (int j = 0; j < 4; ++j) {
        const float d = q[j];
        q[j] = c + j >= G ? spawn
               : !cm || c + j >= live ? inval
               : rounded ? __fmaf_rn(eps, d, rintf(d)) : d;
      }
      store4(cost + m * kCols + c, q);
    }
    __syncwarp();

    // the LSAP, row by row: Dijkstra over the reduced costs, then the
    // augmenting path. Lane l owns the columns c0 + k (k < kSlots), so the
    // first column of a minimum is the lowest lane's that holds it, at that
    // lane's lowest slot. uc is the potential u of the row on a column (p),
    // if any; a used column's minv is kInf, which is its masked value. The
    // scan has no branch: every slot computes, and selects keep what counts
    const int c0 = 1 + kSlots * lane;
    float uc[kSlots], v[kSlots], minv[kSlots];
    int p[kSlots], way[kSlots];  // way: (column << 16) | row it was reached from
    int state[kSlots];           // kAbsent (c0 + k >= C), kOpen or kUsed
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      uc[k] = 0.0f;
      v[k] = 0.0f;
      p[k] = 0;
    }
    for (int i1 = 1; i1 <= M; ++i1) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        minv[k] = kInf;
        way[k] = 0;
        state[k] = c0 + k < C ? kOpen : kAbsent;
      }
      float u1 = 0.0f, ui = 0.0f;  // u[i1]: no earlier pass has scanned row i1
      int reached = i1, off = (i1 - 1) * kCols;  // (column j0 << 16) | row i0, i0's row
      int j0 = 0;
      for (;;) {
        float row[kSlots];
        load_slots<kSlots>(cost + off + c0 - 1, row);
        unsigned best = UINT_MAX;  // the lane's first minimum key, at slot bk
        int bk = 0;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const float cur = __fsub_rn(__fsub_rn(row[k], ui), v[k]);
          const bool take = state[k] == kOpen && cur < minv[k];
          minv[k] = take ? cur : minv[k];
          way[k] = take ? reached : way[k];
          const unsigned key = state[k] != kAbsent ? order_key(minv[k]) : UINT_MAX;
          const bool lower = key < best;
          best = lower ? key : best;
          bk = lower ? k : bk;
        }
        // the lane's candidate, picked while the warp reduces
        float d_own = kInf, u_own = 0.0f;
        int p_own = 0;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          d_own = k == bk ? minv[k] : d_own;
          u_own = k == bk ? uc[k] : u_own;
          p_own = k == bk ? p[k] : p_own;
        }
        const int jp_own = ((c0 + bk) << 16) | p_own;
        const int off_own = (p_own - 1) * kCols;
        const unsigned lo = __reduce_min_sync(kFull, best);
        const int w = __ffs(__ballot_sync(kFull, best == lo)) - 1;  // the winner's lane
        const float delta = __shfl_sync(kFull, d_own, w);
        const float u_next = __shfl_sync(kFull, u_own, w);
        const int jp = __shfl_sync(kFull, jp_own, w);  // (column j1 << 16) | its row
        const int off_next = __shfl_sync(kFull, off_own, w);
        u1 = __fadd_rn(u1, delta);
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const bool used = state[k] == kUsed;  // the used columns' rows, each once
          uc[k] = used ? __fadd_rn(uc[k], delta) : uc[k];
          v[k] = used ? __fsub_rn(v[k], delta) : v[k];
          minv[k] = used ? minv[k] : __fsub_rn(minv[k], delta);
          const bool won = lane == w && k == bk;
          state[k] = won ? kUsed : state[k];
          minv[k] = won ? kInf : minv[k];
        }
        j0 = jp >> 16;
        if ((jp & 0xffff) == 0) break;
        reached = jp;
        ui = u_next;
        off = off_next;
      }
      // the augmenting path: each column on it takes the row (and its u)
      // of the column it was reached from; column 0 holds row i1
      while (j0 != 0) {
        const int jl = (unsigned)(j0 - 1) / kSlots, js = (unsigned)(j0 - 1) % kSlots;
        int w_own = 0;
#pragma unroll
        for (int k = 0; k < kSlots; ++k)
          if (k == js) w_own = way[k];
        const int wj = __shfl_sync(kFull, w_own, jl);
        const int j1 = wj >> 16;
        const int l1 = ((unsigned)(j1 - 1) / kSlots) & (kLanes - 1);
        const int s1 = (unsigned)(j1 - 1) % kSlots;
        float u_own = 0.0f;
#pragma unroll
        for (int k = 0; k < kSlots; ++k)
          if (k == s1) u_own = uc[k];
        float u_move = __shfl_sync(kFull, u_own, l1);
        if (j1 == 0) u_move = u1;
        if (lane == jl) {
#pragma unroll
          for (int k = 0; k < kSlots; ++k) {
            if (k == js) {
              p[k] = wj & 0xffff;
              uc[k] = u_move;
            }
          }
        }
        j0 = j1;
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if (c0 + k < C && p[k] > 0) assign[p[k] - 1] = c0 + k - 1;
    __syncwarp();

    // joins: each group receives at most one candidate, so lanes apply them at once
    for (int m = lane; m < M; m += kLanes) {
      if (!cand[m]) continue;
      const int a = assign[m];
      if (a < live && tag_distance(jtag + m * L, gmean + a * L, L) < tag_thr) {
        float* row = out + ((size_t)a * K + jidx) * F;
        row[0] = ij[m * 2];
        row[1] = ij[m * 2 + 1];
        row[2] = vj[m];
        for (int l = 0; l < L; ++l) {
          row[3 + l] = jtag[m * L + l];
          gsum[a * L + l] = __fadd_rn(gsum[a * L + l], jtag[m * L + l]);
        }
        gcnt[a] = __fadd_rn(gcnt[a], 1.0f);
      } else {
        cand[m] = kSpawn;
      }
    }
    __syncwarp();
    // spawns, in candidate order, up to the capacity: a spawn's group is the
    // count of spawns before it
    for (int base = 0; base < M; base += kLanes) {
      const int m = base + lane;
      const bool spawn = m < M && cand[m] == kSpawn;
      const unsigned spawns = __ballot_sync(kFull, spawn);
      const int gi = n_groups + __popc(spawns & ((1u << lane) - 1u));
      if (spawn && gi < G) {
        float* row = out + ((size_t)gi * K + jidx) * F;
        row[0] = ij[m * 2];
        row[1] = ij[m * 2 + 1];
        row[2] = vj[m];
        for (int l = 0; l < L; ++l) {
          row[3 + l] = jtag[m * L + l];
          gsum[gi * L + l] = jtag[m * L + l];
        }
        gcnt[gi] = 1.0f;
      }
      n_groups = min(G, n_groups + __popc(spawns));
    }
    __syncwarp();
  }
  for (int g = lane; g < G; g += kLanes) valid[(size_t)img * G + g] = g < n_groups;
}

// The least chain one LSAP iteration runs: a shared-memory load whose
// address depends on the last step, a warp min (redux.sync), a ballot of
// the lanes that hold it and a shuffle from the first of them.
__global__ void __launch_bounds__(MP_LANES) step_floor_kernel(int steps, int* out) {
  __shared__ unsigned ring[kLanes];
  const int lane = threadIdx.x;
  ring[lane] = (unsigned)(lane * 7 + steps) % kLanes;
  __syncwarp();
  unsigned at = lane;
  for (int s = 0; s < steps; ++s) {
    const unsigned x = ring[at] + lane;
    const unsigned lo = __reduce_min_sync(kFull, x);
    const unsigned hit = __ballot_sync(kFull, x == lo);
    at = (__shfl_sync(kFull, x, __ffs(hit) - 1) + lane) % kLanes;
  }
  out[lane] = (int)at;
}

}  // namespace

template <int kCols>
cudaError_t launch_match(const float* val_k, const float* tag_k, const float* ind_k,
                         float* groups, unsigned char* valid, int n, int k, int m, int l, int g,
                         const JointOrder& order, float vis_thr, float tag_thr, int flags,
                         cudaStream_t stream) {
  const size_t bytes = smem_words(m, l, g, kCols) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      match_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    match_kernel<kCols><<<n, kLanes, bytes, stream>>>(val_k, tag_k, ind_k, groups, valid, k, m,
                                                       l, g, vis_thr, tag_thr, flags, order);
  }
  return cudaGetLastError();
}

// Groups N images' candidates: val_k [N, K, M], tag_k [N, K, M, L], ind_k
// [N, K, M, 2] (float32, contiguous) -> groups [N, G, K, 3 + L] float32 and
// valid [N, G] (bytes 0 / 1). joint_order is a host array of n_order joint
// indices. Returns the CUDA error of the launch (0 on success): G + M + 1
// above 256 columns is refused, and sizes whose state exceeds a block's
// 227 KB of shared memory fail at the attribute.
extern "C" int mp_match_by_tag(const float* val_k, const float* tag_k, const float* ind_k,
                               float* groups, unsigned char* valid, int n, int k, int m, int l,
                               int g, const int* joint_order, int n_order, float vis_thr,
                               float tag_thr, int flags, cudaStream_t stream) {
  if (n_order > kMaxJoints || n_order < 0) return cudaErrorInvalidValue;
  JointOrder order;
  order.n = n_order;
  for (int i = 0; i < n_order; ++i) order.idx[i] = joint_order[i];
  const int cols = g + m + 1;
  if (cols <= 64)
    return launch_match<64>(val_k, tag_k, ind_k, groups, valid, n, k, m, l, g, order, vis_thr,
                            tag_thr, flags, stream);
  if (cols <= 128)
    return launch_match<128>(val_k, tag_k, ind_k, groups, valid, n, k, m, l, g, order, vis_thr,
                             tag_thr, flags, stream);
  if (cols <= 256)
    return launch_match<256>(val_k, tag_k, ind_k, groups, valid, n, k, m, l, g, order, vis_thr,
                             tag_thr, flags, stream);
  return cudaErrorInvalidValue;
}

// One warp runs `steps` links of step_floor_kernel's chain; out holds 32
// ints. Returns the CUDA error of the launch.
extern "C" int mp_grouping_step_floor(int steps, int* out, cudaStream_t stream) {
  step_floor_kernel<<<1, kLanes, 0, stream>>>(steps, out);
  return cudaGetLastError();
}
