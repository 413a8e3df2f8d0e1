"""The port's fixed-capacity tag matcher against the JAX package's, and its kernel's source.

``mindpose_tpu_torch/ops/grouping.py`` (numpy, the plain version) is held
to ``mindpose_tpu/ops/grouping.py:match_by_tag_device`` and
``match_by_tag_batch`` (jit on the CPU): groups and ``valid`` equal exactly,
bit for bit, on the cases of tests/utils/test_device_grouping.py
(separable tags, ``vis_thr``, far tags spawn, a batch), on seeded candidate
sets shaped like a decoder's (every joint's top-30 sorted, persons' tags
with noise, L = 1 and 2, the rounded norm on and off, ``ignore_too_much``
on and off), where more candidates pass ``vis_thr`` than the capacity
holds, and on tie-heavy sets (tags on a grid, no noise). XLA on the CPU
fuses two multiply-adds of the matcher, and the plain version's ``_fma`` is
pinned to what XLA computes there. The plain version counts its LSAP
iterations (``match_by_tag_batch.steps``), the length of the kernel's
dependent chain.

The CUDA kernel ``csrc/grouping.cu`` runs only on the card, where
chip_smoke.py holds it to the plain version bit for bit. Here its source is
built for the host at one lane (a C++ compiler, the warp intrinsics as
their one-lane identities) and held to the plain version on the same sets:
that pins its arithmetic, its order of operations and its control flow;
and at 32 lanes, each a fiber of one thread, which holds its cross-lane
steps; its argmin key is tested from the same build. The wrapper raises on
a CPU tensor and on sizes beyond its largest column bound.
"""
import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.ops.grouping import match_by_tag_batch as jax_batch
from mindpose_tpu.ops.grouping import match_by_tag_device as jax_device
from mindpose_tpu.utils.match import match_by_tag as jax_host
from mindpose_tpu_torch.ops import grouping
from mindpose_tpu_torch.ops.cuda import grouping as cuda_grouping
from mindpose_tpu_torch.utils.match import match_by_tag
from tests.fixtures.grouping_sets import ORDER, SETS, TIE_SETS, candidate_sets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "mindpose_tpu_torch", "csrc", "grouping.cu")


def _case(num_instances=3, k=5, m=8, tag_sep=4.0, seed=0):
    """tests/utils/test_device_grouping.py's separable case."""
    rng = np.random.RandomState(seed)
    val_k = np.zeros((k, m), np.float32)
    tag_k = np.zeros((k, m, 1), np.float32)
    ind_k = np.zeros((k, m, 2), np.float32)
    for j in range(k):
        for i in range(num_instances):
            val_k[j, i] = 0.5 + 0.4 * rng.rand()
            tag_k[j, i, 0] = i * tag_sep + rng.randn() * 0.05
            ind_k[j, i] = [10 * i + j, 20 * i + j]
    return val_k, tag_k, ind_k


# (use_rounded_norm, ignore_too_much): ignore_too_much acts once M groups
# exist, which the 40-person sets reach
FLAGS = [(True, False), (False, False), (True, True)]


def _assert_bitwise(got, want):
    (g_groups, g_valid), (w_groups, w_valid) = got, want
    np.testing.assert_array_equal(g_valid, np.asarray(w_valid))
    w_groups = np.asarray(w_groups)
    assert g_groups.dtype == w_groups.dtype == np.float32
    np.testing.assert_array_equal(g_groups.view(np.int32), w_groups.view(np.int32))


# ------------------------------------------- tests/utils/test_device_grouping.py


def test_separable_case_equals_jax_and_the_host_matcher():
    val_k, tag_k, ind_k = _case()
    got = grouping.match_by_tag_device(val_k, tag_k, ind_k, list(range(5)), vis_thr=0.1)
    _assert_bitwise(got, jax_device(val_k, tag_k, ind_k, tuple(range(5)), vis_thr=0.1))
    host = match_by_tag(val_k, tag_k, ind_k, list(range(5)), vis_thr=0.1)
    np.testing.assert_array_equal(host, jax_host(val_k, tag_k, ind_k, list(range(5)),
                                                 vis_thr=0.1))
    dev = got[0][got[1]]
    assert dev.shape == host.shape == (3, 5, 4)

    def canon(groups):
        return groups[np.argsort([g[g[:, 2] > 0, 3].mean() for g in groups])]

    np.testing.assert_allclose(canon(dev), canon(host), atol=1e-5)


def test_vis_thr_leaves_an_invisible_joint_empty():
    val_k, tag_k, ind_k = _case(num_instances=2)
    val_k[2, :] = 0.0
    got = grouping.match_by_tag_device(val_k, tag_k, ind_k, list(range(5)), vis_thr=0.1)
    _assert_bitwise(got, jax_device(val_k, tag_k, ind_k, tuple(range(5)), vis_thr=0.1))
    dev = got[0][got[1]]
    assert len(dev) == 2 and (dev[:, 2, 2] == 0).all()


def test_far_tags_spawn_and_a_near_tag_joins():
    val_k = np.zeros((2, 4), np.float32)
    tag_k = np.zeros((2, 4, 1), np.float32)
    ind_k = np.zeros((2, 4, 2), np.float32)
    val_k[0, 0] = val_k[0, 1] = 0.9
    tag_k[0, 1, 0] = 10.0
    val_k[1, 0] = 0.8
    tag_k[1, 0, 0] = 0.1
    got = grouping.match_by_tag_device(val_k, tag_k, ind_k, (0, 1), vis_thr=0.1, tag_thr=1.0)
    _assert_bitwise(got, jax_device(val_k, tag_k, ind_k, (0, 1), vis_thr=0.1, tag_thr=1.0))
    dev = got[0][got[1]]
    assert len(dev) == 2
    assert dev[np.argmin([g[0, 3] for g in dev])][1, 2] > 0


def test_batch_equals_jax_batch():
    val_k, tag_k, ind_k = _case()
    other = _case(num_instances=4, seed=1)
    batch = [np.stack(pair) for pair in zip((val_k, tag_k, ind_k), other)]
    got = grouping.match_by_tag_batch(*batch, joint_order=list(range(5)))
    assert got[0].shape == (2, 8, 5, 4) and got[1].shape == (2, 8)
    _assert_bitwise(got, jax_batch(*batch, joint_order=list(range(5))))


# -------------------------------------------------------- seeded candidate sets


@pytest.mark.parametrize("tag_dim", [1, 2])
@pytest.mark.parametrize("rounded,ignore", FLAGS)
def test_seeded_sets_equal_jax_bitwise(tag_dim, rounded, ignore):
    """4 images of each of ``SETS``: groups and valid equal JAX's bit for bit
    (JAX's per-image function, compiled once per capacity; the batch
    function is the same under ``vmap``, held by the test above)."""
    rng = np.random.RandomState(100 * tag_dim + 10 * rounded + ignore)
    for name, kwargs, cap in SETS:
        val_k, tag_k, ind_k = candidate_sets(rng, 4, tag_dim=tag_dim, **kwargs)
        kw = dict(vis_thr=0.1, tag_thr=1.0, use_rounded_norm=rounded, ignore_too_much=ignore,
                  group_cap=cap)
        got = grouping.match_by_tag_batch(val_k, tag_k, ind_k, ORDER, **kw)
        if cap:  # more candidates than groups: the capacity caps the spawns
            assert got[1].all(), name
        want = [jax_device(v, t, i, tuple(ORDER), **kw) for v, t, i in zip(val_k, tag_k, ind_k)]
        _assert_bitwise(got, (np.stack([np.asarray(g) for g, _ in want]),
                              np.stack([np.asarray(v) for _, v in want])))


def test_empty_batch():
    groups, valid = grouping.match_by_tag_batch(np.zeros((0, 17, 30)), np.zeros((0, 17, 30, 2)),
                                                np.zeros((0, 17, 30, 2)), ORDER)
    assert groups.shape == (0, 30, 17, 5) and valid.shape == (0, 30)


def test_fma_is_what_xla_computes_on_the_cpu():
    """The two multiply-adds XLA fuses in the matcher, over 200,000 values."""
    rng = np.random.RandomState(7)
    d = rng.uniform(0, 20, 200_000).astype(np.float32)
    eps = np.float32(0.5) / (np.float32(30) * (d.max() + np.float32(1)))
    want = np.asarray(jax.jit(lambda d, e: jnp.round(d) + e * d)(d, eps))
    np.testing.assert_array_equal(grouping._fma(eps, d, np.round(d)), want)
    assert not np.array_equal(np.round(d) + eps * d, want)  # a separate rounding differs
    t = rng.normal(0, 3, (200_000, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda t: jnp.sum(t * t, axis=1))(t))
    np.testing.assert_array_equal(grouping._fma(t[:, 1], t[:, 1], t[:, 0] * t[:, 0]), want)


# ------------------------------------------------------------------ the kernel


def test_wrapper_takes_cuda_tensors_only():
    val_k, tag_k, ind_k = (torch.from_numpy(a[None]) for a in _case())
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_grouping.match_by_tag_batch(val_k, tag_k, ind_k, list(range(5)))
    assert cuda_grouping.match_by_tag_batch.launches == 0


@pytest.mark.parametrize("m,cap", [(128, 0), (200, 60)])
def test_wrapper_refuses_sizes_beyond_the_largest_column_bound(m, cap):
    """G + M + 1 above 256 columns: no kernel is compiled for it, and no
    fallback takes it."""
    val_k, tag_k, ind_k = (torch.zeros(shape) for shape in ((1, 2, m), (1, 2, m, 1),
                                                             (1, 2, m, 2)))
    with pytest.raises(ValueError, match="256 columns"):
        cuda_grouping.match_by_tag_batch(val_k, tag_k, ind_k, [0, 1], group_cap=cap)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_grouping.step_floor(torch.zeros(32, dtype=torch.int32), 10)
    assert cuda_grouping.match_by_tag_batch.launches == cuda_grouping.step_floor.launches == 0


def test_plain_version_counts_its_lsap_iterations():
    """``match_by_tag_batch.steps``, the length of the kernel's dependent
    chain, on 2 images of each kind of ``SETS``, each kind drawn from a fresh
    ``RandomState(0)`` (chip_smoke.py's phase 16 draws 32 of each so, and
    counts 4338.4, 2817.8, 2121.1 and 6930.8 an image)."""
    counts = []
    for name, kwargs, cap in SETS:
        sets = candidate_sets(np.random.RandomState(0), 2, **kwargs)
        grouping.match_by_tag_batch.steps = 0
        grouping.match_by_tag_batch(*sets, ORDER, group_cap=cap)
        counts.append(grouping.match_by_tag_batch.steps)
    assert counts == [8478, 5397, 4234, 13259]
    # the counter adds each image's iterations, whichever entry runs it
    grouping.match_by_tag_batch.steps = 0
    for image in zip(*sets):
        grouping.match_by_tag_device(*image, ORDER, group_cap=SETS[-1][2])
    assert grouping.match_by_tag_batch.steps == counts[-1]


def test_tie_sets_equal_jax_batch_bitwise():
    """Tags on a grid with no noise: costs, rounded costs and reduced costs
    tie exactly, and JAX's first-index argmin decides; the plain version
    takes the same decisions (JAX's vmapped batch function on 4 images of
    each kind of ``TIE_SETS`` in one batch, compiled once)."""
    rng = np.random.RandomState(400)
    sets = [np.concatenate(arrays) for arrays in zip(
        *(candidate_sets(rng, 4, **kwargs) for _, kwargs, _ in TIE_SETS))]
    assert all(cap == 0 for _, _, cap in TIE_SETS)
    got = grouping.match_by_tag_batch(*sets, ORDER)
    _assert_bitwise(got, jax_batch(*sets, joint_order=ORDER))


HOST_COMMON = r"""
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
struct MpDim { unsigned x; };
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline unsigned __float_as_uint(float x) {
  unsigned b;
  std::memcpy(&b, &x, sizeof b);
  return b;
}
inline float __uint_as_float(unsigned b) {
  float x;
  std::memcpy(&x, &b, sizeof x);
  return x;
}
using std::min;
namespace { float smem[1 << 20]; }
"""
# one lane: the warp intrinsics are their one-lane identities, and a block
# runs its lane in place
HOST_SHIM = HOST_COMMON + r"""
static MpDim threadIdx = {0}, blockIdx = {0};
template <class T> inline T __shfl_down_sync(unsigned, T v, int) { return v; }
template <class T> inline T __shfl_sync(unsigned, T v, int) { return v; }
inline int __any_sync(unsigned, int v) { return v != 0; }
inline unsigned __reduce_min_sync(unsigned, unsigned v) { return v; }
inline unsigned __reduce_max_sync(unsigned, unsigned v) { return v; }
inline unsigned __ballot_sync(unsigned, int v) { return v != 0; }
inline void __syncwarp() {}
template <class F> void mp_block(F f) { f(); }
#define MP_LANES 1
"""
# 32 lanes as 32 fibers of one thread (ucontext): each runs to its next warp
# intrinsic and posts its value; once all have posted, the scheduler keeps a
# copy of the posts and resumes them in lane order, each reading the copy
WARP_SHIM = HOST_COMMON + r"""
#include <ucontext.h>
#include <vector>
static MpDim threadIdx = {0}, blockIdx = {0};
static ucontext_t mp_main, mp_lane[32];
static unsigned long long mp_post[32], mp_seen[32];
static bool mp_finished[32];
static void* mp_body;
template <class T> unsigned long long mp_bits(T v) {
  unsigned long long b = 0;
  std::memcpy(&b, &v, sizeof v);
  return b;
}
template <class T> T mp_value(unsigned long long b) {
  T v;
  std::memcpy(&v, &b, sizeof v);
  return v;
}
template <class F> auto mp_exchange(unsigned long long mine, F read) {
  const unsigned me = threadIdx.x;
  mp_post[me] = mine;
  swapcontext(&mp_lane[me], &mp_main);
  return read();
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  return mp_exchange(mp_bits(v), [&] { return mp_value<T>(mp_seen[src & 31]); });
}
template <class T> T __shfl_down_sync(unsigned, T v, int offset) {
  const unsigned src = threadIdx.x + offset;
  return mp_exchange(mp_bits(v), [&] { return src < 32 ? mp_value<T>(mp_seen[src]) : v; });
}
inline unsigned __ballot_sync(unsigned, int v) {
  return mp_exchange(v != 0, [] {
    unsigned bits = 0;
    for (int i = 0; i < 32; ++i) bits |= (unsigned)mp_seen[i] << i;
    return bits;
  });
}
inline int __any_sync(unsigned mask, int v) { return __ballot_sync(mask, v) != 0; }
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return mp_exchange(v, [] {
    unsigned lo = UINT_MAX;
    for (int i = 0; i < 32; ++i) lo = std::min(lo, (unsigned)mp_seen[i]);
    return lo;
  });
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return mp_exchange(v, [] {
    unsigned hi = 0;
    for (int i = 0; i < 32; ++i) hi = std::max(hi, (unsigned)mp_seen[i]);
    return hi;
  });
}
inline void __syncwarp() { mp_exchange(0, [] { return 0; }); }
template <class F> void mp_lane_main() {
  (*static_cast<F*>(mp_body))();
  mp_finished[threadIdx.x] = true;
}
template <class F> void mp_block(F f) {
  static std::vector<char> stacks(32 << 18);
  mp_body = &f;
  for (int t = 0; t < 32; ++t) {
    getcontext(&mp_lane[t]);
    mp_lane[t].uc_stack.ss_sp = stacks.data() + ((size_t)t << 18);
    mp_lane[t].uc_stack.ss_size = 1 << 18;
    mp_lane[t].uc_link = &mp_main;
    makecontext(&mp_lane[t], mp_lane_main<F>, 0);
    mp_finished[t] = false;
  }
  for (bool running = true; running;) {
    for (unsigned t = 0; t < 32; ++t) {
      threadIdx.x = t;
      swapcontext(&mp_main, &mp_lane[t]);
    }
    running = false;
    for (int t = 0; t < 32; ++t) running = running || !mp_finished[t];
    std::memcpy(mp_seen, mp_post, sizeof mp_seen);
  }
}
#define MP_LANES 32
"""
HOST_RUN = r"""
extern "C" void host_match(const float* val_k, const float* tag_k, const float* ind_k,
                           float* groups, unsigned char* valid, int n, int k, int m, int l,
                           int g, const int* joint_order, int n_order, float vis_thr,
                           float tag_thr, int flags) {
  JointOrder order;
  order.n = n_order;
  for (int i = 0; i < n_order; ++i) order.idx[i] = joint_order[i];
  const int cols = g + m + 1;  // the launch's choice of column bound
  for (int b = 0; b < n; ++b) {
    blockIdx.x = b;
    mp_block([&] {
      if (cols <= 64)
        match_kernel<64>(val_k, tag_k, ind_k, groups, valid, k, m, l, g, vis_thr, tag_thr,
                         flags, order);
      else if (cols <= 128)
        match_kernel<128>(val_k, tag_k, ind_k, groups, valid, k, m, l, g, vis_thr, tag_thr,
                          flags, order);
      else
        match_kernel<256>(val_k, tag_k, ind_k, groups, valid, k, m, l, g, vis_thr, tag_thr,
                          flags, order);
    });
  }
}
extern "C" unsigned host_order_key(float x) { return order_key(x); }
extern "C" float host_key_value(unsigned key) { return key_value(key); }
"""


def _build_for_host(tmp_path_factory, shim: str, name: str, *flags: str):
    """csrc/grouping.cu's kernel built for the host: the source up to its C
    launch function, with ``shim`` in place of the CUDA headers; returns a
    function of ``ops/grouping.match_by_tag_batch``'s signature."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel's source for the host")
    with open(SOURCE) as f:
        text = f.read()
    end = "}  // namespace"
    body = text[:text.index(end) + len(end)].replace("#include <cuda_runtime.h>", "")
    out = tmp_path_factory.mktemp(name)
    src, lib = out / f"{name}.cpp", out / f"lib{name}.so"
    src.write_text(shim + body + HOST_RUN)
    subprocess.run([cxx, *flags, "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(lib), str(src)], check=True, capture_output=True, timeout=300)
    built = ctypes.CDLL(str(lib))
    fn = built.host_match
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_float] * 2 + [ctypes.c_int])
    built.host_order_key.argtypes = [ctypes.c_float]
    built.host_order_key.restype = ctypes.c_uint
    built.host_key_value.argtypes = [ctypes.c_uint]
    built.host_key_value.restype = ctypes.c_float

    def run(val_k, tag_k, ind_k, joint_order, vis_thr=0.1, tag_thr=1.0, use_rounded_norm=True,
            ignore_too_much=False, group_cap=0):
        n, k, m = val_k.shape
        tag_dim = tag_k.shape[3]
        g = group_cap or m
        arrays = [np.ascontiguousarray(a, np.float32) for a in (val_k, tag_k, ind_k)]
        groups = np.full((n, g, k, 3 + tag_dim), np.nan, np.float32)
        valid = np.full((n, g), 7, np.uint8)
        order = (ctypes.c_int * len(joint_order))(*joint_order)
        flags = (1 if use_rounded_norm else 0) | (2 if ignore_too_much else 0)
        fn(*(a.ctypes.data for a in arrays), groups.ctypes.data, valid.ctypes.data, n, k, m,
           tag_dim, g, order, len(joint_order), vis_thr, tag_thr, flags)
        assert set(np.unique(valid)) <= {0, 1}
        return groups, valid.astype(bool)

    run.order_key = built.host_order_key
    run.key_value = built.host_key_value
    return run


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's source built for the host at one lane: the same steps in order."""
    return _build_for_host(tmp_path_factory, HOST_SHIM, "grouping_host", "-std=c++17")


@pytest.fixture(scope="module")
def warp_kernel(tmp_path_factory):
    """The kernel's source built for the host at 32 lanes, a fiber each: its
    cross-lane steps (the ballot's tie-break, the shuffles along the
    augmenting path, the spawns' ranks) as on the card."""
    return _build_for_host(tmp_path_factory, WARP_SHIM, "grouping_warp", "-std=c++17")


@pytest.mark.parametrize("tag_dim", [1, 2])
@pytest.mark.parametrize("rounded,ignore", FLAGS)
def test_kernel_source_at_one_lane_equals_plain_bitwise(host_kernel, tag_dim, rounded, ignore):
    rng = np.random.RandomState(200 + 100 * tag_dim + 10 * rounded + ignore)
    for name, kwargs, cap in SETS:
        val_k, tag_k, ind_k = candidate_sets(rng, 4, tag_dim=tag_dim, **kwargs)
        kw = dict(vis_thr=0.1, tag_thr=1.0, use_rounded_norm=rounded, ignore_too_much=ignore,
                  group_cap=cap)
        _assert_bitwise(host_kernel(val_k, tag_k, ind_k, ORDER, **kw),
                        grouping.match_by_tag_batch(val_k, tag_k, ind_k, ORDER, **kw))


def test_kernel_source_at_one_lane_on_the_separable_cases(host_kernel):
    for case in (_case(), _case(num_instances=4, seed=1)):
        batch = [a[None] for a in case]
        _assert_bitwise(host_kernel(*batch, list(range(5))),
                        grouping.match_by_tag_batch(*batch, list(range(5))))


@pytest.mark.parametrize("tag_dim", [1, 2])
@pytest.mark.parametrize("rounded,ignore", FLAGS)
def test_kernel_source_at_one_lane_on_the_tie_sets(host_kernel, tag_dim, rounded, ignore):
    rng = np.random.RandomState(500 + 100 * tag_dim + 10 * rounded + ignore)
    for name, kwargs, cap in TIE_SETS:
        val_k, tag_k, ind_k = candidate_sets(rng, 4, tag_dim=tag_dim, **kwargs)
        kw = dict(vis_thr=0.1, tag_thr=1.0, use_rounded_norm=rounded, ignore_too_much=ignore,
                  group_cap=cap)
        _assert_bitwise(host_kernel(val_k, tag_k, ind_k, ORDER, **kw),
                        grouping.match_by_tag_batch(val_k, tag_k, ind_k, ORDER, **kw))


@pytest.mark.parametrize("m,cap", [(48, 0), (100, 40)])
def test_kernel_source_at_one_lane_at_the_wider_column_bounds(host_kernel, m, cap):
    """G + M + 1 = 97 and 141 columns: the kernel's 128- and 256-column builds."""
    sets = candidate_sets(np.random.RandomState(m), 1, m=m, tag_dim=2, persons=12,
                          visible=0.5)
    _assert_bitwise(host_kernel(*sets, ORDER, group_cap=cap),
                    grouping.match_by_tag_batch(*sets, ORDER, group_cap=cap))


def test_order_key_orders_as_floats_and_merges_the_zeros(host_kernel):
    """The kernel's argmin key (``order_key``, built from the source for the
    host): it orders as float comparison does, -0.0 and +0.0 share one key
    (jnp.argmin takes the first of them), and ``key_value`` undoes it, but
    for the sign of a zero."""
    f32 = np.finfo(np.float32)
    tiny = np.float32(f32.smallest_subnormal)
    special = np.array([-f32.max, -1e30, -3.5, -1.0, -f32.tiny, -tiny, -0.0, 0.0, tiny,
                        2 * tiny, f32.tiny, 1e-30, 0.5, 1.0, 1e30, f32.max, np.inf, -np.inf],
                       np.float32)
    rng = np.random.RandomState(11)
    bits = rng.randint(0, 2 ** 32, 200, dtype=np.uint64).astype(np.uint32).view(np.float32)
    values = np.concatenate([special, bits[np.isfinite(bits)]])
    keys = np.array([host_kernel.order_key(float(x)) for x in values], np.uint64)
    assert host_kernel.order_key(-0.0) == host_kernel.order_key(0.0)
    np.testing.assert_array_equal(keys[:, None] < keys[None, :],
                                  values[:, None] < values[None, :])
    np.testing.assert_array_equal(keys[:, None] == keys[None, :],
                                  values[:, None] == values[None, :])
    back = np.array([host_kernel.key_value(int(k)) for k in keys], np.float32)
    want = np.where(values == 0, np.float32(0.0), values)  # -0.0 comes back as +0.0
    np.testing.assert_array_equal(back.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name,kwargs,cap", TIE_SETS, ids=[name for name, _, _ in TIE_SETS])
def test_kernel_source_at_32_lanes_equals_plain_bitwise(warp_kernel, name, kwargs, cap):
    """One image of each tie-heavy kind, L = 2: the first-column tie-break
    across lanes decides on these (with the last lane's instead, both
    differ)."""
    sets = candidate_sets(np.random.RandomState(600), 1, tag_dim=2, **kwargs)
    _assert_bitwise(warp_kernel(*sets, ORDER, group_cap=cap),
                    grouping.match_by_tag_batch(*sets, ORDER, group_cap=cap))
