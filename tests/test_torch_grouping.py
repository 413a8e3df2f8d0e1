"""The port's fixed-capacity tag matcher against the JAX package's, and its kernel's source.

``mindpose_tpu_torch/ops/grouping.py`` (numpy, the plain version) is held
to ``mindpose_tpu/ops/grouping.py:match_by_tag_device`` and
``match_by_tag_batch`` (jit on the CPU): groups and ``valid`` equal exactly,
bit for bit, on the cases of tests/utils/test_device_grouping.py
(separable tags, ``vis_thr``, far tags spawn, a batch), on seeded candidate
sets shaped like a decoder's (every joint's top-30 sorted, persons' tags
with noise, L = 1 and 2, the rounded norm on and off, ``ignore_too_much``
on and off), and where more candidates pass ``vis_thr`` than the capacity
holds. XLA on the CPU fuses two multiply-adds of the matcher, and the plain
version's ``_fma`` is pinned to what XLA computes there.

The CUDA kernel ``csrc/grouping.cu`` runs only on the card, where
chip_smoke.py holds it to the plain version bit for bit. Here its source is
built for the host at one lane (a C++ compiler, the warp intrinsics as
their one-lane identities) and held to the plain version on the same sets:
that pins its arithmetic, its order of operations and its control flow. The
wrapper raises on a CPU tensor.
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
from tests.fixtures.grouping_sets import ORDER, SETS, candidate_sets

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


HOST_SHIM = r"""
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
struct MpDim { unsigned x; };
static MpDim threadIdx = {0}, blockIdx = {0};
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
template <class T> inline T __shfl_down_sync(unsigned, T v, int) { return v; }
template <class T> inline T __shfl_sync(unsigned, T v, int) { return v; }
inline int __any_sync(unsigned, int v) { return v != 0; }
inline void __syncwarp() {}
using std::min;
namespace { float smem[1 << 20]; }
#define MP_LANES 1
"""
HOST_RUN = r"""
extern "C" void host_match(const float* val_k, const float* tag_k, const float* ind_k,
                           float* groups, unsigned char* valid, int n, int k, int m, int l,
                           int g, const int* joint_order, int n_order, float vis_thr,
                           float tag_thr, int flags) {
  JointOrder order;
  order.n = n_order;
  for (int i = 0; i < n_order; ++i) order.idx[i] = joint_order[i];
  for (int b = 0; b < n; ++b) {
    blockIdx.x = b;
    match_kernel(val_k, tag_k, ind_k, groups, valid, k, m, l, g, vis_thr, tag_thr, flags, order);
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/grouping.cu's kernel built for the host at one lane: the source up to
    its C launch function, with the shim above in place of the CUDA headers."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel's source for the host")
    with open(SOURCE) as f:
        text = f.read()
    end = "}  // namespace"
    body = text[:text.index(end) + len(end)].replace("#include <cuda_runtime.h>", "")
    out = tmp_path_factory.mktemp("grouping_host")
    src, lib = out / "grouping_host.cpp", out / "libgrouping_host.so"
    src.write_text(HOST_SHIM + body + HOST_RUN)
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(lib), str(src)], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).host_match
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_float] * 2 + [ctypes.c_int])

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

    return run


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
