"""The port's conv chain against the JAX package's, on the CPU.

On the CPU ``fused_conv_chain`` runs its plain version (per-layer
``F.conv2d`` + ReLU); the CUDA kernel itself is held against that plain
version on the card by chip_smoke.py. Here the same numpy inputs go through
the JAX Pallas kernel in interpret mode and through ``xla_conv_chain``.
float32 tolerances (rtol = atol = 1e-4, those of
tests/models/test_conv_chain_kernel.py) cover the two libraries' different
summation orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.ops.pallas.conv_chain import fused_conv_chain as jax_fused_conv_chain
from mindpose_tpu.ops.pallas.conv_chain import xla_conv_chain
from mindpose_tpu_torch.ops.cuda.conv_chain import (
    conv_chain_plain,
    conv_chain_route,
    fused_conv_chain,
    split_layers,
)


def _inputs(b, h, w, c, depth):
    rng = np.random.RandomState(0)
    x = rng.randn(b, h, w, c).astype(np.float32) * 0.5
    ws = rng.randn(depth, 3, 3, c, c).astype(np.float32) * 0.2
    return x, ws


@pytest.mark.parametrize("b,h,w,c,depth,strip", [
    (2, 8, 8, 8, 3, 4),  # test_conv_chain_kernel.py: test_parity_small
    (1, 16, 12, 4, 4, 4),  # test_parity_rect_multistrip: odd and even ping-pong
])
def test_matches_pallas_interpret_and_xla(b, h, w, c, depth, strip):
    x, ws = _inputs(b, h, w, c, depth)
    launches = fused_conv_chain.launches
    got = fused_conv_chain(torch.from_numpy(x), torch.from_numpy(ws)).numpy()
    assert fused_conv_chain.launches == launches  # the CPU runs no kernel
    pallas = jax_fused_conv_chain(jnp.asarray(x), jnp.asarray(ws), strip=strip, interpret=True)
    xla = xla_conv_chain(jnp.asarray(x), jnp.asarray(ws))
    assert np.abs(np.asarray(xla)).max() > 0.5
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-4, atol=1e-4)


def test_height_that_no_strip_divides():
    # the Pallas kernel refuses H % strip != 0; the port tiles any size
    x, ws = _inputs(2, 13, 7, 8, 3)
    got = fused_conv_chain(torch.from_numpy(x), torch.from_numpy(ws)).numpy()
    want = np.asarray(xla_conv_chain(jnp.asarray(x), jnp.asarray(ws)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_matches_xla():
    """bf16, depth 3, the probe's draws (inputs in [-1, 1], weights in [0, 0.1]).

    Both sides round every layer's output to bf16 (8 significand bits), and
    each sums in its own order and precision, so an element may land a bf16
    ulp away after each layer, and the next layer carries that on. The bound
    is one bf16 ulp of the largest output per layer: 3 * 2^-8 * max|xla|.
    """
    rng = np.random.RandomState(0)
    x = rng.rand(2, 12, 10, 16).astype(np.float32) * 2 - 1
    ws = rng.rand(3, 3, 3, 16, 16).astype(np.float32) * 0.1
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(ws, jnp.bfloat16)
    want = np.asarray(xla_conv_chain(xb, wb).astype(jnp.float32))
    got = fused_conv_chain(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
                           torch.from_numpy(np.array(wb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= 3 * 2.0**-8 * scale


def test_bf16_c64_matches_xla():
    """bf16 at C=64, the widest chain the tensor-core route takes; depth 2,
    He-scaled weights of random sign. Bound as in ``test_bf16_matches_xla``:
    one bf16 ulp of the largest output per layer, 2 * 2^-8 * max|xla|, with
    the ulp's upper end 2^-7 of a value allowed for the one element that may
    sit in the top binade."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 9, 7, 64).astype(np.float32)
    ws = (rng.randn(2, 3, 3, 64, 64) * np.sqrt(2.0 / (9 * 64))).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(ws, jnp.bfloat16)
    want = np.asarray(xla_conv_chain(xb, wb).astype(jnp.float32))
    got = fused_conv_chain(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
                           torch.from_numpy(np.array(wb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (1, 9, 7, 64)
    scale = np.abs(want).max()
    assert scale > 0.5
    assert np.abs(got.float().numpy() - want).max() <= 2 * 2.0**-7 * scale


@pytest.mark.parametrize("dtype,channels,route", [
    (torch.float32, 1, "cuda_core"),
    (torch.float32, 32, "cuda_core"),
    (torch.float32, 128, "cuda_core"),
    (torch.bfloat16, 1, "tensor_core"),
    (torch.bfloat16, 4, "tensor_core"),
    (torch.bfloat16, 17, "tensor_core"),
    (torch.bfloat16, 32, "tensor_core"),
    (torch.bfloat16, 64, "tensor_core"),
])
def test_route_is_chosen_by_dtype(dtype, channels, route):
    assert conv_chain_route(dtype, channels) == route


@pytest.mark.parametrize("dtype,channels", [
    (torch.bfloat16, 65), (torch.bfloat16, 128), (torch.bfloat16, 0), (torch.float16, 32)])
def test_route_refuses(dtype, channels):
    with pytest.raises(ValueError):
        conv_chain_route(dtype, channels)


def test_wide_bf16_chain_raises_on_every_device():
    # the route is checked before the device: a CPU call refuses what the GPU would
    with pytest.raises(ValueError, match="C <= 64"):
        fused_conv_chain(torch.zeros(1, 4, 4, 65, dtype=torch.bfloat16),
                         torch.zeros(1, 3, 3, 65, 65, dtype=torch.bfloat16))


@pytest.mark.parametrize("depth", range(1, 10))
@pytest.mark.parametrize("group", [1, 2, 3, 4])
def test_split_layers_covers_the_chain_in_order(depth, group):
    groups = split_layers(depth, group)
    firsts = np.cumsum((0,) + groups[:-1])
    # launch k runs layers firsts[k] .. firsts[k] + groups[k] - 1: together 0..L-1, in order
    layers = [layer for f, n in zip(firsts, groups) for layer in range(f, f + n)]
    assert layers == list(range(depth))
    assert all(n == group for n in groups[:-1]) and 1 <= groups[-1] <= group


def test_split_layers_refuses_empty_groups():
    with pytest.raises(ValueError):
        split_layers(0, 2)
    with pytest.raises(ValueError):
        split_layers(4, 0)


def test_plain_version_is_the_cpu_path():
    x, ws = _inputs(1, 5, 6, 4, 2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(ws)
    torch.testing.assert_close(fused_conv_chain(xt, wt), conv_chain_plain(xt, wt), rtol=0, atol=0)


@pytest.mark.parametrize("x_shape,w_shape,dtype,w_dtype,why", [
    ((2, 8, 8), (1, 3, 3, 8, 8), torch.float32, torch.float32, "want x"),
    ((1, 8, 8, 8), (3, 3, 8, 8), torch.float32, torch.float32, "want x"),
    ((1, 8, 8, 8), (1, 3, 3, 8, 4), torch.float32, torch.float32, "do not fit"),
    ((1, 8, 8, 8), (1, 5, 5, 8, 8), torch.float32, torch.float32, "do not fit"),
    ((1, 8, 8, 8), (0, 3, 3, 8, 8), torch.float32, torch.float32, "do not fit"),
    ((1, 8, 8, 8), (1, 3, 3, 8, 8), torch.float16, torch.float16, "float32 or bfloat16"),
    ((1, 8, 8, 8), (1, 3, 3, 8, 8), torch.bfloat16, torch.float32, "float32 or bfloat16"),
])
def test_checks_raise_value_error(x_shape, w_shape, dtype, w_dtype, why):
    with pytest.raises(ValueError, match=why):
        fused_conv_chain(torch.zeros(x_shape, dtype=dtype), torch.zeros(w_shape, dtype=w_dtype))


def test_non_contiguous_input_raises():
    x = torch.zeros(1, 8, 8, 8).permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv_chain(x, torch.zeros(1, 3, 3, 8, 8))


def test_probe_imports_on_the_cpu_and_refuses_to_time_it():
    from mindpose_tpu_torch.tools import ablate_conv_chain as probe

    assert probe.DEPTH == 8
    assert [g[1:] for g in probe.GEOMETRIES] == [
        (24, 128, 128, 32), (24, 256, 256, 32), (128, 64, 48, 32)]
    assert probe.DEFAULT_OUT.parent.name == "chiprun_out"
    with pytest.raises(ValueError, match="CUDA"):
        probe.run("cpu", 1, 4, 4, 4, np.random.RandomState(0), device=torch.device("cpu"))


def test_probe_bound_is_the_chains_compute():
    from mindpose_tpu_torch.tools import ablate_conv_chain as probe

    # depth 8, C=32: 57.98 GFLOP at 989 TFLOP/s; one pass over 25.17 MB each way takes a quarter
    for geometry, want in (((128, 64, 48, 32), 0.0586), ((24, 128, 128, 32), 0.0586),
                           ((24, 256, 256, 32), 0.2345)):
        ms, by = probe.bound(*geometry)
        assert by == "operations" and abs(ms - want) < 5e-5
    assert probe.bound(1, 64, 48, 1, depth=1)[1] == "bytes"
