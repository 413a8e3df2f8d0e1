"""Port's heatmap decode against the JAX package's, exactly.

The port's plain decode (what ``argmax_shift_decode`` runs for a CPU tensor,
and what chip_smoke.py holds the CUDA kernel to, bit for bit) must equal the
Pallas kernel run in interpret mode and the XLA path (``argmax_coords`` +
``quarter_offset``) with tolerance 0: the argmax is an index, and the shift
is a sum of an integer and +-0.25, both exact in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.models.decoders.top_down_decoder import TopDownHeatMapDecoder as JaxDecoder
from mindpose_tpu.ops.heatmap import argmax_coords as jax_argmax_coords
from mindpose_tpu.ops.heatmap import quarter_offset as jax_quarter_offset
from mindpose_tpu.ops.pallas.decode import argmax_shift_decode as pallas_decode
from mindpose_tpu_torch.models import create_decoder
from mindpose_tpu_torch.ops.cuda.decode import argmax_shift_decode, argmax_shift_decode_plain
from mindpose_tpu_torch.ops.heatmap import argmax_coords, quarter_offset


def _heatmap(case: str) -> np.ndarray:
    """NCHW float32 heatmaps with planted ties, constant rows and border maxima."""
    rng = np.random.RandomState(0)
    if case == "random":
        return rng.randn(3, 5, 8, 6).astype(np.float32)
    if case == "ties":
        # few distinct values: most rows tie at their maximum
        return rng.randint(0, 3, (3, 5, 8, 6)).astype(np.float32)
    if case == "constant":
        hm = np.ones((2, 4, 8, 6), np.float32) * np.arange(4, dtype=np.float32)[None, :, None, None]
        hm[1, 0] = -np.inf
        return hm
    if case == "border":
        hm = rng.uniform(0.0, 0.5, (1, 8, 8, 6)).astype(np.float32)
        spots = [(0, 0), (0, 5), (7, 0), (7, 5), (0, 3), (7, 2), (4, 0), (3, 5)]
        for k, (y, x) in enumerate(spots):
            hm[0, k, y, x] = 1.0
        return hm
    if case == "nan_taps":
        # a NaN is the maximum (the first one wins) and a second NaN is its
        # right or lower tap; -inf on every side of an interior maximum makes
        # right - left NaN as well: the shifted coordinate is then NaN
        hm = rng.randn(1, 4, 8, 6).astype(np.float32)
        hm[0, 0, 3, 2] = hm[0, 0, 3, 3] = np.nan
        hm[0, 1, 2, 4] = hm[0, 1, 3, 4] = np.nan
        hm[0, 2] = -np.inf
        hm[0, 2, 4, 3] = 1.0
        return hm
    shape = {"tiny_1x1": (2, 3, 1, 1), "tiny_1x5": (2, 3, 1, 5),
             "tiny_5x1": (2, 3, 5, 1), "tiny_2x2": (1, 2, 2, 2)}[case]
    return rng.randn(*shape).astype(np.float32)


CASES = ["random", "ties", "constant", "border", "tiny_1x1", "tiny_1x5", "tiny_5x1", "tiny_2x2"]
# The Pallas kernel finds the maximum's index with ``x >= max``, which no
# element meets when the row's max is NaN, so rows holding NaN are held to
# the XLA path only (whose argmax, like torch's, takes the first NaN).
NAN_CASES = ["nan_taps"]


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_decode_equals_pallas_interpret(case, shift):
    hm = _heatmap(case)
    n, k, h, w = hm.shape
    want_c, want_m = pallas_decode(jnp.asarray(hm.transpose(0, 2, 3, 1)), h, w,
                                   shift=shift, interpret=True)
    got_c, got_m = argmax_shift_decode(torch.from_numpy(hm), shift)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("case", CASES + NAN_CASES)
def test_plain_decode_equals_xla_path(case, shift):
    hm = _heatmap(case)
    nhwc = jnp.asarray(hm.transpose(0, 2, 3, 1))
    want_c, want_m, want_idx = jax_argmax_coords(nhwc)
    if shift:
        want_c = jax_quarter_offset(nhwc, want_c, want_idx)

    t = torch.from_numpy(hm)
    coords, maxvals, idx = argmax_coords(t)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    if shift:
        coords = quarter_offset(t, coords, idx)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(maxvals.numpy(), np.asarray(want_m))
    plain_c, plain_m = argmax_shift_decode_plain(t, shift)
    np.testing.assert_array_equal(plain_c.numpy(), coords.numpy())
    np.testing.assert_array_equal(plain_m.numpy(), maxvals.numpy())


def test_cpu_tensor_takes_the_plain_version_without_a_launch():
    before = argmax_shift_decode.launches
    argmax_shift_decode(torch.from_numpy(_heatmap("random")), True)
    assert argmax_shift_decode.launches == before


@pytest.mark.parametrize("bad", [
    torch.zeros(2, 3, 4, 5, dtype=torch.float64),
    torch.zeros(3, 4, 5),
    torch.zeros(2, 3, 0, 5),
    torch.zeros(2, 3, 4, 5, device="meta"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        argmax_shift_decode(bad, False)


@pytest.mark.parametrize("setting", [
    {}, {"shift_coordinate": True}, {"use_udp": True}, {"to_original": False},
    {"shift_coordinate": True, "backend": "pallas"},
])
def test_decoder_matches_jax_decoder(setting):
    rng = np.random.RandomState(4)
    hm = rng.randn(6, 17, 64, 48).astype(np.float32)
    center = rng.uniform(0, 600, (6, 2)).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, (6, 2)).astype(np.float32)
    score = rng.uniform(0, 1, 6).astype(np.float32)
    want_p, want_b = JaxDecoder(**setting)(jnp.asarray(hm.transpose(0, 2, 3, 1)), center, scale, score)
    # ``backend`` has no effect in the port: the heatmap's device picks the decode
    got_p, got_b = create_decoder("topdown_heatmap", **setting)(
        torch.from_numpy(hm), torch.from_numpy(center), torch.from_numpy(scale),
        torch.from_numpy(score))
    # same float32 formula; a fused multiply-add in one library may move the last bit
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-4)


def test_decoder_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_decoder("topdown_heatmap", dark_udp_refine=True)
    with pytest.raises(ValueError):
        create_decoder("topdown_heatmap", dark_udp_refine=True, shift_coordinate=True)
