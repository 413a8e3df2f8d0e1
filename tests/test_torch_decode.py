"""Port's heatmap decode against the JAX package's, exactly.

The port's plain decode (what ``argmax_shift_decode`` runs for a CPU tensor,
and what chip_smoke.py holds the CUDA kernel to, bit for bit) must equal the
Pallas kernel run in interpret mode and the XLA path (``argmax_coords`` +
``quarter_offset``) with tolerance 0: the argmax is an index, and the shift
is a sum of an integer and +-0.25, both exact in float32.

The fused decode (``decode_heatmap``: the whole decoder in one launch on the
card) keeps as its plain version the decoder's composition of small ops: it
is held to the JAX decoder at that decoder's tolerance, and bit for bit on
the CPU to the composition it replaced.

DARK/UDP refinement (plain PyTorch after the kernel's argmax, as plain XLA
in JAX) is held to the JAX package's on heatmaps of Gaussian peaks, peaks
on the border and flat maps: the refined coordinates within 1e-4 px.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mindpose_tpu.models.decoders.top_down_decoder import TopDownHeatMapDecoder as JaxDecoder
from mindpose_tpu.ops.heatmap import argmax_coords as jax_argmax_coords
from mindpose_tpu.ops.heatmap import dark_udp_refine as jax_dark_udp_refine
from mindpose_tpu.ops.heatmap import quarter_offset as jax_quarter_offset
from mindpose_tpu.ops.pallas.decode import argmax_shift_decode as pallas_decode
from mindpose_tpu_torch.data.transform import box_to_center_scale
from mindpose_tpu_torch.models import create_decoder
from mindpose_tpu_torch.models.decoders import top_down_decoder
from mindpose_tpu_torch.ops.cuda.decode import (
    argmax_shift_decode,
    argmax_shift_decode_plain,
    decode_heatmap,
    decode_heatmap_plain,
)
from mindpose_tpu_torch.ops import heatmap as heatmap_ops
from mindpose_tpu_torch.ops.heatmap import (
    argmax_coords,
    dark_udp_refine,
    gaussian_blur_depthwise,
    gaussian_kernel_2d,
    quarter_offset,
)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)


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


DECODER_SETTINGS = [
    {}, {"shift_coordinate": True}, {"use_udp": True}, {"to_original": False},
    {"shift_coordinate": True, "backend": "pallas"},
]
DARK_SETTINGS = [
    {"use_udp": True, "dark_udp_refine": True},  # configs/udp/README.md's eval recipe
    {"dark_udp_refine": True},
    {"use_udp": True, "dark_udp_refine": True, "to_original": False},
    {"use_udp": True, "dark_udp_refine": True, "kernel_size": 7},
]


def _decoder_inputs():
    rng = np.random.RandomState(4)
    hm = rng.randn(6, 17, 64, 48).astype(np.float32)
    center = rng.uniform(0, 600, (6, 2)).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, (6, 2)).astype(np.float32)
    score = rng.uniform(0, 1, 6).astype(np.float32)
    return hm, center, scale, score


def _fused_kwargs(setting):
    """The decoder's settings as ``decode_heatmap``'s keywords."""
    return {"shift": setting.get("shift_coordinate", False),
            "to_original": setting.get("to_original", True),
            "use_udp": setting.get("use_udp", False), "pixel_std": 200.0}


@pytest.mark.parametrize("setting", DECODER_SETTINGS)
def test_decoder_matches_jax_decoder(setting):
    hm, center, scale, score = _decoder_inputs()
    want_p, want_b = JaxDecoder(**setting)(jnp.asarray(hm.transpose(0, 2, 3, 1)), center, scale, score)
    # ``backend`` has no effect in the port: the heatmap's device picks the decode
    got_p, got_b = create_decoder("topdown_heatmap", **setting)(
        torch.from_numpy(hm), torch.from_numpy(center), torch.from_numpy(scale),
        torch.from_numpy(score))
    # same float32 formula; a fused multiply-add in one library may move the last bit
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-4)


def test_decoder_refuses_what_is_not_ported():
    # every setting of the JAX decoder is ported; the pair it refuses stays refused
    create_decoder("topdown_heatmap", dark_udp_refine=True)
    with pytest.raises(ValueError, match="cannot both be true"):
        create_decoder("topdown_heatmap", dark_udp_refine=True, shift_coordinate=True)


def _dark_heatmaps(case: str) -> np.ndarray:
    """NCHW [3, 17, 64, 48] heatmaps as a trained net gives them: Gaussian
    peaks (sigma 2) of heights 0.2-1 at sub-pixel places, plus noise of
    sd 0.01; "border" puts the peaks on and next to every edge; "flat" holds
    all-zero and constant maps, whose argmax is the first pixel."""
    rng = np.random.RandomState({"peaks": 7, "border": 8, "flat": 9}[case])
    n, k, h, w = 3, 17, 64, 48
    cx, cy = rng.uniform(2, w - 3, (n, k)), rng.uniform(2, h - 3, (n, k))
    if case == "border":
        cx[:, :8] = [0.0, w - 1.0, 0.2, w - 1.3, 0.6, 20.5, 5.0, w - 0.5]
        cy[:, :8] = [0.0, h - 1.0, 30.0, 10.7, 0.4, 0.0, h - 1.0, h - 0.8]
        cx[:, 8:12], cy[:, 8:12] = -0.7, rng.uniform(0, h, 4)  # peaks just off the map
    ys, xs = np.mgrid[0:h, 0:w]
    hm = np.exp(-((xs - cx[..., None, None]) ** 2 + (ys - cy[..., None, None]) ** 2) / 8.0)
    hm = hm * rng.uniform(0.2, 1.0, (n, k, 1, 1)) + 0.01 * rng.standard_normal((n, k, h, w))
    if case == "flat":
        hm[0] = 0.0
        hm[1, :9] = 0.5
        hm[2, ::2] = -0.1  # below the refinement's clamp at 0.001
    return hm.astype(np.float32)


@pytest.mark.parametrize("case", ["peaks", "border", "flat"])
def test_dark_udp_refine_matches_jax(case):
    """From the same integer argmax: both sides blur (float32, sums in other
    orders, measured within 7e-7 of the peak), take logs and one Newton step,
    whose coordinates agree within 1e-4 px (measured: 6e-6)."""
    hm = _dark_heatmaps(case)
    kernel = gaussian_kernel_2d(11)
    nhwc = jnp.asarray(hm.transpose(0, 2, 3, 1))
    coords = np.asarray(jax_argmax_coords(nhwc)[0])
    want = np.asarray(jax_dark_udp_refine(jnp.asarray(coords), nhwc, jnp.asarray(kernel)))
    got = dark_udp_refine(torch.from_numpy(coords.copy()), torch.from_numpy(hm),
                          torch.from_numpy(kernel)).numpy()
    assert np.isfinite(want).all() and np.abs(want - coords).max() > 0.1  # the step moved
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["peaks", "border", "flat"])
@pytest.mark.parametrize("setting", DARK_SETTINGS)
def test_dark_decoder_matches_jax_decoder(setting, case):
    """Scores exactly (both the argmax's maximum); coordinates at the tolerance
    of test_decoder_matches_jax_decoder (measured: 6.1e-5 px at ~600 px)."""
    hm = _dark_heatmaps(case)
    rng = np.random.RandomState(10)
    center = rng.uniform(0, 600, (3, 2)).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, (3, 2)).astype(np.float32)
    score = rng.uniform(0, 1, 3).astype(np.float32)
    want_p, want_b = JaxDecoder(**setting)(jnp.asarray(hm.transpose(0, 2, 3, 1)), center, scale,
                                           score)
    got_p, got_b = create_decoder("topdown_heatmap", **setting)(
        torch.from_numpy(hm), torch.from_numpy(center), torch.from_numpy(scale),
        torch.from_numpy(score))
    np.testing.assert_array_equal(got_p[..., 2].numpy(), np.asarray(want_p)[..., 2])
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-4)


def test_dark_decoder_takes_its_argmax_from_the_kernel_wrapper(monkeypatch):
    """The refinement starts from ``argmax_shift_decode`` with shift off, the
    wrapper that launches the kernel on a CUDA heatmap (here its plain version)."""
    calls = []

    def recording(heatmap, shift):
        calls.append(shift)
        return argmax_shift_decode(heatmap, shift)

    monkeypatch.setattr(top_down_decoder, "argmax_shift_decode", recording)
    hm, center, scale, score = (torch.from_numpy(a) for a in _decoder_inputs())
    create_decoder("topdown_heatmap", use_udp=True, dark_udp_refine=True)(hm, center, scale, score)
    assert calls == [False]


def _blur_float64(heatmap, kernel):
    k = heatmap.shape[1]
    filt = kernel.double().expand(k, 1, *kernel.shape).contiguous()
    return F.conv2d(heatmap.double(), filt, padding="same", groups=k).float()


def _blur_flipped(heatmap, kernel):
    return gaussian_blur_depthwise(heatmap.flip(2, 3), kernel.flip(0, 1)).flip(2, 3)


@pytest.mark.parametrize("blur", [_blur_float64, _blur_flipped], ids=["float64", "flipped"])
@pytest.mark.parametrize("case", ["peaks", "border", "flat", "weak"])
def test_dark_rounding_bound_covers_another_summation_order(monkeypatch, case, blur):
    """chip_smoke.py holds the DARK decoder on the card to its CPU run within
    twice ``dark_rounding_bound``: the refinement with its blur summed in
    another order (exactly, then rounded; or over the flipped map) stays
    within the bound at every joint, and the bound is finite and below 1e-2
    heatmap px wherever a clear peak stands. "weak" maps peak at 1e-3-1e-2
    over noise of sd 1e-3, the near-singular Newton steps the bound is for."""
    import chip_smoke

    hm = _dark_heatmaps("peaks" if case == "weak" else case)
    if case == "weak":
        hm = hm * 0.01 + np.random.RandomState(11).normal(0, 1e-3, hm.shape).astype(np.float32)
    hm = torch.from_numpy(hm)
    kernel = torch.from_numpy(gaussian_kernel_2d(11))
    coords = argmax_coords(hm)[0]
    want = dark_udp_refine(coords, hm, kernel)
    monkeypatch.setattr(heatmap_ops, "gaussian_blur_depthwise", blur)
    got = dark_udp_refine(coords, hm, kernel)
    bound = chip_smoke.dark_rounding_bound(hm, coords, kernel, torch.ones(len(hm), 2))
    err = (got - want).abs().amax(-1).double()
    assert bool((err <= bound).all()), float((err / bound).max())
    if case == "peaks":
        assert float(bound.max()) < 1e-2
    if case == "weak":
        assert float(err.max()) > 0  # the other order did move a joint


def _card_back_projection(coord, center, big, n):
    """The decode kernel's back-projection of one axis, each operation rounded
    in float32: coord * (S * (1 / n)) + center - S * 0.5."""
    f = np.float32
    step = f(big * (f(1) / f(n)))
    return f(f(f(coord) * step) + f(center)) - f(big * f(0.5))


@pytest.mark.parametrize("use_udp", [True, False], ids=["udp", "plain"])
def test_serving_window_check_takes_the_back_projection_s_rounding(use_udp):
    """chip_smoke.py's ``check_preds`` holds each served keypoint inside its
    box's crop window. A joint on the heatmap's border lands on the window's
    edge up to the back-projection's float32 rounding. Every corner of the
    heatmap, for every box of the requests chip_smoke serves, back-projected
    as the card does and by the plain decoder on the CPU, passes the check;
    some land outside the exact window, so the check must allow for it; a
    keypoint 1e-3 px outside still fails."""
    import chip_smoke

    _, requests = chip_smoke.make_requests(np.random.RandomState(chip_smoke.SEED + 20))
    ds = chip_smoke.HRNET_W32["dataset_setting"]
    w, h = ds["heatmap_size"]
    n_x, n_y = (w - 1, h - 1) if use_udp else (w, h)
    corners = [(x, y) for x in (0, w - 1) for y in (0, h - 1)]
    outside = 0
    for boxes in requests:
        cs = [box_to_center_scale(b, ds["image_size"], ds["pixel_std"], ds["scale_padding"])
              for b in boxes]
        center = torch.from_numpy(np.stack([c for c, _ in cs]).astype(np.float32))
        scale = torch.from_numpy(np.stack([s for _, s in cs]).astype(np.float32))
        big = scale.numpy() * np.float32(ds["pixel_std"])
        card = np.zeros((len(boxes), 17, 3), np.float32)
        for j in range(17):
            x, y = corners[j % 4]
            card[:, j, 0] = [_card_back_projection(x, c, b, n_x)
                             for c, b in zip(center[:, 0].numpy(), big[:, 0])]
            card[:, j, 1] = [_card_back_projection(y, c, b, n_y)
                             for c, b in zip(center[:, 1].numpy(), big[:, 1])]
        hm = np.zeros((len(boxes), 17, h, w), np.float32)
        for j in range(17):
            x, y = corners[j % 4]
            hm[:, j, y, x] = 1.0
        plain, _ = decode_heatmap_plain(
            torch.from_numpy(hm), center, scale, torch.ones(len(boxes)), shift=False,
            to_original=True, use_udp=use_udp, pixel_std=ds["pixel_std"])
        half = scale.double().numpy() * ds["pixel_std"] / 2
        lo, hi = center.double().numpy() - half, center.double().numpy() + half
        for preds in (card, plain.numpy()):
            chip_smoke.check_preds(preds, boxes)
            xy = preds[..., :2]
            outside += int(((xy < lo[:, None]) | (xy > hi[:, None])).sum())
        moved = card.copy()
        moved[0, 0, 0] = hi[0, 0] + 1e-3
        with pytest.raises(AssertionError, match="outside their crop windows"):
            chip_smoke.check_preds(moved, boxes)
    assert outside > 0


@pytest.mark.parametrize("setting", DECODER_SETTINGS)
def test_fused_plain_decode_matches_jax_decoder(setting):
    hm, center, scale, score = _decoder_inputs()
    want_p, want_b = JaxDecoder(**setting)(jnp.asarray(hm.transpose(0, 2, 3, 1)), center, scale, score)
    got_p, got_b = decode_heatmap_plain(
        torch.from_numpy(hm), torch.from_numpy(center), torch.from_numpy(scale),
        torch.from_numpy(score), **_fused_kwargs(setting))
    # the tolerance of test_decoder_matches_jax_decoder, for the same reason
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-4)


def _composition(heatmap, center, scale, score, shift, to_original, use_udp, pixel_std):
    """The decoder as it was composed before the fused wrapper: the argmax and
    shift, then the back-projection, preds and boxes as separate ops."""
    coords, maxvals = argmax_shift_decode(heatmap, shift)
    if to_original:
        h, w = heatmap.shape[2:4]
        big = scale * pixel_std
        scale_x = big[:, 0:1] / (w - 1.0) if use_udp else big[:, 0:1] / w
        scale_y = big[:, 1:2] / (h - 1.0) if use_udp else big[:, 1:2] / h
        x = coords[..., 0] * scale_x + center[:, 0:1] - big[:, 0:1] * 0.5
        y = coords[..., 1] * scale_y + center[:, 1:2] - big[:, 1:2] * 0.5
        coords = torch.stack([x, y], dim=-1)
    preds = torch.cat([coords[..., :2], maxvals[..., None]], dim=-1)
    area = torch.prod(scale * pixel_std, dim=1)
    return preds, torch.cat([center, scale, area[:, None], score[:, None]], dim=1)


@pytest.mark.parametrize("case", ["random", "ties", "border", "nan_taps", "tiny_1x5"])
@pytest.mark.parametrize("setting", DECODER_SETTINGS)
def test_fused_decode_equals_the_composition_it_replaces(setting, case):
    """Bit for bit on the CPU: the plain version, the wrapper and the decoder."""
    hm = torch.from_numpy(_heatmap(case))
    rng = np.random.RandomState(5)
    n = hm.shape[0]
    center, scale, score = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.uniform(0, 2000, (n, 2)), rng.uniform(0.2, 3.0, (n, 2)), rng.uniform(0, 1, n)))
    kw = _fused_kwargs(setting)
    want = _composition(hm, center, scale, score, **kw)
    for got in (decode_heatmap_plain(hm, center, scale, score, **kw),
                decode_heatmap(hm, center, scale, score, **kw),
                create_decoder("topdown_heatmap", **setting)(hm, center, scale, score)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())  # NaN where NaN, else equal


def _bad_decode_inputs():
    n = 3
    ok = {"heatmap": torch.zeros(n, 4, 5, 6), "center": torch.zeros(n, 2),
          "scale": torch.ones(n, 2), "score": torch.ones(n)}
    yield "center on another device", dict(ok, center=torch.zeros(n, 2, device="meta"))
    yield "score on another device", dict(ok, score=torch.ones(n, device="meta"))
    yield "float64 scale", dict(ok, scale=torch.ones(n, 2, dtype=torch.float64))
    yield "float64 heatmap", dict(ok, heatmap=torch.zeros(n, 4, 5, 6, dtype=torch.float64))
    yield "scale [N, 3]", dict(ok, scale=torch.ones(n, 3))
    yield "center of another crop count", dict(ok, center=torch.zeros(n + 1, 2))
    yield "score [N, 1]", dict(ok, score=torch.ones(n, 1))
    yield "non-contiguous center", dict(ok, center=torch.zeros(2, n).t())
    yield "non-contiguous heatmap", dict(ok, heatmap=torch.zeros(n, 4, 6, 5).transpose(2, 3))


@pytest.mark.parametrize("what,inputs", list(_bad_decode_inputs()),
                         ids=[name for name, _ in _bad_decode_inputs()])
def test_fused_wrapper_rejects_what_the_kernel_does_not_take(what, inputs):
    with pytest.raises(ValueError):
        decode_heatmap(inputs["heatmap"], inputs["center"], inputs["scale"], inputs["score"],
                       shift=False, to_original=True, use_udp=False, pixel_std=200.0)


def test_fused_decode_of_a_cpu_heatmap_makes_no_launch():
    hm, center, scale, score = (torch.from_numpy(a) for a in _decoder_inputs())
    before = argmax_shift_decode.launches
    decode_heatmap(hm, center, scale, score, shift=True, to_original=True, use_udp=False,
                   pixel_std=200.0)
    create_decoder("topdown_heatmap")(hm, center, scale, score)
    assert argmax_shift_decode.launches == before


# ------------------------------------------------- the torch.library ops


@pytest.mark.parametrize("shift", [False, True])
def test_the_ops_are_the_plain_versions_on_the_cpu(shift):
    """The wrappers call ``mindpose::argmax_shift_decode`` and
    ``mindpose::decode_heatmap``; on a CPU tensor each is its plain version,
    bit for bit, with no launch counted; each op has a CUDA kernel
    registered (the decode kernel's launch) and a fake one (shapes)."""
    hm, center, scale, score = (torch.from_numpy(a) for a in _decoder_inputs())
    before = argmax_shift_decode.launches
    for got, want in ((torch.ops.mindpose.argmax_shift_decode(hm, shift),
                       argmax_shift_decode_plain(hm, shift)),
                      (torch.ops.mindpose.decode_heatmap(hm, center, scale, score, shift, True,
                                                         False, 200.0),
                       decode_heatmap_plain(hm, center, scale, score, shift=shift,
                                            to_original=True, use_udp=False, pixel_std=200.0))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert argmax_shift_decode.launches == before
    for op in ("mindpose::argmax_shift_decode", "mindpose::decode_heatmap"):
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op, key), (op, key)
    with torch.device("meta"):
        coords, maxvals = torch.ops.mindpose.argmax_shift_decode(torch.empty(5, 3, 8, 6), shift)
    assert coords.shape == (5, 3, 2) and maxvals.shape == (5, 3)


class _Decode(torch.nn.Module):
    def __init__(self, setting):
        super().__init__()
        self.decoder = create_decoder("topdown_heatmap", **setting)

    def forward(self, heatmap, center, scale, score):
        return self.decoder(heatmap, center, scale, score)


@pytest.mark.parametrize("setting", [{"shift_coordinate": True}, DARK_SETTINGS[0]],
                         ids=["fused", "dark"])
def test_the_decoder_traces_with_a_symbolic_batch(setting):
    """``torch.export`` captures the decoder as one op node (the DARK path:
    the argmax op, then the refinement as plain operations) with a symbolic
    batch traced at 2; the program at batches 1 and 6 is the eager decoder,
    bit for bit."""
    hm, center, scale, score = (torch.from_numpy(a) for a in _decoder_inputs())
    b = torch.export.Dim("b", min=1)
    program = torch.export.export(_Decode(setting), (hm[:2], center[:2], scale[:2], score[:2]),
                                  dynamic_shapes=({0: b}, {0: b}, {0: b}, {0: b}))
    ops = [str(n.target) for n in program.graph.nodes if "mindpose" in str(n.target)]
    assert ops == (["mindpose.argmax_shift_decode.default"] if "dark_udp_refine" in setting
                   else ["mindpose.decode_heatmap.default"])
    module = program.module()
    for n in (1, 6):
        got = module(hm[:n], center[:n], scale[:n], score[:n])
        want = _Decode(setting)(hm[:n], center[:n], scale[:n], score[:n])
        for g, w in zip(got, want):
            assert g.shape[0] == n and torch.equal(g, w)
