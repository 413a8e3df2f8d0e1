"""The port's bottom-up losses against the JAX package's, on the CPU.

``ae`` (the associative-embedding push/pull loss, gathered at the tag
indices) and ``ae_multi_loss`` (the per-level masked heatmap MSE plus the AE
loss), with one tag per joint and one per person, on a batch whose images
hold 0, 1, 3 and 5 persons (padded instance slots, invisible joints with
nonzero indices), masked pixels and non-square levels. The port takes NCHW
predictions and [N, S, K, Hmax, Wmax] targets; JAX the same values NHWC.

The JAX package takes its losses in float32; the port takes them in the
prediction's dtype promoted to at least float32, so float64 for float64
predictions. To compare the formulas, not float32 rounding, the JAX cast is
lifted to float64 while a test runs (``lift_loss_casts``): the JAX loss
modules' ``jnp.float32`` reads as float64 (their ``jnp`` is seen through
``Float64Numpy``; nothing of the JAX package changes). Then the loss
vector and its gradient with respect to every prediction (``jax.grad`` of
each component) agree within rtol 1e-10. A bf16 prediction, as the head
gives it under autocast, gives a float32 loss within rtol 1e-6 of JAX's on
the same bf16 values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.models.loss import ae as jax_ae_module
from mindpose_tpu.models.loss import mse as jax_mse_module
from mindpose_tpu.models.model_factory import create_loss as jax_create_loss
from mindpose_tpu_torch.models import create_loss

RTOL = 1e-10
N, M, K = 4, 6, 5
PERSONS = (0, 1, 3, 5)  # persons per image; the other slots are padding
LEVELS = ((10, 8), (20, 16))  # (w, h) of the two levels


class Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def lift_loss_casts(mp: pytest.MonkeyPatch) -> None:
    """The JAX losses' float32 casts read as float64."""
    mp.setattr(jax_ae_module, "jnp", Float64Numpy())
    mp.setattr(jax_mse_module, "jnp", Float64Numpy())


@pytest.fixture
def jax_float64(monkeypatch):
    lift_loss_casts(monkeypatch)
    with jax.enable_x64(True):
        yield


def tag_indices(rng, w, h, tag_per_joint=True):
    """[N, M, K, 2] (or [N, M, 2]): each image's persons in scattered slots,
    some joints invisible (valid 0) with a nonzero index; padding is (0, 0)."""
    ind = np.zeros((N, M, K, 2), np.int32)
    for n, persons in enumerate(PERSONS):
        for slot in rng.choice(M, persons, replace=False):
            ind[n, slot, :, 0] = rng.randint(0, w * h, K)
            ind[n, slot, :, 1] = rng.uniform(0, 1, K) < 0.8
            ind[n, slot, 0, 1] = 1  # at least one visible joint
    ind[3, :, -1, 0] = np.where(ind[3, :, -1, 1] == 0, 7, ind[3, :, -1, 0])
    if not tag_per_joint:
        return ind[:, :, 0]
    return ind


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=RTOL * float(np.abs(np.asarray(want)).max()), err_msg=what)


@pytest.mark.parametrize("tag_per_joint", [True, False])
def test_ae_loss_and_gradients_match_jax_in_float64(jax_float64, tag_per_joint):
    rng = np.random.RandomState(0)
    w, h = LEVELS[0]
    shape = (N, K, h, w) if tag_per_joint else (N, h, w)
    pred = rng.standard_normal(shape)
    target = tag_indices(rng, w, h, tag_per_joint)
    pred_j = pred.transpose(0, 2, 3, 1) if tag_per_joint else pred
    jax_loss = jax_create_loss("ae", tag_per_joint=tag_per_joint)
    loss = create_loss("ae", tag_per_joint=tag_per_joint)

    x = torch.tensor(pred, requires_grad=True)
    got = loss(x, torch.from_numpy(target))
    want = jax_loss(jnp.asarray(pred_j), jnp.asarray(target))
    assert got.dtype == torch.float64 and want.dtype == jnp.float64
    _close(got.detach().numpy(), want, "loss")
    assert float(want[0]) > 0 and float(want[1]) > 0
    for c, name in enumerate(("push", "pull")):
        (g,) = torch.autograd.grad(got[c], x, retain_graph=True)
        g_j = np.asarray(jax.grad(lambda p: jax_loss(p, jnp.asarray(target))[c])(
            jnp.asarray(pred_j)))
        if tag_per_joint:
            g_j = g_j.transpose(0, 3, 1, 2)
        _close(g.numpy(), g_j, name)
        assert np.abs(g_j).max() > 0


def test_ae_loss_of_images_with_0_and_1_persons(jax_float64):
    """An image without persons gives 0 push and 0 pull; one person gives 0
    push (no pair); the batch mean divides by N."""
    rng = np.random.RandomState(1)
    w, h = LEVELS[0]
    pred = rng.standard_normal((N, K, h, w))
    target = tag_indices(rng, w, h)
    loss = create_loss("ae", reduction=None)
    got = loss(torch.from_numpy(pred), torch.from_numpy(target))
    want = jax_create_loss("ae", reduction=None)(jnp.asarray(pred.transpose(0, 2, 3, 1)),
                                                 jnp.asarray(target))
    _close(got.numpy(), want, "per-image losses")
    push, pull = got.numpy()
    assert push[0] == 0 and pull[0] == 0 and push[1] == 0 and pull[1] > 0
    assert (push[2:] > 0).all()


def _multi_inputs(rng, tag_per_joint):
    (w0, h0), (w1, h1) = LEVELS
    tags = K if tag_per_joint else 1
    preds = [rng.standard_normal((N, K + tags, h0, w0)), rng.standard_normal((N, K, h1, w1))]
    target = np.zeros((N, 2, K, h1, w1))
    target[:, 0, :, :h0, :w0] = rng.uniform(0, 1, (N, K, h0, w0)) ** 4
    target[:, 1] = rng.uniform(0, 1, (N, K, h1, w1)) ** 4
    mask = (rng.uniform(0, 1, (N, 2, h1, w1)) < 0.7).astype(np.uint8)
    tag_ind = np.stack([tag_indices(rng, w, h, tag_per_joint) for w, h in LEVELS], axis=1)
    return preds, target, mask, tag_ind


def _multi_setting(tag_per_joint):
    # higher_hrnet_w32_tpu.yaml's, at this test's levels and joints
    return dict(num_joints=K, num_stages=2, stage_sizes=[list(s) for s in LEVELS],
                mse_loss_factor=[1.0, 0.5], ae_loss_factor=[0.001, 0.001],
                with_mse_loss=[True, True], with_ae_loss=[True, False],
                tag_per_joint=tag_per_joint)


@pytest.mark.parametrize("tag_per_joint", [True, False])
def test_ae_multi_loss_and_gradients_match_jax_in_float64(jax_float64, tag_per_joint):
    rng = np.random.RandomState(2)
    preds, target, mask, tag_ind = _multi_inputs(rng, tag_per_joint)
    setting = _multi_setting(tag_per_joint)
    loss = create_loss("ae_multi_loss", **setting)
    jax_loss = jax_create_loss("ae_multi_loss", **setting)
    xs = [torch.tensor(p, requires_grad=True) for p in preds]
    got = loss(xs, torch.from_numpy(target), torch.from_numpy(mask), torch.from_numpy(tag_ind))
    args_j = (jnp.asarray(target.transpose(0, 1, 3, 4, 2)), jnp.asarray(mask),
              jnp.asarray(tag_ind))
    preds_j = [jnp.asarray(p.transpose(0, 2, 3, 1)) for p in preds]
    want = jax_loss(preds_j, *args_j)
    assert got.shape == (3,) and got.dtype == torch.float64
    _close(got.detach().numpy(), want, "loss vector")
    assert (np.asarray(want) > 0).all()
    for c, name in enumerate(("mse", "push", "pull")):
        grads = torch.autograd.grad(got[c], xs, retain_graph=True, allow_unused=True)
        want_g = jax.grad(lambda ps: jax_loss(ps, *args_j)[c])(preds_j)
        for level, (g, g_j) in enumerate(zip(grads, want_g)):
            g_j = np.asarray(g_j).transpose(0, 3, 1, 2)
            g = np.zeros_like(g_j) if g is None else g.numpy()
            _close(g, g_j, f"{name}, level {level}")
        if name == "mse":  # a masked pixel takes no gradient
            g1 = np.asarray(want_g[1])
            assert (g1[mask[:, 1] == 0] == 0).all() and np.abs(g1).max() > 0


def test_masked_pixels_do_not_count():
    """The MSE over a masked level equals the mean over unmasked pixels of
    the squared error, divided as the JAX package divides: by all pixels."""
    rng = np.random.RandomState(3)
    preds, target, mask, tag_ind = _multi_inputs(rng, True)
    setting = dict(_multi_setting(True), with_ae_loss=[False, False], mse_loss_factor=[0.0, 1.0])
    got = create_loss("ae_multi_loss", **setting)(
        [torch.from_numpy(p) for p in preds], torch.from_numpy(target), torch.from_numpy(mask),
        torch.from_numpy(tag_ind))
    err = (preds[1] - target[:, 1]) ** 2 * mask[:, 1, None]
    np.testing.assert_allclose(got.numpy(), [err.mean(), 0.0, 0.0], rtol=1e-12)


def test_bf16_prediction_gives_a_float32_loss_like_jax():
    rng = np.random.RandomState(4)
    preds, target, mask, tag_ind = _multi_inputs(rng, True)
    setting = _multi_setting(True)
    bf16 = [torch.from_numpy(p.astype(np.float32)).bfloat16() for p in preds]
    got = create_loss("ae_multi_loss", **setting)(
        bf16, torch.from_numpy(target.astype(np.float32)), torch.from_numpy(mask),
        torch.from_numpy(tag_ind))
    want = jax_create_loss("ae_multi_loss", **setting)(
        [jnp.asarray(p.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16) for p in bf16],
        jnp.asarray(target.astype(np.float32).transpose(0, 1, 3, 4, 2)), jnp.asarray(mask),
        jnp.asarray(tag_ind))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
