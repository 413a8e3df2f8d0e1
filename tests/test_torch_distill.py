"""The port's knowledge distillation against the JAX package's, on the CPU.

- ``joint_mse_distill`` against JAX's ``JointsMSEDistillLoss`` in float64
  (its float32 casts read as float64, ``Float64Numpy``): both components and
  the gradient with respect to the prediction within 1e-12 relative, with
  ``use_target_weight`` on and off and ``alpha`` 0.5 and 1.7; no gradient
  reaches the teacher's heatmaps;
- ``build_teacher`` on the eval fixture (``CKPT``, the reduced HRNet's adam
  TrainState, written by the JAX package's ``save_checkpoint``), on a bare
  variables tree written by the same writer, and on a port checkpoint of
  the same net: the same weights each time, frozen and in eval mode;
- the teacher preprocess against JAX's ``build_teacher_preprocess`` over the
  device preprocess on the same crops: the same columns, the teacher's
  heatmaps within 1e-4 (both float32, the teacher built without a dtype);
- one float64 distillation step (student and teacher both float64, the
  teacher as tests/models/test_distill.py builds it) against JAX's
  ``build_train_step`` with the teacher preprocess: the loss vector within
  rtol 1e-5, the gradient within 1e-4 of each tensor's largest entry and the
  parameters as ``_adam_tolerance`` says, the tolerances of
  tests/test_torch_train_step.py (the port renders its targets in float32).

The train entry with ``distill_setting`` is in tests/test_torch_train_entry.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from mindpose_tpu.data.device_pipeline import build_topdown_preprocess as jax_build_preprocess
from mindpose_tpu.models import create_network as jax_create_network
from mindpose_tpu.models.distill import build_teacher as jax_build_teacher
from mindpose_tpu.models.distill import build_teacher_preprocess as jax_teacher_preprocess
from mindpose_tpu.models.loss import distill as jax_distill_module
from mindpose_tpu.models.loss.distill import JointsMSEDistillLoss as JaxDistillLoss
from mindpose_tpu.models.model_factory import create_loss as jax_create_loss
from mindpose_tpu.models.model_factory import create_network_with_loss as jax_create_nwl
from mindpose_tpu.optim.optim_factory import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel.train import build_train_step as jax_build_train_step
from mindpose_tpu.parallel.train import create_train_state
from mindpose_tpu.utils.checkpoint import load_variables as jax_load_variables
from mindpose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mindpose_tpu_torch.data.device_pipeline import build_topdown_preprocess
from mindpose_tpu_torch.models import create_loss, create_network, create_network_with_loss
from mindpose_tpu_torch.models.convert import convert_net_variables
from mindpose_tpu_torch.models.distill import build_teacher, build_teacher_preprocess
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.utils.checkpoint import save_checkpoint
from tests import make_torch_eval_fixture as fixture
from tests.fixtures.eval_checks import CKPT, RECORD, register_port_backbone
from tests.test_torch_bottomup_loss import Float64Numpy
from tests.test_torch_train_step import (
    MEAN,
    STD,
    _adam_gradients,
    _adam_tolerance,
    _as,
    _keypoints,
)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

SETTING = RECORD["config"]["dataset_setting"]
IMAGE_SIZE, HEATMAP_SIZE = tuple(SETTING["image_size"]), tuple(SETTING["heatmap_size"])
BACKBONE, HEAD = RECORD["config"]["backbone_name"], RECORD["config"]["head_name"]
DISTILL = {"teacher_backbone": BACKBONE, "teacher_head": HEAD, "teacher_ckpt": CKPT}
YAML = dict(name="adamw", weight_decay=0.05, filter_bias_and_bn=True)
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def registered():
    fixture.register_jax_backbone()
    register_port_backbone()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("use_target_weight", [True, False])
@pytest.mark.parametrize("alpha", [0.5, 1.7])
def test_joint_mse_distill_matches_jax(monkeypatch, use_target_weight, alpha):
    rng = np.random.RandomState(0)
    pred, target, teacher = (rng.uniform(0, 1, (3, 8, 6, 5)) for _ in range(3))  # NHWC
    weight = rng.uniform(0, 1, (3, 5))
    weight[:, 1] = 0.0  # a masked joint
    monkeypatch.setattr(jax_distill_module, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        loss_j = JaxDistillLoss(use_target_weight=use_target_weight, alpha=alpha)
        args = [jnp.asarray(a) for a in (pred, target, weight, teacher)]
        want = np.asarray(loss_j(*args))
        grad_j = np.asarray(jax.grad(lambda p: jnp.sum(loss_j(p, *args[1:])))(args[0]))
    p = _nchw(pred).requires_grad_(True)
    t = _nchw(teacher).requires_grad_(True)
    loss = create_loss("joint_mse_distill", use_target_weight=use_target_weight, alpha=alpha)
    got = loss(p, _nchw(target), torch.from_numpy(weight), t)
    got.sum().backward()
    assert got.shape == (2,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(p.grad.permute(0, 2, 3, 1).numpy(), grad_j, rtol=1e-12,
                               atol=1e-15)
    assert t.grad is None  # the teacher's heatmaps are detached
    # float32 and bf16 predictions give a float32 loss, as in JAX
    assert loss(p.detach().bfloat16(), _nchw(target).float(), torch.from_numpy(weight).float(),
                t.detach().bfloat16()).dtype == torch.float32


def test_teacher_checkpoints_load_as_jax_loads_them(tmp_path):
    """The JAX-written TrainState, a bare variables tree written by the same
    writer, and a port checkpoint of the teacher all give its weights."""
    teacher = build_teacher(DISTILL, num_joints=17)
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    want = convert_net_variables(jax_load_variables(CKPT), teacher)
    state = teacher.state_dict()
    assert set(state) == set(want)
    for name, v in want.items():
        assert torch.equal(state[name], v), name
    bare = str(tmp_path / "bare.msgpack")
    jax_save_checkpoint(bare, jax_load_variables(CKPT))
    port = str(tmp_path / "teacher.ckpt")
    save_checkpoint(port, teacher)
    for path in (bare, port):
        other = build_teacher(dict(DISTILL, teacher_ckpt=path), num_joints=17).state_dict()
        for name, v in state.items():
            assert torch.equal(other[name], v), (path, name)
    with pytest.raises(ValueError, match="teacher_ckpt"):
        build_teacher(dict(DISTILL, teacher_ckpt=""), num_joints=17)


def _crops(rng, n):
    image = rng.randint(0, 256, (n, IMAGE_SIZE[1], IMAGE_SIZE[0], 3)).astype(np.uint8)
    return image, _keypoints(rng, n, w=float(IMAGE_SIZE[0]), h=float(IMAGE_SIZE[1]))


def test_teacher_preprocess_matches_jax():
    image, kpts = _crops(np.random.RandomState(1), 4)
    teacher_net, teacher_vars = jax_build_teacher(DISTILL, num_joints=17)
    pp_j = jax_teacher_preprocess(teacher_net, teacher_vars, base_preprocess=jax_build_preprocess(
        IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0))
    want = [np.asarray(c) for c in jax.jit(pp_j)(jnp.asarray(image), jnp.asarray(kpts))]
    pp = build_teacher_preprocess(build_teacher(DISTILL, num_joints=17),
                                  base_preprocess=build_topdown_preprocess(
                                      IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0))
    got = pp(torch.from_numpy(image), torch.from_numpy(kpts))
    assert len(got) == len(want) == 4 and not got[-1].requires_grad
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), want[0], atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-6)
    heat = got[3].permute(0, 2, 3, 1).numpy()
    assert got[3].dtype == torch.float32 and np.abs(want[3]).max() > 0.1
    np.testing.assert_allclose(heat, want[3], atol=1e-4, rtol=0)


def _student_variables(rng):
    """The fixture net's variables with every parameter moved by noise: a
    student that starts away from its teacher."""
    variables = unfreeze(jax_load_variables(CKPT))
    variables["params"] = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32),
        variables["params"])
    return variables


def test_float64_distillation_step_matches_jax(monkeypatch):
    rng = np.random.RandomState(2)
    image, kpts = _crops(rng, 4)
    student_vars = _student_variables(rng)
    teacher_vars = jax_load_variables(CKPT)

    render = build_topdown_preprocess(IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0)
    teacher = build_teacher(DISTILL, num_joints=17).double()
    pp = build_teacher_preprocess(
        teacher, base_preprocess=lambda *c: tuple(t.double() for t in render(*c)))
    net = create_network(BACKBONE, HEAD, num_joints=17)
    net.load_state_dict(convert_net_variables(student_vars, net), strict=True)
    net.double()
    nwl = create_network_with_loss(net, create_loss("joint_mse_distill", alpha=0.5),
                                   has_extra_inputs=True)
    step = build_train_step(nwl, create_optimizer(net, learning_rate=LR, **YAML),
                            preprocess=pp)
    start = {k: v.detach().clone() for k, v in net.named_parameters()}

    monkeypatch.setattr(jax_distill_module, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        make = lambda: jax_create_network(BACKBONE, HEAD, num_joints=17,  # noqa: E731
                                          dtype=jnp.float64)
        student_j, teacher_j = make(), make()
        pp_j = jax_teacher_preprocess(
            teacher_j, {k: _as(v, jnp.float64) for k, v in teacher_vars.items()},
            base_preprocess=jax_build_preprocess(IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0))
        nwl_j = jax_create_nwl(student_j, jax_create_loss("joint_mse_distill", alpha=0.5),
                               has_extra_inputs=True)
        variables64 = {k: _as(v, jnp.float64) for k, v in student_vars.items()}
        tx = jax_create_optimizer(variables64["params"], learning_rate=LR, **YAML)
        state = create_train_state(variables64, tx)
        step_j = jax_build_train_step(nwl_j, tx, preprocess=pp_j, donate=False)
        state, loss_j = step_j(state, jnp.asarray(image), jnp.asarray(kpts))
        grads, _ = _adam_gradients(state.opt_state)
        want_g = convert_net_variables({"params": grads, "batch_stats": state.batch_stats}, net)
        want = convert_net_variables({"params": state.params,
                                      "batch_stats": state.batch_stats}, net)
    loss = step(torch.from_numpy(image), torch.from_numpy(kpts))
    assert loss.shape == (2,) and float(loss[1]) > 0
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5)
    for name, p in net.named_parameters():
        w = want_g[name].double()
        assert float((p.grad - w).abs().max()) <= 1e-4 * float(w.abs().max()), name
    tol = _adam_tolerance([want_g], start, [LR])
    for name, p in net.named_parameters():
        diff = (p.detach() - want[name].double()).abs()
        assert bool((diff <= tol[name]).all()), (name, float(diff.max()))
        assert float((want[name].double() - start[name]).abs().max()) > 1e-4, name
