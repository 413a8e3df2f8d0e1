"""The bottom-up ablation tools' timed programs against the JAX tools', on the CPU.

Split from tests/test_torch_ablations.py by tool (its helpers, and the
description of how the JAX tools' programs are built from their source,
are there): ablate_bottomup's net, backbone, loss and optimizer programs,
ablate_bu_backbone's and ablate_bu_loss's, each returning the JAX
program's scalar within 1e-4 of its magnitude at a reduced shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mindpose_tpu as mp
from mindpose_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from mindpose_tpu.models.backbones.hrnet import _freeze_cfg
from mindpose_tpu.models.heads.higher_hrnet_head import HigherHRNetHead as JaxHigherHead
from mindpose_tpu.models.loss.ae import AELoss as JaxAELoss
from mindpose_tpu.models.loss.mse import JointsMSELossWithMask as JaxMaskedMSE
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.optim import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel import build_train_step as jax_build_train_step
from mindpose_tpu.parallel import create_train_state
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.convert import (
    convert_net_variables,
    convert_variables,
    head_mapping,
    hrnet_mapping,
)
from mindpose_tpu_torch.models.heads import HigherHRNetHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.tools import ablate_bottomup, ablate_bu_backbone, ablate_bu_loss
from tests.fixtures.jax_tools import Float64Numpy, Recorder, jax_defs
from tests.test_torch_ablations_parts import SMALL_CFG
from tests.test_torch_hrnet import CFG
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)
from tests.test_torch_ablations import (  # noqa: F401  (float64_jax: a fixture)
    CPU,
    F32,
    as_float64,
    close,
    float64_jax,
    jitted_init,
    nhwc,
    tree_norm,
)


BU_IMAGE, BU_SIZES = 64, ((16, 16), (32, 32))  # reduced: levels of 16 and 32


def _jax_bu_loss(sizes):
    return mp.create_loss(
        "ae_multi_loss", num_joints=17, num_stages=2, stage_sizes=[list(s) for s in sizes],
        mse_loss_factor=[1.0, 1.0], ae_loss_factor=[0.001, 0.001],
        with_mse_loss=[True, True], with_ae_loss=[True, False])


def _jax_layout(inputs):
    """The port's inputs in the JAX tool's layouts."""
    def t(name):
        return inputs[name].detach()

    return {"x": nhwc(t("x")), "target": t("target").permute(0, 1, 3, 4, 2).numpy(),
            "mask": t("mask").numpy(), "tag_ind": t("tag_ind").numpy().astype(np.int32),
            "feat": nhwc(t("feat")), "pred0": nhwc(t("pred0")), "pred1": nhwc(t("pred1")),
            "t0_exact": nhwc(t("t0_exact")), "t1_exact": nhwc(t("t1_exact")),
            "m0_exact": t("m0_exact").numpy(), "m1_exact": t("m1_exact").numpy()}


@pytest.fixture(scope="module")
def bottomup_case():
    """The reduced HigherHRNet at flax's initial weights in both frameworks, the
    inputs of the net programs (batch 2, 64x64) and of the loss-only ones
    (batch 1 at the full level sizes, which those programs slice by)."""
    head = JaxHigherHead(in_channels=8, num_deconv_filters=(16,), s2d_refine=False)
    jax_net = JaxNet(backbone=JaxHRNet(stage_cfg=_freeze_cfg(CFG)), head=head)
    x0 = np.zeros((1, BU_IMAGE, BU_IMAGE, 3), np.float32)
    variables = jax.jit(lambda k, x: jax_net.init(k, x, train=False))(jax.random.PRNGKey(0), x0)
    port = Net(HRNet(CFG), HigherHRNetHead(in_channels=8, num_deconv_filters=(16,),
                                            s2d_refine=False))
    port.load_state_dict(convert_net_variables(variables, port), strict=True)
    inputs = ablate_bottomup.make_inputs(np.random.RandomState(0), 2, BU_IMAGE, BU_SIZES, CPU,
                                         channels=8, pred_dtype=F32)
    arrays = _jax_layout(inputs)
    # the modules the JAX tool initialises apart for its head-only row
    hvars = head.init(jax.random.PRNGKey(0), arrays["feat"][:1], train=False)
    port_head = HigherHRNetHead(in_channels=8, num_deconv_filters=(16,), s2d_refine=False)
    port_head.load_state_dict(convert_variables(hvars, head_mapping(port_head)), strict=True)
    jax_loss = _jax_bu_loss(BU_SIZES)
    ns = jax_defs("ablate_bottomup", net=jax_net, loss=jax_loss, head=head,
                  nwl=mp.create_network_with_loss(jax_net, jax_loss, has_extra_inputs=True))
    full_inputs = ablate_bottomup.make_inputs(np.random.RandomState(0), 1, 8,
                                              ablate_bottomup.SIZES, CPU, channels=8,
                                              pred_dtype=F32)
    return {"ns": ns, "variables": variables, "hvars": hvars, "arrays": arrays,
            "full_arrays": _jax_layout(full_inputs), "port": port, "head": port_head,
            "inputs": inputs, "full_inputs": full_inputs, "jax_nwl": ns["nwl"]}


NET_VARIANTS = ["full", "fwd", "fwdbwd", "fwdbwd_eval", "head_fwdbwd"]
LOSS_VARIANTS = ["loss_fwdbwd", "mse_fwdbwd", "ae_fwdbwd", "mse_exact_fwdbwd"]


@pytest.mark.parametrize("variant", NET_VARIANTS)
def test_ablate_bottomup_net_programs_match_jax(bottomup_case, variant):
    c = bottomup_case
    v = c["variables"]
    params, stats = v["params"], v["batch_stats"]
    a = c["arrays"]
    batch = (a["x"], a["target"], a["mask"], a["tag_ind"])
    if variant == "full":
        tx = jax_create_optimizer(params, "adam", learning_rate=1e-3)
        step = jax_build_train_step(c["jax_nwl"], tx, mesh=None, donate=False)
        _, loss_vec = step(create_train_state(v, tx), *batch)
        want = float(np.sum(np.asarray(loss_vec)))
    elif variant == "head_fwdbwd":
        want = float(c["ns"][variant](c["hvars"]["params"], c["hvars"]["batch_stats"],
                                      a["feat"]))
    else:
        want = float(c["ns"][variant](params, stats, *batch))
    programs = ablate_bottomup.net_programs(c["port"], ablate_bottomup.build_loss(BU_SIZES), CPU,
                                            "O0", head=c["head"])
    program, names = programs[variant]
    close(float(program(*(c["inputs"][n] for n in names))), want)


def test_ablate_bottomup_backbone_program_matches_jax_in_float64(bottomup_case, float64_jax):
    """The backbone-only row, from the backbone the JAX tool initialises apart."""
    x = bottomup_case["arrays"]["x"]
    backbone = JaxHRNet(stage_cfg=_freeze_cfg(SMALL_CFG), dtype=jnp.float64)
    bvars = jitted_init(backbone, np.zeros((1, *x.shape[1:]), np.float32))
    ns = jax_defs("ablate_bottomup", numpy_=Float64Numpy(), backbone=backbone)
    want = float(ns["bb_fwdbwd"](bvars["params"], bvars["batch_stats"], x))
    port = HRNet(SMALL_CFG)
    port.load_state_dict(convert_variables(bvars, hrnet_mapping(SMALL_CFG)), strict=True)
    port = port.double()
    program, _ = ablate_bottomup.net_programs(bottomup_case["port"], ablate_bottomup.build_loss(
        BU_SIZES), CPU, "O0", backbone=port)["bb_fwdbwd"]
    close(float(program(bottomup_case["inputs"]["x"].double())), want)


@pytest.mark.parametrize("variant", LOSS_VARIANTS + ["opt_only"])
def test_ablate_bottomup_loss_and_optimizer_programs_match_jax(bottomup_case, float64_jax,
                                                               variant):
    """JAX in float64 (these reduce a million elements, or every parameter);
    the port in float32, as it runs."""
    c = bottomup_case
    ns = jax_defs("ablate_bottomup", numpy_=Float64Numpy(),
                  loss=_jax_bu_loss(ablate_bottomup.SIZES), mse_c=JaxMaskedMSE(),
                  ae_c=JaxAELoss())
    if variant == "opt_only":
        params = as_float64(c["variables"]["params"])
        ns["tx"] = tx = jax_create_optimizer(params, "adam", learning_rate=1e-3)
        want = float(ns["opt_only"](params, tx.init(params)))
        close(float(ablate_bottomup.opt_program(c["port"])()), want)
        return
    program, names = ablate_bottomup.loss_programs(
        ablate_bottomup.build_loss(ablate_bottomup.SIZES))[variant]
    want = float(ns[variant](*(c["full_arrays"][n] for n in names)))
    close(float(program(*(c["full_inputs"][n] for n in names))), want)


# ---- ablate_bu_backbone ----

@pytest.mark.parametrize("train", [True, False], ids=["train BN", "eval BN"])
def test_bu_backbone_programs_match_jax_in_float64(float64_jax, train):
    rec = Recorder()
    ns = jax_defs("ablate_bu_backbone", numpy_=Float64Numpy(), ITERS=1)
    ns["timeit_fn"] = rec.timeit
    net = JaxHRNet(stage_cfg=_freeze_cfg(SMALL_CFG), dtype=jnp.float64)
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    variables = jitted_init(net, jnp.asarray(x[:1]))
    ns["bb_cost"](net, variables, jnp.asarray(x), train=train)
    want = tree_norm(rec.outputs[0])
    port = HRNet(SMALL_CFG)
    port.load_state_dict(convert_variables(variables, hrnet_mapping(SMALL_CFG)), strict=True)
    program = ablate_bu_backbone.backbone_program(port.double(), train, CPU, "O0")
    close(float(program(torch.from_numpy(x).permute(0, 3, 1, 2).double())), want)


# ---- ablate_bu_loss ----

def _jax_bu_loss_inputs(b):
    """The JAX tool's module-level draws, in its order, at batch ``b``."""
    rng = np.random.RandomState(0)
    K, M = 17, 30
    x = {}
    x["t1"] = jnp.asarray(rng.rand(b, 256, 256, K).astype(np.float32))
    x["m1"] = jnp.asarray(np.ones((b, 256, 256), np.float32))
    x["p1"] = jnp.asarray(rng.rand(b, 256, 256, K).astype(np.float32))
    x["t1p"] = jnp.asarray(rng.rand(b, 256, 256, 128).astype(np.float32))
    x["p1p"] = jnp.asarray(rng.rand(b, 256, 256, 128).astype(np.float32))
    x["t1c"] = jnp.asarray(rng.rand(b, K, 256, 256).astype(np.float32))
    x["p1c"] = jnp.asarray(rng.rand(b, K, 256, 256).astype(np.float32))
    x["t1f"], x["p1f"] = x["t1"].reshape(b, 256, 256 * K), x["p1"].reshape(b, 256, 256 * K)
    x["tgt"] = jnp.asarray(rng.rand(b, 2, 256, 256, K).astype(np.float32))
    x["msk"] = jnp.asarray(np.ones((b, 2, 256, 256), np.float32))
    x["p0"] = jnp.asarray(rng.rand(b, 128, 128, 2 * K).astype(np.float32))
    tag_ind = np.zeros((b, M, K, 2), np.int32)
    tag_ind[..., 0] = rng.randint(0, 128 * 128, (b, M, K))
    tag_ind[..., 1] = rng.randint(0, 2, (b, M, K))
    x["tag_ind"] = jnp.asarray(tag_ind)
    x["p0t"] = jnp.asarray(rng.rand(b, 128, 128, 2 * K).astype(np.float32))
    tag_full = np.zeros((b, 2, M, K, 2), np.int32)
    tag_full[..., 0] = rng.randint(0, 128 * 128, (b, 2, M, K))
    tag_full[..., 1] = rng.randint(0, 2, (b, 2, M, K))
    x["tag_full"] = jnp.asarray(tag_full)
    return x


# the JAX tool's calls of ``run``, in its order: (program, inputs)
BU_LOSS_RUNS = [
    ("mse_masked", ("p1", "t1", "m1")), ("mse_masked", ("p1", "t1", "m1")),
    ("mse_plain", ("p1", "t1")), ("mse_plain", ("p1p", "t1p")), ("mse_plain", ("p1c", "t1c")),
    ("mse_plain", ("p1f", "t1f")), ("red", ("t1",)), ("mse_two_level", ("p0", "p1", "tgt", "msk")),
    ("ae_fwdbwd", ("p0t", "tag_ind")),
    ("full_loss_fwdbwd", ("p0", "p1", "tgt", "msk", "tag_full")),
]


@pytest.fixture(scope="module")
def bu_loss_case():
    return _jax_bu_loss_inputs(1), ablate_bu_loss.draw_inputs(np.random.RandomState(0), 1, CPU,
                                                              F32)


@pytest.mark.parametrize("i", range(len(ablate_bu_loss.PROGRAMS)),
                         ids=[p[0] for p in ablate_bu_loss.PROGRAMS])
def test_bu_loss_programs_match_jax(bu_loss_case, float64_jax, i):
    """JAX in float64 (each program reduces a million elements); the port in
    float32, as it runs."""
    arrays, inputs = bu_loss_case
    rec = Recorder()
    ns = jax_defs("ablate_bu_loss", numpy_=Float64Numpy(), K=17, ae_c=JaxAELoss(),
                  loss=_jax_bu_loss(ablate_bottomup.SIZES))
    ns["timeit"] = rec.timeit
    fn, names = BU_LOSS_RUNS[i]
    ns["run"]("t", ns[fn], *(arrays[n] for n in names))
    label, program, port_names = ablate_bu_loss.PROGRAMS[i]
    close(float(program(*(inputs[n] for n in port_names))), float(rec.outputs[0]))
