"""The port's ablation tools against the JAX package's timed programs, on the CPU.

Ten of the JAX tools time their full-size programs when imported, so the
test never imports them: ``tests/fixtures/jax_tools.jax_defs`` builds a JAX
tool's functions from its file's source with ``ast``, taking only the
top-level ``def``s and classes and the constant assignments, and binds the
names they read (the net, its variables, the loss, the inputs) to reduced
counterparts; ``jax.numpy`` is seen with ``bfloat16`` read as ``float32``,
so that both sides compute in float32, and the JAX tools' ``timeit`` is
replaced by one that keeps what the timed program returned. profile_parts' modules are
classes inside its ``main``; they are taken from there the same way.

Every timed program of every ablation tool returns the same scalar as
JAX's on the same numpy inputs, within 1e-4 of its magnitude, at a reduced
shape: one case per (tool, variant). Where the JAX program returns a
gradient tree (ablate_step, profile_parts, ablate_bu_backbone), the port
returns its squared norm and the tree is reduced alike here; a train
step's scalar is its loss's sum. The reduced nets are
tests/test_torch_hrnet.py's HRNet, with ``hrnet_head`` or
``higher_hrnet_head`` (16 deconv filters), their JAX variables carried
into the port by ``models/convert.py``. Also: the port's
``space_to_depth`` copy is bit for bit with JAX's; each tool's ``main``
runs on the CPU at a tiny size (``--device cpu``; the shape tables
shrunk); and each of the 14 tools raises without a card unless given
``--device``.
"""
import builtins

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import flatten_dict, unflatten_dict

import mindpose_tpu as mp
from mindpose_tpu.models.backbones.hrnet import HRModule as JaxHRModule
from mindpose_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from mindpose_tpu.models.backbones.hrnet import _freeze_cfg
from mindpose_tpu.models.backbones.resnet import Bottleneck as JaxBottleneck
from mindpose_tpu.models.backbones.s2d import space_to_depth as jax_space_to_depth
from mindpose_tpu.models.common import batch_norm as jax_batch_norm
from mindpose_tpu.models.common import conv3x3 as jax_conv3x3
from mindpose_tpu.models.heads.higher_hrnet_head import HigherHRNetHead as JaxHigherHead
from mindpose_tpu.models.loss.ae import AELoss as JaxAELoss
from mindpose_tpu.models.loss.mse import JointsMSELossWithMask as JaxMaskedMSE
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.optim import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel import build_train_step as jax_build_train_step
from mindpose_tpu.parallel import create_train_state
from mindpose_tpu_torch.models import create_loss, create_network_with_loss
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.convert import (
    _residual_block,
    convert_net_variables,
    convert_variables,
    head_mapping,
    hrnet_mapping,
)
from mindpose_tpu_torch.models.heads import HigherHRNetHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.tools import (
    ablate_accuracy,
    ablate_bottomup,
    ablate_bu_backbone,
    ablate_bu_loss,
    ablate_conv_bwd,
    ablate_conv_chain,
    ablate_conv_layout,
    ablate_conv_shape,
    ablate_s2d_head,
    ablate_step,
    exp_grouping,
    exp_warmstart,
    probe_layout,
    profile_parts,
)
from tests.fixtures.eval_checks import RECORD, register_port_backbone
from tests.fixtures.jax_tools import Float64Numpy, Recorder, jax_defs
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)
from tests.test_torch_bottomup_loss import lift_loss_casts
from tests.test_torch_hrnet import CFG, build_pair

RTOL = 1e-4
CPU = torch.device("cpu")
F32 = torch.float32


@pytest.fixture
def float64_jax(monkeypatch):
    """JAX in float64, the JAX losses' float32 casts read as float64."""
    lift_loss_casts(monkeypatch)
    with jax.enable_x64(True):
        yield


def jitted_init(module, x):
    """``module.init(PRNGKey(0), x, train=False)``, jitted (faster than eager here)."""
    return jax.jit(lambda k, x: module.init(k, x, train=False))(jax.random.PRNGKey(0), x)


def as_float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def tree_norm(tree) -> float:
    """sum of vdot(g, g) over a tree's leaves, in float64."""
    return float(sum(np.vdot(np.asarray(g, np.float64), np.asarray(g, np.float64))
                     for g in jax.tree_util.tree_leaves(tree)))


def close(got: float, want: float) -> None:
    assert np.isfinite(want) and want != 0.0, want
    assert abs(got - float(want)) <= RTOL * abs(float(want)), (got, want)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).contiguous().numpy()


# ---- the conv-chain tools: ablate_conv_chain, _bwd, _layout, _shape ----

SMALL = (2, 8, 6, 4)  # batch, height, width, channels


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "fwd+bwd"])
def test_conv_chain_programs_match_jax(bwd):
    rec = Recorder()
    ns = jax_defs("ablate_conv_chain", rng=np.random.RandomState(0))
    ns["timeit"] = rec.timeit
    ns["run"]("t", *SMALL, bwd=bwd)
    got = ablate_conv_chain.run("t", *SMALL, bwd, np.random.RandomState(0), CPU, 1, F32)
    close(got["value"], float(rec.outputs[0]))


@pytest.mark.parametrize("grad_of", ["dx", "dw", "both"])
def test_conv_bwd_programs_match_jax(grad_of):
    rec = Recorder()
    ns = jax_defs("ablate_conv_bwd", rng=np.random.RandomState(0))
    ns["timeit"] = rec.timeit
    ns["run"]("t", 2, 8, 6, grad_of=grad_of)
    got = ablate_conv_bwd.run("t", 2, 8, 6, np.random.RandomState(0), CPU, F32, grad_of, 1)
    assert ns["C"] == ablate_conv_bwd.C and ns["DEPTH"] == ablate_conv_chain.DEPTH
    close(got["value"], float(rec.outputs[0]))


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("program", ["fwd+bwd", "fwd2x"])
def test_conv_layout_programs_match_jax(layout, program):
    rec = Recorder()
    ns = jax_defs("ablate_conv_layout", rng=np.random.RandomState(0))
    ns["timeit"] = rec.timeit
    ns["run"]("t", *SMALL, layout=layout)
    got = ablate_conv_layout.run("t", *SMALL, np.random.RandomState(0), CPU, layout, F32, 1)
    want = rec.outputs[0] if program == "fwd+bwd" else rec.outputs[1]
    close(got["value" if program == "fwd+bwd" else "fwd2x_value"], float(want))


@pytest.mark.parametrize("i, program", enumerate(["fwd", "fwd+bwd", "fwd+dx", "fwd+dw"]))
def test_conv_shape_programs_match_jax(i, program):
    rec = Recorder()
    ns = jax_defs("ablate_conv_shape", rng=np.random.RandomState(0))
    ns["timeit"] = rec.timeit
    ns["run"]("t", *SMALL)
    got = ablate_conv_shape.run("t", *SMALL, np.random.RandomState(0), CPU, 1, F32)
    close(got[f"{program}_value"], float(rec.outputs[i]))


# ---- ablate_s2d_head ----

def test_space_to_depth_copy_is_bit_for_bit():
    x = np.random.RandomState(0).standard_normal((2, 8, 6, 5)).astype(np.float32)
    got = ablate_s2d_head.space_to_depth(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jax_space_to_depth(jnp.asarray(x))))
    back = ablate_s2d_head.depth_to_space(torch.from_numpy(got)).numpy()
    assert np.array_equal(back, x)


@pytest.mark.parametrize("i", range(len(ablate_s2d_head.CHAINS)),
                         ids=[c[0] for c in ablate_s2d_head.CHAINS])
def test_s2d_head_chains_match_jax(i):
    b, h, w, c = 1, 8, 8, 4
    rec = Recorder()
    ns = jax_defs("ablate_s2d_head", B=b, H=h, W=w, C=c, DT=jnp.float32,
                  space_to_depth=jax_space_to_depth)
    ns["timeit"] = rec.timeit
    depth = ns["DEPTH"]
    # the JAX tool's module-level draws, in its order
    rng = np.random.RandomState(0)
    x_plain = jnp.asarray(rng.rand(b, h, w, c).astype(np.float32))
    ks3 = tuple(jnp.asarray(rng.rand(3, 3, c, c).astype(np.float32) * 0.1)
                for _ in range(depth))
    ks3_s2d = tuple(jnp.asarray(rng.rand(3, 3, 4 * c, 4 * c).astype(np.float32) * 0.1)
                    for _ in range(depth))
    ks2_par = tuple(tuple(jnp.asarray(rng.rand(2, 2, 4 * c, c).astype(np.float32) * 0.1)
                          for _ in range(4)) for _ in range(depth))
    x_s2d = jax_space_to_depth(x_plain)
    jax_chains = [("chain_plain", (x_plain, ks3), 1.0), ("chain_dense", (x_s2d, ks3_s2d), 4.0),
                  ("chain_parity", (x_s2d, ks2_par), 16 / 9),
                  ("chain_dense_conv", (x_plain, ks3_s2d), 4.0),
                  ("chain_parity_conv", (x_plain, ks2_par), 16 / 9)]
    fn, args, flops_x = jax_chains[i]
    ns["report"]("t", ns["loss_of"](ns[fn]), args, flops_x)
    rows = ablate_s2d_head.run(np.random.RandomState(0), CPU, b, h, w, c, 1, F32)
    assert rows[i]["flops_x"] == flops_x
    close(rows[i]["value"], float(rec.outputs[0]))


# ---- probe_layout ----

PROBE_STEPS = 2


def _probe_case(name, rng):
    """(JAX body, port body, NHWC input) of one ladder, as the JAX tool builds it,
    on a random input (the JAX tool's zeros give 0 whatever the program)."""
    if name == "elementwise":
        x = rng.rand(2, 4, 3, 4).astype(np.float32)
        return (lambda x: jnp.tanh(x) * 1.5 + x), probe_layout.elementwise_body, x
    if name == "conv3x3":
        x = rng.rand(2, 4, 3, 4).astype(np.float32)
        conv = nn.Conv(4, (3, 3), padding=((1, 1), (1, 1)), use_bias=False, dtype=jnp.float32)
        v = conv.init(jax.random.PRNGKey(0), x)
        weight = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
        return (lambda x: conv.apply(v, x)), probe_layout.conv3x3_body(weight), x
    if name.startswith("conv1x1"):
        cin, cout = (8, 4) if name == "conv1x1 narrowing" else (4, 8)
        x = rng.rand(2, 4, 3, cin).astype(np.float32)
        conv = nn.Conv(cout, (1, 1), use_bias=False, dtype=jnp.float32)
        v = conv.init(jax.random.PRNGKey(0), x)

        def body(x):  # the JAX tool's
            y = conv.apply(v, x)
            if cout < cin:
                y = jnp.concatenate([y, jnp.zeros(y.shape[:-1] + (cin - cout,), y.dtype)], -1)
            elif cout > cin:
                y = y[..., :cin]
            return y

        weight = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
        return body, probe_layout.conv1x1_body(weight), x
    x = rng.rand(4, 4, 3, 4).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    v = bn.init(jax.random.PRNGKey(0), x)
    # an affine of nonzero mean: flax's initial one (1, 0) sums a normalised output to ~0
    scale, bias = (rng.rand(4) + 0.5).astype(np.float32), (rng.rand(4) + 0.5).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": v["batch_stats"]}
    return ((lambda x: bn.apply(v, x, mutable=["batch_stats"])[0]),
            probe_layout.bn_body(torch.from_numpy(scale), torch.from_numpy(bias)), x)


@pytest.mark.parametrize("name", ["elementwise", "conv3x3", "conv1x1 narrowing",
                                  "conv1x1 widening", "bn"])
def test_probe_layout_ladders_match_jax(name):
    fetched = []

    def recording_float(v):
        fetched.append(builtins.float(v))
        return fetched[-1]

    ns = jax_defs("probe_layout", float=recording_float)
    jax_body, port_body, x = _probe_case(name, np.random.RandomState(0))
    ns["scan_time"](jax_body, jnp.asarray(x), n=PROBE_STEPS, reps=1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    _, got = probe_layout.scan_time(port_body, xt, CPU, PROBE_STEPS, 1)
    close(got, fetched[0])


# ---- ablate_step ----

@pytest.fixture(scope="module")
def step_case():
    jax_net, variables, port, _ = build_pair()
    rng = np.random.RandomState(1)
    x = rng.rand(2, 64, 48, 3).astype(np.float32)
    y = rng.rand(2, 16, 12, 17).astype(np.float32)
    w = np.ones((2, 17), np.float32)
    jax_loss = mp.create_loss("joint_mse", use_target_weight=True)
    jax_nwl = mp.create_network_with_loss(jax_net, jax_loss, has_extra_inputs=True)
    ns = jax_defs("ablate_step", net=jax_net, loss=jax_loss, nwl=jax_nwl, x=jnp.asarray(x),
                  y=jnp.asarray(y), w=jnp.asarray(w))
    loss = create_loss("joint_mse", use_target_weight=True)
    nwl = create_network_with_loss(port, loss, has_extra_inputs=True)
    inputs = (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
              torch.from_numpy(y).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(w))
    return ns, variables, (jax_net, jax_nwl, x, y, w), (port, loss, nwl, inputs)


@pytest.mark.parametrize("variant", ["full", "fwd", "fwdbwd", "fwdbwd_eval", "fwd_eval"])
def test_ablate_step_programs_match_jax(step_case, variant):
    ns, variables, (jax_net, jax_nwl, x, y, w), (port, loss, nwl, inputs) = step_case
    params, stats = variables["params"], variables["batch_stats"]
    if variant == "full":
        tx = jax_create_optimizer(params, "adamw", learning_rate=1e-3, weight_decay=0.05)
        step = jax_build_train_step(jax_nwl, tx, mesh=None, donate=False)
        _, loss_vec = step(create_train_state(variables, tx), x, y, w)
        want = float(np.sum(np.asarray(loss_vec)))
    else:
        out = ns[variant](params, stats)
        want = tree_norm(out) if isinstance(out, dict) else float(out)
    programs = ablate_step.programs(port, loss, nwl, CPU, amp_level="O0")
    got = float(programs[variant](*inputs))
    close(got, want)
    assert set(programs) == set(ablate_step.LABELS)


# ---- profile_parts ----

def _hrmodule_entries(src, mod, n_br, blocks=4, n_out=None):
    """hrnet_mapping's entries of one exchange unit of basic blocks, its fusions
    into the first ``n_out`` branches (all by default)."""
    entries, g = [], 0
    for b in range(n_br):
        for k in range(blocks):
            entries += _residual_block(f"{src}.branches.{b}.{k}", (mod, f"BasicBlock_{g}"), 2,
                                       downsample=False)
            g += 1
    fc = 0
    for i in range(n_br if n_out is None else n_out):
        for j in range(n_br):
            if j == i:
                continue
            for k in range(1 if j > i else i - j):
                tail = f"{i}.{j}" if j > i else f"{i}.{j}.{k}"
                entries.append(("conv", f"{src}.fuse_layers.{tail}.0", (mod, f"Conv_{fc}")))
                entries.append(("bn", f"{src}.fuse_layers.{tail}.1", (mod, f"BatchNorm_{fc}")))
                fc += 1
    return entries


def _stage_entries(n_modules, n_branches):
    entries = []
    for i in range(n_branches):
        entries += [("conv", f"transitions.{i}.0", (f"Conv_{i}",)),
                    ("bn", f"transitions.{i}.1", (f"BatchNorm_{i}",))]
    for m in range(n_modules):  # the last unit fuses into branch 0 alone
        entries += _hrmodule_entries(f"modules_.{m}", f"HRModule_{m}", n_branches,
                                     n_out=1 if m == n_modules - 1 else None)
    return entries


def _without_dead_fusions(variables, n_modules, n_branches):
    """The JAX stage's variables less its last unit's fusions into branches 1
    and up (Conv_/BatchNorm_ from n_branches - 1 on), which feed no output and
    which the port's stage does not build."""
    last = f"HRModule_{n_modules - 1}"

    def dead(path):
        if len(path) < 2 or path[0] != last or "_" not in path[1]:
            return False
        kind, index = path[1].rsplit("_", 1)
        return kind in ("Conv", "BatchNorm") and int(index) >= n_branches - 1

    return {kind: unflatten_dict({k: v for k, v in flatten_dict(tree).items() if not dead(k)})
            for kind, tree in variables.items()}


W = 4  # profile_parts' width, reduced; stages 3 and 4 at one exchange unit
PARTS = {
    # name: (JAX module, port module, entries, input shape NHWC)
    "stem": (lambda ns: ns["Stem"](), profile_parts.Stem,
             [("conv", "conv1", ("Conv_0",)), ("bn", "bn1", ("BatchNorm_0",)),
              ("conv", "conv2", ("Conv_1",)), ("bn", "bn2", ("BatchNorm_1",))], (2, 16, 12, 3)),
    "stage1": (lambda ns: ns["Stage1"](), profile_parts.Stage1,
               [e for i in range(4) for e in _residual_block(
                   f"blocks.{i}", (f"Bottleneck_{i}",), 3, downsample=i == 0)], (2, 4, 3, 64)),
    "stage2": (lambda ns: ns["StageN"](name_="s2", n_modules=1, n_branches=2,
                                       channels=(W, W * 2)),
               lambda: profile_parts.StageN(1, 2, (W, W * 2)), _stage_entries(1, 2),
               (2, 8, 8, W)),
    "stage3": (lambda ns: ns["StageN"](name_="s3", n_modules=1, n_branches=3,
                                       channels=(W, W * 2, W * 4)),
               lambda: profile_parts.StageN(1, 3, (W, W * 2, W * 4)), _stage_entries(1, 3),
               (2, 8, 8, W)),
    "stage4": (lambda ns: ns["StageN"](name_="s4", n_modules=1, n_branches=4,
                                       channels=(W, W * 2, W * 4, W * 8)),
               lambda: profile_parts.StageN(1, 4, (W, W * 2, W * 4, W * 8)),
               _stage_entries(1, 4), (2, 8, 8, W)),
    "head": (lambda ns: ns["HeadLoss"](), lambda: profile_parts.Head(W),
             [("conv_bias", "conv", ("Conv_0",))], (2, 4, 3, W)),
}


class RecordingJax:
    """``jax`` whose ``jit`` keeps what the jitted function returned."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kwargs):
        jitted = jax.jit(fn, **kwargs)

        def call(*args):
            out = jitted(*args)
            self.outputs.append(out)
            return out

        return call


@pytest.mark.parametrize("part", list(PARTS))
def test_profile_parts_programs_match_jax(part):
    recording = RecordingJax()
    classes = jax_defs("profile_parts", body_of="main", nn=nn, dt=jnp.float32,
                       conv3x3=jax_conv3x3, batch_norm=jax_batch_norm,
                       Bottleneck=JaxBottleneck, HRModule=JaxHRModule)
    ns = jax_defs("profile_parts", jax=recording)
    make_jax, make_port, entries, shape = PARTS[part]
    module = make_jax(classes)
    ns["time_fwd_bwd"](module, shape, 1)
    want = tree_norm(recording.outputs[0])
    x = jnp.asarray(np.random.RandomState(0).rand(*shape).astype(np.float32))
    variables = jitted_init(module, x)
    if part.startswith("stage") and part != "stage1":
        variables = _without_dead_fusions(variables, 1, int(part[-1]))
    port = make_port()
    port.load_state_dict(convert_variables(variables, entries), strict=True)
    _, got = profile_parts.time_fwd_bwd(port, shape, 1, CPU, amp_level="O0")
    close(got, want)


# the float64 backbone cases' HRNet: every stage and fuse kind, one block a branch
SMALL_CFG = {
    "stage1": {"num_modules": 1, "num_branches": 1, "block": "BOTTLENECK",
               "num_blocks": (1,), "num_channels": (4,)},
    "stage2": {"num_modules": 1, "num_branches": 2, "block": "BASIC",
               "num_blocks": (1, 1), "num_channels": (4, 8)},
    "stage3": {"num_modules": 1, "num_branches": 3, "block": "BASIC",
               "num_blocks": (1, 1, 1), "num_channels": (4, 8, 16)},
    "stage4": {"num_modules": 1, "num_branches": 4, "block": "BASIC",
               "num_blocks": (1, 1, 1, 1), "num_channels": (4, 8, 16, 32),
               "multiscale_output": False},
}


# A backbone's summed output through train-mode BatchNorm barely depends on
# the weights before the last normalisation, so its gradient is a difference
# of large terms: in float32 the two frameworks' sums then part by 2e-4 to
# 7e-4 (measured on the reduced HRNet at flax's initial weights), and these
# programs are held in float64 on both sides. So are the programs that reduce
# a million elements: JAX's float32 ``vdot`` on the CPU sums 1.1M squares
# 6e-4 away from their float64 sum, where torch's is within 1e-7 (measured).


def test_profile_parts_full_backbone_matches_jax_in_float64(float64_jax):
    recording = RecordingJax()
    ns = jax_defs("profile_parts", numpy_=Float64Numpy(), jax=recording)
    module = JaxHRNet(stage_cfg=_freeze_cfg(SMALL_CFG), dtype=jnp.float64)
    shape = (2, 32, 24, 3)
    ns["time_fwd_bwd"](module, shape, 1)
    want = tree_norm(recording.outputs[0])
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    variables = jitted_init(module, jnp.asarray(x))
    port = HRNet(SMALL_CFG)
    port.load_state_dict(convert_variables(variables, hrnet_mapping(SMALL_CFG)), strict=True)
    program = profile_parts.fwd_bwd_program(port.double(), CPU, amp_level="O0")
    close(float(program(torch.from_numpy(x).permute(0, 3, 1, 2).double())), want)


# ---- ablate_bottomup ----

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


# ---- each main at a tiny size, and the device rule ----

def _tiny_conv_chain(mp_):
    mp_.setattr(ablate_conv_chain, "SHAPES", [("a", 2, 8, 6, 4, False), ("b", 2, 8, 6, 4, True)])
    return ablate_conv_chain, []


def _tiny_conv_bwd(mp_):
    mp_.setattr(ablate_conv_bwd, "SHAPES", [("a", 2, 8, 6, torch.bfloat16, "dx"),
                                            ("b", 2, 8, 6, torch.float32, "both")])
    return ablate_conv_bwd, []


def _tiny_conv_layout(mp_):
    mp_.setattr(ablate_conv_layout, "SHAPES", [("a", 2, 8, 6, 4, "NHWC"),
                                               ("b", 2, 8, 6, 4, "NCHW")])
    return ablate_conv_layout, []


def _tiny_conv_shape(mp_):
    mp_.setattr(ablate_conv_shape, "SHAPES", [("a", 2, 8, 6, 4)])
    return ablate_conv_shape, []


def _tiny_s2d(mp_):
    for name, value in (("H", 8), ("W", 8), ("C", 4)):
        mp_.setattr(ablate_s2d_head, name, value)
    return ablate_s2d_head, ["--batch", "1"]


def _tiny_probe(mp_):
    for name, value in (("ELEMENTWISE_SHAPES", [(2, 4, 3, 4)]), ("CONV3X3", [(4, 3, 4)]),
                        ("CONV1X1", [(8, 4), (4, 8)]), ("BN_CHANNELS", [4]), ("BATCH", 2),
                        ("SPATIAL", (4, 3))):
        mp_.setattr(probe_layout, name, value)
    return probe_layout, ["--steps", "2", "--reps", "1"]


def _tiny_step(mp_):
    register_port_backbone()
    for name, value in (("B", 2), ("BACKBONE", RECORD["config"]["backbone_name"]),
                        ("IMAGE", (32, 24)), ("HEATMAP", (8, 6))):
        mp_.setattr(ablate_step, name, value)
    return ablate_step, []


def _tiny_parts(mp_):
    return profile_parts, ["--batch", "1", "--width", "4", "--input", "32x24"]


def _tiny_bottomup(mp_):
    register_port_backbone()
    for name, value in (("BACKBONE", RECORD["config"]["backbone_name"]), ("IMAGE", 32),
                        ("SIZES", ((8, 8), (16, 16)))):
        mp_.setattr(ablate_bottomup, name, value)
    return ablate_bottomup, ["--batch", "1", "--variant", "base"]


def _tiny_bu_backbone(mp_):
    mp_.setattr(ablate_bu_backbone, "SHAPES", [(1, 32, 24)])
    mp_.setattr(ablate_bu_backbone, "WIDTH", 4)
    return ablate_bu_backbone, []


def _tiny_bu_loss(mp_):
    return ablate_bu_loss, ["--batch", "1"]


TINY = {"ablate_conv_chain": _tiny_conv_chain, "ablate_conv_bwd": _tiny_conv_bwd,
        "ablate_conv_layout": _tiny_conv_layout, "ablate_conv_shape": _tiny_conv_shape,
        "ablate_s2d_head": _tiny_s2d, "probe_layout": _tiny_probe, "ablate_step": _tiny_step,
        "profile_parts": _tiny_parts, "ablate_bottomup": _tiny_bottomup,
        "ablate_bu_backbone": _tiny_bu_backbone, "ablate_bu_loss": _tiny_bu_loss}


@pytest.mark.parametrize("tool", sorted(TINY))
def test_main_runs_on_the_cpu_at_a_tiny_size(monkeypatch, tool):
    module, argv = TINY[tool](monkeypatch)
    iters = [] if tool == "probe_layout" else ["--iters", "1"]
    rows = module.main(["--device", "cpu", *iters, *argv])
    assert rows
    for row in rows:
        ms = [v for k, v in row.items() if k == "ms" or k.endswith("_ms")]
        assert ms and all(np.isfinite(m) and m > 0 for m in ms), row
        values = [v for k, v in row.items() if k == "value" or k.endswith("_value")]
        assert all(v is None or np.isfinite(v) for v in values), row


MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    ablate_accuracy, ablate_bottomup, ablate_bu_backbone, ablate_bu_loss, ablate_conv_bwd,
    ablate_conv_chain, ablate_conv_layout, ablate_conv_shape, ablate_s2d_head, ablate_step,
    exp_grouping, exp_warmstart, probe_layout, profile_parts)}


@pytest.mark.parametrize("tool", sorted(MODULES))
def test_main_needs_the_gpu_unless_asked_for_the_cpu(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        MODULES[tool].main([])
