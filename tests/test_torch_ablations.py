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
``--device``. The profile_parts cases are in
tests/test_torch_ablations_parts.py and the bottom-up tools' in
tests/test_torch_ablations_bottomup.py (split by tool, so that the tier-1
run's workers share them); they import this file's helpers.
"""
import builtins

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import mindpose_tpu as mp
from mindpose_tpu.models.backbones.s2d import space_to_depth as jax_space_to_depth
from mindpose_tpu.optim import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel import build_train_step as jax_build_train_step
from mindpose_tpu.parallel import create_train_state
from mindpose_tpu_torch.models import create_loss, create_network_with_loss
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
from tests.fixtures.jax_tools import Recorder, jax_defs
from tests.test_torch_bottomup_loss import lift_loss_casts
from tests.test_torch_hrnet import build_pair
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

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
