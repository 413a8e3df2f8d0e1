"""profile_parts' timed programs against the JAX tool's, on the CPU.

Split from tests/test_torch_ablations.py by tool (its helpers, and the
description of how the JAX tools' programs are built from their source,
are there): every part of profile_parts returns the JAX program's scalar
within 1e-4 of its magnitude at a reduced width, and its full backbone's
gradient norm agrees with JAX's in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import flatten_dict, unflatten_dict

from mindpose_tpu.models.backbones.hrnet import HRModule as JaxHRModule
from mindpose_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from mindpose_tpu.models.backbones.hrnet import _freeze_cfg
from mindpose_tpu.models.backbones.resnet import Bottleneck as JaxBottleneck
from mindpose_tpu.models.common import batch_norm as jax_batch_norm
from mindpose_tpu.models.common import conv3x3 as jax_conv3x3
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.convert import _residual_block, convert_variables, hrnet_mapping
from mindpose_tpu_torch.tools import profile_parts
from tests.fixtures.jax_tools import Float64Numpy, jax_defs
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)
from tests.test_torch_ablations import (  # noqa: F401  (float64_jax: a fixture)
    CPU,
    close,
    float64_jax,
    jitted_init,
    tree_norm,
)


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
