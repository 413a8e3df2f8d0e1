"""The port's bench tools' train steps against the JAX package's, on the CPU.

The JAX bench tools set up a compilation cache or the TPU's platform when
imported, so the test never imports them whole: ``tests/fixtures/
jax_tools.jax_defs`` builds their functions from the source, the
``import mindpose_tpu`` inside them answered by proxies whose
``create_network`` builds tests/test_torch_hrnet.py's reduced HRNet (with
``hrnet_head``, a 16-filter ``higher_hrnet_head`` or a ``simcc_head``),
``jnp.bfloat16`` read as float32, and ``jax.devices()`` one CPU device.
JAX's initial variables cross into the port by ``models/convert.py``; the
port runs at O0 (float32). For each tool the loss of the first step and
of the second (after one update) is within 1e-4 of JAX's, relative, and
the parameters after the first update agree with JAX's
(``close_update``; SimCC's second loss carries Adam's sign flips, so its
first loss and its parameters are held): ``bench.bench_train_step`` (256x192, batch 2), ``bench.bench_bottomup_step`` (512x512, batch 1, JAX's default
rewrites), ``bench_variant.bench`` (heatmap and SimCC) and the
``bench_bu_variant`` variants ``base`` and ``remat``, each as many steps
as JAX's. ``bench_train_step`` in 2 gloo ranks gives each rank the loss of
the single-process step at ``accum_steps=2`` on the same global batch, at
the first step and the second, which shows the gradients all-reduced.
The rest of the tools: tests/test_torch_bench_tools.py.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import mindpose_tpu as mp
import mindpose_tpu.parallel as jax_parallel
from mindpose_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from mindpose_tpu.models.backbones.hrnet import _freeze_cfg
from mindpose_tpu.models.heads import HigherHRNetHead as JaxHigherHead
from mindpose_tpu.models.heads import HRNetHead as JaxHRNetHead
from mindpose_tpu.models.heads import SimCCHead as JaxSimCCHead
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.optim import create_optimizer as jax_create_optimizer
from mindpose_tpu_torch.models import create_loss, create_network_with_loss
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.convert import convert_net_variables
from mindpose_tpu_torch.models.heads import HigherHRNetHead, HRNetHead, SimCCHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.tools import bench, bench_bu_variant, bench_variant
from tests.fixtures.ddp_ranks import start_ranks
from tests.fixtures.jax_tools import REPO, Proxy, jax_defs
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)
from tests.test_torch_hrnet import CFG, _renamed, build_pair

RTOL = 1e-4
CPU = torch.device("cpu")
BENCH_PY = REPO + "/bench.py"


def close(got: float, want: float) -> None:
    assert np.isfinite(want) and want != 0.0, want
    assert abs(got - float(want)) <= RTOL * abs(float(want)), (got, want)


def close_steps(losses, jax_losses) -> None:
    """The first two steps' losses: the second is taken after one update, so it
    holds the gradients and the optimizer (its rule, rate and decay) to JAX's."""
    assert len(losses) == len(jax_losses), (len(losses), len(jax_losses))
    for got, want in zip(losses[:2], jax_losses[:2]):
        close(float(got.sum()), float(want.sum()))


LR = 1e-3  # the bench tools' adam and adamw rate


def close_update(updated, run, net) -> None:
    """The parameters after the first update against JAX's.

    Adam's first update is lr * g / (|g| + eps) (+ the decay): +-lr wherever
    the gradient is clear of eps. Where a gradient is within float32 rounding
    of 0 the two programs may give it opposite signs, and the element moves
    up to 2 lr the other way; where it is near eps the two moves differ by a
    part of lr. So no element may be off by more than 2 lr, and the mean
    element by no more than 1e-2 lr (a rate 10% off gives 0.1 lr; measured:
    1.1e-5 to 3.7e-3 lr over these tests). Such flips move the later losses:
    with the SimCC head 80 of 3.2M elements are off by more than 1e-4, and
    the second step's loss differs from JAX's by 3.2e-4 of itself, so for
    SimCC this check stands where the second loss cannot.
    """
    variables = dict(run.variables, params=run.updated)
    want = convert_net_variables(_renamed(variables, "CheckpointHRModule", "HRModule"), net)
    total, off = 0, 0.0
    for name, got in updated.items():
        diff = (got - want[name].float()).abs()
        assert float(diff.max()) <= 2.02 * LR, (name, float(diff.max()))
        total += diff.numel()
        off += float(diff.sum())
    assert off / total <= 1e-2 * LR, off / total


# ---- the reduced nets, both packages ----

SIMCC = {"input_size": [192, 256], "split_ratio": 2.0}


def jax_net(head_name, backbone_args=None, head_args=None):
    backbone = JaxHRNet(stage_cfg=_freeze_cfg(CFG), **(backbone_args or {}))
    head_args = dict(head_args or {})
    if head_name == "higher_hrnet_head":
        head = JaxHigherHead(in_channels=8, num_deconv_filters=(16,), **head_args)
    elif head_name == "simcc_head":
        head = JaxSimCCHead(in_channels=8, **head_args)
    else:
        head = JaxHRNetHead(in_channels=8, num_joints=17)
    return JaxNet(backbone=backbone, head=head)


def port_net(head_name, variables, backbone_args=None, head_args=None):
    """The port's reduced net with JAX's ``variables`` (a remat net's scopes renamed)."""
    backbone_args = dict(backbone_args or {})
    head_args = dict(head_args or {})
    if head_name == "higher_hrnet_head":
        head = HigherHRNetHead(in_channels=8, num_deconv_filters=(16,),
                               with_ae_loss=head_args.get("with_ae_loss", (True, False)),
                               s2d_refine=head_args.get("s2d_refine", True))
    elif head_name == "simcc_head":
        head = SimCCHead(in_channels=8, feature_size=(64, 48), **head_args)
    else:
        head = HRNetHead(8, 17)
    net = Net(HRNet(CFG, remat=backbone_args.get("remat", False)), head)
    variables = _renamed(variables, "CheckpointHRModule", "HRModule")
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    return net


class JaxRun:
    """Proxies for a JAX bench function's imports: ``create_network`` builds the
    reduced net; the train state's variables and each step's loss are kept."""

    def __init__(self):
        self.variables = None
        self.updated = None  # the parameters after the first step
        self.losses = []
        self.built = []

    def create_network(self, backbone_name, head_name, dtype=None, backbone_args=None,
                       head_args=None, **kwargs):
        self.built.append((head_name, dict(backbone_args or {}), dict(head_args or {})))
        return jax_net(head_name, backbone_args, head_args)

    def create_train_state(self, variables, tx):
        self.variables = jax.device_get(variables)  # the step donates the state
        return jax_parallel.create_train_state(variables, tx)

    def build_train_step(self, *args, **kwargs):
        step = jax_parallel.build_train_step(*args, **kwargs)

        def recorded(state, *arrays):
            state, loss_vec = step(state, *arrays)
            self.losses.append(np.asarray(loss_vec))
            if self.updated is None:
                self.updated = jax.device_get(state.params)
            return state, loss_vec

        return recorded

    def modules(self):
        return {"mindpose_tpu": Proxy(mp, create_network=self.create_network),
                "mindpose_tpu.parallel": Proxy(jax_parallel, build_train_step=self.build_train_step,
                                               create_train_state=self.create_train_state)}

    def names(self):
        return {"jax": Proxy(jax, devices=lambda: jax.devices()[:1]),
                "mp": Proxy(mp, create_network=self.create_network),
                "create_optimizer": jax_create_optimizer,
                "build_train_step": self.build_train_step,
                "create_train_state": self.create_train_state}


def jax_bench():
    run = JaxRun()
    return run, jax_defs("bench", path=BENCH_PY, modules=run.modules(), **run.names())


def recording_build(losses, updated=None):
    """``build_train_step`` whose steps keep their loss vectors in ``losses``
    and, given ``updated``, the net's parameters after the first step there."""
    def build(nwl, *args, **kwargs):
        step = build_train_step(nwl, *args, **kwargs)

        def recorded(*batch):
            out = step(*batch)
            losses.append(out.detach().clone())
            if updated is not None and not updated:
                updated.update((n, p.detach().clone()) for n, p in nwl.net.named_parameters())
            return out

        return recorded

    return build


def port_run(monkeypatch, module, head_name, variables):
    """Point ``module`` at the reduced net with JAX's variables, in float32;
    returns where its steps' losses, its net and the net's parameters after
    the first step go."""
    port = SimpleNamespace(losses=[], updated={}, nets=[])

    def create(backbone_name, head_name_, backbone_args=None, head_args=None, **kwargs):
        assert head_name_ == head_name
        port.nets.append(port_net(head_name, variables, backbone_args, head_args))
        return port.nets[-1]

    monkeypatch.setattr(module, "create_network", create)
    monkeypatch.setattr(module, "build_train_step", recording_build(port.losses, port.updated))
    monkeypatch.setattr(module, "AMP_LEVEL", "O0")
    return port


def close_run(port, run, losses=True) -> None:
    """The port's steps against JAX's: the first two losses, then the parameters
    after the first update."""
    if losses:
        close_steps(port.losses, run.losses)
    else:
        close(float(port.losses[0].sum()), float(run.losses[0].sum()))
    close_update(port.updated, run, port.nets[0])


# ---- bench.py: the train steps ----

def test_train_step_first_loss_matches_jax(monkeypatch):
    run, ns = jax_bench()
    want = ns["bench_train_step"](batch_per_chip=2, iters=1)
    port = port_run(monkeypatch, bench, "hrnet_head", run.variables)
    got = bench.bench_train_step(batch_per_chip=2, iters=1, device=CPU)
    close_run(port, run)
    assert len(port.losses) == len(run.losses) == 6  # 3 warm steps, 3 loops of 1
    assert set(got) == set(want) and got["n_devices"] == 1 and got["batch_per_chip"] == 2


def test_train_step_in_two_gloo_ranks_is_the_accumulated_step(tmp_path):
    """Each rank trains its half of the global batch through DDP; its loss is
    the single-process step's on the whole batch at accum_steps=2."""
    _, _, port, _ = build_pair()
    torch.save(port, tmp_path / "net.pt")
    start_ranks("train", 2, str(tmp_path), timeout=600, module="tests.fixtures.bench_ranks")
    ranks = [torch.load(tmp_path / f"train_rank{r}.pt", weights_only=False) for r in range(2)]

    rng = np.random.RandomState(0)  # bench_train_step's draws of the global batch
    x = rng.rand(4, 256, 192, 3).astype(np.float32)
    y = rng.rand(4, 64, 48, 17).astype(np.float32)
    nwl = create_network_with_loss(port, create_loss("joint_mse", use_target_weight=True),
                                   has_extra_inputs=True)
    step = build_train_step(nwl, create_optimizer(port, "adamw", learning_rate=1e-3,
                                                  weight_decay=0.05), accum_steps=2)
    want = step(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                torch.from_numpy(y).permute(0, 3, 1, 2).contiguous(), torch.ones(4, 17))
    # the second step shows that DDP all-reduced the gradients: a rank that
    # stepped on its own half's gradients would lose another amount
    wants = [want, step(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                        torch.from_numpy(y).permute(0, 3, 1, 2).contiguous(), torch.ones(4, 17))]
    for r in ranks:
        for got, w in zip(r["losses"][:2], wants):
            torch.testing.assert_close(got, w, rtol=1e-6, atol=0)
        assert r["report"]["n_devices"] == 2 and r["report"]["batch_per_chip"] == 2


def test_bottomup_step_first_loss_matches_jax(monkeypatch):
    run, ns = jax_bench()
    want = ns["bench_bottomup_step"](batch_per_chip=1, iters=1)
    port = port_run(monkeypatch, bench, "higher_hrnet_head", run.variables)
    got = bench.bench_bottomup_step(batch_per_chip=1, iters=1, device=CPU)
    close_run(port, run)
    assert set(got) == set(want)
    # JAX's default: the shipped recipe's rewrites, which the port builds plain
    assert run.built[0][1] == {"branch0_s2d": True, "bn_grad_stats": "fused"}


# ---- bench_variant and bench_bu_variant ----

@pytest.mark.parametrize("head", ["hrnet_head", "simcc_head"])
def test_variant_bench_first_loss_matches_jax(monkeypatch, head):
    run = JaxRun()
    ns = jax_defs("bench_variant", **run.names())
    head_args = SIMCC if head == "simcc_head" else None
    ns["bench"]({}, B=2, iters=1, head=head, head_args=head_args)
    port = port_run(monkeypatch, bench_variant, head, run.variables)
    ms, ips = bench_variant.bench({}, B=2, iters=1, head=head, head_args=head_args, device=CPU)
    # SimCC's second loss carries its Adam sign flips (close_update)
    close_run(port, run, losses=head != "simcc_head")
    assert ms > 0 and ips > 0


@pytest.mark.parametrize("variant", ["base", "remat"])
def test_bu_variant_first_loss_matches_jax(monkeypatch, variant):
    run, ns = jax_bench()
    bargs, hargs = jax_defs("bench_bu_variant")["VARIANTS"][variant]
    ns["bench_bottomup_step"](batch_per_chip=1, iters=1, backbone_args=bargs, head_args=hargs)
    port = port_run(monkeypatch, bench, "higher_hrnet_head", run.variables)
    rows = bench_bu_variant.main(["--device", "cpu", "--variants", variant, "--batch", "1",
                                  "--iters", "1"])
    close_run(port, run)
    assert [r["variant"] for r in rows] == [variant]
