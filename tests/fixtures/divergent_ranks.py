"""Rank processes of the divergent-knob tests' FSDP cases, over gloo on the CPU.

Started as ``tests/fixtures/ddp_ranks.py`` starts DDP's ranks
(``ddp_ranks.start_ranks("fsdp", 2, dir, module="tests.fixtures.divergent_ranks")``):
one fresh interpreter per rank. This module imports torch and the port only,
never JAX; tests/test_torch_divergent_knobs.py imports its inputs from here
and computes one process's results to compare.

Scenario ``fsdp`` (2 ranks), float64:

- ``bn``: for each (fraction, mode) of ``BN_CASES``, a ``BatchNorm2d`` with
  ``sync_group`` the world, rank *r* given rows [3r, 3r + 3) of
  ``bn_inputs(6)``: its output, its input's gradient, its scale and bias
  gradients and its running statistics after one train-mode forward and
  backward of sum(y * r).
- ``radial``: ``radial_module()`` (a conv and a transposed conv) sharded by
  ``parallel/fsdp.shard_net`` on the (1, 2) mesh, both weights along an
  input-channel dim that the projection sums over, then ``FSDP_STEPS``
  ``RadialAdamW`` steps, each rank on its half of each batch; the gathered
  parameters and each weight's shard dim (``fsdp_rank{r}.pt``).
"""
import os
import sys

import numpy as np

# (fraction, mode): the global batch of 6 keeps 2, 3 and 4 leading rows
BN_CASES = ((0.25, "frozen"), (0.5, "exact"), (0.75, "frozen_var"))
FSDP_STEPS = 3


def bn_inputs(n: int, seed: int, c: int = 3, h: int = 4, w: int = 5) -> dict:
    """NHWC float64 input x (mean 0.5, sd 2), the cotangent r, and non-trivial
    scale, bias and running statistics."""
    rng = np.random.RandomState(seed)
    return {"x": 0.5 + 2.0 * rng.standard_normal((n, h, w, c)),
            "r": rng.standard_normal((n, h, w, c)),
            "scale": rng.uniform(0.5, 1.5, c), "bias": 0.2 * rng.standard_normal(c),
            "mean": 0.2 * rng.standard_normal(c), "var": rng.uniform(0.5, 1.5, c)}


def radial_module():
    """A float64 conv (8 -> 6 channels, weight [6, 8, 3, 3]) and transposed conv
    (6 -> 4, weight [6, 4, 2, 2]) with seeded weights, and ``FSDP_STEPS``
    global batches of 4. ``fsdp_shard_dim`` shards each weight along its
    largest dim: 8 (input channels) and 6 (input channels, dim 0 of a
    transposed conv's weight), both summed by the projection."""
    import torch
    from torch import nn

    torch.manual_seed(0)
    module = nn.Sequential(nn.Conv2d(8, 6, 3, padding=1), nn.ConvTranspose2d(6, 4, 2, stride=2))
    module.double()
    rng = np.random.RandomState(1)
    batches = [torch.from_numpy(rng.standard_normal((4, 8, 5, 5))) for _ in range(FSDP_STEPS)]
    return module, batches


def _bn_part(rank: int, world: int) -> dict:
    import torch
    import torch.distributed as dist

    from mindpose_tpu_torch.models.common import BatchNorm2d

    out = {}
    inputs = bn_inputs(6, seed=31)
    rows = slice(3 * rank, 3 * rank + 3)
    for frac, mode in BN_CASES:
        bn = BatchNorm2d(3, frac, mode).double().train()
        with torch.no_grad():
            for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                              ("running_var", "var")):
                getattr(bn, name).copy_(torch.from_numpy(inputs[key]))
        bn.sync_group = dist.group.WORLD
        x = torch.from_numpy(np.ascontiguousarray(
            inputs["x"][rows].transpose(0, 3, 1, 2))).requires_grad_()
        r = torch.from_numpy(np.ascontiguousarray(inputs["r"][rows].transpose(0, 3, 1, 2)))
        y = bn(x)
        (y * r).sum().backward()
        out[(frac, mode)] = {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
                             "bias_grad": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                             "running_var": bn.running_var.clone()}
    return out


def _radial_part(rank: int, world: int) -> dict:
    from mindpose_tpu_torch.optim.optim_factory import RadialAdamW
    from mindpose_tpu_torch.parallel import create_mesh, full_state, shard_net

    module, batches = radial_module()
    shard_net(module, create_mesh(world, "cpu"))
    placements = {n: p.placements[-1].dim for n, p in module.named_parameters()
                  if n.endswith("weight")}
    opt = RadialAdamW([{"params": [module[0].weight], "radial_dim": 0},
                       {"params": [module[1].weight], "radial_dim": 1},
                       {"params": [module[0].bias, module[1].bias]}],
                      lr=1e-2, weight_decay=0.1)
    per = batches[0].shape[0] // world
    for x in batches:
        opt.zero_grad()
        module(x[rank * per:(rank + 1) * per]).square().mean().backward()
        opt.step()
    params, _, _ = full_state(module)
    return {"params": params, "placements": placements}


def _fsdp_scenario(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from mindpose_tpu_torch.parallel import init_distributed

    assert init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") == (rank, world)
    results = {"bn": _bn_part(rank, world), "radial": _radial_part(rank, world)}
    torch.save(results, os.path.join(out_dir, f"fsdp_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    scenario, rank, world, port, out_dir = sys.argv[1:]
    import torch

    torch.set_num_threads(1)  # the test machine already runs one worker per core
    {"fsdp": _fsdp_scenario}[scenario](int(rank), int(world), int(port), out_dir)


if __name__ == "__main__":
    main()
