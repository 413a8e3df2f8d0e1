#!/usr/bin/env python3
"""Why the port's float32 train-step gradient differs from its float64 one.

Usage (from the root of a checkout; it runs on the CPU, but takes a few GB
of memory for full-width HRNet-W32 at batch 2):

    python3 grad_precision.py

It takes chip_smoke.py's phase-10 step (the same weights, batch 2 of the
same synthetic crops, the recipe's loss) on the CPU and prints, each against
the same step in float64:
- the float32 gradient's error per tensor, max|diff| / max|g|: the median
  over tensors and the worst three;
- the ReLU inputs that lie on different sides of 0 in float32 and float64,
  by resolution;
- the BatchNorm layers with the largest E[x^2] / (var + eps), the factor by
  which the one-pass variance cancels;
- the float32 gradient's error again with float64 BatchNorm statistics in
  the float32 net, and with softplus(beta) in place of every ReLU (the
  float64 reference then uses it too).
"""
import copy
import statistics

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

import chip_smoke as cs
from mindpose_tpu_torch.models.common import BatchNorm2d
from mindpose_tpu_torch.parallel import accum_loss_and_grads

CPU = torch.device("cpu")


def grads(net, batch, dtype):
    preprocess = cs.recipe_preprocess()
    accum_loss_and_grads(cs.recipe_net_with_loss(net.to(dtype)), batch,
                         preprocess=lambda *b: tuple(t.to(dtype) for t in preprocess(*b)))
    return cs._grads_and_stats(net)[0]


def report(tag, errs):
    print(f"{tag}: gradients max|diff|/max|g| median {statistics.median(errs.values()):.3e}, "
          f"worst {cs._worst(errs)}")


def bn_float64_stats(self, x):
    """Train-mode BatchNorm2d with its statistics in float64, output in x.dtype."""
    xd = x.double()
    mean = xd.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xd * xd).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    mul = torch.rsqrt(var + self.eps) * self.weight.double()
    return ((xd - mean[None, :, None, None]) * mul[None, :, None, None]
            + self.bias.double()[None, :, None, None]).to(x.dtype)


def main() -> int:
    net = cs.training_net(CPU)
    batch = cs.train_batch(np.random.RandomState(cs.SEED + 3), cs.TRAIN_CPU_BATCH, CPU)
    relu, relu_forward, bn_forward = torch.relu, nn.ReLU.forward, BatchNorm2d.forward
    signs = {}

    def recording(x):
        signs[key].append((tuple(x.shape[-2:]), x.detach() > 0))
        return relu(x)

    def activation(fn):
        torch.relu = fn
        nn.ReLU.forward = lambda self, x: fn(x)

    stats = {}

    def bn_hook(module, inputs, _, name=None):
        x = inputs[0].detach()
        var = x.var((0, 2, 3), unbiased=False)
        stats[name] = (float(((x * x).mean((0, 2, 3)) / (var + module.eps)).max()),
                       x.numel() // x.shape[1])

    try:
        activation(recording)
        key, signs["f32"] = "f32", []
        g32 = grads(copy.deepcopy(net), batch, torch.float32)
        key, signs["f64"] = "f64", []
        ref = copy.deepcopy(net)
        hooks = [m.register_forward_hook(lambda m, i, o, n=n: bn_hook(m, i, o, n))
                 for n, m in ref.named_modules() if isinstance(m, nn.BatchNorm2d)]
        g64 = grads(ref, batch, torch.float64)
        for h in hooks:
            h.remove()
        report("float32 against float64", cs._errors(g32, g64))
        flips, units = {}, {}
        for (hw, a), (_, b) in zip(signs["f32"], signs["f64"]):
            flips[hw] = flips.get(hw, 0) + int((a != b).sum())
            units[hw] = units.get(hw, 0) + a.numel()
        print("ReLU inputs on different sides of 0, float32 against float64, by resolution: "
              + "; ".join(f"{h}x{w}: {flips[h, w]} of {units[h, w]}"
                          for h, w in sorted(units, reverse=True)))
        print("BatchNorm layers by max over channels of E[x^2]/(var+eps): " + "; ".join(
            f"{n} {stats[n][0]:.3e} ({stats[n][1]} values per channel)"
            for n in sorted(stats, key=lambda n: -stats[n][0])[:3]))

        activation(relu)
        BatchNorm2d.forward = bn_float64_stats
        report("float32 with float64 BatchNorm statistics against float64",
               cs._errors(grads(copy.deepcopy(net), batch, torch.float32), g64))
        BatchNorm2d.forward = bn_forward
        for beta in (10.0, 100.0):
            activation(lambda x, beta=beta: F.softplus(x, beta=beta))
            report(f"softplus(beta={beta:g}) in place of ReLU, float32 against float64",
                   cs._errors(grads(copy.deepcopy(net), batch, torch.float32),
                              grads(copy.deepcopy(net), batch, torch.float64)))
    finally:
        torch.relu, nn.ReLU.forward, BatchNorm2d.forward = relu, relu_forward, bn_forward
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
