"""Plain training steps: the networks' forward in full, the loss in blocks of
rows, autograd's backward, and Adam (or AdamW) written out.

``run_steps`` drives any network's loss function through the steps that
decide ``correct``. The two loss functions here are DepthNet's (with PoseNet
for VO), over one dict ``{"depth.<name>": tensor, "pose.<name>": tensor}``
(``pose.`` absent for supervised depth). A step returns the loss and
updates the parameters and the Adam moments in place.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from benchmark.reference import losses, nets

Params = Dict[str, torch.Tensor]


def _split(params: Params, prefix: str) -> Params:
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _blocks(B: int, block: int):
    return [slice(i, min(i + block, B)) for i in range(0, B, block)]


def vo_loss_and_grads(params: Params, batch, noise, cfg, precision=nets.FP32,
                      block: int = 8):
    """Loss of a VO batch, the networks' outputs (the disparities at each
    scale, then PoseNet's axis-angles and translations over the (left,
    target) pairs and the (target, right) pairs) and the loss's gradient
    with respect to each disparity; leaves the gradient in each
    parameter's ``.grad``."""
    target = batch["target_image"]
    B = target.shape[0]
    pairs = torch.cat([torch.cat([batch["source_left"], target], -1),
                       torch.cat([target, batch["source_right"]], -1)], 0)
    outs = [*nets.depthnet(_split(params, "depth."), target, precision),
            *nets.posenet(_split(params, "pose."), pairs, precision)]
    leaves = [o.detach().requires_grad_() for o in outs]
    total = torch.zeros((), device=target.device)
    for rows in _blocks(B, block):
        right = slice(B + rows.start, B + rows.stop)
        T_left = losses.pose_matrix(leaves[-2][rows], leaves[-1][rows], True)
        T_right = losses.pose_matrix(leaves[-2][right], leaves[-1][right], False)
        part = losses.vo_loss_rows(
            [d[rows] for d in leaves[:-2]], T_left, T_right,
            {k: v[rows] for k, v in batch.items()}, [n[rows] for n in noise], cfg) / B
        part.backward()
        total = total + part.detach()
    torch.autograd.backward(outs, [leaf.grad for leaf in leaves])
    return total, [o.detach() for o in outs], [leaf.grad for leaf in leaves[:-2]]


def depth_loss_and_grads(params: Params, batch, cfg, precision=nets.FP32,
                         block: int = 16):
    """Loss of a supervised depth batch, DepthNet's disparities at each
    scale and the loss's gradient with respect to each; leaves the
    gradients in ``.grad``.
    SILog is a function of sums over the whole batch: the sums are taken
    first, then each block's sums are differentiated against the loss's
    gradient with respect to them."""
    B = batch["image"].shape[0]
    disps = nets.depthnet(_split(params, "depth."), batch["image"], precision)
    leaves = [d.detach().requires_grad_() for d in disps]
    blocks = _blocks(B, block)
    with torch.no_grad():
        sums = None
        for rows in blocks:
            part = losses.depth_loss_sums([d[rows] for d in leaves],
                                          {k: v[rows] for k, v in batch.items()}, cfg)
            sums = part if sums is None else [a + b for a, b in zip(sums, part)]
    sums = [s.requires_grad_() for s in sums]
    loss = losses.depth_loss_from_sums(sums, B, cfg)
    d_sums = torch.autograd.grad(loss, sums)
    for rows in blocks:
        part = losses.depth_loss_sums([d[rows] for d in leaves],
                                      {k: v[rows] for k, v in batch.items()}, cfg)
        torch.autograd.backward(part, list(d_sums))
    torch.autograd.backward(disps, [leaf.grad for leaf in leaves])
    return loss.detach(), [d.detach() for d in disps], [leaf.grad for leaf in leaves]


class Adam:
    """torch.optim.Adam's arithmetic (AdamW's decoupled decay where
    ``weight_decay`` > 0), written out; every parameter takes a gradient."""

    def __init__(self, params: Params, lr: float, beta1: float, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.params, self.lr, self.b1, self.b2 = params, lr, beta1, beta2
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        bc1 = 1 - self.b1**self.t
        bc2 = (1 - self.b2**self.t) ** 0.5
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if self.wd:
                p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(self.m[k], self.v[k].sqrt() / bc2 + self.eps, value=-self.lr / bc1)
            p.grad = None


def run_steps(loss_and_grads: Callable, params: Params, batches: Sequence, noises: Sequence,
              optim: Dict, precision=nets.FP32) -> Dict:
    """``len(batches)`` training steps from ``params`` (updated in place).
    ``loss_and_grads(params, batch, noise, precision)`` returns a batch's
    loss, the networks' outputs and the loss's gradient with respect to each
    output the check compares by row, and leaves each parameter's gradient
    in its ``.grad``. Returns each step's loss, the first step's outputs and
    those gradients, the gradient per leaf, and the parameters after the
    last step."""
    for p in params.values():
        p.requires_grad_(True)
    adam = Adam(params, optim["lr"], optim["beta1"], weight_decay=optim["weight_decay"])
    step_losses: List[float] = []
    first_grad = first_outputs = first_ddisp = None
    for i, batch in enumerate(batches):
        noise = noises[i] if noises else None
        loss, outputs, ddisp = loss_and_grads(params, batch, noise, precision)
        if first_grad is None:
            first_grad = {k: p.grad.detach().clone() for k, p in params.items()}
            first_outputs, first_ddisp = outputs, ddisp
        step_losses.append(float(loss))
        adam.step()
    return {"losses": step_losses, "first_grad": first_grad, "first_outputs": first_outputs,
            "first_ddisp": first_ddisp, "params": {k: v.detach() for k, v in params.items()}}
