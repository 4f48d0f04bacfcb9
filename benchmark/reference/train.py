"""The training step: the L2 loss of the rendered radiance mean against a
target image, its gradients in the shading leaves by autograd, and adam
(b1 0.9, b2 0.999, eps 1e-8 outside the square root)."""

from __future__ import annotations

import torch

from benchmark.reference import tracer

BETAS, EPS = (0.9, 0.999), 1e-8


def loss_and_grads(sc, cam, leaves, target, seed, *, width, height, spp,
                   max_depth, t_min=1e-3):
    """(loss, {leaf: gradient}) at ``leaves``; ``target`` is [H*W, 3]
    linear radiance."""
    live = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    pixels = torch.arange(width * height, device=sc.device)
    with torch.enable_grad():
        acc, _ = tracer.radiance(sc, cam, pixels, width=width, height=height,
                                 spp=spp, max_depth=max_depth, seed=seed,
                                 t_min=t_min, leaves={**sc.leaves, **live})
        loss = ((acc * (1.0 / spp) - target) ** 2).mean(0).sum() / 3.0
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(live.items(), grads)}


def adam_steps(sc, cam, leaves, target, seeds, lr, **kw):
    """Adam from fresh moments over one step per seed.  Returns (losses,
    the first step's gradients, the leaves after the last step)."""
    params = {k: v.detach().clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    for step, seed in enumerate(seeds, 1):
        loss, grads = loss_and_grads(sc, cam, params, target, seed, **kw)
        losses.append(float(loss))
        first = grads if first is None else first
        for k, g in grads.items():
            m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
            v2[k] = BETAS[1] * v2[k] + (1 - BETAS[1]) * g * g
            m_hat = m[k] / (1 - BETAS[0] ** step)
            v_hat = v2[k] / (1 - BETAS[1] ** step)
            params[k] = params[k] - lr * m_hat / (torch.sqrt(v_hat) + EPS)
    return losses, first, params
