"""Differentiable rendering and the inverse-rendering train step (port of
``another_raytracer_tpu.grad.diff``).

Estimator: detached-sampling reparameterisation — every random draw is a
counter-based constant with respect to the parameters and every discrete
decision (closest-hit winner, material select, dielectric branch, metal
absorption) is a mask without gradient, while the selected branch's
arithmetic stays differentiable.  ``render_loss`` is the L2 loss of the
rendered radiance mean against a target; on the fused scene class it runs
the record-mode kernel and the replay (``ops/kernels/mega_diff.py``),
otherwise the lockstep autograd path (``ops/integrator.py``).

Parameters are a dict of leaf tensors named as SceneData fields.  The
optimiser is ``torch.optim.Adam`` with optax's ``adam`` defaults
(b1 0.9, b2 0.999, eps 1e-8 outside the sqrt); a train step updates the
parameter tensors in place.  ``params_from_reference`` and
``train_state_from_reference`` carry a JAX-package parameter dict and optax
adam state across from numpy arrays (no JAX import).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from another_raytracer_tpu_torch.ops import render as render_lib

# Scene leaves that are trainable by default: everything shading-related.
DEFAULT_TRAINABLE = (
    "tex_ca", "tex_cb", "tex_cc", "mat_fuzz", "mat_ir", "atlas", "background",
)
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8  # optax.adam's defaults


def split_params(scene, trainable=DEFAULT_TRAINABLE):
    """Split SceneData into (params dict, the scene)."""
    params = {k: getattr(scene, k) for k in trainable}
    return params, scene


def merge_params(scene, params):
    return scene.replace(**params)


def render_loss(params, scene, cam, target, seed, *, width, height, spp,
                samples_per_pass, max_depth, t_min):
    """L2 loss between the rendered radiance mean and a target image
    (linear radiance, [H*W, 3] on the scene's device)."""
    s = merge_params(scene, params)
    acc, _ = render_lib.radiance_batch(
        s, cam, torch.arange(width * height, dtype=torch.int64,
                             device=s.device), seed,
        width=width, height=height, sample_start=0, n_samples=spp,
        spp_cap=spp, samples_per_pass=samples_per_pass, max_depth=max_depth,
        t_min=t_min, differentiable=True, trainable=tuple(sorted(params)),
    )
    inv = 1.0 / spp
    return (
        torch.mean((acc.x * inv - target[:, 0]) ** 2)
        + torch.mean((acc.y * inv - target[:, 1]) ** 2)
        + torch.mean((acc.z * inv - target[:, 2]) ** 2)
    ) / 3.0


def render_value_and_grad(params, scene, cam, target, seed, *, width, height,
                          spp, samples_per_pass, max_depth, t_min):
    """(loss, grads dict): the counterpart of
    ``jax.value_and_grad(render_loss)``.  A leaf the loss does not reach gets
    a zero gradient, as in JAX."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = render_loss(leaves, scene, cam, target, seed, width=width,
                           height=height, spp=spp,
                           samples_per_pass=samples_per_pass,
                           max_depth=max_depth, t_min=t_min)
        # A loss that no leaf reaches (say mat_fuzz on a scene without metal)
        # has no graph at all: every gradient is zero.
        grads = (torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
                 if loss.requires_grad else [None] * len(leaves))
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), grads)}


class TrainState(NamedTuple):
    params: dict
    opt_state: torch.optim.Adam


def _adam(params, learning_rate):
    return torch.optim.Adam(list(params.values()), lr=learning_rate,
                            betas=ADAM_BETAS, eps=ADAM_EPS)


def make_train_step(scene, cam, target, *, width, height, spp,
                    samples_per_pass, max_depth, t_min=1e-3,
                    learning_rate=1e-2, trainable=DEFAULT_TRAINABLE):
    """Build (init_state, step_fn) for inverse rendering with adam.

    step_fn(state, seed) -> (state, loss): one forward + backward through
    ``render_loss`` and one adam update of ``state.params`` (in place).
    """
    params, _ = split_params(scene, trainable)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    state = TrainState(params=params, opt_state=_adam(params, learning_rate))

    def step(state: TrainState, seed):
        opt = state.opt_state
        opt.zero_grad(set_to_none=False)
        with torch.enable_grad():
            loss = render_loss(state.params, scene, cam, target, seed,
                               width=width, height=height, spp=spp,
                               samples_per_pass=samples_per_pass,
                               max_depth=max_depth, t_min=t_min)
            loss.backward()
        # A leaf the loss does not reach keeps a zero gradient (optax sees
        # zeros there too), so adam's moments decay alike in both.
        for p in state.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        return state, loss.detach()

    return state, step


def params_from_reference(params, device="cpu"):
    """A JAX-package params dict (arrays readable by ``np.asarray``) -> the
    port's leaf tensors."""
    return {k: torch.from_numpy(np.array(np.asarray(v), np.float32)).to(device)
            for k, v in params.items()}


def train_state_from_reference(params, opt_state, learning_rate,
                               device="cpu") -> TrainState:
    """Carry a JAX-package TrainState across: ``params`` its params dict and
    ``opt_state`` optax adam's state (``(ScaleByAdamState(count, mu, nu),
    EmptyState())``), read as numpy arrays.  optax's count, mu and nu become
    torch Adam's ``step``, ``exp_avg`` and ``exp_avg_sq``."""
    adam = next(s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_reference(params, device).items()}
    opt = _adam(leaves, learning_rate)
    mu = params_from_reference(adam.mu, device)
    nu = params_from_reference(adam.nu, device)
    step = float(np.asarray(adam.count))
    for k, p in leaves.items():
        opt.state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                        "exp_avg": mu[k], "exp_avg_sq": nu[k]}
    return TrainState(params=leaves, opt_state=opt)
