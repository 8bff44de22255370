"""Inverse-rendering helpers (utils/autodiff.py counterpart; the
reference's mitsuba.python.autodiff): a differentiable ``render`` of a
ParameterMap's trainable tensors and the SGD and Adam optimisers.

The parameters are torch tensors that require a gradient; the gradient
comes from ``loss.backward()`` through the port's drivers (autograd
through the scan driver, or the lane pool's path-replay backward with
``regen=True``):

    pm = traverse(scene).keep(["volumes.gridvolume.grid"])
    opt = Adam(pm.trainable(), lr=0.05)
    for it in range(n):
        loss = ((render(pm, opt.params, seed=it, regen=True) - ref) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()

The reference's ``render_torch`` bridges its JAX renderer into torch
autograd; the port is torch already and has no such bridge.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import integrators
from .params import ParameterMap, traverse

__all__ = ["render", "Optimizer", "SGD", "Adam", "traverse", "ParameterMap"]

# the seed offset of the gradient render under ``unbiased`` (the
# reference's 0x9E3779B9), modulo 2^32
_DECORRELATE = 0x9E3779B9


def _render(pm, params, seed, spp, regen, samples_per_pass):
    return integrators.render(pm.with_trainable(params), seed=seed, spp=spp,
                              samples_per_pass=samples_per_pass, regen=regen)


class _Unbiased(torch.autograd.Function):
    """The primal image from ``seed``, its gradient through an independent
    render from seed + 0x9E3779B9: a loss that multiplies the image with
    its own gradient then stays unbiased (E[g(X) f(Y)] = E[g] E[f] for X
    independent of Y)."""

    @staticmethod
    def forward(ctx, pm, keys, seed, spp, regen, samples_per_pass, *values):
        ctx.args = (pm, keys, seed, spp, regen, samples_per_pass)
        ctx.save_for_backward(*values)
        return _render(pm, dict(zip(keys, values)), seed, spp, regen,
                       samples_per_pass)

    @staticmethod
    def backward(ctx, ct):
        pm, keys, seed, spp, regen, samples_per_pass = ctx.args
        values = ctx.saved_tensors
        wanted = [i for i, w in enumerate(ctx.needs_input_grad[6:]) if w]
        leaves = [v.detach().requires_grad_(i in wanted)
                  for i, v in enumerate(values)]
        with torch.enable_grad():
            img = _render(pm, dict(zip(keys, leaves)),
                          (seed + _DECORRELATE) & 0xFFFFFFFF, spp, regen,
                          samples_per_pass)
            grads = torch.autograd.grad(img, [leaves[i] for i in wanted],
                                        ct, allow_unused=True)
        out = [None] * len(values)
        for i, g in zip(wanted, grads):
            out[i] = g
        return (None,) * 6 + tuple(out)


def render(scene_or_pm, params=None, seed=0, spp=None, unbiased=False,
           regen=False, samples_per_pass=None):
    """Differentiable render -> the developed image (H, W, 3).

    ``scene_or_pm``: a Scene or a ParameterMap; ``params``: name -> tensor
    in place of the map's trainable values (default: the map's values, so
    nothing requires a gradient unless the map's tensors do). ``regen``
    renders on the lane pool, whose backward is the path-replay sweep:
    exact for value-class parameters (volume grids, albedos, emitter and
    surface spectra); trajectory-class ones (shapes, transforms, the
    sensor pose) need the scan driver. ``unbiased`` takes the gradient
    through an independently seeded render."""
    pm = scene_or_pm if isinstance(scene_or_pm, ParameterMap) \
        else traverse(scene_or_pm)
    params = dict(pm.items()) if params is None else params
    if unbiased:
        keys = tuple(params)
        return _Unbiased.apply(pm, keys, seed, spp, regen, samples_per_pass,
                               *params.values())
    return _render(pm, params, seed, spp, regen, samples_per_pass)


class Optimizer:
    """Holds the parameters (name -> leaf tensor that requires a gradient)
    and per-parameter state. ``step()`` updates the parameters in place
    from their ``.grad`` (or from a given name -> gradient dict)."""

    def __init__(self, params: dict, lr: float):
        self.params = {k: torch.as_tensor(v).detach().clone()
                       .requires_grad_() for k, v in params.items()}
        self.lr = lr
        self.state = {}

    def items(self):
        return self.params.items()

    def __getitem__(self, k):
        return self.params[k]

    def __setitem__(self, k, v):
        p = self.params[k]
        with torch.no_grad():
            p.copy_(torch.as_tensor(v, dtype=p.dtype).reshape(p.shape))

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    def _grads(self, grads):
        if grads is None:
            grads = {k: p.grad for k, p in self.params.items()
                     if p.grad is not None}
        return grads

    def state_dict(self):
        """The parameters, the state and the step count, as tensors."""
        out = {f"param:{k}": v.detach().clone()
               for k, v in self.params.items()}
        for k, v in self.state.items():
            for i, leaf in enumerate(v if isinstance(v, tuple) else (v,)):
                out[f"state:{k}:{i}"] = leaf.clone()
        out["t"] = torch.tensor(getattr(self, "t", 0))
        return out

    def save(self, path: str):
        """Checkpoint to an .npz file, in the reference's layout (either
        package loads the other's)."""
        np.savez(path, **{k: v.detach().cpu().numpy()
                          for k, v in self.state_dict().items()})

    def load(self, path: str):
        dev = next(iter(self.params.values())).device
        with np.load(path) as data:
            self.load_state_dict({k: torch.as_tensor(data[k], device=dev)
                                  for k in data.files})

    def load_state_dict(self, data):
        for k in self.params:
            self[k] = data[f"param:{k}"]
        for k, v in self.state.items():
            if isinstance(v, tuple):
                self.state[k] = tuple(data[f"state:{k}:{i}"].clone()
                                      for i in range(len(v)))
            else:
                self.state[k] = data[f"state:{k}:0"].clone()
        if hasattr(self, "t"):
            self.t = int(data["t"])


class SGD(Optimizer):
    """Gradient descent with optional momentum."""

    def __init__(self, params, lr, momentum=0.0):
        super().__init__(params, lr)
        self.momentum = momentum
        if momentum > 0:
            self.state = {k: torch.zeros_like(v)
                          for k, v in self.params.items()}

    @torch.no_grad()
    def step(self, grads=None):
        for k, g in self._grads(grads).items():
            if self.momentum > 0:
                self.state[k] = self.momentum * self.state[k] + g
                g = self.state[k]
            self.params[k] -= self.lr * g


class Adam(Optimizer):
    """Adam (Kingma and Ba 2015) in the reference's form: the bias
    corrections folded into the step size, epsilon added to sqrt(v)."""

    def __init__(self, params, lr, beta_1=0.9, beta_2=0.999, epsilon=1e-8):
        super().__init__(params, lr)
        self.beta_1, self.beta_2, self.epsilon = beta_1, beta_2, epsilon
        self.t = 0
        self.state = {k: (torch.zeros_like(v), torch.zeros_like(v))
                      for k, v in self.params.items()}

    @torch.no_grad()
    def step(self, grads=None):
        self.t += 1
        lr_t = self.lr * (1 - self.beta_2 ** self.t) ** 0.5 \
            / (1 - self.beta_1 ** self.t)
        for k, g in self._grads(grads).items():
            m, v = self.state[k]
            m = self.beta_1 * m + (1 - self.beta_1) * g
            v = self.beta_2 * v + (1 - self.beta_2) * g * g
            self.state[k] = (m, v)
            self.params[k] -= lr_t * m / (torch.sqrt(v) + self.epsilon)
