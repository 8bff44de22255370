"""Path-replay backward of the lane pool (integrators/replay.py
counterpart): the gradient of a lane-pool render with respect to the
scene's value-class tensors, without taping the render.

``render_regen_diff`` is a ``torch.autograd.Function``. Its forward runs
``render_wavefront_regen(..., sample_log=True)`` with autograd off and
keeps the per-sample log of radiance totals. Its backward replays the lane
pool's schedule from the same seed (a sample's random numbers are keyed by
its index, so the replay retraces the same paths) and accumulates the
scene's adjoint bounce by bounce (Vicini et al. 2021, "Path Replay
Backpropagation").

Per sample the estimate is L = sum_k tau_k delta_k: tau_k is the carried
``throughput`` and delta_k the bounce-local terms. Under the detach
discipline a value-class parameter (volume grids, albedos, emitter
spectra: anything that moves no sampled trajectory) enters only through
those value carries, so each replayed bounce needs only the cotangents

    ct(result)     = delta_pix
    ct(throughput) = delta_pix * R / tau,   R = L - result

(R is the radiance still to come, read from the sample log) and one local
``torch.autograd.grad`` of the bounce with those cotangents. This equals
autograd through the scan driver for value-class parameters. For
trajectory-class ones (shape vertices, transforms, the sensor pose) it is
the detached-sampling approximation; the ``geo`` subtree is not
differentiated at all. Lanes whose throughput channel is exactly 0 give 0
there (R / tau is undefined; the reference's division caveat).

The NEE walks in a replayed bounce are the early-exiting Python loops of
volpath._run_walk, differentiated by autograd over the steps they ran:
per-step local adjoints over the executed steps, which is what the
reference's PRB walk (its _run_walk_prb, a custom_vjp) computes, so the
port has no separate module for it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..films import film_gather
from . import REGISTRY, _camera_lanes, _check_regen, _film_rows, _run_pool
from . import render_wavefront_regen

# loop iterations of the lane pool in this process, forward renders and
# adjoint sweeps of render_regen_diff (chip_smoke.py reads them)
counters = {"forward_iterations": 0, "adjoint_iterations": 0}

# samples a chunk of the hoisted per-sample pass (bounds its memory)
HOISTED_CHUNK = 1 << 20


def _partition(scene):
    """(names, floats, rebuild): the scene's floating-point tensors by
    dotted name, leaving out the ``geo`` subtree (trajectory-class: its
    cotangent is a documented zero) and the derived vol_packed, and
    rebuild(floats) -> the scene with those tensors in their places."""
    named = {k: v for k, v in scene.tensors().items()
             if v.is_floating_point() and not k.startswith("geo.")}
    names = tuple(named)

    def rebuild(floats):
        return scene.with_tensors(dict(zip(names, floats)))

    return names, tuple(named.values()), rebuild


def replay_supported(cfg) -> bool:
    """Whether the lane pool's integrator has the replay hooks."""
    return bool(getattr(REGISTRY[cfg.integrator.kind], "_REPLAY_OK", False))


def _detached(x):
    """A record (nested dataclasses of tensors) with every tensor
    detached."""
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _detached(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    return x.detach() if isinstance(x, torch.Tensor) else x


def _add(acc, grads):
    """acc + grads, element by element; a None (an unused input) counts as
    zeros."""
    return [a if g is None else (g if a is None else a + g)
            for a, g in zip(acc, grads)]


def _adjoint_sweep(scene, seed, slog, ct_film, n_lanes, spp, needs):
    """Replay the lane pool's schedule while accumulating d(loss)/d(the
    scene's float tensors of _partition) for the film cotangent
    ``ct_film``. ``needs[i]`` says whether tensor i wants a gradient.
    Returns (gradients, one per tensor, None where not wanted; loop
    iterations).

    Everything per sample is hoisted out of the loop into one vectorised
    pass over all samples (in chunks of HOISTED_CHUNK): the film cotangent
    through film_gather, _film_rows (in spectral the XYZ estimator at the
    hero wavelengths the sensor redraws from the seed; they are not
    logged) and the ray weight to the per-sample result cotangent delta,
    and the sensor-parameter adjoint. The loop then reads two rows a
    refilled lane (delta and the logged total)."""
    cfg = scene.config
    mod = REGISTRY[cfg.integrator.kind]
    _check_regen(cfg)
    dev = ct_film.device
    cw, ch = cfg.crop_size if cfg.crop_size else (cfg.film_width,
                                                  cfg.film_height)
    cx, cy = cfg.crop_offset
    total = ch * cw * spp
    max_iterations, bounce_kwargs = mod._knobs(scene)
    bounce_kwargs.update(getattr(mod, "_REPLAY_BOUNCE_KWARGS", {}))
    # the sweep's lane count is its own: trajectories are keyed by sample
    n_lanes = min(int(dict(cfg.integrator.extra).get("replay_lanes",
                                                     n_lanes)), total)

    _names, floats, rebuild = _partition(scene)
    leaves = [f.detach().requires_grad_() if w else f.detach()
              for f, w in zip(floats, needs)]
    wanted = [x for x, w in zip(leaves, needs) if w]
    scene_c = rebuild([f.detach() for f in floats])  # the schedule's
    scene_g = rebuild(leaves)                        # the bounces'
    grads = [None] * len(wanted)

    # ---- hoisted per-sample pass: delta and the sensor adjoint ----------
    offset = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    deltas = []
    for s0 in range(0, total, HOISTED_CHUNK):
        idx = torch.arange(s0, min(s0 + HOISTED_CHUNK, total),
                           dtype=torch.int64, device=dev)
        with torch.enable_grad():
            _smp, ray, rw, pos = _camera_lanes(scene_g, seed, spp, idx)
            ct_rows = film_gather(ct_film, pos.detach() - offset,
                                  cfg.rfilter, dict(cfg.rfilter_params))
            L = slog[idx].requires_grad_()
            valid = torch.ones(idx.shape[0], dtype=torch.bool, device=dev)
            value = torch.sum(_film_rows(L * rw, valid, ray.wavelengths)
                              * ct_rows)
            g = torch.autograd.grad(value, wanted + [L], allow_unused=True)
        grads = _add(grads, g[:-1])
        deltas.append(g[-1])
    delta_all = torch.cat(deltas)

    # ---- the replay loop -------------------------------------------------
    nc = cfg.variant.n_channels
    lane = {"delta": torch.zeros(n_lanes, nc, device=dev),
            "L": torch.zeros(n_lanes, nc, device=dev)}

    def refill(ridx, new, _ray):
        lane["delta"] = lane["delta"].index_copy(0, ridx, delta_all[new])
        lane["L"] = lane["L"].index_copy(0, ridx, slog[new])

    def bounce(vp, occupied):
        nonlocal grads
        with torch.enable_grad():
            out = mod._bounce(scene_g, vp, **bounce_kwargs)
            tp = out.throughput.detach()
            R = lane["L"] - out.result.detach()  # radiance to go
            ok = occupied[:, None] & (tp != 0.0)
            delta = torch.where(occupied[:, None], lane["delta"], 0.0)
            ct_tp = torch.where(ok, delta * R / torch.where(ok, tp, 1.0),
                                0.0)
            pairs = [(t, c) for t, c in ((out.result, delta),
                                         (out.throughput, ct_tp))
                     if t.requires_grad]
            if pairs and wanted:
                grads = _add(grads, torch.autograd.grad(
                    [t for t, _ in pairs], wanted,
                    grad_outputs=[c for _, c in pairs], allow_unused=True))
        return _detached(out)

    stats = {}
    with torch.no_grad():
        _run_pool(scene_c, n_lanes, seed, spp, total, max_iterations, bounce,
                  refill=refill, stats=stats)
    it = iter(grads)
    return [next(it) if w else None for w in needs], stats["iterations"]


class _RenderRegenDiff(torch.autograd.Function):
    """The lane-pool render as an autograd op of the scene's float tensors
    (passed as explicit arguments, so autograd sees them)."""

    @staticmethod
    def forward(ctx, scene, seed, n_lanes, spp, *floats):
        stats = {}
        film, _rays, slog = render_wavefront_regen(
            scene, n_lanes, seed, spp, stats=stats, sample_log=True)
        counters["forward_iterations"] += stats["iterations"]
        ctx.scene, ctx.seed, ctx.n_lanes, ctx.spp = scene, seed, n_lanes, spp
        ctx.save_for_backward(slog)
        return film

    @staticmethod
    def backward(ctx, ct_film):
        (slog,) = ctx.saved_tensors
        grads, iterations = _adjoint_sweep(
            ctx.scene, ctx.seed, slog, ct_film.contiguous(), ctx.n_lanes,
            ctx.spp, ctx.needs_input_grad[4:])
        counters["adjoint_iterations"] += iterations
        # the scene, the seed and the two counts get none
        return (None, None, None, None, *grads)


def render_regen_diff(scene, seed, n_lanes, spp):
    """The lane-pool render's raw film (ch, cw, C), differentiable with
    respect to the scene's float tensors outside ``geo`` through the
    path-replay backward. With autograd off, or no such tensor requiring a
    gradient, it is render_wavefront_regen's film; with it on, the forward
    runs the same lane pool (the same film, bit for bit) and adds the
    sample log."""
    _names, floats, _rebuild = _partition(scene)
    if not (torch.is_grad_enabled() and any(f.requires_grad
                                             for f in floats)):
        film, _rays = render_wavefront_regen(scene, n_lanes, seed, spp)
        return film
    return _RenderRegenDiff.apply(scene, seed, n_lanes, spp, *floats)
