"""Statistical image-regression harness (utils/ztest.py counterpart;
Mitsuba's src/librender/tests/test_renders.py:64-133).

A scene renders under the ``moment`` wrapper, which carries each pixel's
second moment; a per-pixel Z-test against a stored reference mean and
variance, at a Sidak-corrected significance, decides pass or fail. The
reference images are made by this same harness at a higher sample count
and kept as EXR files (utils/bitmap.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import integrators
from ..scene import load_dict


def render_with_variance(scene_dict, variant=None, spp=None, seed=0,
                         device=None, **render_kw):
    """The mean image and the per-pixel variance of the mean, by the
    moment integrator over the scene's integrator, on ``device`` (the card
    unless named). Returns (mean (H, W, 3) XYZ, var_of_mean (H, W, 3), n)
    as float64 host arrays; ``render_kw`` goes to ``integrators.render``
    (``regen`` and ``samples_per_pass`` choose the driver)."""
    d = dict(scene_dict)
    child = d["integrator"] if d["integrator"].get("type") != "moment" \
        else dict(d["integrator"]).get("child", {"type": "path"})
    d["integrator"] = {"type": "moment", "child": child}
    scene = load_dict(d, variant, device=device)
    spp = spp or scene.config.spp
    film = integrators.render(scene, seed=seed, spp=spp, develop_film=False,
                              **render_kw).detach().cpu().numpy()
    w = np.maximum(film[..., 4:5], 1e-12)
    mean = film[..., 0:3] / w
    m2 = film[..., 5:8] / w
    var = np.maximum(m2 - mean ** 2, 0.0)
    n = w[..., 0]
    return mean, var / np.maximum(n[..., None], 1.0), n


def sidak_alpha(alpha, n_tests):
    return 1.0 - (1.0 - alpha) ** (1.0 / n_tests)


def z_test(mean, var_of_mean, ref_mean, ref_var_of_mean, alpha=0.01,
           min_pass=0.9975):
    """The per-pixel two-sample Z-test (test_renders.py:112-133). Returns
    (ok, pass_fraction, p_values); the p-values in float32, the
    precision of the reference's erf."""
    diff = np.abs(mean - ref_mean)
    sigma = np.sqrt(var_of_mean + ref_var_of_mean)
    # pixels of ~zero variance on both sides compare directly
    degenerate = sigma < 1e-12
    z = diff / np.maximum(sigma, 1e-12)
    p = 1.0 - torch.special.erf(torch.as_tensor(
        z / np.sqrt(2.0), dtype=torch.float32)).numpy()
    p = np.where(degenerate, np.where(diff < 1e-6, 1.0, 0.0), p)
    a = sidak_alpha(alpha, p.size)
    passed = (p > a) | (diff < 5e-4)
    frac = float(passed.mean())
    return frac >= min_pass, frac, p


def check_scene(scene_dict, ref_dir, name, variant=None, spp=64,
                ref_spp=512, alpha=0.01, min_pass=0.9975,
                regenerate=False, device=None, **render_kw):
    """Compare a render of ``scene_dict`` with the stored reference,
    rendering the reference (mean and variance EXRs in ``ref_dir``) when
    it is missing."""
    from .bitmap import read_exr, write_exr

    os.makedirs(ref_dir, exist_ok=True)
    mean_path = os.path.join(ref_dir, f"{name}_mean.exr")
    var_path = os.path.join(ref_dir, f"{name}_var.exr")
    if regenerate or not os.path.exists(mean_path):
        ref_mean, ref_var, _ = render_with_variance(
            scene_dict, variant, spp=ref_spp, seed=1234, device=device,
            **render_kw)
        write_exr(mean_path, ref_mean)
        write_exr(var_path, ref_var)
    ref_mean = read_exr(mean_path)[0]
    ref_var = read_exr(var_path)[0]
    mean, var, _ = render_with_variance(scene_dict, variant, spp=spp, seed=7,
                                        device=device, **render_kw)
    return z_test(mean, var, ref_mean, ref_var, alpha, min_pass)
