"""The comparison that decides ``correct`` for film cells.

Each film the timed calls returned is held against the reference's film of
the same configuration, pixel by pixel, on the difference of their mean
radiances (the program's X, Y and Z over its weight channel, against the
reference's grey radiance times sRGB white). Both are Monte Carlo
estimates, so the per-pixel differences are noise of mean zero when the
program is right; the noise's variance is read from the differences
themselves, so that the scene's own detail does not enter it.

- ``block_chi2``: the mean over blocks of ``block`` x ``block`` pixels and
  the three channels of z^2, z being a block's mean difference over its
  standard error (about 1 for a right film, more for a bias anywhere);
  blocks where both films read 0 throughout are left out.
- ``global_z``: |z| of the whole film's mean difference in Y (a small bias
  everywhere).
- ``samples_lost``: |sum of W - H x W x spp|, the samples that never
  reached the film (a sample's jittered position may round into the next
  pixel in float32, so W is compared summed, not pixel by pixel).
- ``duplicate_films``: pairs of films in the run that are equal (every
  film has its own seed).

Each run reports the worst film of its window."""

import torch

from .common import XYZ_WHITE


def film_numbers(film, ref_sums, ref_counts, spp, block):
    """{name: value} of one (H, W, 5) film against the reference."""
    film = film.to(torch.float64)
    ref = (ref_sums.to(torch.float64) / ref_counts.to(torch.float64))
    W = film[..., 4]
    H, Wd = ref.shape
    samples_lost = float(torch.abs(W.sum() - H * Wd * spp))
    nb_h, nb_w = H // block, Wd // block
    z2 = []
    global_z = 0.0
    for c in range(3):
        mean = film[..., c] / torch.clamp(W, min=1e-30)
        diff = (mean - ref * XYZ_WHITE[c])[:nb_h * block, :nb_w * block]
        blocks = diff.reshape(nb_h, block, nb_w, block).permute(
            0, 2, 1, 3).reshape(nb_h * nb_w, block * block)
        se = blocks.std(dim=1) / block
        m = blocks.mean(dim=1)
        # a block whose differences are all 0 (sky in both films) holds
        # no evidence; one that is constant and not 0 is a bias of z = inf
        live = (se > 0) | (m != 0)
        z = m[live] / se[live]
        z2.append(z * z)
        if c == 1:
            flat = diff.reshape(-1)
            se_all = flat.std() / flat.numel() ** 0.5
            global_z = float(torch.abs(flat.mean())
                             / torch.clamp(se_all, min=1e-300))
    block_chi2 = float(torch.cat(z2).mean())
    bad = lambda v: v != v or v in (float("inf"), float("-inf"))
    if bad(block_chi2) or bad(global_z) or bad(samples_lost):
        # a NaN or infinite film: the largest number JSON carries
        block_chi2 = global_z = samples_lost = 1e300
    return {"block_chi2": block_chi2, "global_z": global_z,
            "samples_lost": samples_lost}


def mean_ratio(films, ref_sums, ref_counts):
    """The films' mean radiance (Y over W) over the reference's."""
    y = sum(float(f[..., 1].double().sum()) for f in films)
    w = sum(float(f[..., 4].double().sum()) for f in films)
    ref = float(ref_sums.double().sum() / ref_counts.sum())
    return (y / w) / ref if w > 0 and ref > 0 else float("nan")


def duplicates(films):
    n = 0
    for a in range(len(films)):
        for b in range(a + 1, len(films)):
            n += bool(torch.equal(films[a], films[b]))
    return n


def run_numbers(films, ref_sums, ref_counts, spp, block):
    """The worst of each number over the run's films."""
    per = [film_numbers(f, ref_sums, ref_counts, spp, block) for f in films]
    out = {k: max(p[k] for p in per) for k in per[0]}
    out["duplicate_films"] = duplicates(films)
    return out
