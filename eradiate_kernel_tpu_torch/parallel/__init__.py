"""Multi-GPU rendering over torch.distributed (parallel/__init__.py
counterpart).

The pixel x sample wavefront is split into equal contiguous lane ranges,
one a shard. A process renders its shards (``Mesh.devices``: its cards,
or one card or the CPU named several times), sums their films on its
first shard device in shard order, and one ``dist.all_reduce`` sums the
processes' films (NCCL between cards, gloo on the CPU), so every process
holds the whole film; the develop step runs on it. The scene is
replicated. Seeding is keyed by the sample index, so the estimate does
not depend on the shard count, and a pixel whose samples all lie in one
shard gets the single-process value bit for bit.

One process a card is PyTorch's idiom: start them with ``torchrun
--nproc-per-node=N`` and call ``init_distributed()`` in each before
``make_mesh()``. Outside a process group ``make_mesh()`` takes every
visible card of the process.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..core.types import resolve_device
from ..films import N_BASE_CHANNELS, develop
from ..integrators import (_requires_grad, render_wavefront,
                           render_wavefront_regen)

__all__ = ["Mesh", "init_distributed", "make_mesh", "render_sharded",
           "sharded_film"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards of a sharded render. ``devices``: this process's shard
    devices, in shard order (a device may repeat); ``group``: the process
    group joining the processes, or None for this process alone; ``axis``:
    the shard axis's name. Every process of the group holds as many
    shards; shard ``rank * len(devices) + i`` runs on ``devices[i]``."""

    devices: tuple
    group: object = None
    axis: str = "rays"

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """The number of shards over every process."""
        return self.world * len(self.devices)

    def shards(self):
        """(global shard index, device) of this process's shards."""
        base = self.rank * len(self.devices)
        return [(base + i, d) for i, d in enumerate(self.devices)]


def _local_rank() -> int:
    """The card of this rank: torchrun's LOCAL_RANK, else the rank modulo
    the visible cards (ranks beyond the cards share them)."""
    return int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() % max(1, torch.cuda.device_count())))


def _indexed(device) -> torch.device:
    """``device`` as tensors report it (``cuda`` -> ``cuda:<current>``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices=None, axis="rays") -> Mesh:
    """The shards of this process, in the process group if one is
    initialised. ``devices`` (a device may repeat) default to this rank's
    card (``cuda:LOCAL_RANK``) in a group and to every visible card outside
    one; without a card that default raises (resolve_device): pass
    ``devices=["cpu"] * n`` for CPU shards. In a group every rank must
    hold as many shards (checked, a collective: call it on every rank)."""
    group = dist.group.WORLD if dist.is_initialized() else None
    if devices is None:
        resolve_device()
        if group is not None:
            devices = [torch.device("cuda", _local_rank())]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = tuple(_indexed(resolve_device(d)) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one shard device")
    if group is not None:
        counts = [None] * dist.get_world_size(group)
        dist.all_gather_object(counts, len(devices), group=group)
        if len(set(counts)) != 1:
            raise ValueError(f"ranks hold different shard counts: {counts}")
    return Mesh(devices, group, axis)


class _Replicated(torch.autograd.Function):
    """The scene's tensors that require a gradient, entering a sharded
    render: the identity forward; the backward sums the processes'
    gradients (each process differentiates its own shards), so every
    process holds the whole gradient."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.clone() for g in grads]
        for g in grads:
            dist.all_reduce(g, group=ctx.group)
        return (None, *grads)


class _Summed(torch.autograd.Function):
    """The processes' films summed by one all_reduce; the backward is the
    identity (the cotangent of the replicated sum is replicated)."""

    @staticmethod
    def forward(ctx, film, group):
        film = film.clone()
        dist.all_reduce(film, group=group)
        return film

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def _replicated(scene, mesh):
    """``scene`` with its gradient-requiring tensors entering through
    _Replicated (in a process group, under autograd)."""
    if mesh.group is None or not torch.is_grad_enabled():
        return scene
    tensors = scene.tensors()
    names = [k for k, v in tensors.items() if v.requires_grad]
    if not names:
        return scene
    outs = _Replicated.apply(mesh.group, *(tensors[k] for k in names))
    return scene.with_tensors(dict(zip(names, outs)))


def _scene_on(scene, device):
    """The scene on ``device`` (itself if it is there already)."""
    if scene.bsphere_center.device == device:
        return scene
    return scene.with_tensors({k: v.to(device)
                               for k, v in scene.tensors().items()})


def _reduce(films, mesh):
    """This process's shard films summed on its first shard device in
    order, then over the processes."""
    film = films[0]
    for f in films[1:]:
        film = film + f.to(film.device)
    if mesh.group is not None:
        film = _Summed.apply(film, mesh.group)
    return film


def _film_size(cfg):
    cw, ch = cfg.crop_size if cfg.crop_size else (cfg.film_width,
                                                  cfg.film_height)
    return cw, ch


def sharded_film(scene, mesh: Mesh, seed, spp):
    """One scan-driver pass of the whole film sharded over ``mesh``: the
    summed raw film (ch, cw, 5 + n_aov), replicated on every process. Shard
    k renders the ceil(total / n) lanes from k * ceil(total / n) on;
    lanes past the film are masked in render_wavefront. Differentiable:
    every process gets the single-process gradient."""
    cw, ch = _film_size(scene.config)
    per_dev = -(-(ch * cw * spp) // mesh.size)
    scene = _replicated(scene, mesh)
    return _reduce([render_wavefront(_scene_on(scene, dev), k * per_dev,
                                     per_dev, seed, spp)
                    for k, dev in mesh.shards()], mesh)


def render_sharded(scene, mesh: Mesh, seed=0, spp=None, develop_film=True,
                   samples_per_pass=None, regen=False, regen_lanes=1 << 14):
    """Render with the wavefront sharded over ``mesh``.

    The scan driver (default) runs passes of ``samples_per_pass`` samples
    (default min(total, 2^22 * shards), rounded up to a multiple of the
    shard count), each shard a contiguous 1/n of a pass. ``regen=True``
    runs one lane pool a shard instead: shard k streams the samples
    [k * per_dev, k * per_dev + count_k) (per_dev = ceil(total / n),
    count_k the part of that range inside the film; a shard past the end
    renders a zero film) through a pool of min(regen_lanes, per_dev)
    lanes. The lane pool is not differentiable (as in the reference):
    under autograd ``regen=True`` raises; the scan driver differentiates.

    Returns the developed image, or the raw film with ``develop_film``
    False (its AOV channels after the 5 base ones)."""
    cfg = scene.config
    spp = spp or cfg.spp
    cw, ch = _film_size(cfg)
    total = ch * cw * spp
    n = mesh.size

    if regen:
        if _requires_grad(scene):
            raise NotImplementedError(
                "render_sharded(regen=True) has no backward (the lane pool "
                "is not differentiable, as in the reference); take the "
                "gradient through the scan driver: render_sharded(regen="
                "False) or sharded_film")
        per_dev = -(-total // n)
        n_lanes = min(regen_lanes, per_dev)
        films = []
        for k, dev in mesh.shards():
            off = min(k * per_dev, total)
            film, _rays = render_wavefront_regen(
                _scene_on(scene, dev), n_lanes, seed, spp, sample_offset=off,
                total=min(per_dev, total - off), max_total=per_dev)
            films.append(film)
    else:
        if samples_per_pass is None:
            samples_per_pass = min(total, (1 << 22) * n)
        samples_per_pass = -(-samples_per_pass // n) * n
        per_dev = samples_per_pass // n
        scene = _replicated(scene, mesh)
        films = [render_wavefront(_scene_on(scene, dev), base + k * per_dev,
                                  per_dev, seed, spp)
                 for base in range(0, total, samples_per_pass)
                 for k, dev in mesh.shards()]
    film = _reduce(films, mesh)
    if not develop_film:
        return film
    mode = "mono" if cfg.variant.is_monochromatic else "rgb"
    return develop(film[..., :N_BASE_CHANNELS], mode, cfg.pixel_format)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend="nccl"):
    """Join this process to the process group (torch.distributed's
    ``init_process_group``) and pin its card, before ``make_mesh``.

    With ``coordinator_address`` ("host:port"; a URL such as
    ``file:///path`` is taken as it is) the group is ``num_processes``
    processes and this one is ``process_id``; without it torchrun's
    environment says (``env://``: RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT). The card pinned is ``cuda:LOCAL_RANK`` (else the rank
    modulo the visible cards). ``backend``: NCCL between cards; "gloo" for
    CPU shards, and for ranks that share a card (NCCL refuses two ranks on
    one GPU; gloo all-reduces CUDA tensors through the host)."""
    if backend == "nccl":
        resolve_device()
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    if torch.cuda.is_available():
        torch.cuda.set_device(_local_rank())
