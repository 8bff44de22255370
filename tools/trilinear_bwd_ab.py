"""Times of the grid lookup's backward entry (grid_trilinear_bwd of
csrc/grid_gather.cu, through ops.gather.grid_trilinear_bwd) of the
eradiate_kernel_tpu_torch package of the checkout this script sits in, on
two loads at C = 1, 3 and 8, in float32 and float64:

  A  32,768 random lanes on a 64^3 grid (chip_smoke.py phase 13's load);
  B  the adjoint's own lanes: the (ct, slot, pl) of the grid_trilinear_bwd
     call with the most lanes of the 64^3 atmosphere's value+grad
     (256x256 spp 2 max_depth 6, 32,768 lanes: C = 1, phase 14's large3d)
     and of the 8-band chromatic 64^3's with respect to its spectral
     sigma_t (64x64 spp 2 max_depth 6: C = 8, phase 37c's); C = 3 takes
     the C = 1 capture's lanes and its cotangent times (0.5, 1, 1.5).

Each load is first held against volumes.trilinear_backward_plain (rtol
1e-5 and atol 1e-7 in float32, 1e-12 and 1e-15 in float64), then timed:
``ms`` by CUDA events over 200 back-to-back wrapper calls (host time
included), ``device_us`` the kernel's profiler time a call, ``all_us``
every kernel of a call (the kernel and the zeroing of d_grid). Prints one
JSON line with the card's name and power limit, the label and, for each
load, the lanes, the share of lanes whose corner row another lane of
their warp shares, the bound and the times. The bound counts the bytes
that chip_smoke.py's trilinear_bwd_bytes gives: the inputs read once and
each distinct voxel that the lanes' corners touch written once.

To compare two checkouts on one card, capture load B once into a file
(the first run whose --loads file is missing captures it, with the
chip_smoke.py of its checkout, which must have capture_bwd and
trilinear_bwd_bytes), then copy
this script into each checkout's tools/ and run the copies in turns (A,
B, B, A) on one card:

    python3 tools/trilinear_bwd_ab.py --label NAME --loads FILE
"""

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def make_loads(path):
    """Loads A and B (B captured from one backward call of each
    value+grad), each with its warps' shared-row share and its bound's
    bytes in float32 and float64, saved on the CPU to ``path``."""
    from chip_smoke import (bwd_warp_lanes, capture_bwd,
                            chromatic_atmosphere, shared_row_share,
                            trilinear_bwd_bytes, value_grad)
    from eradiate_kernel_tpu_torch.core.types import Variant
    from eradiate_kernel_tpu_torch.scene import load_dict
    from eradiate_kernel_tpu_torch.utils.scenes import atmosphere

    d = atmosphere(256, 256, 2, 6, grid_res=(64, 64, 64))
    d["integrator"]["nee_transmittance"] = "residual"
    scenes = {
        1: (load_dict(d), ["volumes.gridvolume.grid"]),
        8: (load_dict(chromatic_atmosphere(64, 64, 2, True, 6),
                      Variant("spectral")),
            ["volumes.gridvolume_spectral.grid"])}
    captured = {}
    for C, (scene, keys) in scenes.items():
        with capture_bwd({}) as cap:
            value_grad(scene, 1 << 15, keys, with_primal=False)
        assert cap["shape"][-1] == C, cap["shape"]
        captured[C] = cap
    gen = torch.Generator().manual_seed(13)
    pl_a = torch.rand(1 << 15, 3, generator=gen)
    slot_a = torch.zeros(1 << 15, dtype=torch.int32)
    loads = {}
    for C in (1, 3, 8):
        loads[f"A C={C}"] = dict(shape=(1, 64, 64, 64, C), slot=slot_a,
                                 pl=pl_a,
                                 ct=torch.randn(1 << 15, C, generator=gen))
    for C, b in ((1, captured[1]), (3, captured[1]), (8, captured[8])):
        # C = 3: the adjoint's own cotangent scaled by 0.5, 1 and 1.5 (a
        # random-signed one cancels on the thousands of lanes that share
        # the cube's top voxels, and no order of atomic sums then meets
        # rtol 1e-5)
        ct = b["ct"].cpu()
        if C == 3:
            ct = ct * torch.tensor([0.5, 1.0, 1.5])
        loads[f"B C={C}"] = dict(shape=b["shape"][:4] + (C,),
                                 slot=b["slot"].cpu(), pl=b["pl"].cpu(),
                                 ct=ct)
    for rec in loads.values():
        C = rec["shape"][-1]
        rec["share"] = {str(t)[6:]: shared_row_share(
            rec["shape"], rec["slot"], rec["pl"], bwd_warp_lanes(C, t))
            for t in (torch.float32, torch.float64)}
        rec["bytes"] = {str(t)[6:]: trilinear_bwd_bytes(
            rec["shape"], rec["slot"], rec["pl"], t.itemsize)
            for t in (torch.float32, torch.float64)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(loads, path)
    return loads


def time_load(ct, shape, slot, pl, nbytes):
    """Hold one load against the plain version and time it; ``nbytes``
    is its bound's bytes."""
    from chip_smoke import HBM_BYTES_PER_S, cuda_ms, device_us
    from eradiate_kernel_tpu_torch.ops import gather
    from eradiate_kernel_tpu_torch.textures import volumes

    out = gather.grid_trilinear_bwd(ct, shape, slot, pl)
    ref = volumes.trilinear_backward_plain(ct, shape, slot, pl)
    torch.cuda.synchronize()
    f64 = ct.dtype == torch.float64
    torch.testing.assert_close(out, ref, rtol=1e-12 if f64 else 1e-5,
                               atol=1e-15 if f64 else 1e-7)
    L, C = ct.shape
    call = lambda: gather.grid_trilinear_bwd(ct, shape, slot, pl)
    return dict(lanes=L, channels=C,
                max_abs_err=float((out - ref).abs().max()),
                bound_us=nbytes / HBM_BYTES_PER_S * 1e6,
                ms=cuda_ms(call, reps=200),
                device_us=device_us(call, ("grid_trilinear_bwd",)),
                all_us=device_us(call))


def main():
    if not torch.cuda.is_available():
        print("trilinear_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    label = args[args.index("--label") + 1] if "--label" in args else ""
    path = (args[args.index("--loads") + 1] if "--loads" in args
            else os.path.join(ROOT, "smoke_out", "trilinear_bwd_loads.pt"))
    # importing gather registers grid_gather.cu with _build
    from eradiate_kernel_tpu_torch.ops import _build, gather  # noqa: F401

    _build.build_kernels(("grid_gather",))
    loads = torch.load(path) if os.path.exists(path) else make_loads(path)
    dev = torch.device("cuda")
    out = {"label": label,
           "device": torch.cuda.get_device_name(0), "loads": {}}
    for name, ld in loads.items():
        for dtype in (torch.float32, torch.float64):
            t = str(dtype)[6:]
            rec = time_load(ld["ct"].to(dev, dtype), ld["shape"],
                            ld["slot"].to(dev), ld["pl"].to(dev, dtype),
                            ld["bytes"][t])
            rec["shared_row_share"] = ld["share"][t]
            out["loads"][f"{name} {t}"] = rec
    out["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
