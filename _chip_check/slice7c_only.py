"""Phase 41 alone on the card(s): build, phase 10's large3d film, then
chip_smoke.slice_7c_phases (run from the repository root; with several
cards 41a spawns one NCCL rank a card)."""
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")


def main():
    import torch

    import chip_smoke as cs
    from eradiate_kernel_tpu_torch.ops import _build, gather, intersect  # noqa: F401

    t0 = time.time()
    print("build", _build.build_kernels(), flush=True)
    print(f"# device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout, flush=True)
    large = cs.large3d_scene()
    film, secs, launches, _counts = cs.counted_pool(large, cs.S41_LANES)
    print(f"phase 10's large3d film: {secs:.2f} s, launches "
          f"{launches['tile_sweep']} / {launches['grid_gather']}", flush=True)
    rec = cs.slice_7c_phases(film)
    print(json.dumps({"slice_7c": rec}))
    print(json.dumps({k: cs.slice_7c_launches(rec, k) for k in (
        "tile_sweep", "grid_gather", "grid_trilinear_bwd")}))
    print(json.dumps({"phase_starts_s": cs.PHASE_STARTS}))
    print("phase 41 script seconds", time.time() - t0, flush=True)


if __name__ == "__main__":
    main()
