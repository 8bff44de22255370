"""Phase 39 alone on the card: build, then chip_smoke.slice_6e_phases."""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from eradiate_kernel_tpu_torch.ops import _build, gather, intersect  # noqa: F401 (they register the kernels)
t0 = time.time()
print("build", _build.build_kernels(), flush=True)
print(f"# device: {torch.cuda.get_device_name(0)}", flush=True)
V, F = cs.terrain(256)
rec = cs.slice_6e_phases(V, F)
print(json.dumps({"slice_6e": rec}))
print(json.dumps({"tile_sweep": cs.slice_6e_launches(rec, "tile_sweep"),
                  "grid_gather": cs.slice_6e_launches(rec, "grid_gather")}))
print("phase 39 seconds", time.time() - t0, flush=True)
