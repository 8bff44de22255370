"""Phase 40 alone on the card: build, then chip_smoke.slice_7b_phases."""
import json, subprocess, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from eradiate_kernel_tpu_torch.ops import _build, accel, bvh, gather, intersect  # noqa: F401
from eradiate_kernel_tpu_torch.utils import bitmap
t0 = time.time()
print("build", _build.build_kernels(), flush=True)
print("host libs", accel._builder(), bvh._builder(), bitmap._load_bridge(), bitmap._bridge_missing(), flush=True)
print(f"# device: {torch.cuda.get_device_name(0)}", flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout, flush=True)
V, F = cs.terrain(256)
rec = cs.slice_7b_phases(V, F)
print(json.dumps({"slice_7b": rec}))
print(json.dumps({k: cs.slice_7b_launches(rec, k) for k in ("tile_sweep", "tile_bvh", "tile_bvh8", "grid_gather", "grid_trilinear_bwd")}))
print(json.dumps({"phase_starts_s": cs.PHASE_STARTS}))
print("phase 40 seconds", time.time() - t0, flush=True)
