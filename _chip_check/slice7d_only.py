"""Phase 42 alone on the card: chip_smoke.slice_7d_phases (the warps,
math helpers and the BSDFs' transport mode, the card against the CPU, and
volume_eval_gradient through the grid_gather kernel against the plain
gather, which builds that kernel at its first launch). Run from the
repository root."""
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")


def main():
    import torch

    import chip_smoke as cs

    t0 = time.time()
    print(f"# device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout, flush=True)
    rec = cs.slice_7d_phases()
    print(json.dumps({"slice_7d": rec}))
    print(json.dumps({"phase_starts_s": cs.PHASE_STARTS}))
    print("phase 42 script seconds", time.time() - t0, flush=True)


if __name__ == "__main__":
    main()
