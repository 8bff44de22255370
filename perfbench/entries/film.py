"""Films through the port's public render: one call renders one whole raw
film (H, W, 5) [X, Y, Z, A, W] of the configuration's scene, on the lane
pool (``regen``) or the scan driver, ``samples_per_pass`` lanes or
samples at a time."""

import torch


class Runner:
    def __init__(self, cfg, mix, scenes, device):
        from eradiate_kernel_tpu_torch.core.types import Variant
        from eradiate_kernel_tpu_torch.scene import load_dict

        self.mix = mix
        self.device = torch.device(device)
        self.inputs = scenes.inputs(cfg["scene"])
        d = scenes.scene_dict(cfg["scene"], self.inputs, mix["width"],
                              mix["height"], mix["spp"])
        self.scene = load_dict(d, Variant(cfg["variant"]), device=device)
        self.samples = mix["width"] * mix["height"] * mix["spp"]

    def __call__(self, seed, spp=None):
        from eradiate_kernel_tpu_torch import integrators

        return integrators.render(
            self.scene, seed=seed, spp=spp, regen=self.mix["regen"],
            samples_per_pass=self.mix["samples_per_pass"],
            develop_film=False)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self):
        self.scene = None
