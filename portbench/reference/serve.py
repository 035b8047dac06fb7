"""The plain reference of the serving forward: the model's features and main
head in eval mode, on uint8 frames normalized as the published transform
does (``/255``, ImageNet mean and std), in float32 with TF32 off, in blocks
of frames. ``control="tf32"`` runs it with TF32 on. Nothing here imports
the port."""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.reference.follow import build_model, state_shapes
from portbench.reference.producer import MEAN, STD


class ServeReference:
    def __init__(self, config: dict, seed: int, device):
        with torch.device(device):
            self.model = build_model(config)
        self.model.load_state_dict(inputs.make_weights(state_shapes(config, device), seed, device))
        self.model.eval()
        self.device = device
        self.mean = torch.tensor(MEAN, device=device)
        self.std = torch.tensor(STD, device=device)

    @torch.no_grad()
    def heatmaps(self, frames: torch.Tensor, control: str | None = None) -> torch.Tensor:
        """``(B, H, W, 3)`` uint8 frames → ``(B, h, w, K)`` float32 heatmaps."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = control == "tf32"
        try:
            x = (frames.to(self.device).to(torch.float32) / 255.0 - self.mean) / self.std
            return self.model.main_head(self.model.features(x))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
