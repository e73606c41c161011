"""LPIPS perceptual metric (VGG16 backbone + learned linear heads).

Port of `wast3d_tpu/ops/lpips.py` (the reference's vendored `lpipsPyTorch`,
used by `metrics.py`): the input is z-scored with the reference's constants,
VGG16 relu1_2 .. relu5_3 activations are unit-normalised across channels
(+1e-10 outside the norm), squared differences are reduced by the 1x1
linear heads, averaged over space and summed over layers.

Weights come from files (torch state dicts or .npz): `WAST3D_VGG16_WEIGHTS`
for the backbone (torchvision `features.*` keys), `WAST3D_LPIPS_WEIGHTS` for
the heads (the download's `lin{i}.model.1.weight`, the reference's renamed
`{i}.1.weight`, or plain `{i}.weight`). Without both, the backbone is the
JAX package's seeded He-init draw, the heads are uniform, and the metric is
reported as `lpips_proxy`: a relative perceptual distance, not comparable
to published LPIPS numbers. `is_calibrated()` says which one it is.

The convolutions run in IEEE float32 whatever the caller's TF32 flags
(`ops/vgg.py::full_f32`), so the metric does not depend on them.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.vgg import conv_stack, he_init, read_state_dict

# torchvision vgg16.features: conv indices and relu capture points
_VGG16_LAYERS = [
    (0, "conv", 3, 64), (1, "relu"), (2, "conv", 64, 64), (3, "relu"),
    (4, "pool"),
    (5, "conv", 64, 128), (6, "relu"), (7, "conv", 128, 128), (8, "relu"),
    (9, "pool"),
    (10, "conv", 128, 256), (11, "relu"), (12, "conv", 256, 256), (13, "relu"),
    (14, "conv", 256, 256), (15, "relu"),
    (16, "pool"),
    (17, "conv", 256, 512), (18, "relu"), (19, "conv", 512, 512), (20, "relu"),
    (21, "conv", 512, 512), (22, "relu"),
    (23, "pool"),
    (24, "conv", 512, 512), (25, "relu"), (26, "conv", 512, 512), (27, "relu"),
    (28, "conv", 512, 512), (29, "relu"),
]
_CAPTURE_RELU = (3, 8, 15, 22, 29)  # relu1_2, 2_2, 3_3, 4_3, 5_3
_CHANNELS = (64, 128, 256, 512, 512)

# The reference's z-score constants (`lpipsPyTorch/modules/networks.py`),
# not ImageNet's; [0, 1] images go straight into this normalisation.
_MEAN = np.array([-0.030, -0.088, -0.188], np.float32)
_STD = np.array([0.458, 0.448, 0.450], np.float32)


def _load_lins(path: Optional[str]) -> List[np.ndarray]:
    if not path:
        return [np.full(c, 1.0 / c, np.float32) for c in _CHANNELS]
    data = read_state_dict(path)

    def pick(i):
        for k in (f"lin{i}.model.1.weight", f"{i}.1.weight", f"{i}.weight"):
            if k in data:
                return data[k]
        raise KeyError(f"no lin weight for layer {i} in {list(data)[:8]}")

    return [np.asarray(pick(i), np.float32).reshape(-1) for i in range(5)]


class LPIPS(nn.Module):
    """`LPIPS()(img1, img2)`: [H, W, 3] images in [0, 1] (numpy or tensors)
    -> scalar distance, on `device` (None means CUDA)."""

    def __init__(self, backbone_path: Optional[str] = None,
                 lin_path: Optional[str] = None, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        backbone_path = backbone_path or os.environ.get("WAST3D_VGG16_WEIGHTS")
        lin_path = lin_path or os.environ.get("WAST3D_LPIPS_WEIGHTS")
        self.calibrated = bool(backbone_path and lin_path)
        if backbone_path:
            data = read_state_dict(backbone_path)
            params = {k: np.asarray(v, np.float32) for k, v in data.items()
                      if k.startswith("features.")}
        else:
            params = he_init(_VGG16_LAYERS, seed)
        dev = resolve_device(device)
        self.keys = sorted(params)
        for k in self.keys:
            self.register_buffer(k.replace(".", "_"), torch.as_tensor(params[k], device=dev))
        for i, lin in enumerate(_load_lins(lin_path)):
            self.register_buffer(f"lin{i}", torch.as_tensor(lin, device=dev).view(1, -1, 1, 1))
        self.register_buffer("mean", torch.as_tensor(_MEAN, device=dev).view(1, 3, 1, 1))
        self.register_buffer("std", torch.as_tensor(_STD, device=dev).view(1, 3, 1, 1))

    def is_calibrated(self) -> bool:
        return self.calibrated

    @property
    def metric_name(self) -> str:
        return "lpips" if self.calibrated else "lpips_proxy"

    def _features(self, img: torch.Tensor) -> List[torch.Tensor]:
        x = (img.permute(2, 0, 1)[None] - self.mean) / self.std
        params = {k: getattr(self, k.replace(".", "_")) for k in self.keys}
        feats = []

        def keep(idx, y):
            if idx in _CAPTURE_RELU:
                feats.append(y)

        conv_stack(params, x, _VGG16_LAYERS, on_relu=keep)
        return feats

    def forward(self, img1, img2) -> torch.Tensor:
        dev = self.mean.device
        f1 = self._features(torch.as_tensor(img1, dtype=torch.float32, device=dev))
        f2 = self._features(torch.as_tensor(img2, dtype=torch.float32, device=dev))
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i, (a, b) in enumerate(zip(f1, f2)):
            an = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            bn = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            total = total + torch.mean(torch.sum((an - bn) ** 2 * getattr(self, f"lin{i}"), dim=1))
        return total
