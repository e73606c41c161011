"""VGG19 feature extractor and the neural-style losses.

Port of `wast3d_tpu/ops/vgg.py` (the reference `loss_utils.py:66-205`):
- VGG19 `features[:29]` (conv1_1 .. conv5_1), capturing the pre-ReLU conv
  outputs at torchvision indices [0, 5, 10, 19, 28];
- `get_features` resizes the input to 112 x 112 by the nearest pixel and
  applies no ImageNet normalisation, as the reference does;
- content loss: sum over layers of MSE; style loss: sum over layers of the
  MSE between unnormalised Gram matrices (batch element 0).

Weights are carried by torchvision's keys (`features.{idx}.weight/bias`):
a `.pth` state dict (`torch.load(weights_only=True)`), an `.npz` with the
same names, or the file named by `WAST3D_VGG19_WEIGHTS`. Without one,
`init_random_params(seed)` draws the JAX package's He-init weights from the
same numpy generator, so both packages get the same random weights.

Images are [H, W, 3] or [B, H, W, 3] as in JAX, and captured features are
returned as [B, H', W', C]; the convolutions run in NCHW inside.

Precision: on the card a float32 `conv2d` goes through cuDNN, which by
PyTorch's default (`torch.backends.cudnn.allow_tf32 = True`) computes in
TF32, about three decimal digits. Every convolution and Gram product here,
forward and backward, runs inside `full_f32()`, which sets IEEE float32 for
its duration and raises if the setting does not hold, so a loss or metric
does not depend on the caller's flags. On the CPU both directions bypass
oneDNN: its 3x3 convolution rounds conv4_1 to 2.5e-6 of its largest value
(the native one to 1e-6), enough to flip a few near-zero ReLU and max-pool
decisions, and then VGG19's input gradient differs from float64 by up to
4e-3 of its largest value, against ~1e-6 natively (one seeded 32^2 case).
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# torchvision vgg19.features[:29]: (layer_idx, type, in_ch, out_ch)
_LAYERS = [
    (0, "conv", 3, 64), (1, "relu"), (2, "conv", 64, 64), (3, "relu"),
    (4, "pool"),
    (5, "conv", 64, 128), (6, "relu"), (7, "conv", 128, 128), (8, "relu"),
    (9, "pool"),
    (10, "conv", 128, 256), (11, "relu"), (12, "conv", 256, 256), (13, "relu"),
    (14, "conv", 256, 256), (15, "relu"), (16, "conv", 256, 256), (17, "relu"),
    (18, "pool"),
    (19, "conv", 256, 512), (20, "relu"), (21, "conv", 512, 512), (22, "relu"),
    (23, "conv", 512, 512), (24, "relu"), (25, "conv", 512, 512), (26, "relu"),
    (27, "pool"),
    (28, "conv", 512, 512),
]

CAPTURE_LAYERS = (0, 5, 10, 19, 28)  # reference req_features


def he_init(layers, seed: int) -> dict:
    """He-init conv weights (zero biases) for a layer list, drawn in the
    JAX package's order from `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    params = {}
    for spec in layers:
        if spec[1] != "conv":
            continue
        idx, _, cin, cout = spec
        w = rng.normal(0, np.sqrt(2.0 / (cin * 9)), (cout, cin, 3, 3))
        params[f"features.{idx}.weight"] = w.astype(np.float32)
        params[f"features.{idx}.bias"] = np.zeros(cout, np.float32)
    return params


def read_state_dict(path: str) -> dict:
    """A state dict as numpy arrays: `.npz`, else a torch file."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def init_random_params(seed: int = 0) -> dict:
    """Deterministic He-init stand-in weights (no pretrained available)."""
    return he_init(_LAYERS, seed)


def load_weights(path: Optional[str] = None, seed: int = 0) -> dict:
    """A torchvision-format vgg19 state dict (.pth or .npz) as float32 numpy
    arrays, else the random fallback. Env override: WAST3D_VGG19_WEIGHTS."""
    path = path or os.environ.get("WAST3D_VGG19_WEIGHTS")
    if not path:
        return init_random_params(seed)
    data = read_state_dict(path)
    params = {}
    for spec in _LAYERS:
        if spec[1] != "conv":
            continue
        for part in ("weight", "bias"):
            key = f"features.{spec[0]}.{part}"
            params[key] = np.asarray(data[key], np.float32)
    return params


def to_device(params: dict, device) -> dict:
    """The weight dict as float32 tensors on `device`."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in params.items()}


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions and CUDA float32 matmuls in IEEE float32 inside
    the block, whatever the caller's TF32 settings; the settings are put
    back on exit. Uses the per-operator `fp32_precision` switches where this
    PyTorch has them (the legacy `allow_tf32` flags otherwise) and raises if
    the setting does not read back."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if hasattr(getattr(cudnn, "conv", None), "fp32_precision"):
        knobs, attr, want = (cudnn.conv, matmul), "fp32_precision", "ieee"
    else:
        knobs, attr, want = (cudnn, matmul), "allow_tf32", False
    saved = [getattr(k, attr) for k in knobs]
    try:
        for k in knobs:
            setattr(k, attr, want)
        if any(getattr(k, attr) != want for k in knobs):
            raise RuntimeError("could not set IEEE float32 for convolutions and matmuls")
        yield
    finally:
        for k, v in zip(knobs, saved):
            setattr(k, attr, v)


@contextlib.contextmanager
def _without_onednn():
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved


class _Conv3x3(torch.autograd.Function):
    """SAME-padded 3x3 convolution (NCHW) whose forward and backward both
    run under `full_f32()`, without oneDNN (module docstring)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with full_f32(), _without_onednn():
            return F.conv2d(x, w, b, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with full_f32(), _without_onednn():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                list(ctx.needs_input_grad))
        return gx, gw, gb


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAME-padded 3x3 convolution of [B, Cin, H, W] by [Cout, Cin, 3, 3],
    in IEEE float32 both ways."""
    return _Conv3x3.apply(x, w, b)


def conv_stack(params: dict, x: torch.Tensor, layers, on_conv=None, on_relu=None) -> None:
    """Run a torchvision `features` layer list on NCHW `x`; `on_conv(idx,
    x)` / `on_relu(idx, x)` see each conv's / ReLU's output. Stops after the
    last layer of the list."""
    for spec in layers:
        kind, idx = spec[1], spec[0]
        if kind == "conv":
            w, b = (torch.as_tensor(params[f"features.{idx}.{part}"], device=x.device)
                    for part in ("weight", "bias"))
            x = conv3x3(x, w, b)
            if on_conv is not None:
                on_conv(idx, x)
        elif kind == "relu":
            x = torch.relu(x)
            if on_relu is not None:
                on_relu(idx, x)
        else:
            x = F.max_pool2d(x, 2, 2)


def vgg_features(params: dict, image: torch.Tensor,
                 capture: Sequence[int] = CAPTURE_LAYERS) -> List[torch.Tensor]:
    """Run the conv stack on [H, W, 3] (or [B, H, W, 3]) in [0, 1]. Returns
    the pre-ReLU conv outputs at `capture` as [B, H', W', C] tensors.
    `params` may hold numpy arrays; tensors on the image's device
    (`to_device`) save a copy per call."""
    x = image[None] if image.dim() == 3 else image
    feats = []

    def keep(idx, y):
        if idx in capture:
            feats.append(y.permute(0, 2, 3, 1))

    conv_stack(params, x.permute(0, 3, 1, 2), _LAYERS, on_conv=keep)
    return feats


def get_features(params: dict, image: torch.Tensor, size: int = 112) -> List[torch.Tensor]:
    """Nearest-pixel resize to size x size, no normalisation, then the
    capture stack. `jax.image.resize(..., "nearest")` samples each output
    pixel at its centre, which is torch's "nearest-exact" (torch's
    "nearest" floors and picks other pixels)."""
    x = image[None] if image.dim() == 3 else image
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="nearest-exact")
    return vgg_features(params, x.permute(0, 2, 3, 1))


def content_loss(feats_gt: List[torch.Tensor], feats_pred: List[torch.Tensor],
                 layers: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Sum over (selected) layers of MSE."""
    idxs = range(len(feats_gt)) if layers is None else layers
    return sum(torch.mean((feats_gt[i] - feats_pred[i]) ** 2) for i in idxs)


class _Gram(torch.autograd.Function):
    """f^T f of an [M, C] matrix, forward and backward under `full_f32()`."""

    @staticmethod
    def forward(ctx, f):
        ctx.save_for_backward(f)
        with full_f32():
            return f.T @ f

    @staticmethod
    def backward(ctx, g):
        (f,) = ctx.saved_tensors
        with full_f32():
            return f @ (g + g.T)


def gram(feat: torch.Tensor) -> torch.Tensor:
    """Unnormalised Gram matrix [C, C] of batch element 0 of [B, H, W, C]."""
    return _Gram.apply(feat[0].reshape(-1, feat.shape[-1]))


def style_loss(feats_gt: List[torch.Tensor], feats_pred: List[torch.Tensor],
               layers: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Sum over (selected) layers of Gram-matrix MSE."""
    idxs = range(len(feats_gt)) if layers is None else layers
    return sum(torch.mean((gram(feats_pred[i]) - gram(feats_gt[i])) ** 2) for i in idxs)
