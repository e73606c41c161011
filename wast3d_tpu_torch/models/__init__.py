"""Model registry: the parametric models this framework trains.

- GaussianScene: the flagship model (3D Gaussian scene).
- VGG19 feature extractor / VGG16-LPIPS: frozen perceptual networks
  (`ops/vgg.py`, `ops/lpips.py`).
- Positional encodings + SphereProjectionModel: the nerf2nerf auxiliary
  experiments (learned sphere projector).
"""

from wast3d_tpu_torch.models.encodings import (  # noqa: F401
    Embedder,
    nerf_positional_encoding,
)
from wast3d_tpu_torch.models.sphere_projection import SphereProjectionModel  # noqa: F401
from wast3d_tpu_torch.scene.gaussians import GaussianScene  # noqa: F401
