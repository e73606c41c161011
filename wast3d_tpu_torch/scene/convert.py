"""Carry a scene's weights across from the JAX package.

`scene_from_numpy` takes the fields of a `wast3d_tpu` GaussianScene as
numpy arrays (for example `{f: np.asarray(getattr(s, f)) for f in ...}`)
and returns the port's scene. Nothing here imports JAX: the caller does
the conversion to numpy.
"""

from __future__ import annotations

from wast3d_tpu_torch.device import DeviceLike
from wast3d_tpu_torch.scene.gaussians import GaussianScene, from_arrays

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "mask")


def scene_from_numpy(d: dict, device: DeviceLike = None) -> GaussianScene:
    """`d` holds the array fields of `FIELDS` plus the ints
    `active_sh_degree` and `max_sh_degree`."""
    return from_arrays(
        xyz=d["xyz"], features_dc=d["features_dc"],
        features_rest=d["features_rest"], scaling=d["scaling"],
        rotation=d["rotation"], opacity=d["opacity"], mask=d["mask"],
        max_sh_degree=int(d["max_sh_degree"]),
        active_sh_degree=int(d["active_sh_degree"]),
        device=device,
    )
