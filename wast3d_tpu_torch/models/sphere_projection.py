"""SphereProjectionModel: the learned sphere projector MLP.

Port of `wast3d_tpu/models/sphere_projection.py` (flax there; the reference
`nerf2nerf/networks.py:160-214`): positional-encode 3D points (num_freqs 2,
max_freq_log2 2), a 2-layer ReLU encoder, a linear head predicting a 3x3
matrix, and a 2-layer decoder producing projected points.
`state_dict_from_flax` carries a flax parameter tree across.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from wast3d_tpu_torch.models.encodings import nerf_positional_encoding

# flax's auto-names of the five Dense layers, in creation order
_FLAX_NAMES = {"enc1": "Dense_0", "enc2": "Dense_1", "rot": "Dense_2",
               "dec1": "Dense_3", "out": "Dense_4"}


class SphereProjectionModel(nn.Module):
    def __init__(self, hidden_dim: int = 128, output_dim: int = 3, num_freqs: int = 2,
                 max_freq_log2: float = 2.0):
        super().__init__()
        self.num_freqs = num_freqs
        self.max_freq_log2 = max_freq_log2
        enc_dim = 3 * 2 * num_freqs
        self.enc1 = nn.Linear(enc_dim, hidden_dim)
        self.enc2 = nn.Linear(hidden_dim, hidden_dim)
        self.rot = nn.Linear(hidden_dim, 9)
        self.dec1 = nn.Linear(hidden_dim, hidden_dim)
        self.out = nn.Linear(hidden_dim, output_dim)

    def forward(self, points: torch.Tensor):
        """points [N, 3] -> (projected [N, output_dim], rot [N, 3, 3])."""
        enc = nerf_positional_encoding(points, max_freq_log2=self.max_freq_log2,
                                       num_freqs=self.num_freqs)
        h = torch.relu(self.enc1(enc))
        h = torch.relu(self.enc2(h))
        rot = self.rot(h).reshape(-1, 3, 3)
        d = torch.relu(self.dec1(h))
        return self.out(d), rot


def state_dict_from_flax(params) -> dict:
    """A flax `{"params": {"Dense_i": {"kernel", "bias"}}}` tree (or its
    inner dict) of numpy arrays -> this module's state_dict. A Dense kernel
    is [in, out]; an `nn.Linear` weight is [out, in]."""
    tree = params.get("params", params)
    sd = {}
    for name, flax_name in _FLAX_NAMES.items():
        layer = tree[flax_name]
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(layer["kernel"], np.float32).T))
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(layer["bias"], np.float32).copy())
    return sd
