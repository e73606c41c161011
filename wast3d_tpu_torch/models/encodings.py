"""Positional encodings (NeRF-style).

Port of `wast3d_tpu/models/encodings.py` (the reference
`nerf2nerf/networks.py:73-138`): the classic NeRF `Embedder` (optional input
passthrough, log or linear frequency bands, sin + cos) and the simpler
`nerf_positional_encoding` (sin / cos at 2^linspace(0, max_freq_log2,
num_freqs)).

The bands follow `jnp.linspace` in float32 as XLA computes it from 0,
i * (stop / (num - 1)) with the last set to stop: bit for bit for every
log-sampled band, where `torch.linspace` differs by an ulp (at a band of
~1000 one ulp moves sin by ~6e-5). Linear bands, which start at 1, may
differ from JAX's by an ulp.
"""

from __future__ import annotations

from typing import List

import torch


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """float32 `jnp.linspace(start, stop, num)` (module docstring)."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    start32 = torch.tensor(start, dtype=torch.float32)
    step = (torch.tensor(stop, dtype=torch.float32) - start32) / (num - 1)
    out = start32 + torch.arange(num, dtype=torch.float32) * step
    out[-1] = stop
    return out


class Embedder:
    """NeRF positional embedding (reference `Embedder`, `networks.py:73-107`)."""

    def __init__(
        self,
        input_dims: int = 3,
        include_input: bool = True,
        max_freq_log2: int = 10,
        num_freqs: int = 10,
        log_sampling: bool = True,
        periodic_fns=(torch.sin, torch.cos),
    ):
        self.include_input = include_input
        if log_sampling:
            self.freq_bands = 2.0 ** _linspace(0.0, max_freq_log2, num_freqs)
        else:
            self.freq_bands = _linspace(2.0 ** 0.0, 2.0 ** max_freq_log2, num_freqs)
        self.periodic_fns = periodic_fns
        self.out_dim = (input_dims if include_input else 0) + input_dims * len(
            periodic_fns) * num_freqs

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        parts: List[torch.Tensor] = [x] if self.include_input else []
        for freq in self.freq_bands.to(x.device):
            for fn in self.periodic_fns:
                parts.append(fn(x * freq))
        return torch.cat(parts, dim=-1)


def nerf_positional_encoding(x: torch.Tensor, max_freq_log2: float = 10.0,
                             num_freqs: int = 6) -> torch.Tensor:
    """Reference `NeRFPositionalEncoding.forward` (`networks.py:113-138`):
    x [..., 3] -> [..., 3 * 2 * num_freqs], per input coordinate its sin
    block then its cos block."""
    bands = 2.0 ** _linspace(0.0, max_freq_log2, num_freqs).to(x.device)  # [F]
    xe = x[..., None]  # [..., 3, 1]
    enc = torch.cat([torch.sin(bands * xe), torch.cos(bands * xe)], dim=-1)  # [..., 3, 2F]
    return enc.reshape(*x.shape[:-1], -1)
