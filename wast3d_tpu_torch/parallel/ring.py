"""Ring-sharded nearest neighbours: k-NN with both point sets over the model axis.

Port of `wast3d_tpu/parallel/ring.py`, ring attention's pattern on point
clouds: each rank holds a contiguous slice of the queries and of the data;
at every step it folds its queries against the resident column block into
a running top-k, then the block moves one hop around the ring (rank r sends
to r + 1). After as many steps as ranks every query has seen every column
once: O(N M / P) work and O(N / P + M / P) memory a rank, no N x M matrix.

Each hop runs `ops.knn.knn_sq_dists` on the resident block, the
single-device function: the same expansion-form distances in column blocks
of `block`, with global row and column indices and the running top-k
folded in. Slices may be uneven (JAX needs N divisible by the axis). As in
JAX, ties between blocks keep the block folded first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from wast3d_tpu_torch.ops.knn import _BIG, knn_sq_dists
from wast3d_tpu_torch.parallel import collectives as C
from wast3d_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size


def ring_knn_sq_dists(
    query: torch.Tensor,
    data: torch.Tensor,
    k: int,
    mesh,
    exclude_self: bool = False,
    query_valid: Optional[torch.Tensor] = None,
    data_valid: Optional[torch.Tensor] = None,
    block: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN with this rank's queries [n, D] and data rows [m, D], both
    contiguous slices (in rank order) of sets sharded over the model axis.
    Returns this rank's (dists [n, k], global indices [n, k]), with the
    semantics of `ops.knn.knn_sq_dists` on the whole sets."""
    group = axis_group(mesh, "model")
    p, me = axis_size(mesh, "model"), axis_index(mesh, "model")
    q_sizes = C.gather_sizes(query.shape[0], group)
    d_sizes = C.gather_sizes(data.shape[0], group)
    q_off = sum(q_sizes[:me])
    valid = (torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
             if data_valid is None else data_valid.to(torch.bool))
    # The block travels with its validity as one [m, D + 1] float tensor.
    resident = torch.cat([data.to(torch.float32), valid.to(torch.float32)[:, None]], 1)
    best = None
    for step in range(p):
        src = (me - step) % p
        best = knn_sq_dists(query, resident[:, :-1], k, data_mask=resident[:, -1] > 0,
                            exclude_self=exclude_self, block=block, best=best,
                            row_offset=q_off, col_offset=sum(d_sizes[:src]))
        if step + 1 < p:
            send, recv = [0] * p, [0] * p
            send[(me + 1) % p] = resident.shape[0]
            recv[(me - 1) % p] = d_sizes[(me - step - 1) % p]
            resident = C.all_to_all(resident, send, recv, group)
    best_d, best_i = best
    if query_valid is not None:
        best_d = torch.where(query_valid.to(torch.bool)[:, None], best_d, _BIG)
    return best_d, best_i


def ring_mean_sq_dist_to_3nn(points: torch.Tensor, mesh,
                             valid: Optional[torch.Tensor] = None,
                             block: int = 2048) -> torch.Tensor:
    """The sharded `ops.knn.mean_sq_dist_to_3nn` (the scale initialisation)
    for this rank's points: [n] mean squared distance to the 3 nearest
    other points of the whole set."""
    d, _ = ring_knn_sq_dists(points, points, k=3, mesh=mesh, exclude_self=True,
                             query_valid=valid, data_valid=valid, block=block)
    return torch.mean(d, dim=-1)
