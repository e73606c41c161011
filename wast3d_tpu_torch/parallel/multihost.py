"""Process groups: join one, or start the ranks of one on this host.

Port of `wast3d_tpu/parallel/multihost.py`. JAX runs one process per host
and `jax.distributed.initialize` makes every host's chips one device list.
The port runs one process per rank (`mesh.py`):
- `init_distributed` opens the process group from an address, a world size
  and a rank, or from `torchrun`'s environment (`WORLD_SIZE`, `RANK`,
  `MASTER_ADDR`, `MASTER_PORT`); it is idempotent, and a no-op returning 0
  in a single process, as JAX's is;
- `launch` is what the CLIs call with `--devices N`: under `torchrun` it
  joins the group and runs the rank's work in this process; otherwise it
  starts N local ranks with `torch.multiprocessing` (spawn), one per card
  for CUDA (nccl) and N processes on the host for the CPU (gloo); asking for
  more CUDA ranks than there are cards raises, as JAX's `make_mesh` fails
  with too few devices;
- `spawn` starts local ranks on a backend named by the caller, and hands
  back what each rank's function returned.
The backend follows the device (nccl for CUDA, gloo for the CPU) unless a
caller names one; nothing switches it on its own.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from wast3d_tpu_torch.parallel.mesh import make_mesh

TIMEOUT_S = 1800  # a collective that waits longer than this fails the run


def backend_for(device) -> str:
    """nccl for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: for CUDA, card `LOCAL_RANK` (set by torchrun and
    by `spawn`); raises if the host has no such card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or local >= torch.cuda.device_count():
        raise RuntimeError(f"rank {local} of this host needs cuda:{local}, but the host has "
                           f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", local)


def under_torchrun() -> bool:
    """Whether torchrun (or a launcher like it) started this process."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def check_ranks(nprocs: int, device) -> None:
    """Raise if `nprocs` local CUDA ranks need more cards than the host has."""
    if backend_for(device) == "nccl" and nprocs > torch.cuda.device_count():
        raise RuntimeError(f"{nprocs} CUDA ranks need {nprocs} cards; this host has "
                           f"{torch.cuda.device_count()}")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda", timeout_s: float = TIMEOUT_S) -> int:
    """Open the process group (idempotent); returns this process's rank.

    Under torchrun every argument may stay None. Elsewhere pass all three
    (`coordinator_address` as host:port of rank 0; a CUDA rank takes card
    `LOCAL_RANK`, `process_id` where it is not set). With nothing to
    coordinate (no address, one process, no torchrun) this is a no-op
    returning 0. The backend is nccl for `device` "cuda" (this rank's
    card becomes the current device) and gloo for "cpu"; a collective that
    waits longer than `timeout_s` fails."""
    if dist.is_initialized():
        return dist.get_rank()
    env = under_torchrun()
    if not env and (coordinator_address is None or num_processes in (None, 1)):
        return 0
    backend = backend_for(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if env:
        if backend == "nccl":
            torch.cuda.set_device(rank_device(device))
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        os.environ.setdefault("LOCAL_RANK", str(process_id))
        if backend == "nccl":
            torch.cuda.set_device(rank_device(device))
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=timeout)
    return dist.get_rank()


def global_mesh(data: int = 1, n_devices: Optional[int] = None):
    """`make_mesh` over every rank of the group (after `init_distributed`)."""
    return make_mesh(n_devices, data=data)


def is_coordinator() -> bool:
    """True on the process that writes files and logs (rank 0, or the only one)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(rank: int, fn: Callable, world: int, backend: str, work: str) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    # The host's cores split over the ranks (torchrun sets one thread a rank):
    # every rank's own default of all cores runs CPU ranks tens of times slower.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    args = torch.load(os.path.join(work, "args.pt"), weights_only=False)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(work, 'store')}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = fn(*args)
        torch.save(result, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (), backend: str = "gloo") -> List:
    """Run `fn(*args)` on `nprocs` new local ranks of a `backend` group and
    return each rank's result (picklable), in rank order. `fn` must be a
    module-level function (the children import it by name). A rank that
    raises makes this raise, after the others are stopped. The arguments
    and results travel through files: a start pipe that has to carry large
    arguments holds up the next rank's start until the last one has read
    them."""
    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="w3d_ranks_")
    try:
        torch.save(tuple(args), os.path.join(work, "args.pt"))
        mp.start_processes(_rank_main, nprocs=nprocs, join=True, start_method="spawn",
                           args=(fn, nprocs, backend, work))
        return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def launch(fn: Callable, nprocs: int, device, args: Sequence = ()) -> List:
    """Run `fn(*args)` on `nprocs` ranks for `device` ("cuda" or "cpu"):
    in this process under torchrun (whose world must hold `nprocs` ranks),
    else on `nprocs` new local ranks (`spawn`), one per card for CUDA.
    Returns the results this process can see: its own under torchrun,
    every rank's otherwise."""
    if under_torchrun():
        if int(os.environ["WORLD_SIZE"]) != nprocs:
            raise ValueError(f"{nprocs} ranks asked for, torchrun started "
                             f"{os.environ['WORLD_SIZE']}")
        init_distributed(device=device)
        return [fn(*args)]
    check_ranks(nprocs, device)
    return spawn(fn, nprocs, args, backend_for(device))
