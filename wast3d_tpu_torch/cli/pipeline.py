"""CLI: the whole WaSt-3D pipeline in one command.

`python -m wast3d_tpu_torch.cli.pipeline --content_data <ds> --style_data <ds>
--workdir out/ [--style_cluster_index 0] [--device cuda|cpu]`

Port of `wast3d_tpu.cli.pipeline` (the reference's shell orchestration,
`scripts/train_style_scenes.sh`, `cluster_style_scenes.sh` and notebook 11),
with its flags plus `--device`, in its five stages, writing its files under
`--workdir`:
1. train the content scene (`content/point_cloud/iteration_<n>/`);
2. train the style scene with the sphere regularisers of `--sphere_mode`
   (`style/...`);
3. export the style scene's k-means clusters (`style_clusters/cluster_*.npz`);
4. stylize the content with cluster `--style_cluster_index`
   (`stylized.ply`);
5. render a spiral turntable of the result (`turntable/00000.png`, ...).
`--skip_recon` reuses the reconstructions already in the workdir.
`--devices N` above 1 splits stage 4's ball fit over N ranks
(`make_mesh(N, data=N)`, as JAX does) started for that stage alone, one per
card for CUDA or on the host for the CPU (`parallel.multihost.launch`); the
other stages run in this process on its device. Under `torchrun` the
ranks are the ones it started: rank 0 runs stages 1-3 and 5 while the others
wait for it (the group's timeout is `RECON_WAIT_S`), and rank 0 writes every
file. The JAX CLI's compile cache (`utils.cache.enable`) has no counterpart
here.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np

RECON_WAIT_S = 24 * 3600  # under torchrun: how long ranks wait for stages 1-3


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="wast3d_tpu_torch full pipeline")
    parser.add_argument("--content_data", required=True, type=str)
    parser.add_argument("--style_data", required=True, type=str)
    parser.add_argument("--workdir", required=True, type=str)
    parser.add_argument("--iterations", type=int, default=30_000)
    parser.add_argument("--num_clusters", type=int, default=100)
    parser.add_argument("--style_cluster_index", type=int, default=0)
    parser.add_argument("--sphere_mode", type=str, default="isotropic",
                        choices=["isotropic", "anisotropic", "anisotropic_simple"])
    parser.add_argument("--white_background", "-w", action="store_true")
    parser.add_argument("--turntable_frames", type=int, default=60)
    parser.add_argument("--devices", type=int, default=1,
                        help="shard the stylization ball-fit axis over this many ranks "
                             "(1 = one device)")
    parser.add_argument("--skip_recon", action="store_true",
                        help="reuse existing reconstructions in workdir")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def stylize_stage(args: argparse.Namespace, content_ply: str, cluster_npz: str,
                  out_ply: str):
    """Stage 4 on this rank: content PLY + style cluster -> stylized PLY
    (written by rank 0). Returns the sizes for the report and, on rank 0,
    the stylized scene (else None)."""
    from wast3d_tpu_torch.parallel import multihost
    from wast3d_tpu_torch.scene.ply import load_ply, save_ply
    from wast3d_tpu_torch.stylize.cluster import load_cluster
    from wast3d_tpu_torch.stylize.pipeline import stylize_scene

    mesh, device = None, args.device
    if args.devices > 1:
        mesh = multihost.global_mesh(data=args.devices)
        device = multihost.rank_device(args.device)
    content_scene = load_ply(content_ply, device=device)
    patch = load_cluster(cluster_npz)
    stylized = stylize_scene(content_scene, patch, verbose=multihost.is_coordinator(),
                             device=device, mesh=mesh)
    lead = multihost.is_coordinator()
    if lead:
        save_ply(stylized, out_ply)
        print(f"stylized scene -> {out_ply}")
    sizes = dict(content_n=content_scene.capacity, patch_n=len(patch),
                 stylized_n=stylized.capacity)
    return sizes, (stylized if lead else None)


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    """Run the pipeline; returns each stage's seconds and what it made (the
    printed lines say the same), on the process that writes (None on the
    other ranks under torchrun)."""
    args = build_parser().parse_args(argv)
    from wast3d_tpu_torch.parallel import multihost
    from wast3d_tpu_torch.utils.cache import enable

    enable()

    torchrun = args.devices > 1 and multihost.under_torchrun()
    if args.devices > 1 and not torchrun:
        multihost.check_ranks(args.devices, args.device)
    if torchrun:
        multihost.init_distributed(device=args.device, timeout_s=RECON_WAIT_S)
    lead = multihost.is_coordinator()
    content_dir = os.path.join(args.workdir, "content")
    style_dir = os.path.join(args.workdir, "style")
    content_ply = os.path.join(content_dir, "point_cloud", f"iteration_{args.iterations}",
                               "point_cloud.ply")
    style_ply = os.path.join(style_dir, "point_cloud", f"iteration_{args.iterations}",
                             "point_cloud.ply")
    clusters_dir = os.path.join(args.workdir, "style_clusters")
    report = {"stage_s": {}}
    if lead:
        report.update(reconstruct_and_cluster(args, content_dir, style_dir, content_ply,
                                              style_ply, clusters_dir))
    if torchrun:
        import torch.distributed as dist

        dist.barrier()
    if lead:
        print("== [4/5] stylization ==")
    t0 = time.perf_counter()
    cluster_npz = os.path.join(clusters_dir, f"cluster_{args.style_cluster_index}.npz")
    out_ply = os.path.join(args.workdir, "stylized.ply")
    stage = (args, content_ply, cluster_npz, out_ply)
    if args.devices > 1:
        sizes, stylized = multihost.launch(stylize_stage, args.devices, args.device, stage)[0]
    else:
        sizes, stylized = stylize_stage(*stage)
    if not lead:
        return None
    report["stage_s"]["stylize"] = time.perf_counter() - t0
    report.update(sizes)
    t0 = time.perf_counter()
    report["frames"] = turntable(args, stylized)
    report["stage_s"]["turntable"] = time.perf_counter() - t0
    return report


def reconstruct_and_cluster(args, content_dir, style_dir, content_ply, style_ply,
                            clusters_dir) -> dict:
    """Stages 1-3: the two reconstructions and the style clusters."""
    from wast3d_tpu_torch.cli.train import sphere_config
    from wast3d_tpu_torch.device import resolve_device
    from wast3d_tpu_torch.scene.ply import load_ply
    from wast3d_tpu_torch.stylize.cluster import export_clusters
    from wast3d_tpu_torch.train.driver import train_scene

    dev = resolve_device(args.device)
    stage_s = {}
    t0 = time.perf_counter()
    if not (args.skip_recon and os.path.exists(content_ply)):
        print("== [1/5] content reconstruction ==")
        train_scene(args.content_data, content_dir, iterations=args.iterations,
                    white_background=args.white_background,
                    save_iterations=[args.iterations], device=dev)
    stage_s["content"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not (args.skip_recon and os.path.exists(style_ply)):
        print("== [2/5] style reconstruction (spheres) ==")
        train_scene(args.style_data, style_dir, iterations=args.iterations,
                    white_background=args.white_background,
                    sphere_cfg=sphere_config(args.sphere_mode),
                    save_iterations=[args.iterations], device=dev)
    stage_s["style"] = time.perf_counter() - t0

    print("== [3/5] style cluster export ==")
    t0 = time.perf_counter()
    style_scene = load_ply(style_ply, device=dev)
    export_clusters(style_scene, clusters_dir, args.num_clusters)
    stage_s["clusters"] = time.perf_counter() - t0
    return {"stage_s": stage_s, "style_n": style_scene.capacity}


def turntable(args, stylized) -> int:
    """Stage 5: a spiral turntable of the stylized scene; returns its frames."""
    from wast3d_tpu_torch.device import resolve_device
    from wast3d_tpu_torch.eval.camera_path import render_path, spiral_path

    print("== [5/5] turntable render ==")
    dev = resolve_device(args.device)
    stylized = stylized.to(dev)
    xyz = stylized.xyz.detach().cpu().numpy()[stylized.mask.cpu().numpy()]
    center = xyz.mean(0)
    radius = float(np.linalg.norm(xyz - center, axis=1).max() * 2.5)
    cams = spiral_path(center, radius, radius * 0.2, num_frames=args.turntable_frames,
                       device=dev)
    out = os.path.join(args.workdir, "turntable")
    frames = render_path(stylized, cams, out, device=dev)
    print(f"{len(frames)} frames -> {out}")
    return len(frames)


if __name__ == "__main__":
    main()
