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
`--devices` above 1 (sharding the ball fit) raises `NotImplementedError`, as
`cli.stylize` does: `parallel/` is not ported yet (ROADMAP.md, queue 1). The
JAX CLI's compile cache (`utils.cache.enable`) has no counterpart here.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np


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
                        help="devices to shard the stylization ball fit over; only 1 "
                             "is ported")
    parser.add_argument("--skip_recon", action="store_true",
                        help="reuse existing reconstructions in workdir")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the pipeline; returns each stage's seconds and what it made (the
    printed lines say the same)."""
    args = build_parser().parse_args(argv)
    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: sharding the ball fit over several devices "
            "needs parallel/, which is not ported yet: see ROADMAP.md, queue 1 (parallel/)")

    from wast3d_tpu_torch.cli.train import sphere_config
    from wast3d_tpu_torch.device import resolve_device
    from wast3d_tpu_torch.train.driver import train_scene

    dev = resolve_device(args.device)
    report = {"stage_s": {}}
    content_dir = os.path.join(args.workdir, "content")
    style_dir = os.path.join(args.workdir, "style")
    content_ply = os.path.join(content_dir, "point_cloud", f"iteration_{args.iterations}",
                               "point_cloud.ply")
    style_ply = os.path.join(style_dir, "point_cloud", f"iteration_{args.iterations}",
                             "point_cloud.ply")

    t0 = time.perf_counter()
    if not (args.skip_recon and os.path.exists(content_ply)):
        print("== [1/5] content reconstruction ==")
        train_scene(args.content_data, content_dir, iterations=args.iterations,
                    white_background=args.white_background,
                    save_iterations=[args.iterations], device=dev)
    report["stage_s"]["content"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not (args.skip_recon and os.path.exists(style_ply)):
        print("== [2/5] style reconstruction (spheres) ==")
        train_scene(args.style_data, style_dir, iterations=args.iterations,
                    white_background=args.white_background,
                    sphere_cfg=sphere_config(args.sphere_mode),
                    save_iterations=[args.iterations], device=dev)
    report["stage_s"]["style"] = time.perf_counter() - t0

    print("== [3/5] style cluster export ==")
    from wast3d_tpu_torch.scene.ply import load_ply, save_ply
    from wast3d_tpu_torch.stylize.cluster import export_clusters, load_cluster

    t0 = time.perf_counter()
    clusters_dir = os.path.join(args.workdir, "style_clusters")
    style_scene = load_ply(style_ply, device=dev)
    paths = export_clusters(style_scene, clusters_dir, args.num_clusters)
    report["stage_s"]["clusters"] = time.perf_counter() - t0
    report["style_n"] = style_scene.capacity

    print("== [4/5] stylization ==")
    from wast3d_tpu_torch.stylize.pipeline import stylize_scene

    t0 = time.perf_counter()
    content_scene = load_ply(content_ply, device=dev)
    patch = load_cluster(paths[args.style_cluster_index])
    stylized = stylize_scene(content_scene, patch, verbose=True, device=dev)
    out_ply = os.path.join(args.workdir, "stylized.ply")
    save_ply(stylized, out_ply)
    print(f"stylized scene -> {out_ply}")
    report["stage_s"]["stylize"] = time.perf_counter() - t0
    report.update(content_n=content_scene.capacity, patch_n=len(patch),
                  stylized_n=stylized.capacity)

    print("== [5/5] turntable render ==")
    from wast3d_tpu_torch.eval.camera_path import render_path, spiral_path

    t0 = time.perf_counter()
    xyz = stylized.xyz.detach().cpu().numpy()[stylized.mask.cpu().numpy()]
    center = xyz.mean(0)
    radius = float(np.linalg.norm(xyz - center, axis=1).max() * 2.5)
    cams = spiral_path(center, radius, radius * 0.2, num_frames=args.turntable_frames,
                       device=dev)
    turntable = os.path.join(args.workdir, "turntable")
    frames = render_path(stylized, cams, turntable, device=dev)
    print(f"{len(frames)} frames -> {turntable}")
    report["stage_s"]["turntable"] = time.perf_counter() - t0
    report["frames"] = len(frames)
    return report


if __name__ == "__main__":
    main()
