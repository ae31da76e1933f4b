"""Command-line registration app — the `alignment` binary, on the port.

Port of ``objective_slam_tpu.cli`` (cli.py:30-418): the same flags with the
same defaults (the reference's configure_options, alignment.cpp:119-172)
and the same flow (main, :191-398): load PLYs -> model diameters -> voxel
grid -> ppf_registration -> ground-truth validation, printing a bare 0/1
match bit per (scene, model) pair on stdout (alignment.cpp:332) -> optional
visualization, exported as a colored PLY, an HTML viewer and a PNG instead
of a PCLVisualizer window. The log lines are the JAX package's, which
tools/analyze_uwa.py parses.

Usage:
  python -m objective_slam_tpu_torch.cli --scene_files s.ply \\
      --model_files m.ply --tau_d 0.1 [--validation_files t.txt] ...

It runs on the CUDA device `--dev` (clamped to the device count).
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from objective_slam_tpu_torch._common import as_tensor, default_device, \
    to_numpy
from objective_slam_tpu_torch.config import PPFConfig
from objective_slam_tpu_torch.pipeline import ppf_registration
from objective_slam_tpu_torch.utils import ply, pointcloud as pc, validation

log = logging.getLogger("objective_slam_tpu_torch")


def csv_list(value: str) -> list[str]:
    """Comma-separated list (CommaSeparatedVector, alignment.cpp:92-117)."""
    return [v for v in value.split(",") if v]


def _bool(s: str) -> bool:
    return s.lower() == "true"


def configure_options(argv=None) -> argparse.Namespace:
    """The JAX CLI's flags and defaults (cli.py:36-153); see its help
    texts for the rebuild extensions."""
    p = argparse.ArgumentParser(
        prog="objective_slam_tpu_torch",
        description="PPF 6-DoF registration on a CUDA device")
    # runstate parameters (alignment.cpp:123-127)
    p.add_argument("--dev", type=int, default=0,
                   help="CUDA device index to use")
    p.add_argument("--logfile", type=str, default=None, help="log file")
    p.add_argument("--loglevel", type=str, default="info",
                   choices=["trace", "debug", "info", "warning", "error",
                            "fatal"])
    # algorithm parameters (alignment.cpp:129-144)
    p.add_argument("--tau_d", type=csv_list, required=True,
                   help="per-model voxel grid factors (CSV)")
    p.add_argument("--scene_leaf_size", type=float, default=10.0)
    p.add_argument("--ref_point_df", type=int, default=1,
                   help="scene reference point downsample factor")
    p.add_argument("--vote_count_threshold", type=float, default=0.4)
    p.add_argument("--cpu_clustering", type=_bool, default=False)
    p.add_argument("--use_l1_norm", type=_bool, default=False)
    p.add_argument("--use_averaged_clusters", type=_bool, default=False)
    p.add_argument("--validation_translation_threshold", type=float,
                   default=0.1)
    p.add_argument("--validation_rotation_threshold", type=float,
                   default=12.0)
    # input files (alignment.cpp:146-152)
    p.add_argument("--scene_files", type=csv_list, required=True)
    p.add_argument("--model_files", type=csv_list, required=True)
    p.add_argument("--validation_files", type=csv_list, default=None)
    # output parameters (alignment.cpp:154-157)
    p.add_argument("--show_normals", type=_bool, default=True)
    p.add_argument("--visualize", type=_bool, default=False)
    p.add_argument("--visualize_out", type=str, default="alignment_vis")
    p.add_argument("--visualize_html", type=_bool, default=True)
    # rebuild extensions
    p.add_argument("--estimate_normals_k", type=int, default=0)
    p.add_argument("--smooth_normals", type=int, default=0)
    p.add_argument("--smooth_normals_order", type=int, default=1,
                   choices=[0, 1])
    p.add_argument("--max_poses", type=int, default=1024)
    p.add_argument("--engine", type=str, default="fast",
                   choices=["fast", "reference", "correlation"])
    p.add_argument("--runs_cap", type=int, default=0)
    p.add_argument("--use_fnv_keys", type=_bool, default=False)
    p.add_argument("--rescore_poses", type=_bool, default=False)
    p.add_argument("--cluster_center_cell", type=_bool, default=False)
    p.add_argument("--icp_iterations", type=int, default=0)
    p.add_argument("--icp_max_dist_factor", type=float, default=2.0)
    p.add_argument("--icp_point_to_plane", type=_bool, default=False)
    p.add_argument("--normal_aware_downsample", type=_bool, default=False)
    p.add_argument("--scene_capacity", type=int, default=0,
                   help="if >0, voxel-downsample scenes on the device to "
                        "this static padded capacity")
    return p.parse_args(argv)


_LEVELS = {"trace": logging.DEBUG, "debug": logging.DEBUG,
           "info": logging.INFO, "warning": logging.WARNING,
           "error": logging.ERROR, "fatal": logging.CRITICAL}


def init_logging(args) -> None:
    """File sink with timestamps + severity filter (init_logging,
    alignment.cpp:174-189)."""
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if args.logfile:
        handlers.append(logging.FileHandler(args.logfile))
    logging.basicConfig(level=_LEVELS[args.loglevel],
                        format="[%(asctime)s]: %(message)s",
                        handlers=handlers, force=True)


def _load_cloud(path, args, device):
    """(points, normals) of a PLY; read normals win, else a mesh's vertex
    normals, else k-NN PCA normals under --estimate_normals_k
    (cli.py:173-187)."""
    cloud = ply.read_ply(path)
    nrm = cloud.normals
    if nrm is None:
        if cloud.faces is not None:
            nrm = pc.mesh_vertex_normals(cloud.points, cloud.faces)
        elif args.estimate_normals_k > 0:
            nrm = to_numpy(pc.estimate_normals_knn(
                cloud.points, k=args.estimate_normals_k, orient="outward",
                device=device))
        else:
            raise SystemExit(
                f"{path}: no normals; pass --estimate_normals_k or provide "
                "a mesh")
    return cloud.points, nrm


def main(argv=None, device=None) -> int:
    """Run the CLI. `device` (not a command-line flag) overrides --dev,
    e.g. device="cpu" to run on the CPU; by default the CUDA device --dev,
    clamped like the reference's min(numDevices-1, devUse) (ppf.cu:37-49)."""
    args = configure_options(argv)
    init_logging(args)
    log.info(" ".join(sys.argv if argv is None else ["cli"] + list(argv)))
    if device is None:
        default_device()                    # raises without a card
        n = torch.cuda.device_count()
        device = torch.device("cuda", min(n - 1, max(args.dev, 0)))
        log.info("Found %d devices; using device %d (%s)", n, device.index,
                 torch.cuda.get_device_name(device))
    device = torch.device(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            return _run(args, device)
    return _run(args, device)


def _run(args, device) -> int:
    scene_clouds = []
    for f in args.scene_files:
        log.info("Loading scene point cloud: %s", f)
        sp, sn = _load_cloud(f, args, device)
        if args.smooth_normals > 0:
            # Smooth the full-resolution scan's normal field before any
            # downsampling, so that the voxelized matcher input and the ICP
            # cloud (this scan) share the denoised orientation.
            sn = to_numpy(pc.smooth_normals_grid(
                sp, sn, args.scene_leaf_size, iterations=args.smooth_normals,
                order=args.smooth_normals_order, device=device))
            log.info("Smoothed scene normals: %d passes, order %d, "
                     "radius %g", args.smooth_normals,
                     args.smooth_normals_order, args.scene_leaf_size)
        scene_clouds.append((sp, sn))

    if len(args.tau_d) != len(args.model_files):
        log.error("Each model must have an associated tau_d.")
        return 1
    tau_d = [float(t) for t in args.tau_d]

    model_clouds = []
    model_d_dists = []
    for i, f in enumerate(args.model_files):
        log.info("Loading model point cloud: %s", f)
        mp, mn = _load_cloud(f, args, device)
        diam = pc.bbox_diameter(mp)   # bbox-edge approx, alignment.cpp:246-253
        model_d_dists.append(tau_d[i] * diam)
        log.debug("model_diam, d_dist: %f, %f", diam, model_d_dists[-1])
        model_clouds.append((mp, mn))

    # Downsample (alignment.cpp:259-288).
    log.info("Downsampling...")
    ds_scenes = []
    # Pad-free twins for the export: --scene_capacity pads ds_scenes with
    # far-sentinel rows that would blow the viewer's bounding box out.
    viz_scenes = []
    # The raw scans on the device: the device voxel grid's input, and what
    # ICP (if enabled) refines against — the voxelized cloud's spacing
    # would floor the achievable accuracy.
    raw_scenes = [(as_tensor(sp, device), as_tensor(sn, device))
                  for sp, sn in scene_clouds]
    for (sp, sn), (sp_d, sn_d) in zip(scene_clouds, raw_scenes):
        log.info("Scene size before filtering: %d", len(sp))
        if args.scene_capacity > 0:
            vox = pc.voxel_downsample(sp_d, sn_d, args.scene_leaf_size,
                                      capacity=args.scene_capacity,
                                      normal_aware=args.
                                      normal_aware_downsample)
            if bool(vox.dropped):
                log.error("scene exceeds --scene_capacity %d; raise it",
                          args.scene_capacity)
                return 1
            log.info("Scene size after filtering: %d (padded to %d)",
                     int(vox.num_voxels), args.scene_capacity)
            ds_scenes.append((vox.points, vox.normals))
            nv = int(vox.num_voxels)
            viz_scenes.append((to_numpy(vox.points[:nv]),
                               to_numpy(vox.normals[:nv])))
        else:
            sp2, sn2 = pc.voxel_downsample_np(
                sp, sn, args.scene_leaf_size,
                normal_aware=args.normal_aware_downsample)
            log.info("Scene size after filtering: %d", len(sp2))
            ds_scenes.append((as_tensor(sp2, device),
                              as_tensor(sn2, device)))
            viz_scenes.append((sp2, sn2))
    ds_models = []
    for (mp, mn), dd in zip(model_clouds, model_d_dists):
        log.info("Model size before filtering: %d", len(mp))
        mp2, mn2 = pc.voxel_downsample_np(
            mp, mn, dd, normal_aware=args.normal_aware_downsample)
        log.info("Model size after filtering: %d", len(mp2))
        ds_models.append((mp2, mn2))

    cfg = PPFConfig(
        ref_point_df=args.ref_point_df,
        vote_count_threshold=args.vote_count_threshold,
        use_l1_norm=args.use_l1_norm,
        use_averaged_clusters=args.use_averaged_clusters,
        validation_translation_threshold=args.validation_translation_threshold,
        validation_rotation_threshold_deg=args.validation_rotation_threshold,
        scene_leaf_size=args.scene_leaf_size,
        max_poses=args.max_poses,
        engine=args.engine,
        use_fnv_keys=args.use_fnv_keys,
        rescore_poses=args.rescore_poses,
        cluster_center_cell=args.cluster_center_cell,
        refine_icp=args.icp_iterations > 0,
        icp_iterations=max(args.icp_iterations, 1),
        icp_max_dist_factor=args.icp_max_dist_factor,
        icp_point_to_plane=args.icp_point_to_plane)

    out = ppf_registration(ds_scenes, ds_models, model_d_dists, cfg,
                           cpu_clustering=args.cpu_clustering,
                           icp_clouds=raw_scenes,
                           runs_cap=args.runs_cap or None, device=device)

    if args.validation_files:
        for i in range(len(ds_scenes)):
            for j in range(len(ds_models)):
                truth = validation.read_truth_file(
                    args.validation_files[i * len(ds_models) + j])
                log.info("Transformations for %s in %s:",
                         args.model_files[j], args.scene_files[i])
                log.info("Estimated transformation:\n%s", out.poses[i][j])
                log.info("Ground truth:\n%s", truth)
                model_diam = model_d_dists[j] / tau_d[j]
                v = validation.validate_pose(out.poses[i][j], truth,
                                             model_diam, cfg)
                log.info("Distance (trans, rot): %f, %f", v.trans_err,
                         v.rot_err)
                log.info("Threshold (validation_translation_threshold"
                         "*model_diam , 12 deg): %f, %f",
                         v.trans_thresh, v.rot_thresh)
                log.info("Match (trans, rot): %d, %d", v.trans_match,
                         v.rot_match)
                # The machine-readable match bit (alignment.cpp:332).
                print(int(v.match))

    if args.visualize:
        _export_visualization(args, viz_scenes, ds_models, out.poses)
    return 0


def _export_visualization(args, scenes, models, poses) -> None:
    """Write the scenes and every posed model as one colored PLY, an HTML
    viewer (--visualize_html) and, where matplotlib is installed, a PNG
    (cli.py:331-418; the PCLVisualizer loop, alignment.cpp:337-396).
    --show_normals writes nx/ny/nz into the PLY and draws a sparse quiver
    in the PNG."""
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255),
              (0, 255, 255), (255, 0, 255), (255, 255, 0)]
    posed = []                      # (scene i, model j, points, normals)
    for i in range(len(scenes)):
        for j, (mp, mn) in enumerate(models):
            T = poses[i][j]
            posed.append((i, j,
                          (mp @ T[:3, :3].T + T[:3, 3]).astype(np.float32),
                          (mn @ T[:3, :3].T).astype(np.float32)))
    pts = np.concatenate([sp for sp, _ in scenes] + [p[2] for p in posed])
    nrm = np.concatenate([sn for _, sn in scenes] + [p[3] for p in posed])
    cols = np.concatenate(
        [np.full((len(sp), 3), 255, np.uint8) for sp, _ in scenes]
        + [np.tile(np.asarray(colors[(i * len(models) + j) % len(colors)],
                              np.uint8), (len(p), 1))
           for i, j, p, _ in posed])
    out_ply = args.visualize_out + ".ply"
    fields = [("p", "<f4", (3,))]
    if args.show_normals:
        fields.append(("n", "<f4", (3,)))
    fields.append(("c", "u1", (3,)))
    rec = np.empty(len(pts), dtype=fields)
    rec["p"] = pts
    rec["c"] = cols
    if args.show_normals:
        rec["n"] = nrm
    with open(out_ply, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(pts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 + ("property float nx\nproperty float ny\n"
                    "property float nz\n" if args.show_normals else "")
                 + "property uchar red\nproperty uchar green\n"
                 "property uchar blue\nend_header\n").encode())
        f.write(rec.tobytes())
    log.info("visualization written: %s", out_ply)
    if args.visualize_html:
        from objective_slam_tpu_torch.utils import html_viewer
        clouds = [{"points": sp, "normals": sn, "name": f"scene{i}"}
                  for i, (sp, sn) in enumerate(scenes)]
        clouds += [{"points": p, "normals": n,
                    "color": html_viewer.default_color(ci),
                    "name": f"model{j}@scene{i}"}
                   for ci, (i, j, p, n) in enumerate(posed)]
        html_viewer.write_html_viewer(args.visualize_out + ".html", clouds,
                                      title="alignment result")
        log.info("visualization written: %s.html", args.visualize_out)
    try:
        import matplotlib
    except ImportError as e:        # matplotlib is optional
        log.debug("png export skipped: %s", e)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    step = max(1, len(pts) // 20000)
    ax.scatter(pts[::step, 0], pts[::step, 1], pts[::step, 2],
               c=cols[::step] / 255.0, s=1)
    if args.show_normals:
        # A sparse subsample at 2% of the scene extent (the PCLVisualizer
        # overlay draws every 10th normal at level 0.02).
        qstep = max(1, len(pts) // 2000)
        extent = float(np.ptp(pts, axis=0).max())
        ax.quiver(pts[::qstep, 0], pts[::qstep, 1], pts[::qstep, 2],
                  nrm[::qstep, 0], nrm[::qstep, 1], nrm[::qstep, 2],
                  length=0.02 * extent, normalize=True, color="gray",
                  linewidth=0.3)
    fig.savefig(args.visualize_out + ".png", dpi=120)
    plt.close(fig)
    log.info("visualization written: %s.png", args.visualize_out)


if __name__ == "__main__":
    sys.exit(main())
