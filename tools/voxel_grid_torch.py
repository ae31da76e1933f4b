"""Standalone PLY -> PLY voxel-grid downsampler on the PyTorch port: the
port's counterpart of tools/voxel_grid.py (same arguments, same output).

Equivalent of the reference's voxel_grid CLI
(pcl/voxel_grid/voxel_grid.cpp:6-31): read a PLY, apply a voxel-grid filter
(default leaf 0.01), write the result. The filter is the port's host-side
`pointcloud.voxel_downsample_np` (numpy, exact, dynamic output size), as
the JAX tool's is, so the tool needs no card and takes no device.

Usage: python tools/voxel_grid_torch.py in.ply out.ply [--leaf 0.01]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from objective_slam_tpu_torch.utils import ply, \
    pointcloud as pc  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="PLY voxel-grid downsampler")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--leaf", type=float, default=0.01)
    args = p.parse_args(argv)

    cloud = ply.read_ply(args.input)
    print(f"Loaded {cloud.points.shape[0]} points from {args.input}")
    pts, nrm = pc.voxel_downsample_np(cloud.points, cloud.normals, args.leaf)
    ply.write_ply(args.output, pts, nrm)
    print(f"Wrote {pts.shape[0]} points to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
