"""Worker of tests/test_torch_sharded_dist.py: one rank of a gloo group on
the CPU running the port's sharded matcher over DistShards. Imports no JAX,
so the spawned processes never load it."""

import numpy as np
import torch
import torch.distributed as dist

import objective_slam_tpu_torch as pt
from objective_slam_tpu_torch.parallel import sharded_match as tsm
from objective_slam_tpu_torch.utils import synthetic

CONFIG = dict(max_poses=128, ref_point_df=3)


def scene(seed=0):
    """A planted blob in clutter: 190 points, R = 64 over the shards."""
    rng = np.random.default_rng(seed)
    mp, mn = synthetic.blob_cloud(rng, 90)
    cp, cn = synthetic.clutter_cloud(rng, 100)
    sp, sn, T = synthetic.plant_model(rng, mp, mn, cp, cn)
    return mp, mn, sp, sn, T


def match(group):
    """The scene through the sharded matcher over `group` on the CPU,
    with caps from the count pass."""
    mp, mn, sp, sn, _ = scene()
    cfg = pt.PPFConfig(**CONFIG)
    desc = pt.build_model_description(mp, mn, cfg, device="cpu")
    return tsm.sharded_match(group, desc, sp, sn, cfg)


def run(rank, world_size, store_path, out_dir):
    """torch.multiprocessing entry: join the FileStore group, match, save
    the result as <out_dir>/rank<r>.npz."""
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size)
    try:
        res = match(tsm.DistShards())
        np.savez(f"{out_dir}/rank{rank}.npz",
                 **{k: v.numpy() for k, v in res._asdict().items()})
    finally:
        dist.destroy_process_group()
