"""Scene generator `bin_picking`: bench.py's scan, `n_instances` copies of
the model (each `n_inst_pts` points drawn from its raw cloud) at random
poses at least a diameter apart, among eight planar clutter patches,
`n_total` points in all."""

from benchmark.frozen import scenes


def make(rng, models, params):
    (model,) = models
    points, normals, _ = scenes.bin_picking_scene(
        rng, model["points"], model["normals"],
        n_total=int(params["n_total"]),
        n_instances=int(params["n_instances"]),
        n_inst_pts=int(params["n_inst_pts"]))
    return points, normals
