"""Scene generator `uwa_analog_scene`: one cluttered UWA-analog scene, a
partial view (55-85% occluded) of every model at a random pose among six
planar clutter patches, 26,000 points in all
(tools/run_uwa_analog.py:135-201)."""

from benchmark.frozen import scenes


def make(rng, models, params):
    del params
    meshes = {m["name"]: (m["points"], m["faces"]) for m in models}
    normals = {m["name"]: m["normals"] for m in models}
    points, nrm, _ = scenes.uwa_analog_scene(rng, meshes, normals)
    return points, nrm
