"""Model generator `blob`: one bumpy star-convex blob of `n_raw` points
with radial normals (bench.py's model, blob_cloud(20000))."""

from benchmark.frozen import scenes


def make(rng, params):
    points, normals = scenes.blob_cloud(rng, int(params["n_raw"]),
                                        float(params["bumps"]))
    return [{"name": "blob", "points": points, "normals": normals}]
