"""Model generator `uwa_analog_models`: the four procedural UWA-analog
meshes (chef, trex, para, chicken) at the UWA diameters, their vertices
with area-weighted vertex normals. Fixed meshes: the seed draws nothing."""

from benchmark.frozen import scenes


def make(rng, params):
    del rng, params
    out = []
    for name, (verts, faces) in scenes.uwa_analog_models().items():
        out.append({"name": name, "points": verts, "faces": faces,
                    "normals": scenes.mesh_vertex_normals(verts, faces)})
    return out
