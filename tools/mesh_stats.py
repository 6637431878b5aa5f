"""Summary of a triangle mesh in OBJ form, the record two isosurface
extractions are held to: vertex and face counts, the bounding box, the
surface area, the count of boundary edges (edges that one face uses: 0 for
a closed surface) and the mean vertex colour of a `v x y z r g b` file.

    python3 tools/mesh_stats.py mesh.obj [--out mesh_stats.json]

numpy only, so the reference's and the port's runs can both call it.
"""

import argparse
import json

import numpy as np


def read_obj(path):
    """(vertices [V, 3] f64, faces [F, 3] i64 zero-based, colours [V, 3] or
    None) of an OBJ with triangle faces, as `save_obj` writes it (each `v`
    line 3 or 6 numbers, each `f` line 3 vertex references)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    vl = [ln[2:] for ln in lines if ln.startswith("v ")]
    fl = [ln[2:] for ln in lines if ln.startswith("f ")]
    v = np.array(" ".join(vl).split(), np.float64).reshape(len(vl), -1) if vl \
        else np.zeros((0, 3))
    ftok = " ".join(fl).split()
    f = np.array([t.split("/")[0] for t in ftok] if "/" in " ".join(fl) else ftok,
                 np.int64).reshape(len(fl), 3) - 1 if fl else np.zeros((0, 3), np.int64)
    return v[:, :3], f, (v[:, 3:6] if v.shape[1] >= 6 else None)


def mesh_stats(verts, faces, colors=None):
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1).sum()
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
                    axis=1)
    _, uses = np.unique(edges[:, 0] * max(len(verts), 1) + edges[:, 1], return_counts=True)
    out = {"n_vertices": int(len(verts)), "n_faces": int(len(faces)),
           "bbox_min": verts.min(axis=0).tolist() if len(verts) else None,
           "bbox_max": verts.max(axis=0).tolist() if len(verts) else None,
           "surface_area": float(area), "boundary_edges": int((uses == 1).sum()),
           "mean_vertex_color": None if colors is None else
           np.asarray(colors, np.float64).mean(axis=0).tolist()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("obj")
    ap.add_argument("--out", help="write the JSON here as well")
    args = ap.parse_args(argv)
    stats = mesh_stats(*read_obj(args.obj))
    text = json.dumps(stats, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
