"""Minimal mesh library (numpy/scipy), the JAX package's ``geom/meshlib.py``:
TriMesh, largest connected component (reference utils/mesh.py:372-381),
area-weighted surface sampling (trimesh.sample.sample_surface as the
reference's metrics use it, deep_sdf/metrics/icp_trans_scale.py:22-24) and
PLY/OBJ read and write."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components


@dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray     # (F, 3) int64

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float64)
        self.faces = np.asarray(self.faces, np.int64)

    @property
    def triangles(self) -> np.ndarray:
        return self.vertices[self.faces]

    def face_areas(self) -> np.ndarray:
        tri = self.triangles
        return 0.5 * np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
        )

    @property
    def area(self) -> float:
        return float(self.face_areas().sum())

    def export(self, path: str) -> None:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".ply":
            write_ply(path, self.vertices, self.faces)
        elif ext == ".obj":
            write_obj(path, self.vertices, self.faces)
        else:
            raise ValueError(f"unsupported export format: {path}")


def split_components(mesh: TriMesh) -> list:
    """Split into face-connected components (reference trimesh.graph.split
    usage at utils/mesh.py:372)."""
    f = mesh.faces
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    n = mesh.vertices.shape[0]
    adj = coo_matrix(
        (np.ones(len(edges)), (edges[:, 0], edges[:, 1])), shape=(n, n)
    )
    n_comp, labels = connected_components(adj, directed=False)
    if n_comp <= 1:
        return [mesh]
    out = []
    for comp in range(n_comp):
        vmask = labels == comp
        fmask = vmask[f[:, 0]]
        if not fmask.any():
            continue
        remap = -np.ones(n, np.int64)
        vidx = np.nonzero(vmask)[0]
        remap[vidx] = np.arange(len(vidx))
        out.append(TriMesh(mesh.vertices[vidx], remap[f[fmask]]))
    return out


def largest_component(mesh: TriMesh) -> TriMesh:
    """Keep the largest-area component (reference utils/mesh.py:372-381)."""
    parts = split_components(mesh)
    if len(parts) == 1:
        return parts[0]
    return max(parts, key=lambda m: m.area)


def sample_surface(mesh: TriMesh, count: int,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Area-weighted uniform surface sampling (trimesh.sample.sample_surface
    semantics: choose faces by area, uniform barycentric points)."""
    rng = rng or np.random.default_rng()
    areas = mesh.face_areas()
    probs = areas / areas.sum()
    face_idx = rng.choice(len(probs), size=count, p=probs)
    tri = mesh.triangles[face_idx]
    r1 = np.sqrt(rng.random(count))
    r2 = rng.random(count)
    a = 1 - r1
    b = r1 * (1 - r2)
    c = r1 * r2
    return (
        tri[:, 0] * a[:, None] + tri[:, 1] * b[:, None] + tri[:, 2] * c[:, None]
    )


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: Optional[np.ndarray] = None) -> None:
    """Binary-little-endian PLY writer (color support mirrors reference
    utils/customized_export_ply.py:4-120)."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int32)
    with open(path, "wb") as fp:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {len(v)}",
                  "property float x", "property float y", "property float z"]
        if vertex_colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += [f"element face {len(f)}",
                   "property list uchar int vertex_indices", "end_header"]
        fp.write(("\n".join(header) + "\n").encode("ascii"))
        if vertex_colors is not None:
            rec = np.zeros(len(v), dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = v
            rec["rgb"] = np.asarray(vertex_colors, np.uint8)
            fp.write(rec.tobytes())
        else:
            fp.write(v.tobytes())
        frec = np.zeros(len(f), dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        frec["n"] = 3
        frec["idx"] = f
        fp.write(frec.tobytes())


def read_ply(path: str) -> TriMesh:
    """Reads the binary PLY files written above plus common ascii PLYs."""
    with open(path, "rb") as fp:
        header_lines = []
        while True:
            line = fp.readline().decode("ascii").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = next(l for l in header_lines if l.startswith("format")).split()[1]
        n_vert = int(next(l for l in header_lines if l.startswith("element vertex")).split()[2])
        n_face = int(next(l for l in header_lines if l.startswith("element face")).split()[2])
        vert_props = []
        in_vertex = False
        for line in header_lines:
            if line.startswith("element vertex"):
                in_vertex = True
            elif line.startswith("element"):
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                vert_props.append(tuple(line.split()[1:]))

        if fmt == "binary_little_endian":
            np_types = {"float": np.float32, "float32": np.float32,
                        "double": np.float64, "uchar": np.uint8, "uint8": np.uint8,
                        "int": np.int32, "int32": np.int32}
            dtype = [(name, np_types[t]) for t, name in vert_props]
            vdata = np.frombuffer(fp.read(n_vert * np.dtype(dtype).itemsize), dtype=dtype)
            verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], axis=1).astype(np.float64)
            faces = np.empty((n_face, 3), np.int64)
            for i in range(n_face):
                n = np.frombuffer(fp.read(1), np.uint8)[0]
                idx = np.frombuffer(fp.read(4 * n), np.int32)
                faces[i] = idx[:3]
            return TriMesh(verts, faces)

        # ascii
        verts = np.empty((n_vert, 3), np.float64)
        for i in range(n_vert):
            parts = fp.readline().split()
            verts[i] = [float(x) for x in parts[:3]]
        faces = np.empty((n_face, 3), np.int64)
        for i in range(n_face):
            parts = fp.readline().split()
            faces[i] = [int(x) for x in parts[1:4]]
        return TriMesh(verts, faces)


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as fp:
        for v in np.asarray(vertices, np.float64):
            fp.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        for f in np.asarray(faces, np.int64) + 1:
            fp.write(f"f {f[0]} {f[1]} {f[2]}\n")


def read_obj(path: str) -> TriMesh:
    verts, faces = [], []
    with open(path) as fp:
        for line in fp:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]]
                faces.append(idx)
    return TriMesh(np.asarray(verts), np.asarray(faces, np.int64))


def load_mesh(path: str) -> TriMesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return read_ply(path)
    if ext == ".obj":
        return read_obj(path)
    raise ValueError(f"unsupported mesh format: {path}")
