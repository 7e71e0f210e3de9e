"""Translation+scale ICP alignment in numpy/scipy on the host, the JAX
package's ``eval/icp.py`` (reference deep_sdf/metrics/icp_trans_scale.py:
11-196, its sklearn KDTree replaced by scipy's cKDTree, which finds the same
nearest neighbours)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from alignsdf_torch.geom.meshlib import TriMesh, sample_surface


class ICPTransScale:
    """Bidirectional closest-point ICP solving least squares for one scale and
    a 3-vector translation (no rotation)."""

    def __init__(self, mesh_source: TriMesh, mesh_target: TriMesh):
        self.mesh_source = mesh_source
        self.mesh_target = mesh_target
        self.points_source = mesh_source.vertices.copy()
        self.points_target = mesh_target.vertices.copy()
        self.trans = np.zeros((1, 3))
        self.scale = 1.0

    def sample_mesh(self, n: int = 30000, mesh_id: str = "both",
                    rng: Optional[np.random.Generator] = None) -> None:
        """Pre-normalize the source cloud to the target's centroid/scale
        (reference icp_trans_scale.py:20-30)."""
        rng = rng or np.random.default_rng(0)
        if mesh_id in ("source", "both"):
            self.points_source = sample_surface(self.mesh_source, n, rng)
        if mesh_id in ("target", "both"):
            self.points_target = sample_surface(self.mesh_target, n, rng)

        self.offset_source = self.points_source.mean(0)
        self.scale_source = np.sqrt(
            ((self.points_source - self.offset_source) ** 2).sum() / len(self.points_source)
        )
        self.offset_target = self.points_target.mean(0)
        self.scale_target = np.sqrt(
            ((self.points_target - self.offset_target) ** 2).sum() / len(self.points_target)
        )
        self.points_source = (
            (self.points_source - self.offset_source)
            / self.scale_source * self.scale_target + self.offset_target
        )

    def run_icp_f(self, max_iter: int = 10, stop_error: float = 1e-3,
                  stop_improvement: float = 1e-5, verbose: int = 0) -> None:
        """KD-trees built once; per-iteration closest-point + lsq solve
        (reference icp_trans_scale.py:32-113)."""
        target_tree = cKDTree(self.points_target)
        source_tree = cKDTree(self.points_source)

        self.trans = np.zeros((1, 3))
        self.scale = 1.0
        a_c123 = None
        previous_error = 1e8

        for i in range(max_iter):
            query_source = self.points_source * self.scale + self.trans
            _, idx_t = target_tree.query(query_source)
            closest_target = self.points_target[idx_t]

            query_target = (self.points_target - self.trans) / self.scale
            _, idx_s = source_tree.query(query_target)
            closest_source = self.points_source[idx_s] * self.scale + self.trans
            query_target = self.points_target

            error = np.sqrt(
                (((query_source - closest_target) ** 2).sum()
                 + ((query_target - closest_source) ** 2).sum())
                / (len(query_source) + len(query_target))
            )
            if verbose:
                print(i, "th iter, error:", error)
            if previous_error - error < stop_improvement:
                break
            previous_error = error
            if error < stop_error:
                break

            a_c0 = np.vstack([
                self.points_source.reshape(-1, 1),
                self.points_source[idx_s].reshape(-1, 1),
            ])
            if a_c123 is None:
                n_rows = len(self.points_source) + len(self.points_target)
                a_c1 = np.tile(np.array([1.0, 0.0, 0.0]), n_rows).reshape(-1, 1)
                a_c2 = np.zeros_like(a_c1)
                a_c2[1:, 0] = a_c1[:-1, 0]
                a_c3 = np.zeros_like(a_c1)
                a_c3[2:, 0] = a_c1[:-2, 0]
                a_c123 = np.hstack([a_c1, a_c2, a_c3])

            a = np.hstack([a_c0, a_c123])
            b = np.vstack([
                closest_target.reshape(-1, 1), query_target.reshape(-1, 1)
            ])
            x, *_ = np.linalg.lstsq(a, b, rcond=None)
            self.scale = x[0]
            self.trans = x[1:].T

    def get_trans_scale(self) -> Tuple[np.ndarray, np.ndarray]:
        all_scale = self.scale_target * self.scale / self.scale_source
        all_trans = (
            self.trans + self.offset_target * self.scale
            - self.offset_source * self.scale_target * self.scale / self.scale_source
        )
        return all_trans, all_scale

    def export_source_mesh(self, path: str) -> None:
        v = self.mesh_source.vertices
        v = (v - self.offset_source) / self.scale_source * self.scale_target + self.offset_target
        v = v * self.scale + self.trans
        TriMesh(v, self.mesh_source.faces).export(path)
