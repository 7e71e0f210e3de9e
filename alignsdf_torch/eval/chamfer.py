"""Chamfer distance and Procrustes/ICP registration in numpy/scipy on the
host, the JAX package's ``eval/chamfer.py`` (reference
deep_sdf/metrics/chamfer.py)."""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.spatial import cKDTree

from alignsdf_torch.eval.icp import ICPTransScale
from alignsdf_torch.geom.meshlib import load_mesh, sample_surface


def transform_points(points: np.ndarray, matrix: np.ndarray,
                     translate: bool = True) -> np.ndarray:
    """Homogeneous transform application (reference chamfer.py:12-58)."""
    points = np.asanyarray(points, np.float64)
    if len(points) == 0:
        return points.copy()
    matrix = np.asanyarray(matrix, np.float64)
    dim = points.shape[1]
    col = np.zeros(len(points)) + int(bool(translate))
    stacked = np.column_stack((points, col))
    return np.ascontiguousarray((matrix @ stacked.T).T[:, :dim])


def procrustes(a: np.ndarray, b: np.ndarray, reflection: bool = True,
               translation: bool = True, scale: bool = True):
    """Similarity-transform fit a->b via SVD (reference chamfer.py:61-104)."""
    a = np.asanyarray(a, np.float64)
    b = np.asanyarray(b, np.float64)
    if len(a) != len(b):
        raise ValueError("a and b must contain same number of points!")

    acenter = a.mean(axis=0) if translation else np.zeros(a.shape[1])
    bcenter = b.mean(axis=0) if translation else np.zeros(b.shape[1])
    if scale:
        ascale = np.sqrt(((a - acenter) ** 2).sum() / len(a))
        bscale = np.sqrt(((b - bcenter) ** 2).sum() / len(b))
    else:
        ascale = bscale = 1

    u, _, vh = np.linalg.svd(((b - bcenter) / bscale).T @ ((a - acenter) / ascale))
    if reflection:
        rot = u @ vh
    else:
        rot = u @ np.diag([1, 1, np.linalg.det(u @ vh)]) @ vh

    translation_vec = bcenter - (bscale / ascale) * rot @ acenter
    matrix = np.vstack([
        np.hstack([bscale / ascale * rot, translation_vec.reshape(-1, 1)]),
        np.array([0.0] * a.shape[1] + [1.0]).reshape(1, -1),
    ])
    transformed = transform_points(a, matrix)
    cost = ((b - transformed) ** 2).mean()
    return matrix, transformed, cost


def procrustes_without_rot(a: np.ndarray, b: np.ndarray):
    """Scale+translation-only least squares (reference chamfer.py:107-130)."""
    a = np.asanyarray(a, np.float64)
    b = np.asanyarray(b, np.float64)
    b_vec = b.reshape(-1)
    dim = b_vec.shape[0]
    A = np.zeros((b.shape[0] * 3, 4))
    A[0:dim:3, 1] = 1
    A[1:dim:3, 2] = 1
    A[2:dim:3, 3] = 1
    A[:, 0] = a.reshape(-1)
    sol = np.linalg.inv(A.T @ A) @ A.T @ b_vec

    matrix = np.zeros((4, 4))
    matrix[:3, :3] = np.eye(3) * sol[0]
    matrix[:3, 3] = sol[1:4]
    matrix[3, 3] = 1
    transformed = transform_points(a, matrix)
    return matrix, transformed, ((b - transformed) ** 2).mean()


def icp(a: np.ndarray, b: np.ndarray, initial: Optional[np.ndarray] = None,
        threshold: float = 1e-5, max_iterations: int = 20, rot: bool = False):
    """Symmetric ICP with Procrustes updates (reference chamfer.py:133-180)."""
    a = np.asanyarray(a, np.float64)
    b = np.asanyarray(b, np.float64)
    initial = np.identity(4) if initial is None else initial
    atree = cKDTree(a)
    btree = cKDTree(b)
    a = transform_points(a, initial)
    b = transform_points(b, initial)
    old_cost = np.inf

    for _ in range(max_iterations):
        _, idx = btree.query(a, 1)
        closest = b[idx]
        fit = procrustes if rot else procrustes_without_rot
        _, transformed_a, cost_pred = fit(a, closest)

        _, idx = atree.query(b, 1)
        closest = a[idx]
        _, transformed_b, cost_gt = fit(b, closest)

        cost = cost_pred + cost_gt
        a, b = transformed_a, transformed_b
        if old_cost - cost < threshold:
            break
        old_cost = cost
    return a, b, cost


def registration_icp(a: np.ndarray, b: np.ndarray,
                     initial: Optional[np.ndarray] = None,
                     threshold: float = 1e-5, max_iterations: int = 20):
    """One-directional ICP with full-procrustes (rotation+scale) updates —
    the semantics of ``trimesh.registration.icp``, which is what the
    reference's ``--rot`` eval path actually calls
    (reference chamfer.py:203).  Returns (total_matrix, transformed_a, cost)."""
    a = np.asanyarray(a, np.float64)
    b = np.asanyarray(b, np.float64)
    total_matrix = np.identity(4) if initial is None else initial
    a = transform_points(a, total_matrix)
    btree = cKDTree(b)
    old_cost = np.inf
    transformed = a
    cost = old_cost
    for _ in range(max_iterations):
        _, idx = btree.query(a, 1)
        matrix, transformed, cost = procrustes(a, b[idx])
        a = transformed
        total_matrix = matrix @ total_matrix
        if old_cost - cost < threshold:
            break
        old_cost = cost
    return total_matrix, transformed, cost


def compute_chamfer(gt_mesh_path: str, pred_mesh_path: str, optim: bool = False,
                    rot: bool = False, n_samples: int = 30000,
                    rng: Optional[np.random.Generator] = None) -> float:
    """Symmetric mean-squared-NN chamfer in cm^2 over surface samples
    (reference chamfer.py:183-231)."""
    rng = rng or np.random.default_rng(0)
    source_mesh = load_mesh(pred_mesh_path)
    target_mesh = load_mesh(gt_mesh_path)

    if optim:
        if rot:
            points_source = sample_surface(source_mesh, n_samples, rng)
            points_target = sample_surface(target_mesh, n_samples, rng)
            _, points_source, _ = registration_icp(points_source, points_target)
        else:
            solver = ICPTransScale(source_mesh, target_mesh)
            solver.sample_mesh(n_samples, "both", rng)
            solver.run_icp_f(max_iter=100)
            points_source = solver.points_source * solver.scale + solver.trans
            points_target = solver.points_target
    else:
        points_source = sample_surface(source_mesh, n_samples, rng)
        points_target = sample_surface(target_mesh, n_samples, rng)

    points_source = points_source * 100.0  # m -> cm
    points_target = points_target * 100.0

    one, _ = cKDTree(points_source).query(points_target)
    two, _ = cKDTree(points_target).query(points_source)
    return float(np.mean(np.square(one)) + np.mean(np.square(two)))
