"""Trajectory evaluation metrics: ATE RMSE with SE(3)/Sim(3) alignment.

The headline metric of BASELINE.json ("ATE RMSE on blurred sequences").
Umeyama alignment + RMSE of translation residuals, the standard VO/SLAM
evaluation protocol.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def align_trajectories_se3(
    est: np.ndarray, ref: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Umeyama alignment est -> ref over [N, 3] translations.

    Returns (R [3,3], t [3], s) minimizing || ref - (s R est + t) ||^2.
    """
    est = np.asarray(est, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    mu_e = est.mean(axis=0)
    mu_r = ref.mean(axis=0)
    xe = est - mu_e
    xr = ref - mu_r
    cov = xr.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (xe ** 2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_r - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_t: np.ndarray,
    ref_t: np.ndarray,
    align: bool = True,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error RMSE over [N, 3] translation sequences."""
    est_t = np.asarray(est_t, dtype=np.float64)
    ref_t = np.asarray(ref_t, dtype=np.float64)
    if align and len(est_t) >= 3:
        R, t, s = align_trajectories_se3(est_t, ref_t, with_scale)
        est_t = (s * (R @ est_t.T)).T + t
    err = est_t - ref_t
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe_rmse(
    est_t: np.ndarray, ref_t: np.ndarray, delta: int = 1
) -> float:
    """Relative pose (translation drift) error RMSE over a frame delta."""
    est_t = np.asarray(est_t, dtype=np.float64)
    ref_t = np.asarray(ref_t, dtype=np.float64)
    de = est_t[delta:] - est_t[:-delta]
    dr = ref_t[delta:] - ref_t[:-delta]
    err = de - dr
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
