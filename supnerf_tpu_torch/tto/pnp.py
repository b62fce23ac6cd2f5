"""PnP-RANSAC pose bootstrap from the encoder's direct box-corner prediction,
in numpy; the port of supnerf_tpu/tto/pnp.py (reference
optimizer_nuscenes.py:464-494, opt_pose 2): the 16-wide prediction is
denormalised to image pixels and solved against the box's 8 corners, the
rotation always taken, the translation only for a depth in (0, 60) m.

JAX calls cv2.solvePnPRansac(p3d, p2d, K, 0, iterationsCount=5000,
reprojectionError=1, flags=SOLVEPNP_P3P). solve_pnp_ransac reproduces what
that call does, as read off OpenCV's solvePnPRansac and checked against
cv2 5.0.0 by experiment on random boxes and poses:
  - the object and image points are rounded to float32 first;
  - RANSAC draws 4 distinct correspondences a sample, solves P3P on the
    first 3 (solve_p3p, up to 4 solutions) and keeps the solution whose
    4th point reprojects closest; a correspondence is an inlier where its
    squared reprojection error is <= reprojectionError^2; a model with more
    inliers than the best so far (and at least 4) replaces it and cuts the
    iteration count to OpenCV's RANSACUpdateNumIters at confidence 0.99;
  - fewer than 4 inliers in every sample is a failure: cv2 then returns
    False with uninitialised rvec/tvec (which JAX takes; see ROADMAP.md
    §C), here (False, None, None, None);
  - the answer is EPnP (solve_epnp, OpenCV's epnp.cpp: PCA control points,
    the three beta approximations each refined by 5 Gauss-Newton steps,
    the one of least mean reprojection error) on the inlier set, not the
    minimal sample's model. Under noise EPnP's answer depends on the signs
    of its control points' axes, so both of its SVDs follow OpenCV's
    one-sided Jacobi SVD (_jacobi_svd_ut), signs included.
So the answer depends on the inlier set alone, and the sampling stream
(here a numpy Generator seeded 0) only decides which set is found where
sets of one size compete (noisy corners). Measured against cv2 5.0.0 on 8
correspondences of random boxes and poses: where both find the same set
of 6 to 8 inliers, the poses agree to ~1e-11 (rotation entries, metres);
exact corners give 8 inliers, one corner 40 px off gives 7. With 4 or 5
inliers EPnP is ill-conditioned (4 box corners are often coplanar) and
cv2's answer moves by metres under rounding of its inputs, so no
implementation reproduces it there; this module gives EPnP's answer in
float64.
"""
from __future__ import annotations

import itertools

import numpy as np

RANSAC_ITERATIONS = 5000
REPROJECTION_ERROR = 1.0
CONFIDENCE = 0.99


def _box_corners_3d(wlh):
    """The 8 corners (8, 3) of a box of size wlh in its own frame (x along
    l, y along w, z along h), in the JAX module's order."""
    w, l, h = wlh
    x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
    y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
    z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
    return np.vstack([x, y, z]).T


def denormalize_uv_direct(uv_direct, roi):
    """(16,) ROI-normalised direct prediction -> (2, 8) image-pixel corners
    (reference :465-470)."""
    uv = np.asarray(uv_direct, np.float64).reshape(2, 8).copy()
    roi = np.asarray(roi, np.float64)
    dim = max(roi[2] - roi[0], roi[3] - roi[1])
    uv = uv * (dim / 2)
    uv[0] += (roi[0] + roi[2]) / 2
    uv[1] += (roi[1] + roi[3]) / 2
    return uv


def project(P, R, t, K):
    """Pixels (N, 2) of object points P (N, 3) under the pose (R, t)."""
    pc = P @ R.T + t
    uvw = pc @ K.T
    return uvw[:, :2] / uvw[:, 2:]


def _rigid_transform(P, Q):
    """(R, t) with Q ~ R P + t for (N, 3) points, N >= 3 (Kabsch)."""
    p0, q0 = P.mean(0), Q.mean(0)
    U, _, Vt = np.linalg.svd((Q - q0).T @ (P - p0))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    return R, q0 - R @ p0


def solve_p3p(P, uv, K):
    """Every pose (R, t) that projects the 3 object points P (3, 3) onto the
    pixels uv (3, 2): Grunert's distance equations reduced to a quartic in
    the ratio v = s3 / s1 by the resultant of the two quadratics in
    u = s2 / s1, each real root giving the depths and a rigid transform."""
    j = np.linalg.solve(K, np.vstack([uv.T, np.ones(3)])).T
    j /= np.linalg.norm(j, axis=1, keepdims=True)
    a2 = np.sum((P[1] - P[2]) ** 2)
    b2 = np.sum((P[0] - P[2]) ** 2)
    c2 = np.sum((P[0] - P[1]) ** 2)
    ca, cb, cg = j[1] @ j[2], j[0] @ j[2], j[0] @ j[1]
    if min(a2, b2, c2) <= 0:
        return []
    # with s2 = u s1 and s3 = v s1, eliminating s1^2 leaves two quadratics
    # in u, b2 u^2 + e1 u + f1(v) = 0 and b2 u^2 + e2(v) u + f2(v) = 0, whose
    # coefficients are polynomials in v (arrays, lowest order first)
    e1 = np.array([-2 * b2 * cg, 0.0])
    f1 = np.array([b2 - c2, 2 * c2 * cb, -c2])
    e2 = np.array([0.0, -2 * b2 * ca])
    f2 = np.array([-a2, 2 * a2 * cb, b2 - a2])
    # the resultant of p2 u^2 + p1 u + p0 and q2 u^2 + q1 u + q0 with p2 = q2
    # = b2: (b2 (q0 - p0))^2 - b2 (q1 - p1) (p1 q0 - p0 q1), a quartic in v
    d0, d1 = f2 - f1, e2 - e1
    res = (b2 * b2 * np.convolve(d0, d0)
           - b2 * np.convolve(d1, np.convolve(e1, f2) - np.convolve(f1, e2))[:5])
    res = np.trim_zeros(res, "b")
    if len(res) < 2:
        return []
    out = []
    for v in np.roots(res[::-1]):
        if abs(v.imag) > 1e-8 * max(1.0, abs(v.real)):
            continue
        v = v.real
        den = d1[0] + d1[1] * v
        if v <= 0 or abs(den) < 1e-300:
            continue
        u = -(d0[0] + (d0[1] + d0[2] * v) * v) / den
        q = 1.0 + u * u - 2.0 * u * cg
        if u <= 0 or q <= 0:
            continue
        s1 = np.sqrt(c2 / q)
        R, t = _rigid_transform(P, np.stack([s1 * j[0], u * s1 * j[1], v * s1 * j[2]]))
        out.append((R, t))
    return out


def _p3p_kernel(P, uv, K):
    """OpenCV's minimal model on 4 correspondences: P3P on the first 3, the
    solution whose 4th point reprojects closest, or None."""
    best, best_err = None, np.inf
    for R, t in solve_p3p(P[:3], uv[:3], K):
        err = np.sum((project(P[3:], R, t, K) - uv[3:]) ** 2)
        if err < best_err:
            best, best_err = (R, t), err
    return best


def _update_num_iters(p, ep, model_points, max_iters):
    """OpenCV's RANSACUpdateNumIters."""
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = np.log(num), np.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) else int(round(num / denom))


def _jacobi_svd_ut(A):
    """Uᵀ and the singular values of a square matrix as OpenCV's one-sided
    Jacobi SVD (lapack.cpp JacobiSVDImpl_, double: eps 10 DBL_EPSILON)
    returns them, signs included: EPnP's control points take the signs of
    these vectors, and under noise its answer depends on them."""
    At = np.array(A, np.float64).T.copy()
    n = len(At)
    W, V = np.sum(At * At, 1), np.eye(n)
    eps = 10 * np.finfo(np.float64).eps
    for _ in range(max(n, 30)):
        changed = False
        for i, j in itertools.combinations(range(n), 2):
            a, b, p = W[i], W[j], At[i] @ At[j]
            if abs(p) <= eps * np.sqrt(a * b):
                continue
            p *= 2
            beta, gamma = a - b, np.hypot(p, a - b)
            if beta < 0:
                s = np.sqrt((gamma - beta) * 0.5 / gamma)
                c = p / (gamma * s * 2)
            else:
                c = np.sqrt((gamma + beta) / (gamma * 2))
                s = p / (gamma * c * 2)
            At[[i, j]] = [c * At[i] + s * At[j], -s * At[i] + c * At[j]]
            V[[i, j]] = [c * V[i] + s * V[j], -s * V[i] + c * V[j]]
            W[i], W[j] = At[i] @ At[i], At[j] @ At[j]
            changed = True
        if not changed:
            break
    W = np.sqrt(np.sum(At * At, 1))
    for i in range(n - 1):
        j = i
        for k in range(i + 1, n):
            if W[j] < W[k]:
                j = k
        if i != j:
            W[[i, j]], At[[i, j]] = W[[j, i]], At[[j, i]]
    tiny = np.finfo(np.float64).tiny
    return At / np.where(W > tiny, W, np.inf)[:, None], W


def _epnp_pose(cws, alphas, ut, betas, P, uv, K):
    """EPnP's compute_R_and_t for one beta vector: camera control points,
    camera points, the sign fix, then Horn's transform and its error."""
    if not np.isfinite(betas).all():
        nan = np.full(3, np.nan)
        return np.full((3, 3), np.nan), nan, np.nan
    ccs = sum(betas[k] * ut[11 - k].reshape(4, 3) for k in range(4))
    pcs = alphas @ ccs
    if pcs[0, 2] < 0:
        pcs = -pcs
    p0, q0 = P.mean(0), pcs.mean(0)
    U, _, Vt = np.linalg.svd((pcs - q0).T @ (P - p0))
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R[2] = -R[2]
    t = q0 - R @ p0
    return R, t, np.mean(np.linalg.norm(project(P, R, t, K) - uv, axis=1))


def _gauss_newton(L, rho, betas):
    """EPnP's 5 Gauss-Newton steps on the betas (NaN where they fail, as
    OpenCV's arithmetic gives then)."""
    for _ in range(5):
        if not np.isfinite(betas).all():
            return np.full(4, np.nan)
        b0, b1, b2, b3 = betas
        A = np.stack([
            2 * L[:, 0] * b0 + L[:, 1] * b1 + L[:, 3] * b2 + L[:, 6] * b3,
            L[:, 1] * b0 + 2 * L[:, 2] * b1 + L[:, 4] * b2 + L[:, 7] * b3,
            L[:, 3] * b0 + L[:, 4] * b1 + 2 * L[:, 5] * b2 + L[:, 8] * b3,
            L[:, 6] * b0 + L[:, 7] * b1 + L[:, 8] * b2 + 2 * L[:, 9] * b3], 1)
        quad = np.array([b0 * b0, b0 * b1, b1 * b1, b0 * b2, b1 * b2, b2 * b2, b0 * b3, b1 * b3,
                         b2 * b3, b3 * b3])
        try:
            betas = betas + np.linalg.lstsq(A, rho - L @ quad, rcond=None)[0]
        except np.linalg.LinAlgError:
            return np.full(4, np.nan)
    return betas


def solve_epnp(P, uv, K):
    """OpenCV's EPnP (epnp.cpp compute_pose) on N >= 4 correspondences ->
    (R, t)."""
    n = len(P)
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    c0 = P.mean(0)
    uct, dc = _jacobi_svd_ut((P - c0).T @ (P - c0))
    cws = np.vstack([c0, c0 + np.sqrt(dc / n)[:, None] * uct])
    alphas = np.zeros((n, 4))
    alphas[:, 1:] = (P - c0) @ np.linalg.pinv((cws[1:] - c0).T).T
    alphas[:, 0] = 1.0 - alphas[:, 1:].sum(1)
    M = np.zeros((2 * n, 12))
    M[0::2, 0::3] = alphas * fu
    M[0::2, 2::3] = alphas * (uc - uv[:, :1])
    M[1::2, 1::3] = alphas * fv
    M[1::2, 2::3] = alphas * (vc - uv[:, 1:])
    ut, _ = _jacobi_svd_ut(M.T @ M)
    pairs = list(itertools.combinations(range(4), 2))
    dv = [np.stack([ut[11 - i].reshape(4, 3)[a] - ut[11 - i].reshape(4, 3)[b]
                    for a, b in pairs]) for i in range(4)]
    terms = [(0, 0, 1), (0, 1, 2), (1, 1, 1), (0, 2, 2), (1, 2, 2), (2, 2, 1), (0, 3, 2),
             (1, 3, 2), (2, 3, 2), (3, 3, 1)]
    L = np.stack([w * np.sum(dv[a] * dv[b], 1) for a, b, w in terms], 1)
    rho = np.array([np.sum((cws[a] - cws[b]) ** 2) for a, b in pairs])

    b4 = np.linalg.lstsq(L[:, [0, 1, 3, 6]], rho, rcond=None)[0]
    sq = np.sqrt(abs(b4[0]))
    betas1 = np.array([sq, *(b4[1:] / sq * (-1 if b4[0] < 0 else 1))])
    b3 = np.linalg.lstsq(L[:, :3], rho, rcond=None)[0]
    b5 = np.linalg.lstsq(L[:, :5], rho, rcond=None)[0]
    found = []
    for b in (betas1, b3, b5):
        if b is not betas1:
            neg = b[0] < 0
            beta0 = np.sqrt(-b[0]) if neg else np.sqrt(b[0])
            beta1 = (np.sqrt(-b[2]) if b[2] < 0 else 0.0) if neg else (
                np.sqrt(b[2]) if b[2] > 0 else 0.0)
            if b[1] < 0:
                beta0 = -beta0
            beta2 = b[3] / beta0 if len(b) == 5 else 0.0
            b = np.array([beta0, beta1, beta2, 0.0])
        found.append(_epnp_pose(cws, alphas, ut, _gauss_newton(L, rho, b), P, uv, K))
    best = found[0]
    for cand in found[1:]:
        if cand[2] < best[2]:
            best = cand
    return best[0], best[1]


def solve_pnp_ransac(object_points, image_points, K):
    """cv2.solvePnPRansac(..., iterationsCount=RANSAC_ITERATIONS,
    reprojectionError=REPROJECTION_ERROR, flags=SOLVEPNP_P3P) with zero
    distortion and confidence CONFIDENCE, on
    N >= 5 correspondences (see the module docstring): (ok, R (3, 3), t (3,),
    inlier indices), or (False, None, None, None) when no sample finds 4
    inliers."""
    P = np.asarray(object_points, np.float32).astype(np.float64)
    uv = np.asarray(image_points, np.float32).astype(np.float64)
    K = np.asarray(K, np.float64)
    n = len(P)
    if n < 5:
        raise ValueError(f"{n} correspondences: RANSAC here takes 5 or more (8 box corners)")
    rng = np.random.default_rng(0)
    best_count, best_mask, niters, it = 0, None, RANSAC_ITERATIONS, 0
    while it < niters:
        sample = rng.choice(n, 4, replace=False)
        model = _p3p_kernel(P[sample], uv[sample], K)
        it += 1
        if model is None:
            continue
        with np.errstate(all="ignore"):
            err = np.sum((project(P, *model, K) - uv) ** 2, axis=1)
        mask = err <= REPROJECTION_ERROR ** 2
        count = int(mask.sum())
        if count > max(best_count, 3):
            best_count, best_mask = count, mask
            niters = _update_num_iters(CONFIDENCE, (n - count) / n, 4, niters)
    if best_mask is None:
        return False, None, None, None
    inliers = np.flatnonzero(best_mask)
    R, t = solve_epnp(P[inliers], uv[inliers], K)
    return True, R, t, inliers


def pnp_bootstrap(uv_direct, roi, wlh, K, src_pose, depth_range=(0.0, 60.0)):
    """src_pose (3, 4) re-seeded by P3P-RANSAC on the predicted corners: the
    rotation always, the translation only if its depth is inside
    depth_range; src_pose unchanged where RANSAC fails (float32)."""
    p2d = denormalize_uv_direct(uv_direct, roi).T
    p3d = _box_corners_3d(np.asarray(wlh, np.float64))
    with np.errstate(all="ignore"):
        ok, R, t, _ = solve_pnp_ransac(p3d, p2d, K)
    out = np.asarray(src_pose, np.float64).copy()
    if ok and np.isfinite(R).all() and np.isfinite(t).all():
        out[:3, :3] = R
        if depth_range[0] < t[2] < depth_range[1]:
            out[:3, 3] = t
    return out.astype(np.float32)
