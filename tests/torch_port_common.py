"""Shared inputs for the differential tests of the PyTorch port
(``tests/test_torch_*.py``) against the JAX package.

Every input is made with numpy from a seed and handed to both frameworks as
numpy arrays; the port runs on the CPU in float64.
"""

import jax.numpy as jnp
import numpy as np
import torch

from mba_vo_tpu.data.synthetic import _box_filter_1d

# the tests run several to a machine (one worker process per file): one
# intra-op thread each keeps them from oversubscribing the cores, and the
# tensors here are too small to gain from more
torch.set_num_threads(1)

H, W = 64, 80
FX = 60.0
KVEC = np.array([FX, FX, (W - 1) / 2, (H - 1) / 2])
DEPTH = 2.0
EXPOSURE = 0.03
FRAME_DT = 0.1
DEGREE = 2


def t64(x) -> torch.Tensor:
    """A float64 CPU tensor from a numpy or JAX array (or a scalar)."""
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def npy(x) -> np.ndarray:
    """numpy view of a JAX array or a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def smooth_texture(h, w, seed=0, passes=2) -> np.ndarray:
    img = np.random.default_rng(seed).uniform(0, 255, (h, w))
    for _ in range(passes):
        img = _box_filter_1d(img, 2, 0)
        img = _box_filter_1d(img, 2, 1)
    return img


def random_quats(rng, n, scale=0.3) -> np.ndarray:
    """[n, 4] unit xyzw quaternions with w > 0."""
    q = np.concatenate([rng.normal(0, scale, (n, 3)), np.ones((n, 1))], axis=1)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def knots_arrays(seed=0, num_knots=2, t0=0.085, dt=0.1):
    """(t [K,3], q [K,4], t0, dt) of a small generic knot window."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.01, (num_knots, 3)),
            random_quats(rng, num_knots, 0.004), t0, dt)


def knots_pair(arrays):
    """The same knots as (JAX SplineKnots, port SplineKnots)."""
    from mba_vo_tpu.core.spline import make_knots as jmake
    from mba_vo_tpu_torch.core.spline import make_knots as tmake

    t, q, t0, dt = arrays
    return (jmake(jnp.asarray(t), jnp.asarray(q), t0, dt),
            tmake(t64(t), t64(q), t0, dt))


def level_arrays(seed=4, n_kp=24, frames=1, h=H, w=W, kvec=KVEC, dead=3,
                 margin=6, border=True):
    """numpy fields of one TrackingLevelData: a smooth keyframe, `frames`
    perturbed copies as current frames, random sub-pixel keypoints (with
    ``border``, two of them within a few pixels of the border) and `dead`
    padded keypoint slots."""
    rng = np.random.default_rng(seed)
    img = smooth_texture(h, w, seed=seed)
    cur = np.stack([smooth_texture(h, w, seed=seed) + rng.normal(0, 2.0, (h, w))
                    for _ in range(frames)])
    kp = rng.uniform([margin, margin], [w - 1 - margin, h - 1 - margin], (n_kp, 2))
    if border:
        kp[:2] = [[1.5, 2.25], [w - 2.5, h - 1.75]]   # patches spill off the image
    mask = np.ones(n_kp)
    mask[n_kp - dead:] = 0.0
    caps = 0.1 + FRAME_DT * np.arange(frames)
    return dict(img_ref=img, cur_imgs=cur, cap_times=caps,
                exp_times=np.full(frames, EXPOSURE), kp_xy=kp,
                kp_z=rng.uniform(1.5, 2.5, n_kp), kp_mask=mask, K=np.asarray(kvec))


def level_pair(arrays, pattern):
    """The same level data as (JAX TrackingLevelData, port TrackingLevelData)."""
    from mba_vo_tpu.ops.image import image_gradients as jgrad
    from mba_vo_tpu.ops.residual import TrackingLevelData as JData
    from mba_vo_tpu_torch.ops.image import image_gradients as tgrad
    from mba_vo_tpu_torch.ops.residual import TrackingLevelData as TData

    a = arrays
    img_j = jnp.asarray(a["img_ref"])
    img_t = t64(a["img_ref"])
    fields = ("cur_imgs", "cap_times", "exp_times", "kp_xy", "kp_z", "kp_mask")
    jd = JData(img_ref=img_j, grad_ref=jgrad(img_j),
               pattern=jnp.asarray(pattern), K=jnp.asarray(a["K"]),
               **{k: jnp.asarray(a[k]) for k in fields})
    td = TData(img_ref=img_t, grad_ref=tgrad(img_t),
               pattern=torch.as_tensor(np.asarray(pattern)), K=t64(a["K"]),
               **{k: t64(a[k]) for k in fields})
    return jd, td


# ------------------------------------------------------------ whole trackers

VEL = np.array([0.06, -0.04, 0.02, 0.02, 0.05, -0.08])   # [translation; rotation] per s


def moving_scene(n_frames, seed=5, knot_noise_seed=None, h=H, w=W, kvec=KVEC,
                 caps=None, exps=None):
    """A smooth texture on a plane at DEPTH seen by a camera moving at VEL
    (with ``knot_noise_seed``, perturbed at every knot): the sharp keyframe,
    `n_frames` blurred frames rendered by the JAX forward model, and per-frame
    sharp/depth keyframe candidates, all numpy."""
    import jax

    from mba_vo_tpu.core import lie as jlie
    from mba_vo_tpu.core.spline import make_knots, spline_pose_at
    from mba_vo_tpu.data.synthetic import synthesize_blurred_image, warp_image

    img = smooth_texture(h, w, seed=seed)
    rng = None if knot_noise_seed is None else np.random.default_rng(knot_noise_seed)
    kt, kq = [np.zeros(3)], [np.array([0.0, 0.0, 0.0, 1.0])]
    for _ in range(n_frames + 4):
        d = VEL * FRAME_DT
        if rng is not None:
            d = d + np.concatenate([rng.normal(0, 3e-4, 3), rng.normal(0, 5e-4, 3)])
        kt.append(kt[-1] + d[:3])
        q = np.asarray(jlie.quat_multiply(jnp.asarray(kq[-1]), jlie.quat_exp(jnp.asarray(d[3:]))))
        kq.append(q / np.linalg.norm(q))
    traj = make_knots(jnp.asarray(np.array(kt)), jnp.asarray(np.array(kq)), 0.0, FRAME_DT)
    K, img_j = jnp.asarray(kvec), jnp.asarray(img)
    caps = [FRAME_DT * i for i in range(1, n_frames + 1)] if caps is None else list(caps)
    exps = [EXPOSURE] * len(caps) if exps is None else list(exps)
    blur = jax.jit(lambda c, e: synthesize_blurred_image(img_j, traj, 2, c, e, 5, DEPTH, K))
    sharp_at = jax.jit(lambda c: warp_image(img_j, *spline_pose_at(traj, c, 2), DEPTH, K))
    return dict(
        img=img, traj=traj, caps=caps, exps=exps, hw=(h, w), kvec=np.asarray(kvec),
        blurred=[np.asarray(blur(c, e)) for c, e in zip(caps, exps)],
        sharp=[np.asarray(sharp_at(c)) for c in caps],
        depth=[np.full((h, w), DEPTH - float(spline_pose_at(traj, c, 2).t[2])) for c in caps])


def bootstrap_pair(cfg, scene, exposure=EXPOSURE):
    """(JAX tracker, port tracker on the CPU) after their first (keyframe)
    frame, with the same non-zero velocity installed: from a standing start
    the first patch anchors sit on integer pixels up to the last bit, and
    the jitted JAX tracker and eager torch may floor them differently."""
    from mba_vo_tpu.tracker import blur_tracker as jbt
    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.tracker import blur_tracker as tbt

    h, w = scene["hw"]
    j = jbt.BlurAwareTracker(cfg, scene["kvec"], (h, w))
    t = tbt.BlurAwareTracker(interop.config_from_fields(cfg), scene["kvec"], (h, w),
                             device="cpu")
    for tr in (j, t):
        tr.track_frame(scene["img"], scene["img"], 0.0, exposure, np.full((h, w), DEPTH))
    j.neigh_velocity = jnp.asarray(VEL)
    interop.install_tracker_state(t, {"neigh_velocity": VEL})
    return j, t


def poses_array(poses) -> np.ndarray:
    """[T, 7] (t; q) rows of a list of JAX or port Poses."""
    return np.stack([np.concatenate([npy(p.t), npy(p.q)]) for p in poses])


def scene_ate(poses, scene, skip=()) -> float:
    from mba_vo_tpu.core.spline import spline_pose_at

    errs = [np.linalg.norm(p[:3] - np.asarray(spline_pose_at(scene["traj"], c, 2).t))
            for i, (p, c) in enumerate(zip(poses, scene["caps"])) if i not in skip]
    return float(np.sqrt(np.mean(np.square(errs))))
