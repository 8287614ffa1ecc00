"""The synthetic room, orbit trajectory, projections and renderer of the
port (numpy/cv2 copies of plvio_tpu/io/synthetic.py:22-305: `GRAVITY`,
`Scene`, `SyntheticTrajectory`, `SyntheticImu`, `make_room_scene`,
`make_orbit_trajectory`, `_eval_orbit`, `project_scene`, `render_frame`),
and the EuRoC-realism MH replay (:375-632: `make_hall_scene`, `_eval_mh`,
`make_mh_trajectory`, `_eval_mh_loop`, `_eval_mh_loop_pos`,
`synthesize_imu_mh` on the port's float32 `so3_log`,
`render_frame_realistic`), and the fisheye renderer (:309-363:
`_kb8_project_cam_np`, `render_frame_kb8`), each consuming its `np.random.Generator` in
the reference's order, so that one seed gives the same scene, IMU and
images.

The rectified pair's second view and the RGB-D depth image (what
tests/test_stereo.py and tests/test_stereo_inertial.py make inline):
`right_eye` moves a trajectory's camera `baseline` metres along its own x
axis, and `oracle_depth` splats every visible point's depth.

Host-side test and benchmark utilities, not device ops.  The IMU
synthesis along the orbit is `plvio_tpu_torch.inputs.synthesize_imu`.

World frame: z-up, gravity (0,0,-g).  Pose convention: T_wc maps camera
coords to world (R_wc, t_wc = camera center).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

GRAVITY = 9.81


@dataclass
class Scene:
    points: np.ndarray           # [P,3] world points
    lines: np.ndarray            # [L,2,3] world segment endpoints
    point_polarity: np.ndarray   # [P] signed blob intensity (render)
    line_polarity: np.ndarray    # [L] signed line intensity (render)
    # render-only texture dots: unique constellations around each point so
    # descriptors are distinctive and viewpoint-consistent
    texture_dots: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    texture_intensity: np.ndarray = field(default_factory=lambda: np.zeros(0))


@dataclass
class SyntheticTrajectory:
    timestamps: np.ndarray       # [N] seconds
    R_wb: np.ndarray             # [N,3,3] world-from-body
    p_wb: np.ndarray             # [N,3]
    v_wb: np.ndarray             # [N,3]


@dataclass
class SyntheticImu:
    timestamps: np.ndarray       # [M]
    gyro: np.ndarray             # [M,3] body rates (measured)
    acc: np.ndarray              # [M,3] specific force (measured)
    bias_gyro: np.ndarray        # [3] true constant bias used
    bias_acc: np.ndarray         # [3]


def make_room_scene(rng: np.random.Generator, n_points: int = 2000,
                    n_lines: int = 60, size: float = 6.0) -> Scene:
    """Points and lines on the walls/floor/ceiling of a [size]^3 room
    centred at origin (cameras orbit inside looking outward)."""
    h = size / 2
    # pick a wall (6 faces) per feature, uniform position on the face
    def on_faces(n):
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-h, h, (n, 2))
        pts = np.zeros((n, 3))
        axis = face // 2                 # 0:x, 1:y, 2:z fixed
        sign = np.where(face % 2 == 0, 1.0, -1.0)
        for i in range(n):
            others = [k for k in range(3) if k != axis[i]]
            pts[i, axis[i]] = sign[i] * h
            pts[i, others[0]] = uv[i, 0]
            pts[i, others[1]] = uv[i, 1]
        return pts, axis, sign

    pts, _, _ = on_faces(n_points)

    # lines: segments lying inside a wall plane
    lp, axis, sign = on_faces(n_lines)
    lines = np.zeros((n_lines, 2, 3))
    for i in range(n_lines):
        others = [k for k in range(3) if k != axis[i]]
        d = np.zeros(3)
        # direction within the wall plane
        ang = rng.uniform(0, np.pi)
        d[others[0]] = np.cos(ang)
        d[others[1]] = np.sin(ang)
        length = rng.uniform(0.8, 2.5)
        lines[i, 0] = lp[i] - d * length / 2
        lines[i, 1] = lp[i] + d * length / 2
        lines[i] = np.clip(lines[i], -h, h)
        lines[i, :, axis[i]] = sign[i] * h
    # unique satellite-dot constellations around each point: 4 dots at
    # per-point random in-plane offsets — viewpoint-consistent local
    # texture that makes BRIEF descriptors distinctive
    pts2, axis2, _ = pts, None, None
    n_sat = 4
    face_axis = np.argmax(np.abs(np.abs(pts) - h) < 1e-9, axis=1)
    dots = np.zeros((n_points * n_sat, 3))
    for i in range(n_points):
        others = [k for k in range(3) if k != face_axis[i]]
        offs = rng.uniform(-0.12, 0.12, (n_sat, 2))
        # keep satellites off the blob itself
        offs += np.sign(offs) * 0.05
        for s in range(n_sat):
            d = pts[i].copy()
            d[others[0]] += offs[s, 0]
            d[others[1]] += offs[s, 1]
            dots[i * n_sat + s] = d
    return Scene(
        points=pts,
        lines=lines,
        point_polarity=rng.uniform(0.4, 1.0, n_points) * rng.choice([-1.0, 1.0], n_points),
        line_polarity=rng.uniform(0.5, 1.0, n_lines) * rng.choice([-1.0, 1.0], n_lines),
        texture_dots=dots,
        texture_intensity=rng.uniform(0.3, 0.9, n_points * n_sat)
        * rng.choice([-1.0, 1.0], n_points * n_sat),
    )


def make_orbit_trajectory(duration: float = 10.0, fps: float = 20.0,
                          radius: float = 1.5, height_amp: float = 0.3,
                          omega: float = 0.45) -> SyntheticTrajectory:
    """Camera orbits inside the room looking outward at the walls.

    Closed-form smooth trajectory; velocity by analytic differentiation.
    The body/camera z-axis (optical axis) points radially outward.
    """
    t = np.arange(0.0, duration, 1.0 / fps)
    return _eval_orbit(t, radius, height_amp, omega)


def _eval_orbit(t: np.ndarray, radius: float, height_amp: float,
                omega: float) -> SyntheticTrajectory:
    th = omega * t
    p = np.stack([radius * np.cos(th), radius * np.sin(th),
                  height_amp * np.sin(2.1 * omega * t)], axis=-1)
    v = np.stack([-radius * omega * np.sin(th), radius * omega * np.cos(th),
                  height_amp * 2.1 * omega * np.cos(2.1 * omega * t)], axis=-1)
    # optical axis = radial outward (+ small pitch bob), camera x right, y down
    look = np.stack([np.cos(th), np.sin(th), 0.12 * np.sin(1.3 * omega * t)], axis=-1)
    look /= np.linalg.norm(look, axis=-1, keepdims=True)
    world_down = np.array([0.0, 0.0, -1.0])
    x = np.cross(world_down, look)      # camera x (right)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(look, x)               # camera y (down-ish)
    R = np.stack([x, y, look], axis=-1)  # columns are camera axes in world
    return SyntheticTrajectory(timestamps=t, R_wb=R, p_wb=p, v_wb=v)


# --------------------------------------------------------------------------
# Rendering (host-side, numpy/cv2 — test/bench utility, not a device op)
# --------------------------------------------------------------------------

def project_scene(scene: Scene, R_wc: np.ndarray, p_wc: np.ndarray,
                  fx: float, fy: float, cx: float, cy: float,
                  width: int, height: int, margin: float = 8.0):
    """Oracle projections for one camera pose.

    Returns (uv [P,2], depth [P], visible [P]) for points and
    (uv_ep [L,2,2], visible_l [L]) for line endpoints.
    """
    R_cw = R_wc.T
    pc = (R_cw @ (scene.points - p_wc).T).T
    z = pc[:, 2]
    uv = np.stack([fx * pc[:, 0] / np.maximum(z, 1e-6) + cx,
                   fy * pc[:, 1] / np.maximum(z, 1e-6) + cy], axis=-1)
    vis = (z > 0.2) & (uv[:, 0] >= margin) & (uv[:, 0] < width - margin) \
        & (uv[:, 1] >= margin) & (uv[:, 1] < height - margin)

    lc = np.einsum("ij,lkj->lki", R_cw, scene.lines - p_wc)
    # near-plane clip in 3D first: a segment with ONE endpoint behind the
    # camera is still partially visible (real detectors see it), so move
    # that endpoint to the z=0.25 plane instead of culling the line
    znear = 0.25
    for i in range(len(lc)):
        z0, z1 = lc[i, 0, 2], lc[i, 1, 2]
        if (z0 > znear) != (z1 > znear):
            t = (znear - z0) / (z1 - z0)
            pcut = lc[i, 0] + t * (lc[i, 1] - lc[i, 0])
            if z0 <= znear:
                lc[i, 0] = pcut
            else:
                lc[i, 1] = pcut
    zl = lc[..., 2]
    uv_l = np.stack([fx * lc[..., 0] / np.maximum(zl, 1e-6) + cx,
                     fy * lc[..., 1] / np.maximum(zl, 1e-6) + cy], axis=-1)
    # clip each projected segment to the image rect (Liang-Barsky) so
    # partially visible lines still count, as a real detector would see them
    uv_clip = uv_l.copy()
    vis_l = np.zeros(len(uv_l), bool)
    lo = np.array([margin, margin])
    hi = np.array([width - margin, height - margin])
    min_len = 0.04 * min(width, height)
    for i in range(len(uv_l)):
        if zl[i, 0] <= 0.2 or zl[i, 1] <= 0.2:
            continue
        p0, d = uv_l[i, 0], uv_l[i, 1] - uv_l[i, 0]
        t0, t1 = 0.0, 1.0
        ok = True
        for k in range(2):
            for bound, sign in ((lo[k], 1.0), (hi[k], -1.0)):
                denom = sign * d[k]
                num = sign * (bound - p0[k])
                if abs(denom) < 1e-12:
                    if num > 0:
                        ok = False
                else:
                    t = num / denom
                    if denom > 0:
                        t0 = max(t0, t)
                    else:
                        t1 = min(t1, t)
        if ok and t0 < t1:
            a, b = p0 + t0 * d, p0 + t1 * d
            if np.linalg.norm(b - a) >= min_len:
                uv_clip[i, 0], uv_clip[i, 1] = a, b
                vis_l[i] = True
    return uv, z, vis, uv_clip, vis_l


def render_frame(scene: Scene, R_wc: np.ndarray, p_wc: np.ndarray,
                 fx: float = 458.654, fy: float = 457.296,
                 cx: float = 367.215, cy: float = 248.375,
                 width: int = 752, height: int = 480,
                 rng: Optional[np.random.Generator] = None,
                 noise: float = 2.0, blob_r: int = 3) -> np.ndarray:
    """Render a grayscale frame: textured blobs at point projections and
    dark/bright segments for lines over a mid-gray background."""
    import cv2

    img = np.full((height, width), 128.0, np.float32)
    uv, z, vis, uv_l, vis_l = project_scene(
        scene, R_wc, p_wc, fx, fy, cx, cy, width, height)

    for i in np.nonzero(vis_l)[0]:
        col = 128.0 + 90.0 * scene.line_polarity[i]
        # sub-pixel endpoints (shift=4 -> 1/16 px): integer rounding
        # would tilt the drawn line by up to ~0.4 deg, which dominates
        # the direction error budget of line triangulation
        p0 = tuple(np.round(uv_l[i, 0] * 16).astype(int))
        p1 = tuple(np.round(uv_l[i, 1] * 16).astype(int))
        cv2.line(img, p0, p1, float(col), 2, cv2.LINE_AA, shift=4)

    # texture dots first (underneath the main blobs)
    if len(scene.texture_dots):
        R_cw = R_wc.T
        dc = (R_cw @ (scene.texture_dots - p_wc).T).T
        zd = dc[:, 2]
        uvd = np.stack([fx * dc[:, 0] / np.maximum(zd, 1e-6) + cx,
                        fy * dc[:, 1] / np.maximum(zd, 1e-6) + cy], axis=-1)
        ok = (zd > 0.2) & (uvd[:, 0] >= 0) & (uvd[:, 0] < width) \
            & (uvd[:, 1] >= 0) & (uvd[:, 1] < height)
        for i in np.nonzero(ok)[0]:
            col = 128.0 + 90.0 * scene.texture_intensity[i]
            c = tuple(np.round(uvd[i]).astype(int))
            r = max(1, int(round(1.5 * 2.0 / max(zd[i], 0.5))))
            cv2.circle(img, c, r, float(col), -1, cv2.LINE_AA)

    for i in np.nonzero(vis)[0]:
        col = 128.0 + 100.0 * scene.point_polarity[i]
        # square blobs give strong FAST corner responses at all 4 corners;
        # draw as a filled circle to get a single dominant corner-ish blob
        c = tuple(np.round(uv[i]).astype(int))
        r = max(2, int(round(blob_r * 2.0 / max(z[i], 0.5))))
        cv2.circle(img, c, r, float(col), -1, cv2.LINE_AA)

    img = cv2.GaussianBlur(img, (3, 3), 0.8)
    if rng is not None and noise > 0:
        img = img + rng.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 255)


def _kb8_project_cam_np(pc: np.ndarray, fx, fy, cx, cy, k) -> np.ndarray:
    """Camera-frame points [N,3] -> raw fisheye pixels [N,2] (the
    equidistant theta polynomial, numpy twin of `ops.cameras.kb8_project`
    for the host-side renderer)."""
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    r = np.sqrt(np.maximum(x * x + y * y, 1e-18))
    theta = np.arctan2(r, np.maximum(z, 1e-9))
    t2 = theta * theta
    theta_d = theta * (1.0 + k[0] * t2 + k[1] * t2 ** 2
                       + k[2] * t2 ** 3 + k[3] * t2 ** 4)
    s = theta_d / r
    return np.stack([fx * x * s + cx, fy * y * s + cy], -1)


def render_frame_kb8(scene: Scene, R_wc: np.ndarray, p_wc: np.ndarray,
                     fx: float = 380.0, fy: float = 380.0,
                     cx: float = 376.0, cy: float = 240.0,
                     k=(0.01, -0.005, 0.002, 0.0),
                     width: int = 752, height: int = 480,
                     rng: Optional[np.random.Generator] = None,
                     noise: float = 2.0, blob_r: int = 3) -> np.ndarray:
    """Fisheye (Kannala-Brandt equidistant) render of the point scene on
    raw pixels: texture dots, then the points' blobs, blur and noise, as
    `render_frame` draws them.  Straight 3D segments are curves under the
    lens, so the lines are not drawn."""
    import cv2

    img = np.full((height, width), 128.0, np.float32)
    R_cw = R_wc.T

    def proj(P):
        pc = (R_cw @ (P - p_wc).T).T
        uv = _kb8_project_cam_np(pc, fx, fy, cx, cy, k)
        z = pc[:, 2]
        ok = (z > 0.2) & (uv[:, 0] >= 8) & (uv[:, 0] < width - 8) \
            & (uv[:, 1] >= 8) & (uv[:, 1] < height - 8)
        return uv, z, ok

    if len(scene.texture_dots):
        uvd, zd, okd = proj(scene.texture_dots)
        for i in np.nonzero(okd)[0]:
            col = 128.0 + 90.0 * scene.texture_intensity[i]
            c = tuple(np.round(uvd[i]).astype(int))
            r = max(1, int(round(1.5 * 2.0 / max(zd[i], 0.5))))
            cv2.circle(img, c, r, float(col), -1, cv2.LINE_AA)
    uv, z, ok = proj(scene.points)
    for i in np.nonzero(ok)[0]:
        col = 128.0 + 100.0 * scene.point_polarity[i]
        c = tuple(np.round(uv[i]).astype(int))
        r = max(2, int(round(blob_r * 2.0 / max(z[i], 0.5))))
        cv2.circle(img, c, r, float(col), -1, cv2.LINE_AA)
    img = cv2.GaussianBlur(img, (3, 3), 0.8)
    if rng is not None and noise > 0:
        img = img + rng.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 255)


# --------------------------------------------------------------------------
# EuRoC-realism replay (the "machine hall"): a larger structured world, an
# MH-style trajectory with a stationary start and an excitation wiggle, a
# 200 Hz IMU with bias random walk, and a renderer with motion blur,
# exposure jitter and vignetting (752x480 at 20 fps, metric truth).
# --------------------------------------------------------------------------

def make_hall_scene(rng: np.random.Generator, n_points: int = 9000,
                    n_lines: int = 500,
                    size=(16.0, 9.0, 5.0)) -> Scene:
    """A machine-hall-like box: dense wall texture + structural lines
    (girders/edges) on walls, floor and ceiling."""
    hx, hy, hz = size[0] / 2, size[1] / 2, size[2] / 2
    half = np.array([hx, hy, hz])

    def on_faces(n):
        face = rng.integers(0, 6, n)
        pts = np.zeros((n, 3))
        axis = face // 2
        sign = np.where(face % 2 == 0, 1.0, -1.0)
        for i in range(n):
            others = [k for k in range(3) if k != axis[i]]
            pts[i, axis[i]] = sign[i] * half[axis[i]]
            pts[i, others[0]] = rng.uniform(-half[others[0]], half[others[0]])
            pts[i, others[1]] = rng.uniform(-half[others[1]], half[others[1]])
        return pts, axis, sign

    pts, _, _ = on_faces(n_points)
    lp, axis, sign = on_faces(n_lines)
    lines = np.zeros((n_lines, 2, 3))
    for i in range(n_lines):
        others = [k for k in range(3) if k != axis[i]]
        d = np.zeros(3)
        # structural lines are mostly axis-aligned (girders), some diag
        if rng.uniform() < 0.7:
            d[others[rng.integers(0, 2)]] = 1.0
        else:
            ang = rng.uniform(0, np.pi)
            d[others[0]] = np.cos(ang)
            d[others[1]] = np.sin(ang)
        length = rng.uniform(1.0, 5.0)
        lines[i, 0] = lp[i] - d * length / 2
        lines[i, 1] = lp[i] + d * length / 2
        lines[i] = np.clip(lines[i], -half, half)
        lines[i, :, axis[i]] = sign[i] * half[axis[i]]

    face_axis = np.argmax(
        np.abs(np.abs(pts) - half[None, :]) < 1e-9, axis=1)
    n_sat = 4
    dots = np.zeros((n_points * n_sat, 3))
    for i in range(n_points):
        others = [k for k in range(3) if k != face_axis[i]]
        offs = rng.uniform(-0.25, 0.25, (n_sat, 2))
        offs += np.sign(offs) * 0.1
        for s in range(n_sat):
            d = pts[i].copy()
            d[others[0]] += offs[s, 0]
            d[others[1]] += offs[s, 1]
            dots[i * n_sat + s] = d
    return Scene(
        points=pts,
        lines=lines,
        point_polarity=rng.uniform(0.4, 1.0, n_points)
        * rng.choice([-1.0, 1.0], n_points),
        line_polarity=rng.uniform(0.5, 1.0, n_lines)
        * rng.choice([-1.0, 1.0], n_lines),
        texture_dots=dots,
        texture_intensity=rng.uniform(0.3, 0.9, n_points * n_sat)
        * rng.choice([-1.0, 1.0], n_points * n_sat),
    )


def _eval_mh(t: np.ndarray) -> SyntheticTrajectory:
    """MH01-style closed-form path: ~3 s near-stationary start, an
    excitation wiggle (the dataset starts with a hand-held shake so the
    IMU initializes), then a slow sweep through the hall (Lissajous in
    x/y with height bobbing), peak speed ~1 m/s."""
    t = np.asarray(t, np.float64)
    # smooth ramp 0 -> 1 over [t0, t0+3 s]
    ramp = 0.5 * (1 + np.tanh((t - 6.0) / 2.0))
    # excitation wiggle at 1.5-2.5 s
    wig = np.exp(-0.5 * ((t - 3.0) / 0.8) ** 2)
    A = np.array([5.5, 2.8, 0.9])
    w = np.array([2 * np.pi / 45.0, 2 * np.pi / 31.0, 2 * np.pi / 17.0])
    ph = np.array([0.3, 1.2, 0.7])

    def pos(tt, rr, ww):
        p = np.stack([
            A[0] * np.sin(w[0] * tt + ph[0]) * rr,
            A[1] * np.sin(w[1] * tt + ph[1]) * rr,
            -0.8 + A[2] * np.sin(w[2] * tt + ph[2]) * rr], -1)
        p[:, 0] += 0.10 * ww * np.sin(2 * np.pi * 1.9 * tt)
        p[:, 1] += 0.08 * ww * np.sin(2 * np.pi * 2.3 * tt + 0.5)
        p[:, 2] += 0.06 * ww * np.sin(2 * np.pi * 1.6 * tt + 1.1)
        return p

    dt = 1e-4
    p = pos(t, ramp, wig)
    rp = 0.5 * (1 + np.tanh((t + dt - 6.0) / 2.0))
    rm = 0.5 * (1 + np.tanh((t - dt - 6.0) / 2.0))
    wp = np.exp(-0.5 * ((t + dt - 3.0) / 0.8) ** 2)
    wm = np.exp(-0.5 * ((t - dt - 3.0) / 0.8) ** 2)
    v = (pos(t + dt, rp, wp) - pos(t - dt, rm, wm)) / (2 * dt)

    # look direction: slow yaw sweep + pitch bob (NOT velocity-coupled,
    # so the stationary start still has a defined attitude)
    yaw = 0.35 * np.sin(w[0] * t * 1.3) + 0.8 * np.sin(w[1] * t * 0.7) \
        + 0.15 * wig * np.sin(2 * np.pi * 1.1 * t)
    pitch = 0.12 * np.sin(w[2] * t + 0.4) \
        + 0.1 * wig * np.sin(2 * np.pi * 1.4 * t + 0.3)
    look = np.stack([np.cos(yaw) * np.cos(pitch),
                     np.sin(yaw) * np.cos(pitch),
                     np.sin(pitch)], -1)
    world_down = np.array([0.0, 0.0, -1.0])
    x = np.cross(world_down, look)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(look, x)
    R = np.stack([x, y, look], axis=-1)
    return SyntheticTrajectory(timestamps=np.asarray(t, np.float64),
                               R_wb=R, p_wb=p, v_wb=v)


def make_mh_trajectory(duration: float = 60.0,
                       fps: float = 20.0) -> SyntheticTrajectory:
    t = np.arange(0.0, duration, 1.0 / fps)
    return _eval_mh(t)


def _eval_mh_loop(t: np.ndarray) -> SyntheticTrajectory:
    """MH-style CLOSED CIRCUIT: stationary start + excitation wiggle,
    then a full orbit of the hall looking outward that returns to the
    starting view at ~t=26 s — the revisit the straight MH sweep never
    makes, so loop closing (detection, Sim3, 4DoF graph, GBA) can be
    exercised end-to-end on realistic imagery.  C-infinity smooth so the
    finite-difference IMU synthesis stays consistent.

    The orbit carries EuRoC-like excitation (radius/speed/height
    modulation, ~0.3 m/s^2): a CONSTANT-speed circle is a known
    degenerate trajectory for monocular VI — the gyro pins the yaw rate
    w but v = w*r leaves the radius (metric scale) free, and the
    centripetal acceleration is constant in the body frame, absorbable
    as accelerometer bias.  Measured on the unmodulated circle: the
    estimate inflated ~8x over 15 s while every recent-chain inertial
    residual stayed consistent (scale-refine pulses reported s=1).
    Real MH sequences never fly constant circles.  All modulation
    periods divide the revisit time so the start pose recurs exactly."""
    t = np.asarray(t, np.float64)
    a, b = 4.0, 1.5
    # s(t) = integral of the smooth ramp 0.5(1+tanh((u-a)/b)):
    # closed form keeps velocity/acceleration exact for the IMU
    s = 0.5 * (t + b * np.log(np.cosh((t - a) / b))) \
        - 0.5 * (0.0 + b * np.log(np.cosh(-a / b)))
    wig = np.exp(-0.5 * ((t - 2.0) / 0.6) ** 2)
    w_orb = 2 * np.pi / 22.0          # full circle once s(t) reaches 22
    ramp = 0.5 * (1 + np.tanh((t - a) / b))
    # angular-speed modulation (zero at t=26: 26/13=2 full periods)
    th = w_orb * (s + 0.5 * ramp * np.sin(2 * np.pi * t / 13.0))
    # radius modulation (zero at t=26: 26/6.5=4 full periods)
    r = 2.0 + 0.30 * ramp * np.sin(2 * np.pi * t / 6.5)
    # height bob (zero at t=26: 26/5.2=5 full periods)
    p = np.stack([r * np.cos(th), r * np.sin(th),
                  -0.5 + 0.22 * ramp * np.sin(2 * np.pi * t / 5.2)], -1)
    p[:, 0] += 0.10 * wig * np.sin(2 * np.pi * 1.9 * t)
    p[:, 1] += 0.08 * wig * np.sin(2 * np.pi * 2.3 * t + 0.5)
    p[:, 2] += 0.06 * wig * np.sin(2 * np.pi * 1.6 * t + 1.1)
    # look radially outward (+ small wiggle-driven yaw/pitch for init
    # excitation); the start view at th=0 is revisited at th=2*pi
    yaw = th + 0.15 * wig * np.sin(2 * np.pi * 1.1 * t)
    pitch = 0.05 * np.sin(2 * np.pi * t / 13.0) \
        + 0.1 * wig * np.sin(2 * np.pi * 1.4 * t + 0.3)
    look = np.stack([np.cos(yaw) * np.cos(pitch),
                     np.sin(yaw) * np.cos(pitch),
                     np.sin(pitch)], -1)
    world_down = np.array([0.0, 0.0, -1.0])
    x = np.cross(world_down, look)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(look, x)
    R = np.stack([x, y, look], axis=-1)
    dt = 1e-4
    v = (_eval_mh_loop_pos(t + dt) - _eval_mh_loop_pos(t - dt)) / (2 * dt)
    return SyntheticTrajectory(timestamps=np.asarray(t, np.float64),
                               R_wb=R, p_wb=p, v_wb=v)


def _eval_mh_loop_pos(t: np.ndarray) -> np.ndarray:
    """Position-only twin of _eval_mh_loop (for finite-diff velocity)."""
    t = np.asarray(t, np.float64)
    a, b = 4.0, 1.5
    s = 0.5 * (t + b * np.log(np.cosh((t - a) / b))) \
        - 0.5 * (0.0 + b * np.log(np.cosh(-a / b)))
    wig = np.exp(-0.5 * ((t - 2.0) / 0.6) ** 2)
    ramp = 0.5 * (1 + np.tanh((t - a) / b))
    th = (2 * np.pi / 22.0) \
        * (s + 0.5 * ramp * np.sin(2 * np.pi * t / 13.0))
    r = 2.0 + 0.30 * ramp * np.sin(2 * np.pi * t / 6.5)
    p = np.stack([r * np.cos(th), r * np.sin(th),
                  -0.5 + 0.22 * ramp * np.sin(2 * np.pi * t / 5.2)], -1)
    p[:, 0] += 0.10 * wig * np.sin(2 * np.pi * 1.9 * t)
    p[:, 1] += 0.08 * wig * np.sin(2 * np.pi * 2.3 * t + 0.5)
    p[:, 2] += 0.06 * wig * np.sin(2 * np.pi * 1.6 * t + 1.1)
    return p


def synthesize_imu_mh(rng: np.random.Generator, duration: float,
                      imu_rate: float = 200.0,
                      noise_gyro: float = 1.7e-4, noise_acc: float = 2.0e-3,
                      walk_gyro: float = 2.0e-5, walk_acc: float = 3.0e-3,
                      bias_gyro_mag: float = 0.003,
                      bias_acc_mag: float = 0.05,
                      eval_fn=None) -> SyntheticImu:
    """200 Hz IMU along the MH path with EuRoC-class noise AND bias
    random walk (the reference's preintegration models the walk via its
    bias-jacobian correction + RW edges; a constant-bias synthetic lets
    those paths go untested)."""
    import torch

    from ..utils import lie

    ev = eval_fn or _eval_mh
    dt = 1.0 / imu_rate
    t = np.arange(dt, duration - dt, dt)
    fine_m = ev(t - dt)
    fine_0 = ev(t)
    fine_p = ev(t + dt)
    n = len(t)
    dR = np.einsum("nij,nik->njk", fine_m.R_wb, fine_p.R_wb)
    w_body = lie.so3_log(torch.from_numpy(dR.astype(np.float32))).numpy(
        ).astype(np.float64) / (2 * dt)
    a_world = (fine_p.v_wb - fine_m.v_wb) / (2 * dt)
    g_w = np.array([0.0, 0.0, -GRAVITY])
    a_body = np.einsum("nij,ni->nj", fine_0.R_wb, a_world - g_w)

    bg0 = rng.normal(0, bias_gyro_mag, 3)
    ba0 = rng.normal(0, bias_acc_mag, 3)
    # bias random walk: b_k = b_{k-1} + N(0, walk^2 * dt)
    bg_w = np.cumsum(rng.normal(0, walk_gyro * np.sqrt(dt), (n, 3)), 0)
    ba_w = np.cumsum(rng.normal(0, walk_acc * np.sqrt(dt), (n, 3)), 0)
    sqrt_rate = np.sqrt(imu_rate)
    gyro = w_body + bg0 + bg_w + rng.normal(0, noise_gyro * sqrt_rate, (n, 3))
    acc = a_body + ba0 + ba_w + rng.normal(0, noise_acc * sqrt_rate, (n, 3))
    return SyntheticImu(timestamps=t, gyro=gyro, acc=acc,
                        bias_gyro=bg0, bias_acc=ba0)


def render_frame_realistic(scene: Scene, traj_eval, t: float,
                           rng: np.random.Generator,
                           exposure_s: float = 0.01,
                           n_sub: int = 3, noise: float = 3.0,
                           **kw) -> np.ndarray:
    """Photometric-realism render: motion blur by averaging `n_sub`
    sub-exposure renders across the shutter interval, per-frame exposure
    gain jitter, and radial vignetting."""
    subs = []
    for k in range(n_sub):
        tk = t + exposure_s * (k / max(n_sub - 1, 1) - 0.5)
        pose = traj_eval(np.array([tk]))
        subs.append(render_frame(scene, pose.R_wb[0], pose.p_wb[0],
                                 rng=None, noise=0.0, **kw))
    img = np.mean(subs, axis=0)
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2)
    img = img * (1.0 - 0.18 * r2)                       # vignette
    img = img * rng.uniform(0.92, 1.08)                 # exposure jitter
    img = img + rng.normal(0, noise, img.shape)         # shot/read noise
    return np.clip(img, 0, 255).astype(np.float32)


def right_eye(traj_eval, baseline: float):
    """A trajectory evaluator (as `_eval_mh`) whose camera sits `baseline`
    metres along its own x axis: the right view of a rectified pair,
    p + R[:, 0] * baseline at every time asked (so every sub-exposure of
    `render_frame_realistic` moves alike)."""
    def ev(t: np.ndarray) -> SyntheticTrajectory:
        tr = traj_eval(t)
        return SyntheticTrajectory(tr.timestamps, tr.R_wb,
                                   tr.p_wb + tr.R_wb[:, :, 0] * baseline,
                                   tr.v_wb)
    return ev


def oracle_depth(scene: Scene, R_wc: np.ndarray, p_wc: np.ndarray,
                 fx: float = 458.654, fy: float = 457.296,
                 cx: float = 367.215, cy: float = 248.375,
                 width: int = 752, height: int = 480) -> np.ndarray:
    """The RGB-D depth image of tests/test_stereo.py:57-62: each visible
    scene point's depth splatted as a 7x7 square (later points over
    earlier ones), 0 elsewhere.  [height, width] float32."""
    depth = np.zeros((height, width), np.float32)
    uv, z, vis, _, _ = project_scene(scene, R_wc, p_wc, fx, fy, cx, cy,
                                     width, height)
    for j in np.nonzero(vis)[0]:
        x0, y0 = int(uv[j, 0]), int(uv[j, 1])
        depth[max(0, y0 - 3):y0 + 4, max(0, x0 - 3):x0 + 4] = z[j]
    return depth
