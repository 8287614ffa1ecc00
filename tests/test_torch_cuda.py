"""The CUDA kernels against their plain PyTorch versions on the card (and
schur_solve's global path, a short keyframe sequence and a short tracked
sequence; PnP, the Sim3 RANSAC, the Sim3 reprojection refinement and the
essential graph, its factor resident in shared memory, streamed or on
the whole grid,
against a float64 run of their plain versions, within 2x the plain
float32 run's distance to it + 1e-6).

Marked `cuda`; each test skips without a CUDA device.  This file imports
no JAX, so it also runs on a GPU machine without JAX, where the suite's
conftest (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: FAST cells and matches identical; angles
within 0.01 deg and >= 99.5% descriptor bits; pose within 1e-5 rad / m;
line segments within 0.01 px but for max(1, 2%) of each side's valid
segments (sums in another order can move a segment across a threshold),
the kernel path the same on every run, bf16 gradients identical; IMU deltas within 1e-5 relative and imu_info within
1e-4 relative Frobenius (Cholesky against LU); VI pose within 1e-4 rad /
m, inliers within 1%, H15 within 1e-3 relative Frobenius; epipolar
matches and rotation-histogram masks identical; triangulated points within
1e-4 relative (float64 Jacobi against a float32 SVD) with equal gates; the
windowed BA's KF poses within 1e-4 of the plain engine's (analytic against
autodiff Jacobians, sums in another order, the same LM decisions) and
equal inlier masks, its landmarks' reprojection residuals within 0.1 px,
at the typical window (16 KF): at 4 KF every float32
path, the plain one on either device included, lies 1.5-2.5e-3 from a
float64 run of the plain engine, so a 1e-4 comparison there would test
rounding, not the kernels.  The redesigned vi_pose_lm and line_detect
(both pyramid levels in one call) bit-equal to the kernels before their
redesign (`PARENT_SLICE19`, kernel_digest.py's lines), and the VI
optimizer's run and the line pyramid free of host synchronization.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from plvio_tpu_torch.entry import tracking_step_pl
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.ops import frontend as FE
from plvio_tpu_torch.ops import matching as M
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.solver.residuals import PinholeK

pytestmark = pytest.mark.cuda
K = PinholeK(458.654, 457.296, 367.215, 248.375)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image(seed, h, w, dev):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 255, (1, 1, h, w)).astype(
        np.float32))
    img = F.avg_pool2d(img, 5, 1, 2)[0, 0] * 1.7 - 90.0   # blobs + corners
    return img.clamp(0, 255).contiguous().to(dev)


@pytest.mark.parametrize("shape", [(120, 200), (480, 752), (37, 50)])
def test_orb_fast_grid_identical(dev, shape):
    img = _image(0, *shape, dev)
    bk, ak = FE.orb_fast_grid(img, 20.0, 7.0)
    bp, ap = FE.orb_fast_grid_plain(img, 20.0, 7.0)
    torch.cuda.synchronize()
    assert torch.equal(ak, ap) and torch.equal(bk, bp)
    assert FE.ORB_FAST_GRID.launches > 0


@pytest.mark.parametrize("shape", [(480, 752), (120, 200), (37, 50)])
def test_orb_detect_identical(dev, shape):
    """The detector of every level in two launches (`orb_detect`) against
    its plain path (`orb_detect_plain`: `orb_fast_grid_plain`,
    `select_top_cells` and the glue a level) on the image's 8-level
    pyramid at 1000 features: every output bit-equal, levels without a
    whole cell included at (37, 50)."""
    img = _image(0, *shape, dev)
    specs = FE.make_level_specs(*shape)
    pyr = FE.build_pyramid(img, specs)
    n0 = FE.ORB_FAST_GRID.launches
    k = FE.orb_detect(pyr, specs, 20.0, 7.0)
    p = FE.orb_detect_plain(pyr, specs, 20.0, 7.0)
    torch.cuda.synchronize()
    for name in FE.Detected._fields:
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    assert FE.ORB_FAST_GRID.launches == n0 + 2


def test_orb_describe_matches_plain(dev):
    levels = [_image(1, 120, 200, dev), _image(2, 100, 167, dev)]
    rng = np.random.default_rng(3)
    xy = np.concatenate([rng.integers(0, [200, 120], (60, 2)),
                         rng.integers(0, [167, 100], (40, 2))])
    xy = torch.from_numpy(xy.astype(np.float32)).to(dev)
    lv = torch.tensor([0] * 60 + [1] * 40, dtype=torch.int32, device=dev)
    orb = FE.OrbExtractor(FE.make_level_specs(120, 200, 100, 2)).to(dev)
    args = (levels, xy, lv, orb.taps, orb.pattern, orb.wx, orb.wy)
    ak, dk = FE.orb_describe(*args)
    ap, dp = FE.orb_describe_plain(*args)
    torch.cuda.synchronize()
    da = (ak - ap).abs()
    assert float(torch.minimum(da, 360.0 - da).max()) <= 0.01
    agree = (M.unpack_u32_to_pm1(dk) == M.unpack_u32_to_pm1(dp)).float()
    assert float(agree.mean()) >= 0.995


@pytest.mark.parametrize("line", [False, True])
def test_hamming_match_identical(dev, line):
    g = torch.Generator().manual_seed(4)
    n, m = 700, 500
    a = (torch.randint(0, 4, (n, 8), generator=g) << 30).to(torch.int32)
    b = (torch.randint(0, 4, (m, 8), generator=g) << 30).to(torch.int32)
    case = [a, b, torch.rand(n, generator=g) < 0.9,
            torch.rand(m, generator=g) < 0.9,
            torch.rand(n, 2, generator=g) * 120,
            torch.rand(m, 2, generator=g) * 120]
    kw = dict(radius=20.0, max_dist=80.0, ratio=0.9)
    if line:
        kw = dict(radius=40.0, max_dist=110.0, ratio=0.95, angle_tol=0.25,
                  a_ang=torch.rand(n, generator=g) * math.pi,
                  b_ang=torch.rand(m, generator=g) * math.pi)
    case = [t.to(dev) for t in case]
    kw = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in kw.items()}
    ik, okk = M.hamming_match(*case, **kw)
    ip, okp = M.hamming_match_plain(*case, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip) and torch.equal(okk, okp)
    assert bool(okk.any())


@pytest.mark.parametrize("n_lines", [0, 64])
def test_pose_irls_matches_plain(dev, n_lines):
    rng = np.random.default_rng(5)
    n = 1500
    X = rng.uniform([-3, -2, 3], [3, 2, 9], (n, 3))
    uv = np.stack([K.fx * X[:, 0] / X[:, 2] + K.cx,
                   K.fy * X[:, 1] / X[:, 2] + K.cy], -1)
    uv += rng.normal(0, 0.8, uv.shape)
    uv[: n // 5] += rng.uniform(-30, 30, (n // 5, 2))
    Xs = rng.uniform([-3, -2, 3], [3, 2, 9], (n_lines, 3))
    Xe = Xs + rng.normal(0, 0.8, (n_lines, 3))

    def pr(P):
        return np.c_[K.fx * P[:, 0] / P[:, 2] + K.cx,
                     K.fy * P[:, 1] / P[:, 2] + K.cy, np.ones(len(P))]

    l = np.cross(pr(Xs), pr(Xe)).reshape(n_lines, 3)
    l /= np.maximum(np.linalg.norm(l[:, :2], axis=1, keepdims=True), 1e-9)
    pose0 = np.eye(3, 4)
    pose0[:, 3] = [0.02, -0.03, 0.05]

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(dev)

    args = (K, t(pose0), t(uv), t(X), t(rng.random(n) < 0.95, torch.bool),
            t(np.ones(n)), t(l), t(Xs), t(Xe),
            t(np.ones(n_lines, bool), torch.bool), t(np.ones(n_lines)))
    Pk, ipk, ilk, nk = KN.pose_irls(*args)
    Pp, ipp, ilp, np_ = KN.pose_irls_plain(*args)
    torch.cuda.synchronize()
    dR = Pk[:, :3].double() @ Pp[:, :3].double().T
    rot = math.acos(min(1.0, max(-1.0, (float(torch.trace(dR)) - 1) / 2)))
    assert rot <= 1e-5 and float((Pk[:, 3] - Pp[:, 3]).abs().max()) <= 1e-5
    assert abs(int(nk) - int(np_)) <= 2


def test_tracking_step_kernel_path_matches_plain_path(dev):
    step, args = tracking_step_pl(240, 376, 300, 256, 32, 64, device=dev)
    plain, _ = tracking_step_pl(240, 376, 300, 256, 32, 64, device=dev,
                                plain=True)
    with torch.no_grad():
        pk, nk = step(*args)
        pp, np_ = plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(pk).all())
    assert float((pk - pp).abs().max()) <= 1e-4
    assert int(nk) == int(np_)


# ---------------------------------------------------------------------------
# the kernels of slice 2: line front end, IMU preintegration, VI pose LM
# ---------------------------------------------------------------------------

def _unmatched(ea, va, eb, vb, tol=0.01):
    """Valid segments of a without a valid segment of b whose endpoints are
    both within tol (either orientation), and how many may be: max(1,
    2%)."""
    ea, eb = ea.double().cpu().numpy(), eb.double().cpu().numpy()
    va, vb = va.cpu().numpy(), vb.cpu().numpy()
    n = 0
    for i in np.nonzero(va)[0]:
        same = np.maximum(np.linalg.norm(eb[:, :2] - ea[i, :2], axis=1),
                          np.linalg.norm(eb[:, 2:] - ea[i, 2:], axis=1))
        flip = np.maximum(np.linalg.norm(eb[:, :2] - ea[i, 2:], axis=1),
                          np.linalg.norm(eb[:, 2:] - ea[i, :2], axis=1))
        n += int(np.where(vb, np.minimum(same, flip), np.inf).min() > tol)
    return n, max(1, int(0.02 * va.sum()))


def _sets_agree(ea, va, eb, vb):
    return all(n <= allowed for n, allowed in (_unmatched(ea, va, eb, vb),
                                               _unmatched(eb, vb, ea, va)))


def _segments(dev, h=240, w=376, n=30, seed=0):
    """Dense random bright segments over a smooth background."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 100.0 + 20.0 * np.sin(xx / 40.0) + 10.0 * np.cos(yy / 30.0)
    for _ in range(n):
        p0 = rng.uniform([10, 10], [w - 10, h - 10])
        ang = rng.uniform(0, np.pi)
        d = np.array([np.cos(ang), np.sin(ang)])
        L = rng.uniform(25, 100)
        t = (xx - p0[0]) * d[0] + (yy - p0[1]) * d[1]
        perp = np.abs(-(xx - p0[0]) * d[1] + (yy - p0[1]) * d[0])
        img += 80.0 * ((perp < 1.5) & (t > 0) & (t < L))
    img += rng.normal(0, 1.0, img.shape)
    return torch.from_numpy(np.clip(img, 0, 255).astype(np.float32)).to(dev)


@pytest.mark.parametrize("image", ["segments", "flat"])
def test_line_kernels_match_plain(dev, image):
    """line_detect and line_refine_lbd against their plain versions; the
    flat image has no atoms, so both give an empty line set."""
    from plvio_tpu_torch.ops import lines as LN
    img = _segments(dev) if image == "segments" \
        else torch.full((240, 376), 77.0, device=dev)
    pairs = torch.from_numpy(LN._band_pair_pattern()).to(dev)
    dk = LN.line_detect(img, 96)
    dp = LN.detect_lines(img, 96)
    torch.cuda.synchronize()
    assert torch.equal(dk[4][0], dp[4][0]) and torch.equal(dk[4][1], dp[4][1])
    assert _sets_agree(dk[0], dk[3], dp[0], dp[3])
    fk = LN.line_refine_lbd(dp[4][0], dp[4][1], dp[0], dp[3], pairs)
    fp = LN.refine_lbd_plain(dp[4][0], dp[4][1], dp[0], dp[3], pairs)
    torch.cuda.synchronize()
    assert _sets_agree(fk.ep, fk.valid, fp.ep, fp.valid)
    both = fk.valid & fp.valid & ((fk.ep - fp.ep).abs().amax(1) <= 0.01)
    if image == "flat":
        assert not bool(dk[3].any()) and not bool(fk.valid.any())
    else:
        assert int(both.sum()) >= 5
        agree = (M.unpack_u32_to_pm1(fk.desc[both])
                 == M.unpack_u32_to_pm1(fp.desc[both])).float().mean()
        assert float(agree) >= 0.995
    # the whole pyramid, kernel path against plain path
    pk = LN.LineExtractor(128, 2).to(dev)(img)
    pp = LN.LineExtractor(128, 2, plain=True).to(dev)(img)
    torch.cuda.synchronize()
    assert _sets_agree(pk.ep, pk.valid, pp.ep, pp.valid)
    again = LN.LineExtractor(128, 2).to(dev)(img)
    assert all(torch.equal(a, b) for a, b in zip(pk, again))
    assert LN.LINE_DETECT.launches > 0 and LN.LINE_REFINE_LBD.launches > 0


@pytest.mark.parametrize("k,n_valid", [(10, 10), (10, 4), (16, 16),
                                       (128, 100)])
def test_imu_preint_matches_plain(dev, k, n_valid):
    """Up to 16 samples (a frame) within 1e-5 relative; the keyframe
    window of the bootstrap, padded past 64 samples, within 5e-5 (the bias
    Jacobians drift ~1.5e-5 over ~100 samples in another order)."""
    from plvio_tpu_torch.config import ImuConfig
    from plvio_tpu_torch.ops import imu as IMU
    rng = np.random.default_rng(k + n_valid)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dt).to(dev)

    args = (t(rng.normal(0, 0.5, (k, 3))),
            t(rng.normal(0, 1.0, (k, 3)) + [0, 0, 9.81]),
            t(rng.uniform(0.004, 0.006, k)), t(np.arange(k) < n_valid,
                                               torch.bool),
            IMU.make_calib(ImuConfig()), t(rng.normal(0, 0.02, 3)),
            t(rng.normal(0, 0.1, 3)),
            t(np.c_[np.eye(3), [1.0, -2.0, 0.5]]), t([0.3, -0.1, 0.2]))
    fk = IMU.imu_preint(*args)
    fp = IMU.imu_preint_plain(*args)
    torch.cuda.synchronize()
    for a, b in [(getattr(fk.pre, f), getattr(fp.pre, f))
                 for f in fk.pre._fields] + [(fk.R2, fp.R2), (fk.v2, fp.v2),
                                             (fk.p2, fp.p2)]:
        scale = float(b.abs().max())
        tol = 1e-5 if k <= 16 else 5e-5
        assert float((a - b).abs().max()) <= tol * max(scale, 1e-30)
    rel = (fk.imu_info - fp.imu_info).norm() / fp.imu_info.norm()
    assert float(rel) <= 1e-4


@pytest.mark.parametrize("have_prior", [True, False])
def test_vi_pose_lm_matches_plain(dev, have_prior):
    from plvio_tpu_torch.config import ImuConfig
    from plvio_tpu_torch.ops import imu as IMU
    from plvio_tpu_torch.utils import lie
    rng = np.random.default_rng(7)
    cap = 1024
    R0 = lie.so3_exp(torch.tensor(rng.normal(0, 0.3, 3),
                                  dtype=torch.float32))
    p0 = torch.tensor(rng.normal(0, 1, 3), dtype=torch.float32)
    v0 = torch.tensor(rng.normal(0, 0.5, 3), dtype=torch.float32)
    prev = torch.cat([R0, p0[:, None]], 1)
    g = torch.tensor(rng.normal(0, 0.3, (10, 3)), dtype=torch.float32)
    a = torch.tensor(rng.normal(0, 0.5, (10, 3)), dtype=torch.float32) \
        + R0.T @ torch.tensor([0.0, 0.0, 9.81])
    f = IMU.imu_preint_plain(g, a, torch.full((10,), 0.005),
                             torch.ones(10, dtype=torch.bool),
                             IMU.make_calib(ImuConfig()), torch.zeros(3),
                             torch.zeros(3), prev, v0)
    R2, p2 = f.R2.double().numpy(), f.p2.double().numpy()
    Xc = rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (cap, 3))
    X = torch.tensor(Xc @ R2.T + p2, dtype=torch.float32)
    uv = np.stack([K.fx * Xc[:, 0] / Xc[:, 2] + K.cx,
                   K.fy * Xc[:, 1] / Xc[:, 2] + K.cy], -1) \
        + rng.normal(0, 0.7, (cap, 2))
    uv[:150] += rng.uniform(-25, 25, (150, 2))
    Rp = R2 @ lie.so3_exp(torch.tensor(rng.normal(0, 0.01, 3))).numpy()
    pose0 = torch.tensor(np.c_[Rp, p2 + rng.normal(0, 0.02, 3)],
                         dtype=torch.float32)
    pre = f.pre
    pre_const = {k: getattr(pre, k) for k in ("dT", "dR", "dV", "dP", "JRg",
                                              "JVg", "JVa", "JPg", "JPa")}
    pre_const.update(bg0=pre.bias_gyro, ba0=pre.bias_acc)
    prior_const = dict(R0=R0, p0=p0, v0=v0, bg0=torch.zeros(3),
                       ba0=torch.zeros(3))
    rw = torch.tensor([1 / (1.9393e-5 ** 2 * 10)] * 3
                      + [1 / (3e-3 ** 2 * 10)] * 3)

    def d(x):
        if isinstance(x, dict):
            return {k: v.to(dev).contiguous() for k, v in x.items()}
        return x.to(dev).contiguous()

    case = [K, d(torch.eye(3)), d(torch.zeros(3)), 9.81, d(pose0), d(f.v2),
            d(torch.full((3,), 1e-3)), d(torch.full((3,), 1e-2)),
            d(torch.tensor(uv, dtype=torch.float32)), d(X),
            d(torch.tensor(rng.random(cap) < 0.9)),
            d(torch.tensor(1 / 1.2 ** (2 * rng.integers(0, 3, cap)),
                           dtype=torch.float32)),
            d(prev), d(v0), d(pre_const), d(f.imu_info), d(rw),
            d(prior_const), d(torch.eye(15) * 100.0)]
    ok = KN.vi_pose_lm(*case, have_prior)
    op = KN.vi_pose_opt_plain(*case, have_prior)
    torch.cuda.synchronize()
    dR = ok[0][:, :3].double().T @ op[0][:, :3].double()
    skew = torch.stack([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                        dR[1, 0] - dR[0, 1]]) / 2
    assert float(skew.norm()) <= 1e-4
    assert float((ok[0][:, 3] - op[0][:, 3]).abs().max()) <= 1e-4
    assert abs(int(ok[5]) - int(op[5])) <= 0.01 * int(op[5])
    assert float((ok[6] - op[6]).norm() / op[6].norm()) <= 1e-3
    assert KN.VI_POSE_LM.launches > 0


def test_tracking_step_vi_kernel_path_matches_plain_path(dev):
    from plvio_tpu_torch.entry import tracking_step_vi
    from plvio_tpu_torch.inputs import build_imu_windows, build_inputs
    from plvio_tpu_torch.state import from_numpy
    fr = build_inputs(3, 256, 32, 240, 376, n_features=300, device=dev)
    g, a, dts, c0 = build_imu_windows(fr[-1], 3)
    st = from_numpy(dict(pt_xyz=fr[2], pt_desc=fr[3], pt_valid=fr[4],
                         ln_ep6=fr[5], ln_desc=fr[6], ln_valid=fr[7]), dev)
    m = [st[k] for k in ("pt_xyz", "pt_desc", "pt_valid", "ln_ep6",
                         "ln_desc", "ln_valid")]
    out = []
    for plain in (False, True):
        step, _ = tracking_step_vi(240, 376, 300, 256, 64, device=dev,
                                   plain=plain)
        c = tuple(torch.from_numpy(x.copy()).to(dev) for x in c0)
        xs = (torch.from_numpy(fr[0][1]).to(dev),
              *(torch.from_numpy(x[0]).to(dev) for x in (g, a, dts)))
        with torch.no_grad():
            c, (n, _) = step(c, xs, *m)
        out.append((c, int(n)))
    torch.cuda.synchronize()
    (ck, nk), (cp, np_) = out
    assert bool(torch.isfinite(ck[0]).all())
    assert float((ck[0] - cp[0]).abs().max()) <= 1e-4
    assert abs(nk - np_) <= max(1, 0.03 * np_)


# ---------------------------------------------------------------------------
# the kernels of slice 3: the keyframe mapping step
# ---------------------------------------------------------------------------

SMALL_MAP = dict(n_kf=4, n_pt=256, n_obs=512, n_feat=128, n_ln=32, n_lobs=64)


@pytest.mark.parametrize("with_oct", [False, True])
def test_epipolar_match_identical(dev, with_oct):
    from plvio_tpu_torch.inputs import build_mapping_inputs
    A = build_mapping_inputs(**SMALL_MAP, device=dev)
    g = torch.Generator().manual_seed(8)
    n = SMALL_MAP["n_feat"]
    uv1 = (A["uv_a"].cpu() + torch.randn(n, 2, generator=g)).to(dev)
    d2 = (A["desc"].cpu() ^ (torch.randint(0, 2, (n, 8), generator=g)
                              << 7).to(torch.int32)).to(dev)
    F = KN.fundamental(K, A["pose_a"], A["pose_b"])
    th = 2.0 * torch.pow(1.2, torch.randint(0, 4, (n,), generator=g).float()
                         if with_oct else torch.zeros(n)).to(dev)
    args = (A["desc"], d2, A["ok"], A["ok"], uv1.contiguous(), A["uv_b"])
    kw = dict(radius=0.0, max_dist=60.0, ratio=0.8, epi_F=F, epi_th=th)
    ik, okk = M.hamming_match(*args, **kw)
    ip, okp = M.hamming_match_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(okk, okp) and torch.equal(ik[okk], ip[okp])
    assert int(okk.sum()) >= 20


def test_rot_hist_identical_with_ties(dev):
    g = torch.Generator().manual_seed(9)
    n = 600
    a2 = torch.rand(n, generator=g) * 360
    # four bins of 100 each: the third place is a tie of bins 11 and 22
    rot = torch.cat([torch.tensor([18.0, 78.0, 138.0, 270.0]).repeat_interleave(
        100), torch.rand(n - 400, generator=g) * 360])
    cases = [((a2 + rot) % 360, a2, torch.arange(n, dtype=torch.int32)),
             (torch.rand(n, generator=g) * 360, a2,
              torch.randint(0, n, (n,), generator=g, dtype=torch.int32)),
             (torch.rand(n, generator=g) * 6.28, torch.rand(n, generator=g)
              * 6.28, torch.arange(n, dtype=torch.int32))]
    for a1, b, idx in cases:
        ok = torch.rand(n, generator=g) < 0.9
        args = [t.to(dev).contiguous() for t in (a1, b, idx, ok)]
        hk = M.rot_hist(*args)
        hp = M.rotation_histogram_filter(*args)
        torch.cuda.synchronize()
        assert torch.equal(hk, hp)
    assert M.ROT_HIST.launches > 0


def test_triangulate_matches_plain(dev):
    from plvio_tpu_torch.inputs import build_mapping_inputs
    A = build_mapping_inputs(**SMALL_MAP, device=dev)
    g = torch.Generator().manual_seed(10)
    n = SMALL_MAP["n_feat"]
    uv2 = (A["uv_b"].cpu() + 0.7 * torch.randn(n, 2, generator=g)).to(dev)
    uv2[:10] = uv2[:10].flip(0)
    valid = (torch.rand(n, generator=g) < 0.9).to(dev)
    th = torch.full((n,), 5.991, device=dev)
    args = (K, A["pose_a"], A["pose_b"], A["uv_a"], uv2.contiguous(), valid,
            th, th)
    Xk, gk = KN.triangulate(*args)
    Xp, gp = KN.triangulate_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(gk, gp) and int(gk.sum()) >= 50
    rel = (Xk - Xp).norm(dim=1) / Xp.norm(dim=1)
    assert float(rel[gk].max()) <= 1e-4


@pytest.mark.parametrize("perturbed", [False, True])
def test_mapping_step_kernel_path_matches_plain_path(dev, perturbed):
    """The typical mapping step held to runs that repeat: the plain path in
    float32 on the CPU and the BA's plain engine in float64.  (The card's
    plain path sums by atomics, so its KF poses move ~1e-4 from run to
    run, and its LM decisions with them: 1.33e-4 from the kernel path in
    one of three full runs on an H100; it is run and printed, not asserted
    on.)
    The triangulated count, the LM iterations per round and the point and
    line inlier masks equal to the CPU run's; the KF poses within 1e-4 of
    its, and within 2x its distance to the float64 BA (+ 1e-6); the landmarks
    reprojecting within 0.1 px of the CPU run's (~2x 1e-4 x fx)."""
    from plvio_tpu_torch.entry import MAPPING_TYPICAL, mapping_step
    from plvio_tpu_torch.inputs import perturb_window
    step, A = mapping_step(**MAPPING_TYPICAL, device=dev)
    plain, _ = mapping_step(**MAPPING_TYPICAL, device=dev, plain=True)
    cpu_step, _ = mapping_step(**MAPPING_TYPICAL, device="cpu")
    if perturbed:
        P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                              A["pt_xyz"].cpu().numpy())
        A["kf_poses"] = torch.from_numpy(P).to(dev)
        A["pt_xyz"] = torch.from_numpy(X).to(dev)
    Ac = {k: v.cpu() for k, v in A.items()}
    n0 = KN.SCHUR_SOLVE.launches
    sk, sp, sc = [], [], []
    with torch.no_grad():
        ok_ = step(A, stats=sk)
        op_ = plain(A, stats=sp)
        oc_ = cpu_step(Ac, stats=sc)
    torch.cuda.synchronize()
    assert KN.SCHUR_SOLVE.launches - n0 == 16
    ref = KN.local_ba_pl_plain(K, *[Ac[k].double() if Ac[k].is_floating_point()
                                    else Ac[k] for k in BA_KEYS])[0]
    gk, gp, gc = (float((o.kf_poses.double().cpu() - ref).abs().max())
                  for o in (ok_, op_, oc_))
    flips = int((ok_.inlier.cpu() != oc_.inlier).sum())
    flips_l = int((ok_.inlier_l.cpu() != oc_.inlier_l).sum())
    dc = float((ok_.kf_poses.cpu() - oc_.kf_poses).abs().max())
    print(f"perturbed={perturbed}: iterations kernel {[int(x) for x in sk]}, "
          f"CPU {[int(x) for x in sc]}, card plain {sp}; mask rows differing "
          f"from the CPU run {flips} points, {flips_l} lines; KF poses from "
          f"the float64 BA: kernel {gk:.2e}, CPU {gc:.2e}, card plain "
          f"{gp:.2e}; kernel - card plain "
          f"{float((ok_.kf_poses - op_.kf_poses).abs().max()):.2e}, kernel - "
          f"CPU {dc:.2e}")
    assert int(ok_.n_good) == int(oc_.n_good)
    assert [int(x) for x in sk] == [int(x) for x in sc]
    assert flips == 0 and flips_l == 0
    assert dc <= 1e-4
    assert gk <= 2 * gc + 1e-6
    assert bool(torch.isfinite(ok_.pt_xyz).all())
    oc_dev = oc_._replace(kf_poses=oc_.kf_poses.to(dev),
                          pt_xyz=oc_.pt_xyz.to(dev), ln_ep6=oc_.ln_ep6.to(dev))

    # the landmarks, by their reprojection in every observation (null
    # directions do not count)
    def residuals(o):
        return (RES.point_reproj_jac(K, o.kf_poses[A["obs_kf"].long()],
                                     o.pt_xyz[A["obs_pt"].long()],
                                     A["obs_uv"])[0],
                RES.line_reproj_jac(K, o.kf_poses[A["lobs_kf"].long()],
                                    o.ln_ep6[A["lobs_ln"].long()],
                                    A["lobs_eq"])[0])
    for rk, rc in zip(residuals(ok_), residuals(oc_dev)):
        assert float((rk - rc).abs().max()) <= 0.1


BA_KEYS = ("kf_poses", "kf_free", "pt_xyz", "pt_free", "obs_kf", "obs_pt",
           "obs_uv", "obs_valid", "obs_is2", "ln_ep6", "ln_free", "lobs_kf",
           "lobs_ln", "lobs_eq", "lobs_valid", "lobs_is2")


@pytest.mark.parametrize("size", ["small", "typical"])
def test_local_ba_kernel_as_close_to_float64_as_plain(dev, size):
    """From the perturbed start, the float32 paths against the plain engine
    in float64 on the CPU: the kernel path's KF poses within 2x the plain
    path's on the CPU, which repeats bit for bit (the card's plain path
    sums by atomics, so its distance varies from run to run: 1.48-1.76e-3
    at the small window, where the kernel path lies 2.36e-3 and the CPU's
    1.47e-3; all three printed, run with -s)."""
    from plvio_tpu_torch.entry import MAPPING_TYPICAL, mapping_step
    from plvio_tpu_torch.inputs import perturb_window
    sz = SMALL_MAP if size == "small" else MAPPING_TYPICAL
    _, A = mapping_step(**sz, device="cpu")
    P, X = perturb_window(A["kf_poses"].numpy(), A["pt_xyz"].numpy())
    A["kf_poses"], A["pt_xyz"] = torch.from_numpy(P), torch.from_numpy(X)
    args = [A[k] for k in BA_KEYS]
    ref = KN.local_ba_pl_plain(K, *[a.double() if a.is_floating_point()
                                    else a for a in args])[0]
    card = [a.to(dev) for a in args]

    def gap(out):
        return float((out[0].cpu().double() - ref).abs().max())
    with torch.no_grad():
        gk = gap(KN.local_ba_pl(K, *card))
        gp = gap(KN.local_ba_pl_plain(K, *card))
        gc = gap(KN.local_ba_pl_plain(K, *args))
    print(f"{size}: KF poses from the float64 run: kernel {gk:.2e}, plain "
          f"on the card {gp:.2e}, plain on the CPU {gc:.2e}")
    assert gk <= 2 * gc


def _window_without_keyframe(dev, k):
    """The point+line window of `kernel_digest.schur_windows` with every
    observation of keyframe k invalid (a keyframe slot with no
    observations, as the full-map windows' padding has)."""
    from plvio_tpu_torch.entry import MAPPING_WORST, mapping_step
    _, A = mapping_step(**MAPPING_WORST, device=dev)
    A["obs_valid"] = A["obs_valid"] & (A["obs_kf"] != k)
    A["lobs_valid"] = A["lobs_valid"] & (A["lobs_kf"] != k)
    w = KN._BAWork(K, *[A[k2] for k2 in BA_KEYS], lam0=1e-4, early_tol=1e-2,
                   cg_iters=48)
    w.linearize(KN.BA_MODE_INIT)
    w.linearize(KN.BA_MODE_LINEARIZE)
    return w


@pytest.mark.parametrize("kind", ["point+line", "15-DoF", "point-only",
                                  "empty keyframe"])
def test_schur_fill_in_matches_dense_operand(dev, kind):
    """schur_solve's sparse fill-in (a block a keyframe pair, walking the
    pair's shared landmarks) within 1e-5 relative of torch.mm on the dense
    operand assembled from its per-observation factors
    (`KN.schur_dense_operand`), on the three windows the main paths give
    it and on one with a keyframe that has no observations, and the whole
    step bit-equal over three launches."""
    from plvio_tpu_torch import cuda
    from plvio_tpu_torch.kernel_digest import schur_windows
    w = _window_without_keyframe(dev, 3) if kind == "empty keyframe" \
        else dict(schur_windows(dev))[kind]
    outs = []
    for _ in range(3):
        KN.SCHUR_SOLVE.launch(*w.args, cuda.stream())
        outs.append([w.t[k].clone() for k in ("ff", "dx", "cposes", "cpts",
                                               "clns")])
    gm = KN.schur_dense_operand(w)
    ref = gm @ gm.T
    torch.cuda.synchronize()
    assert _rel(w.t["ff"], ref) <= 1e-5
    assert all(torch.equal(a, b) for o in outs[1:] for a, b in
               zip(o, outs[0]))


# -- slice 4: the inertial back end ------------------------------------------

def _liba(dev, perturbed=True, dtype=torch.float32):
    """The half-bucket inertial window (16 KF, 2048 points / 4096
    observations, 256 lines / 512 observations) and its argument list."""
    from plvio_tpu_torch.entry import LIBA_HALF
    from plvio_tpu_torch.inputs import build_inertial_window
    A = build_inertial_window(**LIBA_HALF, device=dev, perturbed=perturbed)

    def cast(v):
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        return v.to(dtype) if v.is_floating_point() else v
    return A, [cast(A[k]) for k in KN.LIBA_KEYS]


def _liba_problem(A, args, lines=True):
    """The plain engine's problem at the masks of `args` (obs_valid,
    lobs_valid), and its states."""
    n_kf, n_pt, n_ln = (A["kf_pose_wb"].shape[0], A["pt_xyz"].shape[0],
                        A["ln_ep6"].shape[0])
    dt = args[0].dtype
    prob = KN._liba_problem(
        K, A["Rcb"].to(dt), A["tcb"].to(dt), 9.81, n_kf, n_pt, n_ln,
        (args[8].long(), args[9].long(), args[10], args[12]), args[11],
        (args[20].long(), args[21].long(), args[22]) if lines else None,
        args[23], (args[13], args[14], args[15], args[16], args[17]))
    st = {"pose": args[0], "vel": args[1], "bg": args[2], "ba": args[3],
          "pt": args[6], "ln": args[18]}
    free = ({"pose": args[4], "vel": args[4], "bg": args[5],
             "ba": args[5]}, {"pt": args[7], "ln": args[19]})
    return prob, st, free


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_inertial_kernels_match_plain_engine(dev):
    """One LM step of the perturbed half-bucket window: the dense H and g
    that ba_linearize's body-frame blocks and inertial_chain's link blocks
    assemble, the landmark blocks and the cost, within 1e-5 relative of
    the plain engine's (analytic against autodiff Jacobians, sums in
    another order); schur_solve's candidate poses, velocities and biases
    within 2x the farther plain float32 step's (on the card, whose
    atomics make it vary from run to run, and on the CPU) distance to the
    engine in float64 (+1e-6): this first step from the perturbed start
    puts every float32 path ~2e-3 from float64 (120 fixed CG steps on an
    ill-conditioned system, 2.4e-3 in a pose entry on the CPU)."""
    A, args = _liba(dev)
    n_kf = A["kf_pose_wb"].shape[0]
    w = KN.inertial_work(K, A["Rcb"], A["tcb"], 9.81, *args)
    w.chain(KN.CHAIN_COST_STATE)
    w.linearize(KN.BA_MODE_INIT)
    w.linearize(KN.BA_MODE_LINEARIZE)
    w.chain(KN.CHAIN_LINEARIZE)
    prob, st, free = _liba_problem(A, args)
    layout, H, g, lm_sys, cost, _ = prob.build_normal_equations(st)
    Hk, gk = KN.inertial_dense_system(w.t, n_kf)
    t = w.t
    iu = torch.triu_indices(3, 3)
    errs = {"H": _rel(Hk, H), "g": _rel(gk, g),
            "cost": abs(float(t["ctrl"][1]) - float(cost)) / float(cost),
            "gp points": _rel(t["hpt"][:, 6:], lm_sys["pt"][1]),
            "Hpp points": _rel(t["hpt"][:, :6],
                               lm_sys["pt"][0][:, iu[0], iu[1]]),
            "gp lines": _rel(t["hln"][:, 21:], lm_sys["ln"][1])}
    print({k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= 1e-5, errs
    torch.cuda.synchronize()
    KN.SCHUR_SOLVE.launch(*w.args, KN.cuda.stream())
    lam = torch.tensor(1e-4, device=dev)
    new = prob.step_from_system(layout, H, g, lm_sys, st, lam, *free)
    _, args64 = _liba(torch.device("cpu"), dtype=torch.float64)
    prob64, st64, free64 = _liba_problem({k: A[k].cpu() for k in (
        "kf_pose_wb", "pt_xyz", "ln_ep6", "Rcb", "tcb")}, args64)
    ref, _, _ = prob64.solve_step(st64, torch.tensor(1e-4,
                                                     dtype=torch.float64),
                                  *free64)
    _, args32 = _liba(torch.device("cpu"))
    prob32, st32, free32 = _liba_problem({k: A[k].cpu() for k in (
        "kf_pose_wb", "pt_xyz", "ln_ep6", "Rcb", "tcb")}, args32)
    cpu32, _, _ = prob32.solve_step(st32, torch.tensor(1e-4), *free32)
    kfx = t["ckfx"].double().cpu()
    cand = {"pose": t["cposes"].view(n_kf, 3, 4), "vel": kfx[:, :3],
            "bg": kfx[:, 3:6], "ba": kfx[:, 6:]}
    for name in ("pose", "vel", "bg", "ba"):
        gk_ = float((cand[name].double().cpu() - ref[name]).abs().max())
        gp_ = float((new[name].double().cpu() - ref[name]).abs().max())
        gc_ = float((cpu32[name].double() - ref[name]).abs().max())
        print(f"{name}: kernel {gk_:.2e}, plain {gp_:.2e} / CPU {gc_:.2e} "
              "from float64")
        assert gk_ <= 2 * max(gp_, gc_) + 1e-6, (name, gk_, gp_, gc_)


def _f64_gaps(outs, ref, keys):
    """Largest entry gap of each output in `outs` to `ref` (float64 on the
    CPU), per key."""
    return [{k: float((o[i].double().cpu() - ref[i]).abs().max())
             for i, k in keys} for o in outs]


@pytest.mark.parametrize("perturbed,lines", [(False, True), (True, True),
                                             (True, False)])
def test_inertial_ba_step_kernel_path_matches_plain_path(dev, perturbed,
                                                         lines):
    """The whole window solve at the half bucket, held to runs that repeat:
    the plain engine in float32 on the CPU and in float64.  (The card's
    plain path sums by atomics, so its LM iterations and its inlier mask
    near the chi2 gate change from run to run: [6, 6] against the
    kernel's [5, 6] on an H100; it is run and printed, not asserted on.)
    LM iterations per round within one of the CPU run's (the early exit
    at a relative cost change of 1e-2 can fire one iteration apart: the
    kernel's [5, 6] against the CPU's [5, 7] without lines), the point and
    line inlier masks equal to its and some observations rejected, the
    final LM cost (evaluated in float64 at both
    results and their masks) within 2% of the CPU run's, as the 1e-2 exit
    allows; poses, velocities and accelerometer biases within 1.5x the CPU
    float32 run's distance to the float64 run (every float32 path lies ~1e-3
    from float64 here: 120 fixed CG steps per iteration; printed, run with
    -s), the gyro bias (2e-3 rad/s here; the float32 runs 1e-7 to 1.5e-6
    from float64) within 1e-5; landmarks reprojecting within 0.1 px of the
    CPU run's where the iteration counts agree.  Without lines (the
    reference's default n_ln = 0) the same on the point-only window."""
    from plvio_tpu_torch.entry import LIBA_HALF, InertialBAOut
    A, args = _liba(dev, perturbed)
    Rcb, tcb = A["Rcb"].cpu(), A["tcb"].cpu()
    nl = len(args) if lines else 18
    sz = dict(LIBA_HALF) if lines else dict(LIBA_HALF, n_ln=0, n_lobs=0)
    step, plain = (KN.make_local_inertial_ba(
        K, 16, sz["n_pt"], sz["n_obs"], Rcb, tcb, 9.81, n_ln=sz["n_ln"],
        n_lobs=sz["n_lobs"], plain=p) for p in (False, True))
    n0 = KN.INERTIAL_CHAIN.launches
    sk, sp, sc = [], [], []
    with torch.no_grad():
        ok_ = InertialBAOut(*step(*args[:nl], stats=sk))
        op_ = InertialBAOut(*plain(*args[:nl], stats=sp))
    torch.cuda.synchronize()
    assert KN.INERTIAL_CHAIN.launches > n0
    _, args64 = _liba(torch.device("cpu"), perturbed, torch.float64)
    _, args32 = _liba(torch.device("cpu"), perturbed)
    ref = KN.local_inertial_ba_plain(K, Rcb.double(), tcb.double(), 9.81,
                                     *args64[:nl])
    oc_ = InertialBAOut(*KN.local_inertial_ba_plain(
        K, Rcb, tcb, 9.81, *args32[:nl], stats=sc))
    keys = [(0, "pose"), (1, "vel"), (2, "bg"), (3, "ba")]
    gk, gp, gc = _f64_gaps((ok_, op_, oc_), ref, keys)
    flips = int((ok_.inlier.cpu() != oc_.inlier).sum())
    flips_l = int((ok_.inlier_l.cpu() != oc_.inlier_l).sum()) if lines \
        else 0
    print(f"perturbed={perturbed}, lines={lines}: iterations kernel "
          f"{[int(x) for x in sk]}, CPU {[int(x) for x in sc]}, card plain "
          f"{sp}; inliers kernel {int(ok_.inlier.sum())}, CPU "
          f"{int(oc_.inlier.sum())}, card plain {int(op_.inlier.sum())}; "
          f"mask rows differing from the CPU run: {flips} points, {flips_l} "
          f"lines; from float64: kernel {gk}, CPU {gc}, card plain {gp}")
    assert len(sk) == len(sc) == 2
    assert all(abs(int(a) - int(b)) <= 1 for a, b in zip(sk, sc))
    assert flips == 0
    assert int((~ok_.inlier).sum()) > 0
    if lines:
        assert flips_l == 0
    else:
        assert ok_.ln_ep6 is None and oc_.inlier_l is None
    for k in ("pose", "vel", "ba"):
        assert gk[k] <= 1.5 * gc[k] + 1e-7, k
    assert gk["bg"] <= 1e-5
    for o in (ok_, op_):
        assert all(bool(torch.isfinite(x).all()) for x in o if x is not None)

    def cost64(o):
        a = list(args64)
        a[11] = o.inlier.cpu()
        for i, x in ((0, o.pose_wb), (1, o.vel), (2, o.bg), (3, o.ba),
                     (6, o.pt_xyz)):
            a[i] = x.double().cpu()
        if lines:
            a[18], a[23] = o.ln_ep6.double().cpu(), o.inlier_l.cpu()
        prob, st, _ = _liba_problem({k: A[k].cpu() for k in (
            "kf_pose_wb", "pt_xyz", "ln_ep6", "Rcb", "tcb")}, a, lines)
        if not lines:
            del st["ln"]
        return float(prob.cost(st)[0])
    ck, cc = cost64(ok_), cost64(oc_)
    print(f"final cost in float64: kernel {ck}, CPU {cc}, card plain "
          f"{cost64(op_)}")
    assert abs(ck - cc) <= 0.02 * cc
    if [int(x) for x in sk] != [int(x) for x in sc]:
        return
    Rcb, tcb = A["Rcb"], A["tcb"]
    oc_dev = InertialBAOut(*(None if x is None else x.to(dev) for x in oc_))

    def res(o):
        r = [RES.point_reproj_body_ba_jac(
            K, Rcb, tcb, o.pose_wb[A["obs_kf"].long()],
            o.pt_xyz[A["obs_pt"].long()], A["obs_uv"])[0]]
        if lines:
            r.append(RES.line_reproj_body_ba_jac(
                K, Rcb, tcb, o.pose_wb[A["lobs_kf"].long()],
                o.ln_ep6[A["lobs_ln"].long()], A["lobs_eq"])[0])
        return r
    for rk, rc in zip(res(ok_), res(oc_dev)):
        assert float((rk - rc).abs().max()) <= 0.1


@pytest.mark.parametrize("refine", [False, True])
def test_inertial_gs_lm_matches_plain(dev, refine):
    """IMU initialization and scale refinement at the cap of 32 KF, one
    launch: the kernel's gravity direction, scale, biases and velocities
    against the plain engine run in float64 on the CPU, within twice the
    farthest of the plain float32 runs' (on the card, and on the CPU over
    `KN.FLOAT32_ORDERS` orders of the edges in the sums, the row-order
    rule of `KN.against_float64`) plus a floor (printed, run with
    -s): the LM's last accept / reject decisions follow float32 noise in
    the cost near the optimum, which leaves the kernel 1.2e-5 from float64
    in the scale and the CPU's float32 runs up to 2.0e-6 over four edge
    orders.  (Before the card's plain path summed in a fixed order, its
    atomics gave that spread, 6.5e-5 in one run.)"""
    from plvio_tpu_torch.entry import imu_init
    m, B = imu_init(device=dev)
    mp, _ = imu_init(device=dev, plain=True)
    mc, Bc = imu_init(device="cpu")
    n0 = KN.INERTIAL_GS_LM.launches
    with torch.no_grad():
        ok_ = m.refine(B) if refine else m(B)
        op_ = mp.refine(B) if refine else mp(B)
    torch.cuda.synchronize()
    assert KN.INERTIAL_GS_LM.launches == n0 + 1

    def cast(v):
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        return v.double() if torch.is_tensor(v) and v.is_floating_point() \
            else v
    B64 = cast(Bc)
    ref = mc.refine(B64) if refine else mc(B64)
    keys = list(enumerate(("Rwg", "scale", "bg", "ba", "vel")[:len(ref)]))
    gc = None
    for o in range(KN.FLOAT32_ORDERS):
        order = None if o == 0 else torch.from_numpy(
            np.random.default_rng(o).permutation(Bc["edge_valid"].shape[0]))
        if refine:
            oc_ = KN.scale_refine_plain(
                9.81, *[Bc[k] for k in ("ref_Rwg0", "ref_vel", "ref_bg",
                                        "ref_ba", "pre_const", "ref_pose_R",
                                        "ref_pose_p", "imu_info",
                                        "edge_valid")], order=order)
        else:
            oc_ = KN.inertial_init_plain(
                9.81, *[Bc[k] for k in ("Rwg0", "vel0", "pre_const",
                                        "pose_R", "pose_p", "imu_info",
                                        "edge_valid")], order=order)
        g = _f64_gaps((oc_,), ref, keys)[0]
        gc = g if gc is None else {k: max(gc[k], g[k]) for k in gc}
    gk, gp = _f64_gaps((ok_, op_), ref, keys)
    print(f"refine={refine}: scale {float(ok_[1])} / {float(op_[1])} / "
          f"{float(ref[1])}; from float64: kernel {gk}, plain on the card "
          f"{gp}, plain on the CPU over {KN.FLOAT32_ORDERS} edge orders {gc}")
    floor = {"Rwg": 1e-6, "scale": 1e-5, "bg": 1e-7, "ba": 1e-8,
             "vel": 1e-6}
    for _, k in keys:
        assert gk[k] <= 2 * max(gp[k], gc[k]) + floor[k], k


# -- slice 5: the keyframe step's neighbourhood work -------------------------

def _np_t(a, dev):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a).to(dev)


@pytest.mark.parametrize("mode", ["fuse", "tracker"])
def test_proj_match_matches_plain(dev, mode):
    """inputs.build_projection_case (2048 points x 1000 features, every
    gate deciding rows) in the fuse's mode (radius 2, max 50) and the
    tracker's (frustum gates, radius 6, max 80): uv_m, pt_feat, matched
    and feat_pt identical."""
    from plvio_tpu_torch.inputs import build_projection_case
    c = {k: _np_t(v, dev) for k, v in build_projection_case().items()}
    args = [c[k] for k in ("pose", "pt_xyz", "pt_desc", "pt_valid",
                           "feat_uv", "feat_desc", "feat_octave",
                           "feat_valid")]
    fr = (c["pt_normal"], c["pt_min_dist"], c["pt_max_dist"]) \
        if mode == "tracker" else (None, None, None)
    rk = (2.0, 50.0) if mode == "fuse" else (6.0, 80.0)
    n0 = KN.PROJ_MATCH.launches
    ok_ = KN.proj_match(K, *args, *rk, *fr)
    op_ = KN.proj_match_plain(K, *args, *rk, *fr)
    torch.cuda.synchronize()
    assert KN.PROJ_MATCH.launches == n0 + 1
    for a, b in zip(ok_, op_):
        assert torch.equal(a, b)
    assert int(ok_[2].sum()) >= 150


def _keyframe_map():
    from plvio_tpu_torch.inputs import build_keyframe_map
    from plvio_tpu_torch.state import mapstore_from_numpy
    arrays, truth = build_keyframe_map(False)
    return mapstore_from_numpy(arrays), truth


def _angles(ep):
    return (np.arctan2(ep[:, 3] - ep[:, 1], ep[:, 2] - ep[:, 0])
            % np.pi).astype(np.float32)


def test_line_pair_mode_and_line_triangulate_match_plain(dev):
    """The new keyframe's 256 line features against each neighbour's
    (hamming_match's line pair mode: idx and ok identical), and the pairs
    triangulated (line_triangulate: good identical, endpoints within 5e-5
    relative)."""
    m, truth = _keyframe_map()
    kf = truth["new_kf"]
    n_pairs = 0
    for nb in m.covisible_kfs(kf, n=10, min_weight=5):
        ep1, ep2 = (_np_t(m.kf_line_ep[k], dev) for k in (nb, kf))
        args = (_np_t(m.kf_line_desc[nb], dev), _np_t(m.kf_line_desc[kf], dev),
                _np_t(m.kf_line_valid[nb], dev),
                _np_t(m.kf_line_valid[kf], dev), ep1, ep2)
        kw = dict(radius=80.0, max_dist=110.0, ratio=0.95,
                  a_ang=_np_t(_angles(m.kf_line_ep[nb]), dev),
                  b_ang=_np_t(_angles(m.kf_line_ep[kf]), dev),
                  angle_tol=0.25, pair=True)
        ik, okk = M.hamming_match(*args, **kw)
        ip, okp = M.hamming_match_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(okk, okp) and torch.equal(ik[okk], ip[okp])
        targs = (_np_t(m.kf_pose_cw[nb], dev), _np_t(m.kf_pose_cw[kf], dev),
                 ep1, ep2[ik.long()].contiguous(), okk)
        Xk = KN.line_triangulate(K, *targs)
        Xp = KN.line_triangulate_plain(K, *targs)
        torch.cuda.synchronize()
        assert torch.equal(Xk[2], Xp[2])
        g = Xk[2]
        n_pairs += int(g.sum())
        if not bool(g.any()):
            continue
        for a, b in zip(Xk[:2], Xp[:2]):
            rel = (a - b).norm(dim=1) / b.norm(dim=1)
            assert float(rel[g].max()) <= 5e-5
    assert n_pairs >= 50


def test_local_ba_points_kernel_as_close_to_float64_as_plain(dev):
    """make_local_ba (no line family) at the typical window from the
    perturbed start: the kernel path's KF poses within 2x the CPU plain
    run's distance to the plain engine in float64, inlier masks equal to
    the card's plain path."""
    from plvio_tpu_torch.entry import MAPPING_TYPICAL, mapping_step
    from plvio_tpu_torch.inputs import perturb_window
    _, A = mapping_step(**MAPPING_TYPICAL, device="cpu")
    P, X = perturb_window(A["kf_poses"].numpy(), A["pt_xyz"].numpy())
    A["kf_poses"], A["pt_xyz"] = torch.from_numpy(P), torch.from_numpy(X)
    args = [A[k] for k in BA_KEYS[:9]]
    ref = KN.local_ba_plain(K, *[a.double() if a.is_floating_point()
                                 else a for a in args])[0]
    card = [a.to(dev) for a in args]

    def gap(out):
        return float((out[0].cpu().double() - ref).abs().max())
    n0 = KN.SCHUR_SOLVE.launches
    with torch.no_grad():
        ok_ = KN.local_ba(K, *card)
        op_ = KN.local_ba_plain(K, *card)
        gk, gp = gap(ok_), gap(op_)
        gc = gap(KN.local_ba_plain(K, *args))
    torch.cuda.synchronize()
    print(f"point-only BA, KF poses from the float64 run: kernel {gk:.2e}, "
          f"plain on the card {gp:.2e}, plain on the CPU {gc:.2e}")
    assert KN.SCHUR_SOLVE.launches - n0 == 16
    assert gk <= 2 * gc
    assert torch.equal(ok_[2], op_[2])


@pytest.mark.parametrize("confirmed", [False, True])
def test_neighborhood_step_kernel_path_matches_plain_path(dev, confirmed):
    """neighborhood_step at production caps on each map, the kernel and
    plain paths from their own copies: new lines, fuse binds, merges,
    refusals and the BA path equal, the bindings equal but for 0.1%, every
    kernel of the path launched; the BA's KF poses within 2x the CPU plain
    run's distance to the engine in float64 on the same window (the card's
    plain BA sums by atomics: its poses lay 1e-5 to 1.02e-4 from the
    kernel path's in a pose entry from run to run on the confirmed-lines
    map)."""
    from plvio_tpu_torch.entry import neighborhood_step
    step, mk = neighborhood_step(confirmed, device=dev)
    plain, mp = neighborhood_step(confirmed, device=dev, plain=True)
    kern = (KN.PROJ_MATCH, M.HAMMING_MATCH, KN.LINE_TRIANGULATE,
            KN.BA_LINEARIZE, KN.SCHUR_SOLVE)
    n0 = [k.launches for k in kern]
    attr = "local_ba_pl_kernel" if confirmed else "local_ba_kernel"
    ba = getattr(step.mapper, attr)
    calls = []

    def record(*a, **kw):
        out = ba(*a, **kw)
        calls.append((a, out))
        return out
    setattr(step.mapper, attr, record)
    with torch.no_grad():
        ok_ = step(mk)
        op_ = plain(mp)
    torch.cuda.synchronize()
    assert all(k.launches > n for k, n in zip(kern, n0))
    print(f"confirmed={confirmed}: kernel {tuple(ok_)}, plain {tuple(op_)}")
    assert ok_[:5] == op_[:5]
    assert ok_.ba_path == ("pl" if confirmed else "pt")
    nb = int((mk.kf_match_pt >= 0).sum())
    db = int((mk.kf_match_pt != mp.kf_match_pt).sum()
             + (mk.kf_match_ln != mp.kf_match_ln).sum())
    assert db <= 0.001 * nb
    (args, out), = calls
    cpu = [x.cpu() for x in args]
    fn = KN.local_ba_pl_plain if confirmed else KN.local_ba_plain
    ref = fn(K, *[x.double() if x.is_floating_point() else x
                  for x in cpu])[0]
    gk = float((out[0].cpu().double() - ref).abs().max())
    gc = float((fn(K, *cpu)[0].double() - ref).abs().max())
    print(f"the BA's KF poses from the float64 run: kernel {gk:.2e}, plain "
          f"on the CPU {gc:.2e}; kernel - plain on the card "
          f"{float(np.abs(mk.kf_pose_cw - mp.kf_pose_cw).max()):.2e}")
    assert gk <= 2 * gc + 1e-6
    assert ok_.host_syncs > 0 and op_.host_syncs > 0


def test_undistort_matches_plain(dev):
    """Keypoints on a grid over the whole image and 256 segments at EuRoC's
    coefficients: the kernel's undistorted pixels equal to the plain
    version's (the same float32 operations in the same order; the plain
    version divides by tensors, as eager CUDA divides by a Python scalar
    through its reciprocal), the segments' line equations those of the
    kernel's own endpoints (`ops.lines.line_equation`): a, b within 1e-6,
    c within 1e-6 of the products it cancels over the segment's length
    (6.1e-5 at c ~ 200 on an H100); `undistort_pixels` on the card goes
    through it."""
    from plvio_tpu_torch.config import CameraConfig
    from plvio_tpu_torch.ops import cameras as CAM
    cam = CAM.make_camera(CameraConfig())
    u, v = np.meshgrid(np.linspace(0, 751, 40), np.linspace(0, 479, 25))
    kp = torch.from_numpy(np.stack([u.ravel(), v.ravel()], -1).astype(
        np.float32)).to(dev)
    rng = np.random.default_rng(6)
    ep = torch.from_numpy(rng.uniform([0, 0, 0, 0], [751, 479, 751, 479],
                                      (256, 4)).astype(np.float32)).to(dev)
    n0 = CAM.UNDISTORT.launches
    kk, ek, qk = CAM.undistort(cam, kp, ep)
    kp_, ep_, qp = CAM.undistort_frame_plain(cam, kp, ep)
    torch.cuda.synchronize()
    assert CAM.UNDISTORT.launches == n0 + 1
    from plvio_tpu_torch.ops.lines import line_equation
    own = line_equation(ek)
    print(f"undistort: kernel - plain {float((kk - kp_).abs().max()):.2e} "
          f"px (keypoints), {float((ek - ep_).abs().max()):.2e} px "
          f"(endpoints); line equations against line_equation of the "
          f"kernel's endpoints {float((qk - own).abs().max()):.2e}")
    assert torch.equal(kk, kp_) and torch.equal(ek, ep_)
    assert float((qk[:, :2] - own[:, :2]).abs().max()) <= 1e-6
    # c = (x0 y1 - y0 x1) / n cancels products of ~1e5: its rounding scales
    # with them, not with c
    scale = (ek[:, 0] * ek[:, 3]).abs() + (ek[:, 1] * ek[:, 2]).abs()
    n = torch.linalg.vector_norm(ek[:, 2:] - ek[:, :2], dim=1)
    assert bool(((qk[:, 2] - own[:, 2]).abs() <= 1e-6 * scale / n).all())
    und = CAM.undistort_pixels(cam, kp)
    assert CAM.UNDISTORT.launches == n0 + 2 and torch.equal(und, kk)


def _twoview_case(name, n, dev):
    from plvio_tpu_torch.config import CameraConfig
    from plvio_tpu_torch.inputs import build_twoview_cases
    from plvio_tpu_torch.ops import cameras as CAM
    from plvio_tpu_torch.ops import twoview as TV
    c = build_twoview_cases(0, n)[name]
    uv1, uv2 = (torch.from_numpy(c[k]).to(dev) for k in ("uv1", "uv2"))
    if c["raw"]:
        cam = CAM.make_camera(CameraConfig())
        uv1, uv2 = CAM.undistort_pixels(cam, uv1), \
            CAM.undistort_pixels(cam, uv2)
    valid = torch.from_numpy(c["valid"]).to(dev)
    g = torch.Generator().manual_seed(n)
    idx_h = TV.sample_indices(valid.cpu(), 200, 4, g)
    idx_f = TV.sample_indices(valid.cpu(), 200, 8, g)
    return uv1, uv2, valid, idx_h, idx_f


@pytest.mark.parametrize("name,n", [("general", 200), ("planar", 200),
                                    ("outliers", 200), ("rotation", 200),
                                    ("euroc_raw", 200), ("general", 1000)])
def test_twoview_kernels_match_plain(dev, name, n):
    """`twoview_hypotheses` + `twoview_recover` against the plain version
    in float64 (the kernels solve in float64) on the same sample indices
    (`ops.twoview.kernels_against_float64`): every minimal model's score
    within 1e-6 of the best score where the model's condition number is
    below 1e6, the best hypotheses equal (ties of the top two scores
    within 1e-9 excepted), success, the model, R and t within 1e-5 (an
    entry), `is_triangulated` equal but for 1% of the matches (gate values
    within rounding), the common points within 1e-5 of their magnitude.
    The pure rotation fails."""
    from plvio_tpu_torch.ops import twoview as TV
    uv1, uv2, valid, idx_h, idx_f = _twoview_case(name, n, dev)
    n0 = (TV.TWOVIEW_HYPOTHESES.launches, TV.TWOVIEW_RECOVER.launches)
    g = TV.kernels_against_float64(K, uv1, uv2, valid, idx_h, idx_f)
    torch.cuda.synchronize()
    assert (TV.TWOVIEW_HYPOTHESES.launches, TV.TWOVIEW_RECOVER.launches) \
        == (n0[0] + 1, n0[1] + 1)
    r, rp = g.out.result, g.ref.result
    print(f"{name} N={n}: info {g.info.tolist()}; plain float64 success "
          f"{bool(rp.success)} homography {bool(rp.used_homography)} "
          f"triangulated {int(rp.is_triangulated.sum())}; scores within "
          f"{g.score_gap:.1e}, R / t / points within {g.gaps}, {g.flips} "
          "flips")
    assert g.score_gap <= 1e-6 and g.best_equal
    assert bool(r.success) == bool(rp.success) == (name != "rotation")
    assert bool(r.used_homography) == bool(rp.used_homography)
    assert max(g.gaps) <= 1e-5
    assert g.flips <= 0.01 * n


def test_bootstrap_step_kernel_path_matches_float64(dev):
    """`bootstrap_step` on the kernel path (its own RANSAC draws): the map
    starts on a frame of the sequence, every kernel of the path launched
    (but `undistort`: the rendered frames have no distortion); its last
    two-view attempt held to the plain version in float64 on the same
    matches and draws (R and t within 1e-5, `is_triangulated` but for
    1%), the second keyframe's pose consistent with it, the first
    preintegration held to the plain version's.  The CPU's plain run of
    the whole bootstrap (its front end rounds differently, so its matches
    may differ) is printed."""
    from plvio_tpu_torch.entry import bootstrap_step
    from plvio_tpu_torch.ops import imu as IMU
    from plvio_tpu_torch.ops import lines as LN
    from plvio_tpu_torch.ops import twoview as TV
    kernels = (FE.ORB_FAST_GRID, FE.ORB_DESCRIBE, M.HAMMING_MATCH,
               M.ROT_HIST, LN.LINE_DETECT, LN.LINE_REFINE_LBD,
               TV.TWOVIEW_HYPOTHESES, TV.TWOVIEW_RECOVER,
               KN.LINE_TRIANGULATE, IMU.IMU_PREINT)
    step, B = bootstrap_step(device=dev)
    n0 = [k.launches for k in kernels]
    with torch.no_grad():
        out = step(B)
    torch.cuda.synchronize()
    assert all(k.launches > c for k, c in zip(kernels, n0)), \
        [k.name for k, c in zip(kernels, n0) if k.launches == c]
    tr = out.tracker
    print(f"kernel path: frame {out.init_frame}, attempts {out.attempts}, "
          f"homography {out.used_homography}, matches {out.init_matches}, "
          f"triangulated {out.n_triangulated}, points {out.points}, lines "
          f"{out.lines}, host syncs {out.host_syncs}")
    assert out.init_frame >= 1 and out.points >= 60 and out.lines > 0
    uv0, uv1, ok, idx_h, idx_f = tr.last_twoview_inputs
    ref = TV.twoview_plain(K, uv0.double().cpu(), uv1.double().cpu(),
                           ok.cpu(), torch.as_tensor(idx_h),
                           torch.as_tensor(idx_f)).result
    r = tr.last_twoview
    assert bool(ref.success) and bool(r.success)
    assert bool(ref.used_homography) == bool(r.used_homography)
    assert float((r.R.double().cpu() - ref.R).abs().max()) <= 1e-5
    assert float((r.t.double().cpu() - ref.t).abs().max()) <= 1e-5
    assert int((r.is_triangulated.cpu() != ref.is_triangulated).sum()) \
        <= 0.01 * int(ok.sum())
    m = out.map
    kf1 = tr.new_kf_queue[1]
    np.testing.assert_allclose(m.kf_pose_cw[kf1, :, :3],
                               r.R.cpu().numpy(), atol=1e-6)
    pre = m.kf_preint[kf1]
    raw = m.kf_imu_raw[kf1]
    n_imu = len(raw[2])
    cap = 64
    while cap < n_imu:
        cap *= 2

    def pad(a, shape):
        z = np.zeros(shape, np.float32)
        z[:len(a)] = a
        return torch.from_numpy(z)
    plain = IMU.preintegrate(pad(raw[0], (cap, 3)), pad(raw[1], (cap, 3)),
                             pad(raw[2], (cap,)),
                             torch.arange(cap) < n_imu, tr.calib,
                             torch.zeros(3), torch.zeros(3))
    for f in pre._fields:
        a, b = np.asarray(getattr(pre, f)), getattr(plain, f).numpy()
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30), f
    cpu_step, B_cpu = bootstrap_step(device="cpu")
    with torch.no_grad():
        oc = cpu_step(B_cpu)
    print(f"CPU plain path: frame {oc.init_frame}, attempts {oc.attempts}, "
          f"homography {oc.used_homography}, matches {oc.init_matches}, "
          f"triangulated {oc.n_triangulated}, points {oc.points}, lines "
          f"{oc.lines}")


# -- slice 7: schur_solve's global path (S beyond one block) ------------------

@pytest.mark.parametrize("kind,n_kf", [("inertial", 23), ("inertial", 64),
                                       ("points", 128)])
def test_schur_solve_global_path(dev, kind, n_kf):
    """The reduced solve beyond one block (S = 345 and 960 for the 15-DoF
    window, 768 for the point-only one): one Schur step from the
    perturbed start held by `KN.global_solve_against_float64`'s rule
    (the global path taken, the same bits on a second launch, each state
    within 2x the card's plain float32 step's distance to float64 and no
    farther from that step than it lies from float64, the pose within a
    quarter of the float64 step of it)."""
    got = KN.global_solve_against_float64(kind, n_kf, dev)
    print(f"{kind} {n_kf} KF (S = {got.S}), kernel / plain from float64, "
          f"kernel - plain: {got.summary()}")
    assert not got.failures(), got.failures()


@pytest.mark.parametrize("kind,n_kf", [("inertial", 30), ("points", 160)])
def test_schur_solve_global_path_float32_orders(dev, kind, n_kf):
    """The global path where `KN.global_solve_against_float64`'s rule
    reads float32 rounding (its bg at 30 KF: kernel - plain 1.12e-4
    against the plain step's 7.93e-5 from float64) and on a point-only
    system whose rows do not fit the cluster's shared memory (160 KF, S =
    960 dense, the rows read from the workspace): one Schur step held,
    state by state, to `KN.against_float64`'s rule over the plain step's
    `KN.FLOAT32_ORDERS` observation orders (within 2x their largest
    distance to float64 + 1e-6, the same bits on three launches)."""
    got = KN.global_step_against_float64(kind, n_kf, dev)
    for name, out in got.items():
        print(f"{kind} {n_kf} KF {name}: kernel {out['kernel']:.3e}, plain "
              f"orders {[f'{x:.3e}' for x in out['plain_orders']]}")
    assert not [out["failures"] for out in got.values() if out["failures"]]


@pytest.mark.parametrize("kind,n_kf", [("inertial", 22), ("points", 37)])
def test_schur_solve_one_block_largest(dev, kind, n_kf):
    """The one-block solve on its largest windows (S = 330 for the 15-DoF
    window, where a thread owns two rows, and 222 for the point-only one,
    the most whose full rows fit): the path `KN.solve_fits` names, held by
    the same rule as the global path."""
    got = KN.global_solve_against_float64(kind, n_kf, dev)
    print(f"{kind} {n_kf} KF (S = {got.S}), kernel / plain from float64, "
          f"kernel - plain: {got.summary()}")
    assert got.path == 0
    assert not got.failures(), got.failures()


def test_keyframe_sequence_kernel_path_matches_cpu(dev):
    """A short keyframe sequence (17 keyframes of 256 features, the
    reduced store and windows of tests/test_torch_keyframe_step.py) on the
    kernel path against the plain path in float32 on the CPU: the IMU
    initializes at the same keyframe, keyframes, points and lines alive at
    the end within 5%, the final scale against the truth and the Sim3 ATE
    within 2x the CPU run's error plus 2 mm, and every kernel of the step
    launched."""
    from plvio_tpu_torch.entry import keyframe_sequence
    from plvio_tpu_torch.ops import imu as IMU
    kw = dict(store=dict(max_kf=16, max_pts=4096, max_lines=1024),
              caps=dict(ba_kf_cap=16, ba_pt_cap=1024, ba_obs_cap=2048),
              viba_caps=dict(viba_kf_cap=32, viba_pt_cap=1024,
                             viba_obs_cap=2048, viba_ln_cap=128,
                             viba_lobs_cap=256),
              seq_kw=dict(n_kf=17, n_feat=256))
    kern = (M.HAMMING_MATCH, M.ROT_HIST, KN.TRIANGULATE,
            KN.LINE_TRIANGULATE, KN.PROJ_MATCH, KN.BA_LINEARIZE,
            KN.SCHUR_SOLVE, KN.INERTIAL_CHAIN, KN.INERTIAL_GS_LM,
            IMU.IMU_PREINT)
    n0 = [k.launches for k in kern]
    step, seq = keyframe_sequence(device=dev, **kw)
    with torch.no_grad():
        ok_ = step(seq)
    torch.cuda.synchronize()
    assert all(k.launches > n for k, n in zip(kern, n0))
    cpu, seq_c = keyframe_sequence(device="cpu", **kw)
    oc = cpu(seq_c)
    print(f"kernel: init {ok_.init_kf} kf {ok_.map.n_kf} pts {ok_.map.n_pt} "
          f"lines {ok_.map.n_ln} scale {ok_.scale:.4f} ate {ok_.ate_sim3:.4f};"
          f" CPU: init {oc.init_kf} kf {oc.map.n_kf} pts {oc.map.n_pt} lines "
          f"{oc.map.n_ln} scale {oc.scale:.4f} ate {oc.ate_sim3:.4f}")
    assert ok_.init_kf == oc.init_kf == 13
    for a, b in ((ok_.map.n_kf, oc.map.n_kf), (ok_.map.n_pt, oc.map.n_pt),
                 (ok_.map.n_ln, oc.map.n_ln)):
        assert abs(a - b) <= 0.05 * b, (a, b)
    assert abs(ok_.scale - 1) <= 2 * abs(oc.scale - 1) + 2e-3
    assert ok_.ate_sim3 <= 2 * oc.ate_sim3 + 2e-3


# -- slice 8: the pyramid and the tracked sequence -----------------------------

@pytest.mark.parametrize("shape", [(480, 752), (121, 203)])
def test_pyramid_matches_plain(dev, shape):
    """The 7 pyramid levels and the line level on the card against their
    plain versions (contracted by matmul with TF32 off): within 1e-4 grey
    levels at every level, chained and from the plain level above."""
    h, w = shape
    img = _image(4, h, w, dev)
    specs = FE.make_level_specs(h, w, 1000)
    n0 = (FE.PYRAMID.launches, FE.PYRAMID_LINE.launches)
    pk, pp = FE.build_pyramid(img, specs), FE.build_pyramid_plain(img, specs)
    torch.cuda.synchronize()
    assert FE.PYRAMID.launches == n0[0] + 7
    for lv in range(8):
        assert tuple(pk[lv].shape) == (specs[lv].height, specs[lv].width)
        assert float((pk[lv] - pp[lv]).abs().max()) <= 1e-4, lv
        if lv:
            one = FE.pyramid_level(pp[lv - 1], specs[lv].height,
                                   specs[lv].width)
            assert float((one - pp[lv]).abs().max()) <= 1e-4, lv
    lk, lp = FE.line_level(img), FE.line_level_plain(img)
    assert FE.PYRAMID_LINE.launches == n0[1] + 1
    assert lk.shape == lp.shape and float((lk - lp).abs().max()) <= 1e-4
    n1 = FE.PYRAMID.launches
    fk, lf = FE.build_pyramid_line(img, specs)
    assert FE.PYRAMID_LINE.launches == n0[1] + 2
    assert FE.PYRAMID.launches == n1 + 7
    assert all(torch.equal(a, b) for a, b in zip(fk, pk))
    assert torch.equal(lf, lp) and torch.equal(lk, lp)
    with pytest.raises(ValueError):
        FE.pyramid_level(img, h // 2, w // 2)        # below 1/1.5 a side


@pytest.mark.parametrize("shape,offset", [((480, 752), 0), ((121, 203), 0),
                                          ((64, 96), 1), ((33, 47), 0)])
def test_line_level_bit_equal(dev, shape, offset):
    """The line level, from the pyramid's first launch and alone, bit-equal
    to `line_level_plain`: 16-byte loads where the width and pointers allow
    (480 x 752), one output a thread elsewhere (odd widths, an image
    starting one float past an aligned address)."""
    h, w = shape
    base = _image(5, h * w + offset, 1, dev).view(-1)
    img = base[offset:].view(h, w)
    lp = FE.line_level_plain(img)
    specs = FE.make_level_specs(h, w, 200)
    _, lf = FE.build_pyramid_line(img, specs)
    assert torch.equal(FE.line_level(img), lp) and torch.equal(lf, lp)


def test_hamming_match_ungated_matches_plain(dev):
    """The tracker's reference-keyframe match: `hamming_match`'s window
    mode at an infinite radius against the plain version's NN-ratio match
    with no gate (ratio 0.75, max 60, mutual), 2048 x 1000."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, (2048, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (1000, 8), dtype=np.uint32)
    b[:300] = a[:300] ^ 1
    ta, tb = (torch.from_numpy(x.view(np.int32)).to(dev) for x in (a, b))
    va = torch.from_numpy(rng.random(2048) < 0.8).to(dev)
    vb = torch.ones(1000, dtype=torch.bool, device=dev)
    uv = torch.from_numpy(rng.uniform(0, 500, (1000, 2)).astype(
        np.float32)).to(dev)
    z = torch.zeros(2048, 2, device=dev)
    ik, ok = M.hamming_match(ta, tb, va, vb, z, uv, radius=math.inf,
                             max_dist=60.0, ratio=0.75)
    dist = M.hamming_matrix(M.unpack_u32_to_pm1(ta), M.unpack_u32_to_pm1(tb))
    ip, op = M.match_nn_ratio(dist, va, vb, None, max_dist=60.0, ratio=0.75,
                              mutual=True)
    torch.cuda.synchronize()
    assert torch.equal(ok, op) and int(op.sum()) > 100
    assert torch.equal(ik[op], ip[op].to(ik.dtype))


def test_tracked_sequence_kernel_path_matches_cpu(dev):
    """The tracker and the keyframe step on the kernel path against the
    plain path on the CPU, from one state and on the same features: 24
    frames of the tracked sequence (1000 features, the reduced store and
    windows of tests/test_torch_tracked_sequence.py), the CPU front end's
    features for both, the CPU run's state after its bootstrap carried to
    the card (`state.mapstore_from_numpy`, `load_mapper_state`,
    `load_tracker_state`: two bootstraps' float32 homography refits leave
    maps ~1e-3 apart). Every frame after it: the state equal, inliers
    within 3% and the camera centre within 2 mm of the CPU run's (the
    slice-1 frame's bounds); keyframes within one and points within 5% at
    the end; the kernels of the tracker and of the keyframe step's point
    path launched (the line triangulator only where a line pair matches,
    which chip_smoke.py's 180 frames hold)."""
    from plvio_tpu_torch.entry import TrackedSequence
    from plvio_tpu_torch.inputs import build_tracked_sequence
    from plvio_tpu_torch.models.system import (apply_pending_transform,
                                               drain_keyframes,
                                               frame_prelude)
    from plvio_tpu_torch.models.tracking import TrackState
    from plvio_tpu_torch.ops import imu as IMU
    from plvio_tpu_torch.state import (load_mapper_state,
                                       load_tracker_state, mapper_state,
                                       mapstore_from_numpy,
                                       mapstore_to_numpy, tracker_state)
    kw = dict(store=dict(max_kf=64, max_pts=4096, max_lines=512),
              caps=dict(ba_kf_cap=16, ba_pt_cap=1024, ba_obs_cap=2048),
              n_features=1000)
    S = build_tracked_sequence(0, 24)
    cpu = TrackedSequence(plain=True, device="cpu", **kw)
    card = TrackedSequence(device=dev, **kw)
    with torch.no_grad():
        feats = [frame_prelude(cpu.orb, cpu.lines, cpu.cam,
                               torch.from_numpy(im)) for im in S["frames"]]
    tc, mc = cpu.new_pipeline()
    tk, mk = card.new_pipeline()
    kern = (M.HAMMING_MATCH, M.ROT_HIST, KN.PROJ_MATCH, KN.POSE_IRLS,
            KN.TRIANGULATE, KN.BA_LINEARIZE, KN.SCHUR_SOLVE, IMU.IMU_PREINT)
    n0, rows, start = [k.launches for k in kern], [], -1
    for i, (f, lf) in enumerate(feats):
        t, imu = float(S["timestamps"][i]), S["imu"][i]
        if start < 0 and tc.state == TrackState.OK:
            start = i
            tk.atlas.maps[0] = mapstore_from_numpy(mapstore_to_numpy(tc.map))
            load_mapper_state(mk, mapper_state(mc))
            load_tracker_state(tk, tracker_state(tc))
        with torch.no_grad():
            for tr, mp, ff, ll in ((tc, mc, f, lf), (tk, mk, None, None)):
                if tr is tk:
                    if start < 0:
                        continue
                    ff = f._replace(**{k: getattr(f, k).to(dev)
                                       for k in f._fields})
                    ll = lf._replace(**{k: getattr(lf, k).to(dev)
                                        for k in lf._fields})
                tr.process_frame(ff, t, imu=imu, line_feats=ll)
                drain_keyframes(tr, mp)
                apply_pending_transform(tr, mp)
        if start >= 0:
            rows.append((i, int(tc.state), int(tk.state), tc.last_n_inliers,
                         tk.last_n_inliers, tc.last_pose_cw.copy(),
                         tk.last_pose_cw.copy()))
    torch.cuda.synchronize()
    gaps = [float(np.linalg.norm(Pk[:, :3].T @ Pk[:, 3]
                                 - Pc[:, :3].T @ Pc[:, 3]))
            for *_, Pc, Pk in rows]
    print(f"inliers (card, CPU): {[(r[4], r[3]) for r in rows]}; largest "
          f"centre gap {max(gaps):.2e}; keyframes {tk.map.n_kf} / "
          f"{tc.map.n_kf}, points {tk.map.n_pt} / {tc.map.n_pt}; launches "
          f"{[k.launches - n for k, n in zip(kern, n0)]}")
    assert 1 <= start <= 4 and len(rows) == 24 - start
    assert all(k.launches > n for k, n in zip(kern, n0))
    for i, sc, sk, nc, nk, _, _ in rows:
        assert sc == sk == int(TrackState.OK), (i, sc, sk)
        assert abs(nk - nc) <= 0.03 * nc, (i, nk, nc)
    assert max(gaps) <= 2e-3
    assert abs(tk.map.n_kf - tc.map.n_kf) <= 1
    assert abs(tk.map.n_pt - tc.map.n_pt) <= 0.05 * tc.map.n_pt


@pytest.mark.parametrize("kind", ["orb", "lbd"])
def test_bow_transform_bit_equal(dev, kind):
    """The descent and the bag on the card against the plain pipeline on
    the same device: ids and bags bit-equal (integer counts over their
    total, one true division), written into a bank's row."""
    from plvio_tpu_torch.models import vocabulary as V
    voc = V.default_vocabulary(kind)
    n = 1000 if kind == "orb" else 256
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
                         .view(np.int32)).to(dev)
    d[n // 2:] = d[: n - n // 2] ^ 1            # repeated words
    valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    bank = torch.zeros(4, voc.n_words, device=dev)
    ids = torch.full((4, n), -1, dtype=torch.int32, device=dev)
    n0 = V.BOW_TRANSFORM.launches
    wk, bk = V.make_bow_pipeline(voc, n)(d, valid, ids_out=ids[2],
                                         bow_out=bank[2])
    wp, bp = V.make_bow_pipeline(voc, n, plain=True)(d, valid)
    torch.cuda.synchronize()
    assert V.BOW_TRANSFORM.launches == n0 + 1
    assert torch.equal(wk, wp) and torch.equal(bk, bp)
    assert torch.equal(ids[2], wp) and torch.equal(bank[2], bp)
    assert float(bank[[0, 1, 3]].abs().sum()) == 0.0


def test_bow_score_matches_plain(dev):
    """The masked L1 score of a query against a 512-row bank: within 1e-6
    of the plain version (another summation order)."""
    from plvio_tpu_torch.models import vocabulary as V
    rng = np.random.default_rng(6)
    W = 10000
    bank = np.zeros((512, W), np.float32)
    for r in range(512):
        np.add.at(bank[r], rng.integers(0, W, 1000), 1.0)
        bank[r] /= bank[r].sum()
    v = torch.from_numpy(0.5 * bank[3] + 0.5 * bank[9]).to(dev)
    tb = torch.from_numpy(bank).to(dev)
    mask = torch.from_numpy(rng.random(512) > 0.2).to(dev)
    sk = V.bow_score(v, tb, mask)
    sp = V.score_plain(v, tb, mask)
    torch.cuda.synchronize()
    assert float((sk - sp).abs().max()) <= 1e-6
    assert torch.equal(sk < -0.5, ~mask)
    assert torch.equal(sk, V.bow_score(v, tb, mask))


@pytest.mark.parametrize("name", ["place", "rendered"])
def test_pnp_kernels_match_float64(dev, name):
    """`pnp_ransac` and `mlpnp_refine` against the plain version's float64
    run on the same samples (`ops.pnp.kernels_against_float64`: the best
    hypothesis equal, masks equal but near the gate, poses within 2x the
    plain float32 run's gap + 1e-5)."""
    from plvio_tpu_torch.inputs import build_pnp_case
    from plvio_tpu_torch.ops import pnp as PNP
    from plvio_tpu_torch.ops.twoview import sample_indices
    uv, X, valid, _ = build_pnp_case(name)
    tv = torch.from_numpy(valid)
    s = sample_indices(tv, 128, 6, torch.Generator().manual_seed(1))
    r = PNP.kernels_against_float64(
        K, *(torch.from_numpy(a).to(dev) for a in (uv, X, valid)),
        s.to(dev))
    print({k: v for k, v in r.items() if k != "failures"})
    assert not r["failures"], r["failures"]
    assert r["n"] >= 10 and r["n_ml"] >= 10
    # the Jacobi rotations the kernels report (chip_smoke.py's bound):
    # at least one a solve, at most 50 sweeps of 66 (linalg.cuh)
    st = {}
    PNP.pnp_ransac(K, *(torch.from_numpy(a).to(dev) for a in (uv, X, valid)),
                   s.to(dev), stats=st)
    assert 128 + 3 <= int(st["rotations"]) <= (128 + 3) * 50 * 66


# --------------------------------------------------------------------------
# Slice 10: the loop closer's kernels against float64
# --------------------------------------------------------------------------

def _circle_verification():
    """The drifted circle's first Sim3 verification inputs and its
    essential graph, from the loop closer's plain run on the CPU."""
    from plvio_tpu_torch.entry import loop_closure
    from plvio_tpu_torch.ops import pnp as PNP
    got = {}
    orig_r, orig_g = PNP.sim3_ransac_plain, KN.pose_graph_compacted_plain

    def rec_r(*a, **kw):
        got.setdefault("ransac", (a, kw))
        return orig_r(*a, **kw)

    def rec_g(*a, **kw):
        got.setdefault("graph", (a, kw))
        return orig_g(*a, **kw)
    PNP.sim3_ransac_plain, KN.pose_graph_compacted_plain = rec_r, rec_g
    try:
        step, inputs = loop_closure("circle", device="cpu", plain=True,
                                    gba_caps=(32, 2048, 4096))
        step(inputs)
    finally:
        PNP.sim3_ransac_plain, KN.pose_graph_compacted_plain = orig_r, orig_g
    return got


@pytest.fixture(scope="module")
def circle_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _circle_verification()


@pytest.mark.parametrize("own_samples", [False, True])
def test_sim3_ransac_matches_float64(dev, circle_inputs, own_samples):
    from plvio_tpu_torch.ops import pnp as PNP
    from plvio_tpu_torch.ops import twoview as TV
    (X1, X2, valid, samples), kw = circle_inputs["ransac"]
    if own_samples:
        samples = TV.sample_indices(valid, 64, 3,
                                    torch.Generator().manual_seed(1))
    r = PNP.sim3_against_float64(X1.to(dev), X2.to(dev), valid.to(dev),
                                 samples.to(dev), kw.get("th", 0.08),
                                 kw.get("fix_scale", False))
    assert not r["failures"], r


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_reproj_matches_float64(dev, fix_scale):
    """tests/test_essential_graph_big.py:114's case: 256 pairs a side
    observed with 0.3 px noise, 7 forward outliers, from a perturbed
    start."""
    from plvio_tpu_torch.utils import lie
    rng = np.random.default_rng(0)
    cap = 256

    def rot(v):
        return lie.so3_exp(torch.tensor(v, dtype=torch.float32)).numpy()
    Rg, tg = rot([0.02, -0.03, 0.2]), np.array([0.5, -0.3, 0.2])
    P1 = np.eye(3, 4, dtype=np.float32)
    P2 = np.concatenate([rot([0., 0.25, 0.]),
                         np.array([[0.1], [0.], [0.3]], np.float32)], 1)
    X1 = rng.uniform(-2, 2, (cap, 3))
    X1[:, 2] = rng.uniform(3, 7, cap)
    X2 = 1.1 * X1 @ Rg.T + tg

    def proj(P, X):
        pc = X @ P[:, :3].T + P[:, 3]
        return np.stack([400 * pc[:, 0] / pc[:, 2] + 376,
                         400 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv2 = proj(P2, X2) + rng.normal(0, 0.3, (cap, 2))
    uv2[:7] += 25.0
    uv1 = proj(P1, X1) + rng.normal(0, 0.3, (cap, 2))
    S13 = np.concatenate([rot([0.01, 0.01, 0.25]).reshape(-1),
                          tg + [0.1, -0.1, 0.05], [1.0]])
    ones, valid = np.ones(cap, np.float32), np.ones(cap, bool)
    ts = [torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
          for a, dt in ((S13, np.float32), (X1, np.float32),
                        (uv2, np.float32), (valid, bool), (ones, np.float32),
                        (X2, np.float32), (uv1, np.float32), (valid, bool),
                        (ones, np.float32), (P1, np.float32),
                        (P2, np.float32))]
    r = KN.sim3_reproj_against_float64(PinholeK(400., 400., 376., 240.),
                                       ts, fix_scale=fix_scale)
    assert not r["failures"], r


@pytest.mark.parametrize("four_dof", [False, True])
def test_pose_graph_one_block_matches_float64(dev, circle_inputs, four_dof):
    (args, kw) = circle_inputs["graph"]
    n_active = args[11] if len(args) > 11 else kw.get("n_active")
    r = KN.pose_graph_against_float64([a.to(dev) for a in args[:9]],
                                      four_dof=four_dof, n_active=n_active)
    assert r["path"] == 0 and not r["failures"], r


@pytest.mark.parametrize("n_kf", [600, 511])
def test_pose_graph_global_path_matches_float64(dev, n_kf):
    """tests/test_essential_graph_big.py's chain through the
    production-cap graph (512 keyframes x 4096 edges), the factor streamed
    through shared memory: 601 keyframes subsampled to 301 anchors (S =
    2107), and 512 keyframes, the graph's capacity (S = 3584)."""
    from plvio_tpu_torch.config import CameraConfig, SystemConfig
    from plvio_tpu_torch.inputs import build_big_chain
    from plvio_tpu_torch.models.loop_closing import LoopCloser
    from plvio_tpu_torch.models.mapstore import Atlas
    got = {}
    orig = KN.pose_graph

    def rec(*a, **kw):
        got["args"] = a
        return orig(*a, **kw)
    KN.pose_graph = rec
    try:
        m, kfs, gt = build_big_chain(n_kf=n_kf)
        lc = LoopCloser(SystemConfig(camera=CameraConfig(dist=(0.0,) * 4),
                                     use_lines=False),
                        Atlas(maps=[m], active=0), None, m.n_feat,
                        device=dev)
        chain = m.kf_chain()
        pre = {int(k): (m.kf_pose_cw[k, :, :3].copy(),
                        m.kf_pose_cw[k, :, 3].copy()) for k in chain}
        kf, cand = int(kfs[-1]), int(kfs[0])
        R_w = gt[-1][0].T @ pre[kf][0]
        t_w = gt[-1][0].T @ (pre[kf][1] - gt[-1][1])
        lc._essential_graph(kf, cand, 1.0, R_w, t_w, pre, {kf})
    finally:
        KN.pose_graph = orig
    a = got["args"]
    r = KN.pose_graph_against_float64(list(a[:9]), four_dof=False,
                                      n_active=a[11])
    assert r["S"] == 7 * (301 if n_kf == 600 else 512) and r["path"] == 1 \
        and not r["failures"], r


def test_pose_graph_arrows_matches_float64(dev):
    """A 40-keyframe chain with a loop edge to the fixed first keyframe and
    three past-loop arrows (`kernel_digest.random_graph`): the pattern's
    fill reaches the arrows' rows, the factor stays in shared memory."""
    from plvio_tpu_torch.kernel_digest import random_graph
    g = [torch.from_numpy(a).to(dev) for a in random_graph(40, 3, 40)]
    pat = KN.pg_pattern(g[2].cpu().numpy(), g[3].cpu().numpy(),
                        g[1].cpu().numpy(), 40)
    assert pat["nb"] > 3 * 40          # the arrows' fill
    r = KN.pose_graph_against_float64(g, four_dof=False)
    assert r["path"] == 0 and r["nb"] == pat["nb"] and not r["failures"], r
    r = KN.pose_graph_against_float64(g, four_dof=True)
    assert not r["failures"], r


@pytest.mark.parametrize("graph", ["revisit 512/50", "random 200+400"])
def test_pose_graph_grid_path_matches_float64(dev, graph):
    """Graphs whose long-range edges fill the factor take the grid path
    (2, `KN.pg_path`): a revisited 512-keyframe map (its last 50
    keyframes joined to its first 50, `kernel_digest.revisit_graph`) and
    400 random edges over 200 keyframes; held to float64 by the rule of
    the other graphs, and the same solve on the streamed path (1) by it
    too."""
    from plvio_tpu_torch.kernel_digest import random_graph, revisit_graph
    g = revisit_graph(512, 50, 5) if graph.startswith("revisit") \
        else random_graph(200, 400, 200)
    g = [torch.from_numpy(a).to(dev) for a in g]
    r = KN.pose_graph_against_float64(g, four_dof=False)
    assert r["path"] == 2 and not r["failures"], r
    r = KN.pose_graph_against_float64(g, four_dof=False, path=1)
    assert r["path"] == 1 and not r["failures"], r


def test_pose_graph_indefinite_step_rejected(dev):
    """An edge of information -1e4 makes the damped normal matrix
    indefinite: the kernel's factor meets a non-positive pivot, the step
    is rejected as the plain version's, and the states come back
    unchanged."""
    from plvio_tpu_torch.kernel_digest import random_graph
    g = [torch.from_numpy(a).to(dev) for a in random_graph(17, 20, 17)]
    g[8][0] = -1e4
    out = KN.pose_graph(*g, iters=1)
    plain = KN.pose_graph_compacted_plain(*g, iters=1)
    torch.cuda.synchronize()
    assert torch.equal(out, g[0]) and torch.equal(plain, g[0])


def test_bow_score_pair_and_masks(dev):
    """The point and line banks scored in one launch (`bow_score_pair`)
    within 1e-6 of the plain version, the same bits on a second launch,
    -1 exactly on every masked row; an all-masked bank gives all -1."""
    from plvio_tpu_torch.models import vocabulary as V
    rng = np.random.default_rng(7)

    def bank(W, n_words):
        b = np.zeros((512, W), np.float32)
        for r in range(512):
            np.add.at(b[r], rng.integers(0, W, n_words), 1.0)
            b[r] /= b[r].sum()
        return torch.from_numpy(b).to(dev)
    tb, tl = bank(10000, 1000), bank(1000, 256)
    v, vl = 0.5 * (tb[3] + tb[9]), tl[11].clone()
    mask = torch.from_numpy(rng.random(512) < 0.1).to(dev)
    mask_l = mask & torch.from_numpy(rng.random(512) < 0.7).to(dev)
    n0 = V.BOW_SCORE.launches
    k = V.bow_score_pair(v, tb, mask, vl, tl, mask_l)
    assert V.BOW_SCORE.launches == n0 + 1
    k2 = V.bow_score_pair(v, tb, mask, vl, tl, mask_l)
    p = V.score_pair_plain(v, tb, mask, vl, tl, mask_l)
    none = V.bow_score(v, tb, torch.zeros_like(mask))
    torch.cuda.synchronize()
    assert float((k - p).abs().max()) <= 1e-6 and torch.equal(k, k2)
    assert bool((k[0][~mask] == -1).all()) and bool((k[1][~mask_l] == -1)
                                                   .all())
    assert bool((k[0][mask] > -0.5).all()) and bool((none == -1).all())
    assert torch.equal(k[0], V.bow_score(v, tb, mask))


def test_bow_score_disjoint_bags_tie(dev):
    """A query against 512 bags that share no word with it: DBoW2's score
    is exactly 0 there (it sums over the shared words only), and
    `KeyFrameDatabase` keeps a row where the score is above 0, so the
    kernel and the plain version (on the CPU and on the card) must both
    give exactly 0 on every row, with equal keep decisions; the same
    bank's rows that share a word with a second query keep the kernel's
    bits on a second launch and lie within 1e-6 of the plain version."""
    from plvio_tpu_torch.models import vocabulary as V
    rng = np.random.default_rng(8)
    W = 10000
    b = np.zeros((513, W), np.float32)
    for r in range(513):
        lo = 0 if r == 0 else W // 2
        np.add.at(b[r], rng.integers(lo, lo + W // 2, 1000), 1.0)
        b[r] /= b[r].sum()
    v, bank = torch.from_numpy(b[0]), torch.from_numpy(b[1:])
    mask = torch.ones(512, dtype=torch.bool)
    k = V.bow_score(v.to(dev), bank.to(dev), mask.to(dev)).cpu()
    pc = V.bow_score(v, bank, mask)
    pd = V.score_plain(v.to(dev), bank.to(dev), mask.to(dev)).cpu()
    for name, s in (("kernel", k), ("CPU plain", pc), ("card plain", pd)):
        assert bool((s == 0).all()), f"{name}: {int((s != 0).sum())} rows " \
            f"of 512 not exactly 0 (in [{float(s.min()):.2e}, " \
            f"{float(s.max()):.2e}])"
    assert torch.equal(k > 0, pc > 0) and torch.equal(k > 0, pd > 0)
    q = bank[7].clone().to(dev)
    ks = V.bow_score(q, bank.to(dev), mask.to(dev))
    ks2 = V.bow_score(q, bank.to(dev), mask.to(dev))
    ps = V.score_plain(q.cpu(), bank, mask)
    torch.cuda.synchronize()
    assert torch.equal(ks, ks2) and bool((ks > 0).all())
    assert float((ks.cpu() - ps).abs().max()) <= 1e-6


def test_hamming_matrix_mode_matches_plain(dev):
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (1024, 8)).astype(
        np.int32))
    b = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (700, 8)).astype(
        np.int32))
    assert torch.equal(M.hamming_dist(a.to(dev), b.to(dev)).cpu(),
                       M.hamming_dist_plain(a, b))


# ---------------------------------------------------------------------------
# slice 11: the rectified pair's matchers and the stereo solver rows
# ---------------------------------------------------------------------------

BF = 0.11 * K.fx


def test_stereo_match_modes_identical(dev):
    """`match_stereo` (mode 4) and `match_stereo_lines` (mode 5) bit-equal
    to their plain versions on the card, on synthetic sets and on the
    features of a rendered full-width pair."""
    from plvio_tpu_torch.inputs import build_stereo_replay
    from plvio_tpu_torch.kernel_digest import (stereo_line_case,
                                               stereo_point_case)
    from plvio_tpu_torch.ops import stereo as ST
    from plvio_tpu_torch.ops.lines import LineExtractor
    cases = [("points", stereo_point_case(dev)),
             ("lines", stereo_line_case(dev))]
    S = build_stereo_replay(n_frames=1)
    orb = FE.OrbExtractor(FE.make_level_specs(480, 752, 1000, 8)).to(dev)
    lines = LineExtractor(256, levels=2).to(dev)
    views = [torch.from_numpy(S[k][0]).to(dev) for k in ("frames", "right")]
    with torch.no_grad():
        fl, fr = (orb(v) for v in views)
        ll, lr = (lines(v) for v in views)
    cases.append(("points", (fl.uv.contiguous(), fl.desc, fl.octave,
                             fl.valid, fr.uv.contiguous(), fr.desc,
                             fr.octave, fr.valid)))
    cases.append(("lines", (ll.ep.contiguous(), ll.desc,
                            ll.angle.contiguous(), ll.valid,
                            lr.ep.contiguous(), lr.desc,
                            lr.angle.contiguous(), lr.valid)))
    for kind, case in cases:
        if kind == "points":
            k = ST.match_stereo(*case, BF)
            p = ST.match_stereo_plain(*case, BF)
        else:
            k = ST.match_stereo_lines(*case, BF)
            p = ST.match_stereo_lines_plain(*case, BF)
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            assert torch.equal(a, b), kind
        assert int(k[2].sum()) >= 5, kind
    assert ST.STEREO_MATCH_POINTS.launches >= 2
    assert ST.STEREO_MATCH_LINES.launches >= 2


def test_pose_irls_stereo_matches_float64(dev):
    """`pose_irls` with the u_R column against float64 runs of its plain
    version: within 2x the plain float32 runs' distance (over
    `KN.FLOAT32_ORDERS` row orders) + 1e-6, the same bits on three
    launches, inliers within max(2, 1%)."""
    from plvio_tpu_torch.kernel_digest import pose_case
    *args, ur = pose_case(dev, 128, stereo=True)[1:]
    n0 = KN.POSE_IRLS_STEREO.launches
    out = KN.pose_irls_against_float64(K, args, ur, BF)
    assert not out["failures"], out
    assert KN.POSE_IRLS_STEREO.launches == n0 + 3


@pytest.mark.parametrize("have_prior", [True, False])
def test_vi_pose_lm_stereo_matches_float64(dev, have_prior):
    """`vi_pose_lm` with the stereo term against float64 runs of its plain
    version (`pose_irls_stereo`'s rule, on pose, velocity and biases), on
    kernel_digest.py's VI case with a u_R column."""
    from plvio_tpu_torch.kernel_digest import vi_case
    _, *args, ur = vi_case(dev, stereo=True)
    n0 = KN.VI_POSE_LM_STEREO.launches
    out = KN.vi_pose_lm_against_float64(K, args, have_prior, ur, BF)
    assert not out["failures"], out
    assert KN.VI_POSE_LM_STEREO.launches == n0 + 3


# --------------------------------------------------------------------------
# Slice 12: the pose LM (stereo, KB8) and the KB8 modes of undistort,
# proj_match and ba_linearize; the plain mapping path's sums
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kb8", [False, True])
def test_pose_lm_matches_float64(dev, kb8):
    """`pose_lm` (stereo: 1500 rows, u_R on two thirds; KB8: 2048 rows of
    a wide-angle cloud; both with 20% outliers) against float64 runs of
    its plain version: within 2x the plain float32 runs' distance (over
    `KN.FLOAT32_ORDERS` row orders) + 1e-6 a pose entry, the same bits on
    three launches, inliers within max(2, 1%)."""
    from plvio_tpu_torch.kernel_digest import kb8_lm_case, stereo_lm_case
    args = kb8_lm_case(dev) if kb8 else stereo_lm_case(dev)
    kern = KN.POSE_LM_KB8 if kb8 else KN.POSE_LM_STEREO
    n0 = kern.launches
    out = KN.pose_lm_against_float64(args, kb8)
    print(f"pose_lm kb8={kb8}: from float64 kernel {out['kernel']:.2e}, "
          f"plain float32 {out['plain']:.2e}; inliers {out['n']} / "
          f"{out['n64']}")
    assert not out["failures"], out
    assert kern.launches == n0 + 3


def test_undistort_kb8_matches_plain(dev):
    """The KB8 mode of `undistort` against `kb8_undistort_pixels` on the
    card on a 40 x 25 grid of raw pixels over the image: within 1e-4 px
    (the same float32 operations in the same order; tan and atan are the
    card's in both)."""
    from plvio_tpu_torch.config import CameraConfig
    from plvio_tpu_torch.inputs import KB8_INTRINSICS, KB8_K
    from plvio_tpu_torch.ops import cameras as CAM
    cam = CAM.make_camera(CameraConfig(model="kb8", dist=KB8_K,
                                       **KB8_INTRINSICS))
    u, v = np.meshgrid(np.linspace(0, 751, 40), np.linspace(0, 479, 25))
    kp = torch.from_numpy(np.stack([u.ravel(), v.ravel()], -1).astype(
        np.float32)).to(dev)
    n0 = CAM.UNDISTORT_KB8.launches
    kk, _, _ = CAM.undistort(cam, kp, None)
    pk = CAM.kb8_undistort_pixels(cam, kp)
    torch.cuda.synchronize()
    assert CAM.UNDISTORT_KB8.launches == n0 + 1
    d = float((kk - pk).abs().max())
    print(f"undistort kb8: kernel - plain {d:.2e} px, bit-equal "
          f"{torch.equal(kk, pk)}")
    assert d <= 1e-4
    assert torch.equal(CAM.undistort_pixels(cam, kp), kk)


@pytest.mark.parametrize("mode", ["fuse", "tracker"])
def test_proj_match_kb8_matches_plain(dev, mode):
    """`proj_match`'s KB8 mode on `inputs.build_projection_case(kb8=True)`
    in the fuse's mode and the tracker's (range gate; the normal is not
    read): uv_m, pt_feat, matched and feat_pt identical to the plain
    version on the card."""
    from plvio_tpu_torch.inputs import build_projection_case, kb8_camera
    c = {k: _np_t(v, dev) for k, v in build_projection_case(
        kb8=True).items()}
    args = [c[k] for k in ("pose", "pt_xyz", "pt_desc", "pt_valid",
                           "feat_uv", "feat_desc", "feat_octave",
                           "feat_valid")]
    fr = (c["pt_normal"], c["pt_min_dist"], c["pt_max_dist"]) \
        if mode == "tracker" else (None, None, None)
    rk = (2.0, 50.0) if mode == "fuse" else (6.0, 80.0)
    K8 = kb8_camera()
    n0 = KN.PROJ_MATCH_KB8.launches
    ok_ = KN.proj_match(K8, *args, *rk, *fr)
    op_ = KN.proj_match_plain(K8, *args, *rk, *fr)
    torch.cuda.synchronize()
    assert KN.PROJ_MATCH_KB8.launches == n0 + 1
    for a, b in zip(ok_, op_):
        assert torch.equal(a, b)
    assert int(ok_[2].sum()) >= 150


def test_local_ba_kb8_kernel_as_close_to_float64_as_plain(dev):
    """`make_local_ba` with the KB8 lens (`inputs.build_kb8_window`, 16
    KF, perturbed start): the kernel path's KF poses within 2x the CPU
    plain run's distance to the plain engine in float64, inlier masks
    equal to the card's plain path's."""
    from plvio_tpu_torch.inputs import build_kb8_window, kb8_camera
    K8 = kb8_camera()
    A = build_kb8_window(device="cpu")
    args = list(A.values())
    ref = KN.local_ba_plain(K8, *[a.double() if a.is_floating_point()
                                  else a for a in args])[0]
    card = [a.to(dev) for a in args]

    def gap(out):
        return float((out[0].cpu().double() - ref).abs().max())
    n0 = KN.BA_LINEARIZE_KB8.launches
    with torch.no_grad():
        ok_ = KN.local_ba(K8, *card)
        op_ = KN.local_ba_plain(K8, *card)
        gk, gp = gap(ok_), gap(op_)
        gc = gap(KN.local_ba_plain(K8, *args))
    torch.cuda.synchronize()
    print(f"KB8 BA, KF poses from the float64 run: kernel {gk:.2e}, plain "
          f"on the card {gp:.2e}, plain on the CPU {gc:.2e}")
    assert KN.BA_LINEARIZE_KB8.launches > n0
    assert gk <= 2 * gc
    assert torch.equal(ok_[2], op_[2])


def test_mapping_step_plain_path_is_deterministic(dev):
    """The plain mapping path on the card sums its normal equations by
    sorted segment sums (solver/engine.py `accumulate`): three runs of the
    typical mapping step from the perturbed start give the same bits, and
    the kernel path's KF poses lie within 1e-4 of them."""
    from plvio_tpu_torch.entry import MAPPING_TYPICAL, mapping_step
    from plvio_tpu_torch.inputs import perturb_window
    step, A = mapping_step(**MAPPING_TYPICAL, device=dev)
    plain, _ = mapping_step(**MAPPING_TYPICAL, device=dev, plain=True)
    P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                          A["pt_xyz"].cpu().numpy())
    A["kf_poses"] = torch.from_numpy(P).to(dev)
    A["pt_xyz"] = torch.from_numpy(X).to(dev)
    with torch.no_grad():
        ok_ = step(A)
        runs = [plain(A) for _ in range(3)]
    torch.cuda.synchronize()
    for o in runs[1:]:
        for a, b in zip(o, runs[0]):
            if torch.is_tensor(a):
                assert torch.equal(a, b)
    d = float((ok_.kf_poses - runs[0].kf_poses).abs().max())
    print(f"typical perturbed: kernel - card plain KF poses {d:.2e}")
    assert d <= 1e-4


# --------------------------------------------------------------------------
# Slice 13: the body-frame KB8 and KB8 + lines modes of ba_linearize, the
# line-only families of pose_lm and the line-only mode of ba_linearize
# (schur_solve with no point blocks), undistort's KB8 endpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [1, 2, 3])
def test_pose_lm_line_families_match_float64(dev, mode):
    """`pose_lm`'s line family of SLAM mode 1, 2, 3 on
    `inputs.build_line_pose_case` (cap 256, 160 valid lines, 10% 30 px
    outliers) against float64 runs of its plain version: within 2x the
    plain float32 runs' distance + 1e-6 a pose entry, the same bits on
    three launches, inliers within max(2, 1%)."""
    from plvio_tpu_torch.entry import K_EUROC
    from plvio_tpu_torch.inputs import build_line_pose_case
    args, _ = build_line_pose_case(device=dev)
    n0 = KN.POSE_LM_LINE.launches
    out = KN.line_pose_lm_against_float64(K_EUROC, mode, args)
    print(f"pose_lm line mode {mode}: from float64 kernel "
          f"{out['kernel']:.2e}, plain float32 {out['plain']:.2e}; inliers "
          f"{out['n']} / {out['n64']}")
    assert not out["failures"], out
    assert KN.POSE_LM_LINE.launches == n0 + 3


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_local_ba_lines_only_matches_float64(dev, mode):
    """`make_local_ba_lines_only` (ba_linearize's line-only mode, schur_solve
    with no point blocks) on `inputs.build_line_window` (16 KF x 512 line
    slots x 1024 observations) against the plain engine in float32 and
    float64 on the CPU: KF poses and endpoints within 2x the plain float32
    runs' distance (over `KN.FLOAT32_ORDERS` observation orders) + 1e-6,
    the same bits on three launches."""
    from plvio_tpu_torch.entry import K_EUROC
    from plvio_tpu_torch.inputs import build_line_window
    A = build_line_window(device=dev)
    n0 = KN.BA_LINEARIZE_LINE_ONLY.launches
    with torch.no_grad():
        out = KN.against_float64(
            lambda *a: KN.local_ba_lines_only(K_EUROC, mode, *a),
            lambda *a: KN.local_ba_lines_only_plain(K_EUROC, mode, *a),
            list(A.values()), (0, 1), rows=KN.LINES_ONLY_ROWS)
    print(f"line-only BA mode {mode}: from float64 kernel "
          f"{out['kernel']:.2e}, plain float32 {out['plain']:.2e}")
    assert KN.BA_LINEARIZE_LINE_ONLY.launches > n0
    assert not out["failures"], out


@pytest.mark.parametrize("lines", [False, True])
def test_local_inertial_ba_kb8_matches_float64(dev, lines):
    """The inertial window BA with the KB8 lens (ba_linearize's body-frame
    KB8 mode) on `inputs.build_inertial_window(kb8=True)` at the half
    bucket (16 KF, 2048 points / 4096 observations, with 256 lines / 512
    or none), perturbed start: pose, velocity and biases within
    2x the plain float32 runs' distance to float64 (over
    `KN.FLOAT32_ORDERS` observation orders) + 1e-6, the same bits
    on three launches (the keyframe states: a landmark that loses its
    observations to the gate drifts by metres in either run, the pinhole
    window's as well)."""
    from plvio_tpu_torch.inputs import build_inertial_window, kb8_camera
    K8 = kb8_camera()
    A = build_inertial_window(2048, 4096, 256 if lines else 0,
                              512 if lines else 0, perturbed=True,
                              device=dev, kb8=True)
    keys = KN.LIBA_KEYS if lines else KN.LIBA_KEYS[:18]
    Rcb, tcb = A["Rcb"].cpu(), A["tcb"].cpu()
    n0 = KN.BA_LINEARIZE_KB8_BODY.launches
    with torch.no_grad():
        out = KN.against_float64(
            lambda *a: KN.local_inertial_ba(K8, Rcb, tcb, 9.81, *a),
            lambda *a: KN.local_inertial_ba_plain(
                K8, Rcb.to(a[0].dtype), tcb.to(a[0].dtype), 9.81, *a),
            [A[k] for k in keys], (0, 1, 2, 3),
            rows=KN.LIBA_ROWS if lines else KN.LIBA_ROWS[:1])
    print(f"KB8 inertial window lines={lines}: from float64 kernel "
          f"{out['kernel']:.2e}, plain float32 {out['plain']:.2e}")
    assert KN.BA_LINEARIZE_KB8_BODY.launches > n0
    assert not out["failures"], out


def test_schur_solve_global_path_kb8(dev):
    """The 64-KF inertial window with the KB8 lens (S = 960, the global
    path): one Schur step against the plain engine's in float64, the rule
    of `test_schur_solve_global_path`."""
    n0 = KN.BA_LINEARIZE_KB8_BODY.launches
    r = KN.global_solve_against_float64("inertial", 64, dev, kb8=True)
    print(r.summary())
    assert r.path == 1 and KN.BA_LINEARIZE_KB8_BODY.launches > n0
    assert not r.failures(), r.failures()


def test_local_ba_pl_kb8_matches_float64(dev):
    """`make_local_ba_pl` with the KB8 lens (the point edges through it,
    the line edges on its pinhole fx, fy, cx, cy) on
    `inputs.build_kb8_window(n_ln=256, n_lobs=512)`: poses, points and
    endpoints within 2x the plain float32 runs' distance to float64 (over
    `KN.FLOAT32_ORDERS` observation orders) + 1e-6, the same bits on
    three launches."""
    from plvio_tpu_torch.inputs import build_kb8_window, kb8_camera
    K8 = kb8_camera()
    A = build_kb8_window(device=dev, n_ln=256, n_lobs=512)
    n0 = KN.BA_LINEARIZE_KB8_LINES.launches
    with torch.no_grad():
        out = KN.against_float64(
            lambda *a: KN.local_ba_pl(K8, *a),
            lambda *a: KN.local_ba_pl_plain(K8, *a), list(A.values()),
            (0, 1, 2), rows=KN.BA_ROWS)
    print(f"KB8 point+line window: from float64 kernel {out['kernel']:.2e},"
          f" plain float32 {out['plain']:.2e}")
    assert KN.BA_LINEARIZE_KB8_LINES.launches > n0
    assert not out["failures"], out


def test_undistort_kb8_endpoints_match_plain(dev):
    """`undistort`'s KB8 mode with segments (the fisheye System with
    lines): keypoints bit-equal to the keypoint-only launch, endpoints
    within 1e-4 px of the plain version, the line equations as
    `test_undistort_matches_plain` holds them (against line_equation of
    the kernel's endpoints: (a, b) within 1e-6, c within 1e-6 of its
    products' scale)."""
    from plvio_tpu_torch.config import CameraConfig
    from plvio_tpu_torch.inputs import KB8_INTRINSICS, KB8_K
    from plvio_tpu_torch.ops import cameras as CAM
    cam = CAM.make_camera(CameraConfig(model="kb8", dist=KB8_K,
                                       **KB8_INTRINSICS))
    u, v = np.meshgrid(np.linspace(0, 751, 40), np.linspace(0, 479, 25))
    kp = torch.from_numpy(np.stack([u.ravel(), v.ravel()], -1).astype(
        np.float32)).to(dev)
    ep = torch.from_numpy(np.random.default_rng(6).uniform(
        [0, 0, 0, 0], [751, 479, 751, 479], (256, 4)).astype(
            np.float32)).to(dev)
    kk, ek, lk = CAM.undistort(cam, kp, ep)
    k0 = CAM.undistort(cam, kp, None)[0]
    _, ep_, lp = CAM.undistort_frame_plain(cam, kp, ep)
    torch.cuda.synchronize()
    from plvio_tpu_torch.ops.lines import line_equation
    own = line_equation(ek)
    de, dl = float((ek - ep_).abs().max()), float((lk - own).abs().max())
    print(f"undistort kb8 endpoints: {de:.2e} px, line equations against "
          f"line_equation of the kernel's endpoints {dl:.2e}")
    assert torch.equal(kk, k0) and de <= 1e-4
    assert float((lk[:, :2] - own[:, :2]).abs().max()) <= 1e-6
    scale = (ek[:, 0] * ek[:, 3]).abs() + (ek[:, 1] * ek[:, 2]).abs()
    n = torch.linalg.vector_norm(ek[:, 2:] - ek[:, :2], dim=1)
    assert bool(((lk[:, 2] - own[:, 2]).abs() <= 1e-6 * scale / n).all())


def test_pose_irls_nan_line_rows_as_plain(dev):
    """`pose_irls` with gated-off line rows whose equations are NaN (a KB8
    frame's padded segments undistort to NaN, and the line matcher hands
    those to its unmatched rows): the Huber weight is NaN, 0 x NaN poisons
    the normal equations as in the reference (jnp.maximum / minimum), so
    the kernel returns a NaN pose and no inliers, as its plain version;
    with finite rows the kernel keeps its bits (the case of
    `test_pose_irls_matches_plain`, kernel_digest's `pose_irls mono`)."""
    from plvio_tpu_torch.kernel_digest import pose_case
    K_, *a = pose_case(dev, 64)
    a[8] = torch.zeros_like(a[8])                 # no line matched
    a[5] = torch.full_like(a[5], float("nan"))    # NaN equations
    pk = KN.pose_irls(K_, *a)
    pp = KN.pose_irls_plain(K_, *a)
    torch.cuda.synchronize()
    assert bool(torch.isnan(pp[0]).all()) and int(pp[3]) == 0
    assert bool(torch.isnan(pk[0]).all()) and int(pk[3]) == 0


def _slice13_linearization(case, dev):
    """(_BAWork, plain problem, states) of one slice-13 window BA mode at
    the path's shape, its kernel path's buffers at the window's start."""
    from plvio_tpu_torch.entry import K_EUROC, LIBA_WORST
    from plvio_tpu_torch.inputs import (build_inertial_window,
                                        build_kb8_window, build_line_window,
                                        kb8_camera)
    K8 = kb8_camera()
    if case == "kb8_body":
        A = build_inertial_window(**LIBA_WORST, perturbed=True, device=dev,
                                  kb8=True)
        a = [A[k] for k in KN.LIBA_KEYS]
        w = KN.inertial_work(K8, A["Rcb"].cpu(), A["tcb"].cpu(), 9.81, *a)
        w.chain(KN.CHAIN_COST_STATE)
        prob = KN._liba_problem(
            K8, A["Rcb"], A["tcb"], 9.81, 16, LIBA_WORST["n_pt"],
            LIBA_WORST["n_ln"], (a[8].long(), a[9].long(), a[10], a[12]),
            a[11], (a[20].long(), a[21].long(), a[22]), a[23],
            (a[13], a[14], a[15], a[16], a[17]))
        prob.terms = [t for t in prob.terms if t.name in ("reproj", "line")]
        return w, prob, {"pose": a[0], "vel": a[1], "bg": a[2], "ba": a[3],
                         "pt": a[6], "ln": a[18]}
    if case == "kb8_lines":
        a = list(build_kb8_window(device=dev, n_ln=256, n_lobs=512).values())
        w = KN._BAWork(K8, *a, lam0=1e-4, early_tol=1e-2, cg_iters=48)
        prob = KN._ba_problem(K8, 16, a[2].shape[0], 256, a[4].long(),
                              a[5].long(), a[6], a[7], a[8], a[11].long(),
                              a[12].long(), a[13], a[14], a[15])
        return w, prob, {"pose": a[0], "pt": a[2], "ln": a[9]}
    mode = int(case[-1])
    a = list(build_line_window(device=dev).values())
    w = KN.lines_only_work(K_EUROC, mode, *a)
    prob = KN._lines_only_problem(K_EUROC, 16, a[2].shape[0], a[4].long(),
                                  a[5].long(), a[6], a[7], a[8], a[9], mode)
    return w, prob, {"pose": a[0], "ln": a[2]}


@pytest.mark.parametrize("case", ["kb8_body", "kb8_lines", "line_only_1",
                                  "line_only_2", "line_only_3"])
def test_slice13_linearization_matches_plain_engine(dev, case):
    """One linearization of each slice-13 mode of `ba_linearize` (the
    body-frame KB8 mode on the worst inertial bucket with lines, the KB8
    point edge beside the line family, the line-only mode's edge sets of
    SLAM modes 1, 2, 3) against the plain engine's normal equations of the
    same terms: the pose blocks, g, Hpp, gp and the couplings B within
    1e-4 relative (`KN.linearization_against_plain`), as chip_smoke.py
    phase 17 holds them."""
    counter = {"kb8_body": KN.BA_LINEARIZE_KB8_BODY,
               "kb8_lines": KN.BA_LINEARIZE_KB8_LINES}.get(
                   case, KN.BA_LINEARIZE_LINE_ONLY)
    n0 = counter.launches
    with torch.no_grad():
        w, prob, st = _slice13_linearization(case, dev)
        errs = KN.linearization_against_plain(w, prob, st)
    torch.cuda.synchronize()
    print(f"{case}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert counter.launches == n0 + 2
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("image", ["segments", "flat"])
def test_line_detect_ed_matches_plain(dev, image):
    """line_detect_ed against its plain version at both pyramid levels,
    stage by stage (`ops.lines.ed_against_plain`): the bf16 gradients and
    magnitude and the cells' candidate anchors bit-equal, no walk
    different, the outputs bit-equal (so the segment sets agree); three
    launches give the same bits; the flat image gives no segment."""
    from plvio_tpu_torch.ops import lines as LN
    img = _segments(dev, 480, 752, 80) if image == "segments" \
        else torch.full((480, 752), 77.0, device=dev)
    n0 = LN.LINE_DETECT_ED.launches
    for lv, (im, n) in enumerate(((img, 192),
                                  (FE.line_level(img), 64))):
        r = LN.ed_against_plain(im, n)
        k, p = r["kernel"], r["plain"]
        print(f"{image} level {lv}: {int(k[3].sum())} segments, "
              f"{r['walks_differ']} of {r['n_walks']} walks differ")
        assert r["grads"] and r["mag"] and r["cells"], (lv, r)
        assert r["walks_differ"] == 0 and r["same"], (lv, r)
        assert _sets_agree(k[0], k[3], p[0], p[3])
        again = [LN.line_detect_ed(im, n) for _ in range(2)]
        for a in again:
            assert all(torch.equal(x, y) for x, y in zip(a[:4], k[:4]))
            assert torch.equal(a[4][0], k[4][0])
        if image == "flat":
            assert not bool(k[3].any())
        else:
            assert int(k[3].sum()) >= 10
    assert LN.LINE_DETECT_ED.launches == n0 + 6


def test_line_extractor_ed_matches_plain(dev):
    """The whole pyramid under detector 1, kernel path against plain path:
    the segment sets as `_sets_agree`, the kernel path the same on every
    run."""
    from plvio_tpu_torch.ops import lines as LN
    img = _segments(dev, 480, 752, 80)
    pk = LN.LineExtractor(256, 2, detector=1).to(dev)(img)
    pp = LN.LineExtractor(256, 2, plain=True, detector=1).to(dev)(img)
    torch.cuda.synchronize()
    assert int(pk.valid.sum()) >= 10
    assert _sets_agree(pk.ep, pk.valid, pp.ep, pp.valid)
    again = LN.LineExtractor(256, 2, detector=1).to(dev)(img)
    assert all(torch.equal(a, b) for a, b in zip(pk, again))


def test_prior_relocalizer_aligns_as_plain(dev, tmp_path):
    """The prior-map relocalizer on the card (ORB, the bag, the Hamming
    matrix and PnP kernels) against its plain run on the CPU on a
    hand-made live map of the synthetic prior set
    (`inputs.place_prior_keyframes`), both with the same RANSAC samples:
    the same prior frames tried with the same matches, T_prior_from_live
    within 2x the CPU float32 run's distance to a float64 run of the plain
    PnP + 1e-5 (the kernels solve in float64), the relocalized poses
    within 1e-4."""
    from plvio_tpu_torch.config import CameraConfig, RelocConfig, \
        SystemConfig
    from plvio_tpu_torch.inputs import build_prior_set, place_prior_keyframes
    from plvio_tpu_torch.models import vocabulary as V
    from plvio_tpu_torch.models.mapstore import Atlas, MapStore
    from plvio_tpu_torch.models.relocalization import PriorMapRelocalizer
    from plvio_tpu_torch.ops import pnp as PNP
    build_prior_set(tmp_path)
    cfg = SystemConfig(camera=CameraConfig(
        width=640, height=480, fx=518.0, fy=519.0, cx=325.5, cy=253.5,
        dist=()), reloc=RelocConfig(enabled=True))
    voc = V.default_vocabulary("orb")
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        r = PriorMapRelocalizer(cfg, Atlas([MapStore(max_kf=16,
                                                     n_feat=1000)]),
                                voc, 1000, device=d)
        g = torch.Generator().manual_seed(5)
        r.sampler = lambda v, g=g: torch.multinomial(
            torch.from_numpy(v).double().expand(128, -1), 6, generator=g)
        r.load_prior_dir(str(tmp_path))
        rec = []
        pnp = r._pnp

        def recording(K, uv, X, v, s, _pnp=pnp, _rec=rec):
            _rec.append((uv.cpu(), X.cpu(), v.cpu(), s.cpu()))
            return _pnp(K, uv, X, v, s)
        r._pnp = recording
        with torch.no_grad():
            for i, kf in enumerate(place_prior_keyframes(r.atlas.current,
                                                         r.prior_frames)):
                r.process_keyframe(kf, float(i))
        torch.cuda.synchronize()
        runs[name] = (r, rec)
    (rc, kc), (rp, kp) = runs["card"], runs["cpu"]
    assert rc.T_prior_from_live is not None \
        and rp.T_prior_from_live is not None
    tried = [[(a["prior"], a["matches"]) for a in t] for t in rc.attempts]
    assert tried == [[(a["prior"], a["matches"]) for a in t]
                     for t in rp.attempts]
    assert len(kc) == len(kp) >= 1
    uv, X, v, s = kp[-1]
    K = rp.K
    res = PNP.pnp_ransac_plain(K, uv.double(), X.double(), v, s)
    R64, t64, _, _ = PNP.mlpnp_refine_plain(K, uv.double(), X.double(),
                                            res.inliers, res.R, res.t)
    m = rp.atlas.current
    R_wc = R64.numpy().T
    T64 = np.concatenate([R_wc @ m.kf_pose_cw[rp.aligned_kf, :, :3],
                          (R_wc @ m.kf_pose_cw[rp.aligned_kf, :, 3]
                           - R_wc @ t64.numpy())[:, None]], 1)
    gap = np.abs(rc.T_prior_from_live - rp.T_prior_from_live).max()
    ref = np.abs(rp.T_prior_from_live - T64).max()
    print(f"T_prior_from_live: card - CPU {gap:.2e}, CPU - float64 "
          f"{ref:.2e}")
    assert gap <= 2 * ref + 1e-5
    for t, T in rp.relocalized_poses.items():
        assert np.abs(rc.relocalized_poses[t] - T).max() <= 1e-4


def test_sharded_window_matches_plain_mesh(dev):
    """The landmark-sharded inertial window (`entry.dist_window`, 8 KF x
    512 points) on 2 shards of the card against the plain version on a
    2-shard CPU mesh: poses within 1e-4, the same bits on a second run;
    every solve through schur_reduce and schur_solve_reduced."""
    from plvio_tpu_torch.entry import dist_window
    sz = dict(n_pt=512, n_obs=1024, n_ln=32, n_lobs=64, n_kf=8,
              n_observers=3)
    step, W, _ = dist_window(2, device=dev, sizes=sz)
    plain, _, _ = dist_window(2, device="cpu", sizes=sz)
    KN.SCHUR_REDUCE.launches = KN.SCHUR_SOLVE_REDUCED_CG.launches = 0
    a, b = step(W), step(W)
    assert KN.SCHUR_REDUCE.launches > 0
    assert KN.SCHUR_SOLVE_REDUCED_CG.launches > 0
    p = plain(W)
    assert all(np.array_equal(x, y) for x, y in zip(a[:5], b[:5]))
    assert np.abs(a[0] - p[0]).max() < 1e-4


def test_dist_ba_and_chain_ba_match_plain_mesh(dev):
    """dist_ba and chain_ba on 2 shards of the card (schur_reduce in raw
    mode, schur_solve_reduced's Cholesky) against their plain versions on
    a 2-shard CPU mesh: poses within 1e-4, points within 1e-3."""
    from plvio_tpu_torch.entry import chain_ba_step, dist_ba_step
    for make in (dist_ba_step, chain_ba_step):
        out = make(2, device=dev)
        ref = make(2, device="cpu")
        k = out[0](out[1])
        p = ref[0](ref[1])
        assert float((k[0].cpu() - p[0]).abs().max()) < 1e-4
        assert float((k[1].cpu() - p[1]).abs().max()) < 1e-3


# kernel_digest.py's lines on the kernels before the redesign of
# vi_pose_lm and line_detect (the `ed` and `slice19` modes, and the stereo
# VI case); the redesigned kernels keep every bit
PARENT_SLICE19 = {
    "vi_pose_lm have_prior=True": "37ea30a8a290d2c88c800dd7a3a51f93",
    "vi_pose_lm have_prior=False": "6f78a10c419546a19ef6a4f638b18a58",
    "vi_pose_lm stereo have_prior=True": "fee3602579827a00d96a65ede7505daa",
    "vi_pose_lm stereo have_prior=False": "e748b89f234ebab035c4d8ba0162fada",
    "vi_pose_lm nan_prior have_prior=True": "a97a835666220fe57a456e3bebe344e1",
    "line_detect level=0": "548bcb898ec742bac683a5a282cb9208",
    "line_detect level=1": "e19e562cb2f6620920f02faa7d364d2c",
    "line_detect_ed level=0": "2f72c9bf43c94b16a079af0744a24e6a",
    "line_detect_ed level=1": "06e2324b7407c6db86fcbd2fce6af0a0",
    "line_detect 480x752 n=192": "24ec7ea3814d46fad4a9457c7a9b4f3c",
    "line_detect 240x376 n=64": "a47e48c7a19786073da004a3ac416403",
    "line_detect 237x411 n=192": "fcd842cbf1a426c6bb2022181a220af9",
    "line_detect 118x205 n=64": "cd913977fab1ce4c1c44a85e63ffd9a1"}


def _digest_lines(lines):
    return dict(line.rsplit(" ", 1) for line in lines)


def test_vi_pose_lm_keeps_parent_digests(dev):
    """vi_pose_lm, mono and stereo, with and without the prior, and with
    a NaN prior (every iteration runs), gives the bits of the kernel
    before its redesign."""
    from plvio_tpu_torch import kernel_digest as KD
    got = {}
    case, stereo = KD.vi_case(dev), KD.vi_case(dev, stereo=True)
    for hp in (True, False):
        got[f"vi_pose_lm have_prior={hp}"] = KD.digest(KN.vi_pose_lm(*case,
                                                                      hp))
    got.update(_digest_lines(KD.vi_stereo_digests(dev)))
    got.update(_digest_lines(KD.slice19_digests(dev)[:1]))
    assert {k: v for k, v in got.items() if v != PARENT_SLICE19[k]} == {}


def test_line_detect_keeps_parent_digests(dev):
    """line_detect on a rendered room view, a rendered 480x752 frame, their
    line levels and an odd-size crop, and line_detect_ed (which shares
    csrc/lines.cuh) give the bits of the kernels before the redesign."""
    from plvio_tpu_torch import kernel_digest as KD
    got = _digest_lines(KD.ed_digests(dev) + KD.line_digests(dev))
    assert {k: v for k, v in got.items() if v != PARENT_SLICE19[k]} == {}


@pytest.mark.parametrize("size", ["480x752", "240x376", "237x411"])
def test_line_detect_levels_bit_equal_to_one_level(dev, size):
    """Both pyramid levels in one call (`line_detect_levels`, two
    launches) give bit for bit what two one-level calls give, at the
    frame's size, its line level's and an odd size; a second call on the
    same workspace gives the same bits."""
    from plvio_tpu_torch import kernel_digest as KD
    from plvio_tpu_torch.inputs import build_inputs
    from plvio_tpu_torch.ops import frontend as FE
    from plvio_tpu_torch.ops import lines as LN
    frame = torch.from_numpy(build_inputs(2, device=dev)[0][1]).to(dev)
    img = {"480x752": frame, "240x376": FE.line_level(frame),
           "237x411": frame[:237, :411].contiguous()}[size]
    img1 = FE.line_level(img)
    n0 = LN.LINE_DETECT.launches
    both = LN.line_detect_levels([img, img1], [192, 64])
    assert LN.LINE_DETECT.launches == n0 + 1
    again = LN.line_detect_levels([img, img1], [192, 64])
    one = [LN.line_detect(img, 192), LN.line_detect(img1, 64)]
    for b, a, o in zip(both, again, one):
        assert KD.digest(KD._flat(b)) == KD.digest(KD._flat(o))
        assert KD.digest(KD._flat(a)) == KD.digest(KD._flat(o))


def test_vi_run_and_line_pyramid_never_sync(dev):
    """`make_vi_pose_optimizer`'s run and the line pyramid on CUDA inputs
    make no call that synchronizes the host with the card (torch.cuda's
    sync debug mode raises on one): the extrinsics move to the card once,
    without a blocking copy, and the detector allocates nothing but its
    outputs between calls."""
    from plvio_tpu_torch import kernel_digest as KD
    from plvio_tpu_torch.ops import lines as LN
    case = KD.vi_case(dev)
    run = KN.make_vi_pose_optimizer(K, case[9].shape[0], np.eye(3),
                                    np.zeros(3), 9.81)
    uvr = torch.cat([case[8], -torch.ones_like(case[8][:, :1])], 1)
    args = case[4:8] + [uvr] + case[9:]
    ext = LN.LineExtractor(256, 2).to(dev)
    img = _segments(dev, 480, 752, n=60)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [run(*args, hp) for hp in (True, False)]
        lines = [ext(img) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for hp, o in zip((True, False), outs):
        assert KD.digest(o) == KD.digest(KN.vi_pose_lm(*case, hp))
    assert all(torch.equal(a, b) for a, b in zip(*lines))


# kernel_digest.py's lines on the kernels before the redesign of
# ba_linearize and hamming_match (the default mode's hamming_match and
# stereo_match lines, `window`, `dist` and `slice20`): the redesigned
# kernels keep every bit
PARENT_SLICE20 = {
    "mapping_step typical perturbed":
        "ffee42bd85ba709ff5f3ffbb53f13dd2",
    "inertial_ba_step worst perturbed=False":
        "0d04417e03d24acba24ab736cb8797b1",
    "inertial_ba_step worst perturbed=True":
        "818c7a613f019b9f2c46aa2149068fd3",
    "inertial_ba_step half perturbed=False":
        "47441b0135441193ee29c35bd49223de",
    "inertial_ba_step half perturbed=True":
        "7172a6fcf7e94e963a5bfe3920b5e93d",
    "local_ba pinhole points":
        "f0089d9e6cb04c42f015959d9673178f",
    "local_ba_lines_only mode=1":
        "d7c3328f9bca7a793ee9a5d1a5a60be9",
    "local_ba_lines_only mode=2":
        "c421f800f2ea623353454ca60fc8eba7",
    "local_ba_lines_only mode=3":
        "fe6af36818209809840b085db86a8848",
    "local_inertial_ba kb8 lines=False":
        "8b6507d7b6bc4b7f601af02629233313",
    "local_inertial_ba kb8 lines=True":
        "baa3cf9fc9265fab4ee42c6a6908a718",
    "local_ba_pl kb8":
        "fdb842c024a07f21501509d8fcf5793f",
    "hamming_match window 20 px 2048 x 1000":
        "d4c35a2a718a21d411b7a248b9c84e84",
    "hamming_match ungated 2048 x 1000":
        "77199435cada406a785764786c4bc9d6",
    "hamming_match line 256 x 256":
        "8aa25b36422ef912b0aff8ca362426df",
    "hamming_match line pair 256 x 256":
        "ed0e4718da43c6b75949948fb32d4869",
    "hamming_match epipolar 1024 x 1024":
        "d701b20b28e4668bae7cb011daaaa85e",
    "hamming_match stereo points 1000 x 1000":
        "1fa6b830a8d829c1e7f6ad4334e4fb86",
    "hamming_match stereo lines 256 x 256":
        "67689bba4a467036177dc73b5dae1c4d",
    "mapping_step worst perturbed":
        "5116674609416ba3d03082fd586fae26",
    "local_inertial_ba 64 KF":
        "5c7f7f316ffc97e152581cfe6162aaa6",
    "local_ba points 128 KF":
        "cc0e2f518b62cae191fbf6671ea43539",
    "dist_window D=1":
        "e3aab8c44fca108272c4bd5faec26e19",
    "dist_window D=2":
        "fecbd018767ceaf812c908edbce11952",
    "dist_window D=4":
        "a508c1f92b54cfe4a2fa0398119844c0",
    "dist_ba D=2":
        "81d6caae63c24d3fbf1f36f39fe73100",
    "chain_ba D=2":
        "b78e3a99781bbde46b3a3628e1469d4d",
    "chain_liba D=2":
        "34d6ebb967219b3d6a707887dcb0a4fd",
    "hamming_match window":
        "ca998a1ead77423fb022a08e0d0a5664",
    "hamming_match line":
        "00b9cec0d480e37091a5502e60b7a0c3",
    "hamming_match epipolar":
        "7e81bfa9c6443682a347dcfab4f64f21",
    "stereo_match points":
        "90413c996073abc73d67bf1dd8bf8cef",
    "stereo_match lines":
        "67689bba4a467036177dc73b5dae1c4d"}


def _parent_lines(lines, prefixes):
    got = _digest_lines(lines)
    return {k: v for k, v in got.items() if k.startswith(prefixes)}


def test_ba_linearize_keeps_parent_digests(dev):
    """The window BAs on ba_linearize (the mapping step at both buckets,
    the inertial windows at both buckets and starts, the pinhole point BA,
    the line-only modes, the KB8 windows, the 64-KF inertial and 128-KF
    point-only windows run whole) give the bits of the kernel before its
    redesign."""
    from plvio_tpu_torch import kernel_digest as KD
    got = _parent_lines(KD.window_digests(dev) + KD.slice20_digests(dev),
                        ("mapping_step", "inertial_ba_step", "local_"))
    assert len(got) == 15
    assert {k: v for k, v in got.items() if v != PARENT_SLICE20[k]} == {}


def test_mesh_modes_keep_parent_digests(dev):
    """ba_linearize's mesh modes (4-7) on the sharded inertial window at D
    = 1, 2, 4 and dist_ba, chain_ba and chain_liba at D = 2: the parent's
    bits."""
    from plvio_tpu_torch import kernel_digest as KD
    got = _digest_lines(KD.dist_digests(dev))
    assert len(got) == 6
    assert {k: v for k, v in got.items() if v != PARENT_SLICE20[k]} == {}


def test_hamming_match_keeps_parent_digests(dev):
    """hamming_match's window, line and epipolar modes on kernel_digest's
    tie-heavy case, every mode at the paths' shapes (the window at 20 px
    and ungated at 2048 x 1000, line and line pair at 256 x 256, epipolar
    at 1024 x 1024) and both stereo matchers: the parent's bits."""
    from plvio_tpu_torch import kernel_digest as KD
    lines = [f"hamming_match {name} {KD.digest(M.hamming_match(*a, **kw))}"
             for name, a, kw in KD.hamming_cases(dev)]
    lines += KD.stereo_digests(dev)[:2] + KD.slice20_digests(dev)
    got = _parent_lines(lines, ("hamming_match", "stereo_match"))
    assert len(got) == 12
    assert {k: v for k, v in got.items() if v != PARENT_SLICE20[k]} == {}


def _workspace_clean(dev):
    """Every matcher workspace on the card reads ticket 0 and no column's
    best (all bits set) between calls."""
    torch.cuda.synchronize()
    for ws in M._WORKSPACE.values():
        if ws.device.type == "cuda":
            assert int(ws[0]) == 0 and bool((ws[1:] == -1).all())


def test_back_to_back_calls_reset_their_tickets(dev):
    """Calls of different sizes back to back on one stream, each against
    its plain version (hamming_match at 2048 x 1000 ungated, then 700 x
    500, then at 2048 x 1000 again; the stereo matchers between them),
    the matcher's workspace clean after each; the mapping step at both
    buckets twice in turns, each run giving the bits of its first; and
    two window BAs of different sizes linearized and decided in turns,
    each launch's ticket back at 0 and every decision counted."""
    from plvio_tpu_torch import kernel_digest as KD
    from plvio_tpu_torch.ops import stereo as ST
    cases = {name: (fn, a, kw) for name, fn, a, kw
             in KD.hamming_stage_cases(dev)}
    small = KD.hamming_cases(dev)[0]
    plain = {"stereo points 1000 x 1000": ST.match_stereo_plain,
             "stereo lines 256 x 256": ST.match_stereo_lines_plain}
    order = ["ungated 2048 x 1000", None, "stereo points 1000 x 1000",
             "ungated 2048 x 1000", "stereo lines 256 x 256",
             "window 20 px 2048 x 1000", None]
    for name in order:
        if name is None:
            k = M.hamming_match(*small[1], **small[2])
            p = M.hamming_match_plain(*small[1], **small[2])
        else:
            fn, a, kw = cases[name]
            k = fn(*a, **kw)
            p = plain[name](*a) if name in plain else \
                M.hamming_match_plain(*a, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(k, p)), name
        _workspace_clean(dev)
    from plvio_tpu_torch.entry import (MAPPING_TYPICAL, MAPPING_WORST,
                                       mapping_step)
    steps = [mapping_step(**sz, device=dev)
             for sz in (MAPPING_TYPICAL, MAPPING_WORST)]
    runs = []
    with torch.no_grad():
        for _ in range(2):
            for step, A in steps:
                o = step(A)
                runs.append(KD.digest((o.kf_poses, o.pt_xyz, o.ln_ep6,
                                       o.inlier, o.inlier_l)))
    assert runs[:2] == runs[2:] and runs[0] != runs[1]
    works = [w for _, w in KD.ba_stage_windows(dev)[:2]]
    for w in works:
        w._keep[2][7] = -1.0             # no early exit: every launch runs
    for _ in range(4):
        for w in works:
            w.linearize(KN.BA_MODE_DECIDE)
            w.linearize(KN.BA_MODE_LINEARIZE)
    torch.cuda.synchronize()
    for w in works:
        assert float(w.t["ctrl"][7]) == 0.0
        assert int(w.t["ctrl"][4]) == 4


def test_matchers_on_empty_inputs(dev):
    """n = 0 rows: empty outputs; m = 0 columns: every row unmatched (idx
    0, ok False; the stereo outputs -1), in the point, line and stereo
    modes (the plain versions' argmin refuses an empty axis), the
    workspace clean after them.  The window BAs' empty line family (the
    point-only window) is held to the parent's bits by
    `test_ba_linearize_keeps_parent_digests`."""
    from plvio_tpu_torch import kernel_digest as KD
    from plvio_tpu_torch.ops import stereo as ST
    name, a, kw = KD.hamming_cases(dev)[1]
    for n, m in ((0, 500), (700, 0), (0, 0)):
        args = [a[0][:n], a[1][:m], a[2][:n], a[3][:m], a[4][:n], a[5][:m]]
        for kwx in (dict(radius=20.0, max_dist=80.0, ratio=0.9),
                    dict(kw, a_ang=kw["a_ang"][:n], b_ang=kw["b_ang"][:m])):
            idx, ok = M.hamming_match(*args, **kwx)
            torch.cuda.synchronize()
            assert idx.shape == ok.shape == (n,)
            assert not bool(idx.any()) and not bool(ok.any()), (n, m)
    pts = KD.stereo_point_case(dev)
    for n, m in ((0, 900), (900, 0)):
        c = [t[:n] for t in pts[:4]] + [t[:m] for t in pts[4:]]
        u, d, has = ST.match_stereo(*c, 50.0)
        torch.cuda.synchronize()
        assert u.shape == d.shape == has.shape == (n,)
        assert bool((u == -1).all() and (d == -1).all()) and not has.any()
    _workspace_clean(dev)


def test_launches_per_call(dev):
    """One LM iteration of the point+line window launches 2 ba_linearize
    kernels (the linearization, the decision; 5 before the redesign); a
    hamming_match and a stereo_match call each one kernel and no memset
    (3 stream operations before)."""
    from torch.profiler import ProfilerActivity, profile
    from plvio_tpu_torch import kernel_digest as KD
    from plvio_tpu_torch.ops import stereo as ST
    w = KD.schur_windows(dev)[0][1]
    name, a, kw = KD.hamming_cases(dev)[0]
    pts = KD.stereo_point_case(dev)
    for _ in range(2):
        M.hamming_match(*a, **kw)
        ST.match_stereo(*pts, 50.0)
    torch.cuda.synchronize()

    def ops(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    ba = [k for k in ops(w.step) if "linearize_kernel" in k
          or "cost_pass_kernel" in k or "obs_kernel" in k
          or "reduce_kernel" in k or "accept_kernel" in k]
    assert len(ba) == 2, ba
    for fn in (lambda: M.hamming_match(*a, **kw),
               lambda: ST.match_stereo(*pts, 50.0)):
        got = ops(fn)
        assert len(got) == 1 and "match_kernel" in got[0], got
