"""The nineteen CUDA kernels against their plain PyTorch versions on the card
(and schur_solve's global path, and a short keyframe sequence).

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
rounding, not the kernels.
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
    farther of the plain float32 runs' (on the card and on the CPU) plus
    a floor (printed, run with -s): the LM's last accept / reject
    decisions follow float32 noise in the cost near the optimum, which
    leaves the plain path on the card 6.5e-5 from float64 in the scale and
    the kernel 1.2e-5."""
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
    oc_ = mc.refine(Bc) if refine else mc(Bc)
    keys = list(enumerate(("Rwg", "scale", "bg", "ba", "vel")[:len(ref)]))
    gk, gp, gc = _f64_gaps((ok_, op_, oc_), ref, keys)
    print(f"refine={refine}: scale {float(ok_[1])} / {float(op_[1])} / "
          f"{float(ref[1])}; from float64: kernel {gk}, plain on the card "
          f"{gp}, plain on the CPU {gc}")
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
