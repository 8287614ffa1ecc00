"""The fourteen CUDA kernels against their plain PyTorch versions on the card.

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


@pytest.mark.parametrize("k,n_valid", [(10, 10), (10, 4), (16, 16)])
def test_imu_preint_matches_plain(dev, k, n_valid):
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
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30)
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
    from plvio_tpu_torch.entry import MAPPING_TYPICAL, mapping_step
    from plvio_tpu_torch.inputs import perturb_window
    step, A = mapping_step(**MAPPING_TYPICAL, device=dev)
    plain, _ = mapping_step(**MAPPING_TYPICAL, device=dev, plain=True)
    if perturbed:
        P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                              A["pt_xyz"].cpu().numpy())
        A["kf_poses"] = torch.from_numpy(P).to(dev)
        A["pt_xyz"] = torch.from_numpy(X).to(dev)
    n0 = KN.SCHUR_SOLVE.launches
    sk, sp = [], []
    with torch.no_grad():
        ok_ = step(A, stats=sk)
        op_ = plain(A, stats=sp)
    torch.cuda.synchronize()
    assert [int(x) for x in sk] == sp
    assert int(ok_.n_good) == int(op_.n_good)
    assert torch.equal(ok_.inlier, op_.inlier)
    assert torch.equal(ok_.inlier_l, op_.inlier_l)
    assert float((ok_.kf_poses - op_.kf_poses).abs().max()) <= 1e-4
    assert bool(torch.isfinite(ok_.pt_xyz).all())
    # the landmarks, by their reprojection in every observation (null
    # directions do not count): within 0.1 px, ~2x the pose tolerance x fx
    def residuals(o):
        return (RES.point_reproj_jac(K, o.kf_poses[A["obs_kf"].long()],
                                     o.pt_xyz[A["obs_pt"].long()],
                                     A["obs_uv"])[0],
                RES.line_reproj_jac(K, o.kf_poses[A["lobs_kf"].long()],
                                    o.ln_ep6[A["lobs_ln"].long()],
                                    A["lobs_eq"])[0])
    for rk, rp in zip(residuals(ok_), residuals(op_)):
        assert float((rk - rp).abs().max()) <= 0.1
    assert KN.SCHUR_SOLVE.launches - n0 == 16


BA_KEYS = ("kf_poses", "kf_free", "pt_xyz", "pt_free", "obs_kf", "obs_pt",
           "obs_uv", "obs_valid", "obs_is2", "ln_ep6", "ln_free", "lobs_kf",
           "lobs_ln", "lobs_eq", "lobs_valid", "lobs_is2")


@pytest.mark.parametrize("size", ["small", "typical"])
def test_local_ba_kernel_as_close_to_float64_as_plain(dev, size):
    """From the perturbed start, the float32 paths against the plain engine
    in float64 on the CPU: the kernel path's KF poses within 1.5x the
    farther of the plain path's on the card and on the CPU (the card's
    plain path sums by atomics, so its distance varies from run to run;
    all three printed, run with -s)."""
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
    assert gk <= 1.5 * max(gp, gc)


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
    """The whole window solve at the half bucket: LM iterations per round
    within one of the plain path's (the card's plain path sums by atomics,
    and its early exit at a relative cost change of 1e-2 can fire one
    iteration apart: [5, 6] against [5, 7] seen), the point and line
    inlier masks equal to its (and some observations rejected), the final
    LM cost (evaluated in float64 at both paths' results and the final
    masks) within 2% of the plain path's, as the 1e-2 exit allows; poses, velocities and accelerometer
    biases as close to the plain engine run in float64 on the CPU as 1.5x
    the farther of the plain path's float32 runs on the card and on the
    CPU (every float32 path lies ~1e-3 from float64 here: 120 fixed CG
    steps per iteration; printed, run with -s), the gyro bias (2e-3 rad/s
    here; the float32 runs 1e-7 to 1.5e-6 from float64) within 1e-5;
    landmarks reprojecting within 0.1 px of the plain path's where the
    iteration counts agree.  Without lines (the reference's default n_ln
    = 0) the same on the point-only window."""
    from plvio_tpu_torch.entry import LIBA_HALF, InertialBAOut
    A, args = _liba(dev, perturbed)
    Rcb, tcb = A["Rcb"].cpu(), A["tcb"].cpu()
    nl = len(args) if lines else 18
    sz = dict(LIBA_HALF) if lines else dict(LIBA_HALF, n_ln=0, n_lobs=0)
    step, plain = (KN.make_local_inertial_ba(
        K, 16, sz["n_pt"], sz["n_obs"], Rcb, tcb, 9.81, n_ln=sz["n_ln"],
        n_lobs=sz["n_lobs"], plain=p) for p in (False, True))
    n0 = KN.INERTIAL_CHAIN.launches
    sk, sp = [], []
    with torch.no_grad():
        ok_ = InertialBAOut(*step(*args[:nl], stats=sk))
        op_ = InertialBAOut(*plain(*args[:nl], stats=sp))
    torch.cuda.synchronize()
    assert KN.INERTIAL_CHAIN.launches > n0
    _, args64 = _liba(torch.device("cpu"), perturbed, torch.float64)
    _, args32 = _liba(torch.device("cpu"), perturbed)
    ref = KN.local_inertial_ba_plain(K, Rcb.double(), tcb.double(), 9.81,
                                     *args64[:nl])
    oc_ = KN.local_inertial_ba_plain(K, Rcb, tcb, 9.81, *args32[:nl])
    keys = [(0, "pose"), (1, "vel"), (2, "bg"), (3, "ba")]
    gk, gp, gc = _f64_gaps((ok_, op_, oc_), ref, keys)
    kp = [float((a - b).abs().max()) for a, b in zip(ok_[:4], op_[:4])]
    print(f"perturbed={perturbed}, lines={lines}: iterations "
          f"{[int(x) for x in sk]} / {sp}; inliers {int(ok_.inlier.sum())} / "
          f"{int(op_.inlier.sum())}; kernel - plain {kp}; from float64: "
          f"kernel {gk}, plain on the card {gp}, plain on the CPU {gc}")
    assert len(sk) == len(sp) == 2
    assert all(abs(int(a) - b) <= 1 for a, b in zip(sk, sp))
    assert torch.equal(ok_.inlier, op_.inlier)
    assert int((~ok_.inlier).sum()) > 0
    if lines:
        assert torch.equal(ok_.inlier_l, op_.inlier_l)
    else:
        assert ok_.ln_ep6 is None and op_.inlier_l is None
    for k in ("pose", "vel", "ba"):
        assert gk[k] <= 1.5 * max(gp[k], gc[k]) + 1e-7, k
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
    ck, cp = cost64(ok_), cost64(op_)
    print(f"final cost in float64: kernel {ck}, plain {cp}")
    assert abs(ck - cp) <= 0.02 * cp
    if [int(x) for x in sk] != sp:
        return
    Rcb, tcb = A["Rcb"], A["tcb"]

    def res(o):
        r = [RES.point_reproj_body_ba_jac(
            K, Rcb, tcb, o.pose_wb[A["obs_kf"].long()],
            o.pt_xyz[A["obs_pt"].long()], A["obs_uv"])[0]]
        if lines:
            r.append(RES.line_reproj_body_ba_jac(
                K, Rcb, tcb, o.pose_wb[A["lobs_kf"].long()],
                o.ln_ep6[A["lobs_ln"].long()], A["lobs_eq"])[0])
        return r
    for rk, rp in zip(res(ok_), res(op_)):
        assert float((rk - rp).abs().max()) <= 0.1


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
