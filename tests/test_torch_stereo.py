"""Slice 11's device stages against the JAX package on the CPU (the port's
plain versions, torch pinned to one thread).

1. `ops.stereo.match_stereo` and `match_stereo_lines` against
   plvio_tpu.ops.stereo on the port's CPU features of a rendered
   full-width pair (the room orbit's first pair: ORB, 1000 features; LBD
   segments, 256) and of the hall replay's first pair, and on the
   synthetic segments of tests/test_stereo.py:73-121 (JAX gets the same
   descriptors as +-1 bf16, the port packed): has equal on every row, u_R
   equal, depths equal to 1 ulp (both divide bf by the same float32
   disparity).
2. The point+line pose IRLS with the u_R column (`pose_irls`' plain
   version) against `fast_pose_opt_pl(ur=, bf=)` with a third of the
   points mono: the rule of tests/test_torch_pose_opt.py (rotation within
   2e-4 rad, translation within 5e-4, inliers equal but for rows whose
   chi2 lies within 1% of their gate, 7.815 stereo or 5.991 mono).
3. The VI pose optimization with the stereo term (`vi_pose_opt_plain`
   with ur, bf) against `make_vi_pose_optimizer(bf=)`, with and without
   the carried prior, within tests/test_torch_vi_pose_opt.py's bounds;
   and the stereo residual's analytic Jacobian
   (`solver.residuals.stereo_reproj_body_jac`, the kernel's formula)
   against jacrev of the residual in float64, within 1e-7 of its largest
   entry.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

from plvio_tpu.config import ImuConfig
from plvio_tpu.models import kernels as JK
from plvio_tpu.ops import imu as JI
from plvio_tpu.ops import stereo as JST
from plvio_tpu.solver.residuals import PinholeK as JPin
from plvio_tpu_torch.models import kernels as TK
from plvio_tpu_torch.ops import matching as PM
from plvio_tpu_torch.ops import stereo as ST
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.solver.residuals import PinholeK
from plvio_tpu_torch.utils import lie

KV = (458.654, 457.296, 367.215, 248.375)
BF = 0.11 * KV[0]
CAP = 256
D64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pm1(packed):
    return jnp.asarray(PM.unpack_u32_to_pm1(packed).numpy(), jnp.bfloat16)


def _j(t):
    return jnp.asarray(t.numpy())


J_MATCH = jax.jit(JST.match_stereo, static_argnames=("bf",))
J_LINES = jax.jit(JST.match_stereo_lines, static_argnames=("bf",))


def _assert_same(port, ref, depth_rows):
    """has equal on every row, the other outputs equal but depths within
    1 ulp."""
    has_p, has_j = port[2].numpy(), np.asarray(ref[2])
    np.testing.assert_array_equal(has_p, has_j)
    for k in range(2):
        a, b = port[k].numpy(), np.asarray(ref[k])
        if k in depth_rows:
            ulp = np.spacing(np.abs(b).astype(np.float32))
            assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()
        else:
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def pairs():
    """The port's CPU features of two rendered full-width pairs: the room
    orbit's first pair and the hall replay's first pair."""
    from plvio_tpu_torch.inputs import build_stereo_replay, build_stereo_room
    from plvio_tpu_torch.ops.frontend import OrbExtractor, make_level_specs
    from plvio_tpu_torch.ops.lines import LineExtractor
    orb = OrbExtractor(make_level_specs(480, 752, 1000, 8, 1.2), 20, 7)
    lines = LineExtractor(256, levels=2)
    out = {}
    for name, S in (("room", build_stereo_room(0, 1)),
                    ("hall", build_stereo_replay(n_frames=1))):
        with torch.no_grad():
            views = [torch.from_numpy(S[k][0]) for k in ("frames", "right")]
            out[name] = ([orb(v) for v in views], [lines(v) for v in views])
    return out


@pytest.mark.parametrize("name", ["room", "hall"])
def test_match_stereo_as_reference(pairs, name):
    (fl, fr), _ = pairs[name]
    port = ST.match_stereo(fl.uv, fl.desc, fl.octave, fl.valid, fr.uv,
                           fr.desc, fr.octave, fr.valid, BF)
    ref = J_MATCH(_j(fl.uv), _pm1(fl.desc), _j(fl.octave), _j(fl.valid),
                  _j(fr.uv), _pm1(fr.desc), _j(fr.octave), _j(fr.valid),
                  bf=BF)
    _assert_same(port, ref, depth_rows=(1,))
    assert int(port[2].sum()) > 200


@pytest.mark.parametrize("name", ["room", "hall"])
def test_match_stereo_lines_as_reference(pairs, name):
    _, (ll, lr) = pairs[name]
    port = ST.match_stereo_lines(ll.ep, ll.desc, ll.angle, ll.valid, lr.ep,
                                 lr.desc, lr.angle, lr.valid, BF)
    ref = J_LINES(_j(ll.ep), _pm1(ll.desc), _j(ll.angle), _j(ll.valid),
                  _j(lr.ep), _pm1(lr.desc), _j(lr.angle), _j(lr.valid),
                  bf=BF)
    _assert_same(port, ref, depth_rows=(0, 1))
    if name == "hall":
        assert int(port[2].sum()) >= 10


def _synthetic_segments(seed):
    """tests/test_stereo.py:73-121's 12 matchable vertical-ish segments
    among 32 rows, the same descriptors left and right."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = 458.0, 457.0, 376.0, 240.0
    b, L, n = 0.11, 32, 12
    z0 = rng.uniform(2.0, 8.0, n)
    z1 = z0 + rng.uniform(-0.3, 0.3, n)
    x0 = rng.uniform(-1.5, 1.5, n)
    y0 = rng.uniform(-1.0, 0.2, n)
    x1 = x0 + rng.uniform(-0.3, 0.3, n)
    y1 = y0 + rng.uniform(0.5, 1.2, n)

    def proj(X, Y, Z, tx=0.0):
        return np.stack([fx * (X - tx) / Z + cx, fy * Y / Z + cy], -1)
    epL = np.zeros((L, 4), np.float32)
    epR = np.zeros((L, 4), np.float32)
    epL[:n, :2], epL[:n, 2:] = proj(x0, y0, z0), proj(x1, y1, z1)
    epR[:n, :2], epR[:n, 2:] = proj(x0, y0, z0, b), proj(x1, y1, z1, b)
    d = epL[:, 2:] - epL[:, :2]
    ang = (np.arctan2(d[:, 1], d[:, 0]) % np.pi).astype(np.float32)
    valid = np.zeros(L, bool)
    valid[:n] = True
    desc = rng.choice([-1.0, 1.0], size=(L, 256)).astype(np.float32)
    return epL, epR, ang, valid, desc, b * fx, (z0, z1)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_stereo_lines_synthetic(seed):
    epL, epR, ang, valid, desc, bf, (z0, z1) = _synthetic_segments(seed)
    packed = PM.pack_bits_u32(torch.from_numpy(desc))
    T = torch.from_numpy
    port = ST.match_stereo_lines(T(epL), packed, T(ang), T(valid), T(epR),
                                 packed, T(ang), T(valid), bf)
    dj = jnp.asarray(desc, jnp.bfloat16)
    ref = J_LINES(jnp.asarray(epL), dj, jnp.asarray(ang), jnp.asarray(valid),
                  jnp.asarray(epR), dj, jnp.asarray(ang), jnp.asarray(valid),
                  bf=bf)
    _assert_same(port, ref, depth_rows=(0, 1))
    has = port[2].numpy()
    assert has[:12].sum() >= 10 and not has[12:].any()
    np.testing.assert_allclose(port[0].numpy()[:12][has[:12]],
                               z0[has[:12]], rtol=0.02)


def test_match_stereo_synthetic_gates():
    """Many equal descriptors across rows and columns (ties, the mutual
    check, the row and disparity gates and the octave tolerance), on a
    synthetic set the gates leave several candidates a row."""
    rng = np.random.default_rng(5)
    n = m = 400
    uv_l = np.stack([rng.uniform(40, 700, n), rng.uniform(20, 460, n)],
                    -1).astype(np.float32)
    perm = rng.permutation(m)
    disp = rng.uniform(-2.0, 60.0, m)
    uv_r = (uv_l[perm] - np.stack([disp, rng.normal(0, 1.5, m)], -1)
            ).astype(np.float32)
    base = rng.integers(0, 2, (40, 256))
    desc_l = base[rng.integers(0, 40, n)] ^ (rng.random((n, 256)) < 0.05)
    desc_r = desc_l[perm] ^ (rng.random((m, 256)) < 0.05)
    oct_l = rng.integers(0, 8, n).astype(np.int32)
    oct_r = oct_l[perm]
    valid_l, valid_r = rng.random(n) < 0.95, rng.random(m) < 0.95
    T = torch.from_numpy
    pk = lambda d: PM.pack_bits_u32(T(d.astype(np.float32)))  # noqa: E731
    port = ST.match_stereo(T(uv_l), pk(desc_l), T(oct_l), T(valid_l),
                           T(uv_r), pk(desc_r), T(oct_r), T(valid_r), BF)
    pm = lambda d: jnp.asarray(d * 2.0 - 1.0, jnp.bfloat16)  # noqa: E731
    ref = J_MATCH(jnp.asarray(uv_l), pm(desc_l), jnp.asarray(oct_l),
                  jnp.asarray(valid_l), jnp.asarray(uv_r), pm(desc_r),
                  jnp.asarray(oct_r), jnp.asarray(valid_r), bf=BF)
    _assert_same(port, ref, depth_rows=(1,))
    assert 50 < int(port[2].sum()) < n


# ---------------------------------------------------------------------------
# the point+line pose IRLS with the u_R column
# ---------------------------------------------------------------------------

def _pose_problem(seed, n_pts, n_lns):
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = KV
    R_true = lie.so3_exp(torch.tensor(rng.normal(0, 0.05, 3),
                                      dtype=D64)).numpy()
    t_true = rng.normal(0, 0.1, 3)

    def proj(P):
        pc = P @ R_true.T + t_true
        return np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                         fy * pc[:, 1] / pc[:, 2] + cy], -1), pc[:, 2]
    X = rng.uniform([-3, -2, 3], [3, 2, 9], (n_pts, 3))
    octave = rng.integers(0, 4, n_pts)
    uv0, z = proj(X)
    noise = rng.normal(0, 0.7, (n_pts, 3)) * 1.2 ** octave[:, None]
    uv = uv0 + noise[:, :2]
    ur = uv0[:, 0] - BF / z + noise[:, 2]
    out = rng.random(n_pts) < 0.2
    uv[out] += rng.uniform(-25, 25, (out.sum(), 2))
    ur[out] += rng.uniform(-25, 25, out.sum())
    ur[::3] = -1.0                       # a third of the points mono
    valid = rng.random(n_pts) < 0.9
    is2 = 1.0 / 1.2 ** (2.0 * octave)
    Xs = rng.uniform([-3, -2, 3], [3, 2, 9], (n_lns, 3))
    Xe = Xs + rng.normal(0, 0.8, (n_lns, 3))
    ps = proj(Xs)[0] + rng.normal(0, 0.5, (n_lns, 2))
    pe = proj(Xe)[0] + rng.normal(0, 0.5, (n_lns, 2))
    ln = np.cross(np.c_[ps, np.ones(n_lns)], np.c_[pe, np.ones(n_lns)])
    ln /= np.linalg.norm(ln[:, :2], axis=1, keepdims=True)
    dR = lie.so3_exp(torch.tensor(rng.normal(0, 0.01, 3))).numpy()
    pose0 = np.c_[dR @ R_true, t_true + rng.normal(0, 0.03, 3)]
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return dict(pose0=f32(pose0), uv=f32(uv), X=f32(X), valid=valid,
                is2=f32(is2), l_obs=f32(ln), Xs=f32(Xs), Xe=f32(Xe),
                valid_l=rng.random(n_lns) < 0.9,
                is2_l=np.ones(n_lns, np.float32), ur=f32(ur))


def _stereo_chi2(P, p):
    """Each point's chi2 at pose P (float64) and its gate."""
    fx, fy, cx, cy = KV
    pc = p["X"].astype(np.float64) @ P[:, :3].T + P[:, 3]
    z = np.maximum(pc[:, 2], 1e-4)
    u = fx * pc[:, 0] / z + cx
    r = np.stack([u - p["uv"][:, 0], fy * pc[:, 1] / z + cy - p["uv"][:, 1],
                  (u - BF / z - p["ur"]) * (p["ur"] > 0)], -1)
    return (r * r).sum(-1) * p["is2"], np.where(p["ur"] > 0, 7.815, 5.991)


@pytest.mark.parametrize("seed,n_pts,n_lns", [(0, 2048, 128), (1, 512, 32)])
def test_pose_irls_stereo_as_reference(seed, n_pts, n_lns):
    p = _pose_problem(seed, n_pts, n_lns)
    names = ("pose0", "uv", "X", "valid", "is2", "l_obs", "Xs", "Xe",
             "valid_l", "is2_l")
    jrun = JK.make_fast_pose_optimizer_pl(JPin(*KV), n_pts, n_lns, bf=BF)
    Pj, inl_j, _, n_j = jrun(*[jnp.asarray(p[k]) for k in names + ("ur",)])
    trun = TK.make_fast_pose_optimizer_pl(PinholeK(*KV), bf=BF)
    with torch.no_grad():
        Pt, inl_t, _, n_t = trun(*[torch.from_numpy(p[k])
                                   for k in names + ("ur",)])
    Pj = np.asarray(Pj, np.float64)
    Pt64 = Pt.numpy().astype(np.float64)
    dR = Pj[:, :3] @ Pt64[:, :3].T
    rot = math.acos(min(1.0, max(-1.0, (np.trace(dR) - 1) / 2)))
    assert rot <= 2e-4, rot
    assert np.abs(Pj[:, 3] - Pt64[:, 3]).max() <= 5e-4
    chi2, gate = _stereo_chi2(Pj, p)
    diff = np.asarray(inl_j) != inl_t.numpy()
    near = np.abs(chi2 - gate) <= 0.01 * gate
    assert (~diff | near).all(), np.nonzero(diff & ~near)
    assert abs(int(n_j) - int(n_t)) <= max(2, int(0.01 * int(n_j)))
    # the stereo rows count: some pass only under their wider gate
    stereo_in = inl_t.numpy() & (p["ur"] > 0)
    assert stereo_in.sum() > 0.4 * (p["valid"] & (p["ur"] > 0)).sum()


def test_pose_irls_stereo_rows_tighten_depth():
    """With every point's u_R, the noisy shallow field's depth axis is
    recovered at least as well as without (the reference test of
    tests/test_stereo.py:124)."""
    p = _pose_problem(2, 512, 0)
    T = torch.from_numpy
    base = (T(p["pose0"]), T(p["uv"]), T(p["X"]), T(p["valid"]),
            T(p["is2"]), torch.zeros(0, 3), torch.zeros(0, 3),
            torch.zeros(0, 3), torch.zeros(0, dtype=torch.bool),
            torch.zeros(0))
    Pm, _, _, _ = TK.pose_irls(PinholeK(*KV), *base)
    Ps, _, _, n = TK.pose_irls(PinholeK(*KV), *base, ur=T(p["ur"]), bf=BF)
    assert int(n) > 300
    assert np.isfinite(Ps.numpy()).all() and np.isfinite(Pm.numpy()).all()


# ---------------------------------------------------------------------------
# the VI pose optimization with the stereo term
# ---------------------------------------------------------------------------

def _check_jac(J, Jad):
    scale = float(Jad.abs().max())
    assert float((J - Jad).abs().max()) <= 1e-7 * scale


@pytest.mark.parametrize("seed", [0, 1])
def test_stereo_reproj_body_jacobian(seed):
    rng = np.random.default_rng(seed)
    K = PinholeK(*KV)
    R = lie.so3_exp(torch.tensor(rng.normal(0, 0.3, 3), dtype=D64))
    P = torch.cat([R, torch.tensor(rng.normal(0, 0.2, 3),
                                   dtype=D64)[:, None]], 1)
    Rcb = lie.so3_exp(torch.tensor(rng.normal(0, 0.05, 3), dtype=D64))
    tcb = torch.tensor(rng.normal(0, 0.05, 3), dtype=D64)
    Xc = torch.tensor(rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (16, 3)),
                      dtype=D64)
    X = (Xc - tcb) @ Rcb @ P[:, :3].T + P[:, 3]
    uvr = torch.tensor(rng.uniform(0, 400, (16, 3)), dtype=D64)
    r, J = RES.stereo_reproj_body_jac(K, BF, Rcb, tcb, P, X, uvr)
    res = RES.make_stereo_reproj_body(K, BF, Rcb, tcb)
    for k in range(16):
        c = {"uvr": uvr[k], "X": X[k]}
        Jad = jacrev(lambda d: res((P,), (d,), c))(
            torch.zeros(6, dtype=D64))
        _check_jac(J[k], Jad)
        torch.testing.assert_close(
            r[k], res((P,), (torch.zeros(6, dtype=D64),), c))


def _vi_frame(rng, prev_state, calib):
    """tests/test_torch_vi_pose_opt.py's frame problem with a u_R column
    on two thirds of the points (its noise, its outliers)."""
    R0, p0, v0 = prev_state
    k = 10
    gyro = rng.normal(0, 0.3, (k, 3)).astype(np.float32)
    acc = (rng.normal(0, 0.5, (k, 3))
           + R0.T @ np.array([0, 0, 9.81])).astype(np.float32)
    dt = np.full(k, 0.005, np.float32)
    pre = JI.preintegrate(jnp.asarray(gyro), jnp.asarray(acc),
                          jnp.asarray(dt), jnp.ones(k, bool), calib,
                          jnp.zeros(3), jnp.zeros(3))
    R2, v2, p2 = (np.asarray(a) for a in JI.predict_state(
        pre, jnp.asarray(R0), jnp.asarray(v0), jnp.asarray(p0),
        jnp.array([0.0, 0.0, -9.81], jnp.float32)))
    fx, fy, cx, cy = KV
    Xc = rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (CAP, 3))
    Xw = (Xc @ R2.T + p2).astype(np.float32)
    u = fx * Xc[:, 0] / Xc[:, 2] + cx
    noise = rng.normal(0, 0.7, (CAP, 3))
    uv = np.stack([u, fy * Xc[:, 1] / Xc[:, 2] + cy], -1) + noise[:, :2]
    ur = u - BF / Xc[:, 2] + noise[:, 2]
    n_out = CAP * 15 // 100
    uv[:n_out] += rng.uniform(-25, 25, (n_out, 2))
    ur[:n_out] += rng.uniform(-25, 25, n_out)
    ur[::3] = -1.0
    uvr = np.concatenate([uv, ur[:, None]], 1).astype(np.float32)
    dth = rng.normal(0, 0.01, 3)
    R2p = R2 @ lie.so3_exp(torch.tensor(dth, dtype=D64)).numpy()
    p2p = p2 + rng.normal(0, 0.02, 3)
    pose0 = np.concatenate([R2p, p2p[:, None]], 1).astype(np.float32)
    pre_const = {"dT": pre.dT, "dR": pre.dR, "dV": pre.dV, "dP": pre.dP,
                 "JRg": pre.JRg, "JVg": pre.JVg, "JVa": pre.JVa,
                 "JPg": pre.JPg, "JPa": pre.JPa, "bg0": pre.bias_gyro,
                 "ba0": pre.bias_acc}
    info = np.linalg.inv(np.asarray(pre.C, np.float64)[:9, :9]
                         + np.eye(9) * 1e-8).astype(np.float32)
    return (pose0, v2.astype(np.float32), uvr, Xw,
            rng.random(CAP) < 0.9,
            (1.0 / 1.2 ** (2 * rng.integers(0, 3, CAP))).astype(np.float32),
            {k_: np.asarray(v) for k_, v in pre_const.items()}, info)


@pytest.fixture(scope="module")
def vi_optimizers():
    jo = JK.make_vi_pose_optimizer(JPin(*KV), CAP, np.eye(3, dtype=np.float32),
                                   np.zeros(3, np.float32), 9.81, bf=BF)
    to = TK.make_vi_pose_optimizer(PinholeK(*KV), CAP, np.eye(3),
                                   np.zeros(3), 9.81, bf=BF)
    return jo, to


def _vi_run(opts, prob, prev_pose, prev_v, bg, ba, prior_const, H15,
            have_prior):
    jo, to = opts
    pose0, v0, uvr, Xw, valid, is2, pre_const, info = prob
    rw = np.concatenate([np.full(3, 1 / (1.9393e-5 ** 2 * 10)),
                         np.full(3, 1 / (3e-3 ** 2 * 10))]).astype(np.float32)
    args = (pose0, v0, bg, ba, uvr, Xw, valid, is2, prev_pose, prev_v,
            pre_const, info, rw, prior_const, H15)
    J = lambda a: ({k: jnp.asarray(v) for k, v in a.items()}  # noqa: E731
                   if isinstance(a, dict) else jnp.asarray(a))
    T = lambda a: ({k: torch.from_numpy(np.array(v))  # noqa: E731
                    for k, v in a.items()} if isinstance(a, dict)
                   else torch.from_numpy(np.array(a)))
    oj = jo(*(J(a) for a in args), jnp.asarray(have_prior))
    with torch.no_grad():
        ot = to(*(T(a) for a in args), have_prior)
    return oj, ot


def _vi_compare(oj, ot, prob, stereo_share=0.0):
    """tests/test_torch_vi_pose_opt.py's bounds; inlier masks equal but
    for rows within 1% of their gate at the port's solution."""
    Pj, Pt = np.asarray(oj[0], np.float64), ot[0].double().numpy()
    dR = Pj[:, :3].T @ Pt[:, :3]
    skew = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                     dR[1, 0] - dR[0, 1]]) / 2
    assert np.linalg.norm(skew) <= 1e-4
    assert np.abs(Pj[:, 3] - Pt[:, 3]).max() <= 1e-4
    assert np.abs(np.asarray(oj[1]) - ot[1].numpy()).max() <= 1e-4
    for a, b in ((oj[2], ot[2]), (oj[3], ot[3])):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 5e-5
    Hj = np.asarray(oj[6], np.float64)
    if np.all(np.isfinite(Hj)):
        rel = np.linalg.norm(ot[6].double().numpy() - Hj) \
            / np.linalg.norm(Hj)
        assert rel <= 1e-3, rel
    else:
        assert not bool(torch.isfinite(ot[6]).all())
    _, _, uvr, Xw, _, is2 = prob[:6]
    fx, fy, cx, cy = KV
    Xb = (Xw - Pt[:, 3]) @ Pt[:, :3]
    u = fx * Xb[:, 0] / Xb[:, 2] + cx
    st = uvr[:, 2] > 0
    r = np.stack([u - uvr[:, 0], fy * Xb[:, 1] / Xb[:, 2] + cy - uvr[:, 1],
                  (u - BF / Xb[:, 2] - uvr[:, 2]) * st], -1)
    chi2 = (r * r).sum(-1) * is2
    gate = np.where(st, 7.815, 5.991)
    near = np.abs(chi2 - gate) <= 0.01 * gate
    diff = np.asarray(oj[4]) != ot[4].numpy()
    assert not np.any(diff & ~near)
    assert int(ot[5]) == int(ot[4].sum())
    assert (ot[4].numpy() & st).sum() > stereo_share * (prob[4] & st).sum()


@pytest.mark.parametrize("have_prior", [True, False])
def test_vi_pose_stereo_as_reference(vi_optimizers, have_prior):
    rng = np.random.default_rng(3)
    calib = JI.make_calib(ImuConfig())
    R0 = lie.so3_exp(torch.tensor(rng.normal(0, 0.3, 3))).numpy()
    p0, v0 = rng.normal(0, 1, 3), rng.normal(0, 0.5, 3)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    prob = _vi_frame(rng, (f32(R0), f32(p0), f32(v0)), calib)
    prev = f32(np.concatenate([R0, p0[:, None]], 1))
    prior_const = {"R0": f32(R0), "p0": f32(p0), "v0": f32(v0),
                   "bg0": np.zeros(3, np.float32),
                   "ba0": np.zeros(3, np.float32)}
    oj, ot = _vi_run(vi_optimizers, prob, prev, f32(v0),
                     np.full(3, 1e-3, np.float32),
                     np.full(3, 1e-2, np.float32), prior_const,
                     np.eye(15, dtype=np.float32) * 100.0, have_prior)
    _vi_compare(oj, ot, prob, stereo_share=0.5)


def test_vi_pose_stereo_carries_prior(vi_optimizers):
    """3 frames, each solved against the previous solution with its H15 +
    1e-4 I as the prior; both sides carry their own state."""
    rng = np.random.default_rng(4)
    calib = JI.make_calib(ImuConfig())
    R = lie.so3_exp(torch.tensor(rng.normal(0, 0.3, 3))).numpy().astype(
        np.float32)
    p, v = (rng.normal(0, 1, 3).astype(np.float32),
            rng.normal(0, 0.5, 3).astype(np.float32))
    z3 = np.zeros(3, np.float32)
    cj = ct = (np.concatenate([R, p[:, None]], 1), v, z3, z3,
               np.eye(15, dtype=np.float32))
    eye = np.eye(15, dtype=np.float32) * 1e-4
    for _ in range(3):
        prob = _vi_frame(rng, (cj[0][:, :3], cj[0][:, 3], cj[1]), calib)
        outs = []
        for c in (cj, ct):
            pc = {"R0": c[0][:, :3], "p0": c[0][:, 3], "v0": c[1],
                  "bg0": c[2], "ba0": c[3]}
            outs.append(_vi_run(vi_optimizers, prob, c[0], c[1], c[2], c[3],
                                pc, c[4], True))
        oj, ot = outs[0][0], outs[1][1]
        _vi_compare(oj, ot, prob)
        cj = tuple(np.asarray(a) for a in oj[:4]) + (np.asarray(oj[6])
                                                    + eye,)
        ct = tuple(a.numpy() for a in ot[:4]) + (ot[6].numpy() + eye,)
