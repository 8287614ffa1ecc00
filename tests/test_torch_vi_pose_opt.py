"""The VI pose optimizer of the port against the reference.

1. Each analytic Jacobian of solver/residuals.py (the formulas of
   csrc/vi_pose_lm.cu) against automatic differentiation of its residual
   at random, non-trivial states, in float64: within 1e-7 relative to the
   Jacobian's largest entry.  The port differentiates with
   torch.func.jacrev: PyTorch's forward mode (jacfwd) gives float32 x
   Python-float products a float64 tangent that a matmul then refuses.
2. `make_vi_pose_optimizer` (plain version, CPU) against
   plvio_tpu.models.kernels.make_vi_pose_optimizer on the same seeded
   problem (cap 256 points, 15% outliers, both `have_prior` values, and 3
   frames carrying H15 as the VI frame does).  Tolerances: rotation within
   1e-4 rad, position within 1e-4 m, velocity within 1e-4 m/s, biases
   within 5e-5 (they are weakly observed: a flat direction of the
   float32 LM), inlier masks equal but for rows within 1% of the 5.991
   gate, H15 within 1e-3 relative Frobenius (float32 LM in both, summed
   in different orders; eigh pseudo-inverse)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.func import jacrev

from plvio_tpu.config import ImuConfig
from plvio_tpu.models import kernels as JK
from plvio_tpu.ops import imu as JI
from plvio_tpu.solver.residuals import PinholeK as JPin
from plvio_tpu_torch.models import kernels as TK
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.solver.residuals import PinholeK
from plvio_tpu_torch.utils import lie

KV = (458.654, 457.296, 367.215, 248.375)
CAP = 256
D64 = torch.float64


def _rand_pose(rng, s_rot=0.5, s_p=1.0):
    R = lie.so3_exp(torch.tensor(rng.normal(0, s_rot, 3), dtype=D64))
    return torch.cat([R, torch.tensor(rng.normal(0, s_p, 3),
                                      dtype=D64)[:, None]], 1)


def _rand_pre(rng):
    t = lambda *s: torch.tensor(rng.normal(0, 0.05, s), dtype=D64)
    return {"dT": torch.tensor(0.05, dtype=D64),
            "dR": lie.so3_exp(t(3) * 4), "dV": t(3) * 10, "dP": t(3),
            "JRg": t(3, 3), "JVg": t(3, 3), "JVa": t(3, 3), "JPg": t(3, 3),
            "JPa": t(3, 3), "bg0": t(3) * 0.1, "ba0": t(3)}


def _check(J, Jad):
    scale = float(Jad.abs().max())
    assert float((J - Jad).abs().max()) <= 1e-7 * scale, \
        float((J - Jad).abs().max()) / scale


def _jac(res, blocks, dofs, const):
    def f(d):
        return res(blocks, torch.split(d, dofs), const)
    return jacrev(f)(torch.zeros(sum(dofs), dtype=D64))


@pytest.mark.parametrize("seed", [0, 1])
def test_point_reproj_body_jacobian(seed):
    rng = np.random.default_rng(seed)
    K = PinholeK(*KV)
    P = _rand_pose(rng, 0.3, 0.2)
    Rcb = lie.so3_exp(torch.tensor(rng.normal(0, 0.05, 3), dtype=D64))
    tcb = torch.tensor(rng.normal(0, 0.05, 3), dtype=D64)
    Xc = torch.tensor(rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (16, 3)),
                      dtype=D64)
    X = (Xc - tcb) @ Rcb @ P[:, :3].T + P[:, 3]
    uv = torch.tensor(rng.uniform(0, 400, (16, 2)), dtype=D64)
    r, J = RES.point_reproj_body_jac(K, Rcb, tcb, P, X, uv)
    res = RES.make_point_reproj_body(K, Rcb, tcb)
    for k in range(16):
        c = {"uv": uv[k], "X": X[k]}
        _check(J[k], _jac(res, (P,), [6], c))
        torch.testing.assert_close(r[k], res((P,), (torch.zeros(6, dtype=D64),),
                                             c))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inertial_jacobian(seed):
    rng = np.random.default_rng(seed)
    blocks = (_rand_pose(rng), torch.tensor(rng.normal(0, 1, 3), dtype=D64),
              torch.tensor(rng.normal(0, 0.01, 3), dtype=D64),
              torch.tensor(rng.normal(0, 0.1, 3), dtype=D64),
              _rand_pose(rng), torch.tensor(rng.normal(0, 1, 3), dtype=D64))
    const = _rand_pre(rng)
    r, J = RES.inertial_jac(9.81, blocks, const)
    res = RES.make_inertial(9.81)
    _check(J, _jac(res, blocks, [6, 3, 3, 3, 6, 3], const))
    zero = tuple(torch.zeros(d, dtype=D64) for d in (6, 3, 3, 3, 6, 3))
    torch.testing.assert_close(r, res(blocks, zero, const))


@pytest.mark.parametrize("seed", [0, 1])
def test_prior15_and_bias_rw_jacobians(seed):
    rng = np.random.default_rng(seed)
    v = lambda s: torch.tensor(rng.normal(0, s, 3), dtype=D64)
    blocks = (_rand_pose(rng), v(1), v(0.01), v(0.1))
    const = {"R0": _rand_pose(rng)[:, :3], "p0": v(1), "v0": v(1),
             "bg0": v(0.01), "ba0": v(0.1)}
    r, J = RES.prior15_jac(blocks, const)
    _check(J, _jac(RES.make_prior15(), blocks, [6, 3, 3, 3], const))
    zero = tuple(torch.zeros(d, dtype=D64) for d in (6, 3, 3, 3))
    torch.testing.assert_close(r, RES.make_prior15()(blocks, zero, const))
    b = (v(0.1), v(0.1))
    r, J = RES.bias_rw_jac(b)
    _check(J, _jac(RES.bias_rw, b, [3, 3], None))


# ---------------------------------------------------------------------------
# the optimizer against the reference
# ---------------------------------------------------------------------------

def _frame_problem(rng, prev_state, calib):
    """One frame: the IMU window from the previous state to a new true
    state, its matches and a perturbed prediction."""
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
    uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                   fy * Xc[:, 1] / Xc[:, 2] + cy], -1) \
        + rng.normal(0, 0.7, (CAP, 2))
    uv[: CAP * 15 // 100] += rng.uniform(-25, 25, (CAP * 15 // 100, 2))
    uvr = np.concatenate([uv, -np.ones((CAP, 1))], 1).astype(np.float32)
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
            {k_: np.asarray(v) for k_, v in pre_const.items()}, info,
            (R2, p2, v2))


@pytest.fixture(scope="module")
def optimizers():
    jo = JK.make_vi_pose_optimizer(JPin(*KV), CAP, np.eye(3, dtype=np.float32),
                                   np.zeros(3, np.float32), 9.81)
    to = TK.make_vi_pose_optimizer(PinholeK(*KV), CAP, np.eye(3),
                                   np.zeros(3), 9.81)
    return jo, to


def _compare(oj, ot):
    Pj, Pt = np.asarray(oj[0], np.float64), ot[0].double().numpy()
    dR = Pj[:, :3].T @ Pt[:, :3]
    skew = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                     dR[1, 0] - dR[0, 1]]) / 2
    assert np.linalg.norm(skew) <= 1e-4              # sin of the angle
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
    return np.asarray(oj[4]) != ot[4].numpy()


def _run_both(optimizers, prob, prev_pose, prev_v, bg, ba, prior_const,
              H15, have_prior):
    jo, to = optimizers
    pose0, v0, uvr, Xw, valid, is2, pre_const, info, _ = prob
    rw = np.concatenate([np.full(3, 1 / (1.9393e-5 ** 2 * 10)),
                         np.full(3, 1 / (3e-3 ** 2 * 10))]).astype(np.float32)
    args = (pose0, v0, bg, ba, uvr, Xw, valid, is2, prev_pose, prev_v,
            pre_const, info, rw, prior_const, H15)
    J = lambda a: ({k: jnp.asarray(v) for k, v in a.items()}
                   if isinstance(a, dict) else jnp.asarray(a))
    T = lambda a: ({k: torch.from_numpy(np.array(v))
                    for k, v in a.items()} if isinstance(a, dict)
                   else torch.from_numpy(np.array(a)))
    oj = jo(*(J(a) for a in args), jnp.asarray(have_prior))
    with torch.no_grad():
        ot = to(*(T(a) for a in args), have_prior)
    return oj, ot


def _gate_near(ot, prob):
    """Rows whose final chi2 (port) is within 1% of the gate."""
    pose, _, uvr, Xw, _, is2 = (ot[0].double().numpy(), None, *prob[2:6])
    fx, fy, cx, cy = KV
    Xb = (Xw - pose[:, 3]) @ pose[:, :3]
    uv = np.stack([fx * Xb[:, 0] / Xb[:, 2] + cx,
                   fy * Xb[:, 1] / Xb[:, 2] + cy], -1)
    chi2 = ((uv - uvr[:, :2]) ** 2).sum(-1) * is2
    return np.abs(chi2 - 5.991) <= 0.01 * 5.991


@pytest.mark.parametrize("have_prior", [True, False])
def test_vi_pose_optimizer_matches_reference(optimizers, have_prior):
    rng = np.random.default_rng(3)
    calib = JI.make_calib(ImuConfig())
    R0 = lie.so3_exp(torch.tensor(rng.normal(0, 0.3, 3))).numpy()
    p0, v0 = rng.normal(0, 1, 3), rng.normal(0, 0.5, 3)
    prob = _frame_problem(rng, (R0.astype(np.float32),
                                p0.astype(np.float32),
                                v0.astype(np.float32)), calib)
    prev = np.concatenate([R0, p0[:, None]], 1).astype(np.float32)
    bg, ba = np.full(3, 1e-3, np.float32), np.full(3, 1e-2, np.float32)
    prior_const = {"R0": R0.astype(np.float32), "p0": p0.astype(np.float32),
                   "v0": v0.astype(np.float32), "bg0": np.zeros(3, np.float32),
                   "ba0": np.zeros(3, np.float32)}
    H15 = np.eye(15, dtype=np.float32) * 100.0
    oj, ot = _run_both(optimizers, prob, prev, v0.astype(np.float32), bg, ba,
                       prior_const, H15, have_prior)
    diff = _compare(oj, ot)
    assert not np.any(diff & ~_gate_near(ot, prob))
    assert int(ot[5]) >= 0.7 * CAP * 0.9


def test_vi_pose_optimizer_carries_prior(optimizers):
    """3 frames, each solved against the previous solution with the
    previous H15 + 1e-4 I as its prior (the VI frame's recursion); both
    sides carry their own state."""
    rng = np.random.default_rng(4)
    calib = JI.make_calib(ImuConfig())
    R = lie.so3_exp(torch.tensor(rng.normal(0, 0.3, 3))).numpy().astype(
        np.float32)
    p, v = (rng.normal(0, 1, 3).astype(np.float32),
            rng.normal(0, 0.5, 3).astype(np.float32))
    bg, ba = np.zeros(3, np.float32), np.zeros(3, np.float32)
    H15 = np.eye(15, dtype=np.float32)
    cj = ct = (np.concatenate([R, p[:, None]], 1), v, bg, ba, H15)
    for _ in range(3):
        state = (cj[0][:, :3], cj[0][:, 3], cj[1])
        prob = _frame_problem(rng, state, calib)
        outs = []
        for c in (cj, ct):
            pc = {"R0": c[0][:, :3], "p0": c[0][:, 3], "v0": c[1],
                  "bg0": c[2], "ba0": c[3]}
            outs.append(_run_both(optimizers, prob, c[0], c[1], c[2], c[3],
                                  pc, c[4], True))
        oj, ot = outs[0][0], outs[1][1]
        diff = _compare(oj, ot)
        assert not np.any(diff & ~_gate_near(ot, prob))
        eye = np.eye(15, dtype=np.float32) * 1e-4
        cj = (np.asarray(oj[0]), np.asarray(oj[1]), np.asarray(oj[2]),
              np.asarray(oj[3]), np.asarray(oj[6]) + eye)
        ct = (ot[0].numpy(), ot[1].numpy(), ot[2].numpy(), ot[3].numpy(),
              ot[6].numpy() + eye)
