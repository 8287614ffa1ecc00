"""The inertial window BA against the JAX package (CPU): the analytic
Jacobians of the new residuals and retractions, the window's
preintegration, one LM step of the window and the whole
`make_local_inertial_ba`, at 8 KF (3 fixed observers + 5 window KFs) /
256 points / 512 observations / 32 lines / 64 line observations
(`inputs.build_inertial_window`, 2% outliers, perturbed start).

Tolerances, and why:
- Jacobians: analytic against torch.func.jacrev in float64, <= 1e-9
  relative (the same function; 1e-15 seen).
- preintegration: the port's float32 `ops/imu.preintegrate` against the
  reference's on the same samples, 1e-6 relative per constant (the same
  float32 recursion; sin / cos may differ in the last bit).
- one LM step: cost within 1e-5 relative; candidate states within 2x the
  farther of the two packages' float32 steps from the port's engine in
  float64, plus 1e-6: this first step from the perturbed start puts any
  float32 run ~1e-3 from float64 (120 fixed CG steps on an
  ill-conditioned system).
- the whole BA: poses within 1e-4 (a pose entry), velocities within
  1e-4 m/s, gyro biases within 1e-5, accelerometer biases within 1e-4
  (weakly held: the float32 engine lies up to 3.8e-4 from float64 in
  them at the half bucket; 5.6e-5 seen without lines), points within
  1e-3 m (their depth along a low-parallax ray is weakly held), point
  and line inlier masks equal,
  and the largest position error within 10% of the reference's; the
  float32 BA within 1e-3 of the same engine in float64 with the same
  iteration counts.

Run as a script, it prints REF_LIBA, the guard of chip_smoke.py: the JAX
function on the CPU at both production buckets (16 KF; 4096 / 8192 and
2048 / 4096 points / observations, 256 / 512 lines / line observations),
from the true and the perturbed start:

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_inertial_ba.py
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import jacrev, vmap

from plvio_tpu.config import ImuConfig as JImuConfig
from plvio_tpu.models import kernels as JK
from plvio_tpu.ops import imu as JIMU
from plvio_tpu.solver import engine as JE
from plvio_tpu.solver import residuals as JR
from plvio_tpu.solver.residuals import PinholeK as JPin
from plvio_tpu_torch.entry import K_EUROC, LIBA_HALF, LIBA_WORST
from plvio_tpu_torch.inputs import build_inertial_window, extrinsics
from plvio_tpu_torch.models import kernels as TK
from plvio_tpu_torch.models.kernels import LIBA_KEYS, PRE_KEYS
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.state import inertial_from_numpy
from plvio_tpu_torch.utils import lie

SMALL = dict(n_pt=256, n_obs=512, n_ln=32, n_lobs=64, n_kf=8, n_observers=3)
JPK = JPin(*K_EUROC)
G = 9.81


def _np(v):
    if isinstance(v, dict):
        return {k: _np(x) for k, x in v.items()}
    return v.numpy() if torch.is_tensor(v) else v


def _jnp(v):
    return jax.tree_util.tree_map(jnp.asarray, v)


@pytest.fixture(scope="module")
def windows():
    """The small window from both starts, as numpy."""
    return {p: {k: _np(v) for k, v in build_inertial_window(
        **SMALL, device="cpu", perturbed=p).items()} for p in (False, True)}


def _t(v):
    if isinstance(v, dict):
        return {k: _t(x) for k, x in v.items()}
    return torch.from_numpy(np.array(v))


# -- analytic Jacobians --------------------------------------------------

def _body_case(seed, n=32):
    rng = np.random.default_rng(seed)
    Rcb, tcb = (torch.from_numpy(a) for a in extrinsics())
    P = torch.cat([lie.so3_exp(torch.from_numpy(rng.normal(0, 0.3, (n, 3)))),
                   torch.from_numpy(rng.normal(0, 0.5, (n, 3, 1)))], -1)
    xc = torch.from_numpy(rng.uniform([-1, -1, 2], [1, 1, 6], (n, 3)))
    Xb = (xc - tcb) @ Rcb                 # Rcb^T (xc - tcb)
    X = (P[..., :3] @ Xb[..., None])[..., 0] + P[..., 3]
    return rng, Rcb, tcb, P, X


def _autodiff(res, blocks, const, dofs):
    def f(delta, blk, c):
        return res(blk, torch.split(delta, dofs), c)
    n = blocks[0].shape[0]
    zeros = torch.zeros(n, sum(dofs), dtype=torch.float64)
    return vmap(jacrev(f))(zeros, blocks, const)


def _close(a, b, tol=1e-9):
    return float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_point_body_ba_jacobian_matches_autodiff():
    rng, Rcb, tcb, P, X = _body_case(0)
    uv = torch.from_numpy(rng.uniform(0, 400, (X.shape[0], 2)))
    J = _autodiff(RES.make_point_reproj_body_ba(K_EUROC, Rcb, tcb), (P, X),
                  {"uv": uv}, [6, 3])
    r, Jp, Jx = RES.point_reproj_body_ba_jac(K_EUROC, Rcb, tcb, P, X, uv)
    assert _close(torch.cat([Jp, Jx], -1), J)
    r_ref = vmap(RES.make_point_reproj_body_ba(K_EUROC, Rcb, tcb))(
        (P, X), (torch.zeros(32, 6, dtype=torch.float64),
                 torch.zeros(32, 3, dtype=torch.float64)), {"uv": uv})
    assert float((r - r_ref).abs().max()) <= 1e-9


def test_line_body_ba_jacobian_matches_autodiff():
    rng, Rcb, tcb, P, X = _body_case(1)
    L = torch.cat([X, X + torch.from_numpy(rng.normal(0, 0.3, X.shape))], 1)
    l = torch.from_numpy(rng.normal(0, 1, (X.shape[0], 3)))
    l = l / l[:, :2].norm(dim=1, keepdim=True)
    J = _autodiff(RES.make_line_reproj_body_ba(K_EUROC, Rcb, tcb), (P, L),
                  {"l": l}, [6, 6])
    r, Jp, Jl = RES.line_reproj_body_ba_jac(K_EUROC, Rcb, tcb, P, L, l)
    assert _close(torch.cat([Jp, Jl], -1), J)


def _gs_case(seed):
    rng = np.random.default_rng(seed)

    def v3(s=1.0):
        return torch.from_numpy(rng.normal(0, s, 3))

    def m3(s=0.3):
        return torch.from_numpy(rng.normal(0, s, (3, 3)))
    const = {"dT": torch.tensor(0.4, dtype=torch.float64),
             "dR": lie.so3_exp(v3(0.1)), "dV": v3(), "dP": v3(0.1),
             "JRg": m3(), "JVg": m3(), "JVa": m3(), "JPg": m3(), "JPa": m3(),
             "bg0": v3(0.01), "ba0": v3(0.01), "R1": lie.so3_exp(v3()),
             "p1": v3(), "R2": lie.so3_exp(v3()), "p2": v3()}
    blocks = (lie.so3_exp(v3(0.2)), torch.tensor([1.3], dtype=torch.float64),
              v3(0.01), v3(0.01), v3(), v3())
    return blocks, const


@pytest.mark.parametrize("seed", [0, 1])
def test_inertial_gs_jacobian_matches_autodiff(seed):
    blocks, const = _gs_case(seed)
    res = RES.make_inertial_gs(G)
    dofs = [2, 1, 3, 3, 3, 3]
    J = jacrev(lambda d: res(blocks, torch.split(d, dofs), const))(
        torch.zeros(15, dtype=torch.float64))
    r, Ja = RES.inertial_gs_jac(G, blocks, const)
    assert _close(Ja, J)
    r0 = res(blocks, torch.split(torch.zeros(15, dtype=torch.float64), dofs),
             const)
    assert float((r - r0).abs().max()) <= 1e-12


def test_retraction_and_prior_jacobians_match_autodiff():
    rng = np.random.default_rng(3)
    R = lie.so3_exp(torch.from_numpy(rng.normal(0, 1, 3)))
    Jg = jacrev(lambda d: RES.retract_gdir(R[None], d[None])[0])(
        torch.zeros(2, dtype=torch.float64))
    assert _close(RES.retract_gdir_jac(R), Jg)
    s = torch.tensor([1.7], dtype=torch.float64)
    Js = jacrev(lambda d: RES.retract_scale(s, d))(
        torch.zeros(1, dtype=torch.float64))
    assert _close(RES.retract_scale_jac(s)[:, None], Js)
    x = torch.from_numpy(rng.normal(0, 1, 3))
    c = {"x0": torch.from_numpy(rng.normal(0, 1, 3))}
    Jp = jacrev(lambda d: RES.state_prior((x,), (d,), c))(
        torch.zeros(3, dtype=torch.float64))
    r, Ja = RES.state_prior_jac((x,), c)
    assert torch.equal(Ja, Jp) and torch.equal(r, x - c["x0"])


def test_residuals_match_reference():
    """The new residuals on the same float32 inputs as the reference's."""
    rng, Rcb, tcb, P, X = _body_case(4, n=8)
    P, X, Rcb, tcb = (a.float() for a in (P, X, Rcb, tcb))
    uv = torch.from_numpy(rng.uniform(0, 400, (8, 2)).astype(np.float32))
    L = torch.cat([X, X + 0.3], 1)
    l = torch.tensor([[0.6, 0.8, -300.0]] * 8)
    z6, z3 = torch.zeros(6), torch.zeros(3)
    jfn = JR.make_point_reproj_body_ba(JPK, jnp.asarray(Rcb.numpy()),
                                       jnp.asarray(tcb.numpy()))
    jln = JR.make_line_reproj_body_ba(JPK, jnp.asarray(Rcb.numpy()),
                                      jnp.asarray(tcb.numpy()))
    tfn = RES.make_point_reproj_body_ba(K_EUROC, Rcb, tcb)
    tln = RES.make_line_reproj_body_ba(K_EUROC, Rcb, tcb)
    for k in range(8):
        a = np.asarray(jfn((P[k].numpy(), X[k].numpy()), (z6.numpy(),
                                                         z3.numpy()),
                           {"uv": uv[k].numpy()}))
        b = tfn((P[k], X[k]), (z6, z3), {"uv": uv[k]}).numpy()
        assert np.abs(a - b).max() <= 1e-3          # pixels, float32
        a = np.asarray(jln((P[k].numpy(), L[k].numpy()), (z6.numpy(),
                                                         z6.numpy()),
                           {"l": l[k].numpy()}))
        b = tln((P[k], L[k]), (z6, z6), {"l": l[k]}).numpy()
        assert np.abs(a - b).max() <= 1e-3


# -- the window inputs ---------------------------------------------------

def test_window_preintegration_matches_reference(windows):
    """Each valid link's constants against plvio_tpu.ops.imu.preintegrate
    on the same samples; masked links carry the identity."""
    W = windows[False]
    calib = JIMU.make_calib(JImuConfig())
    ev = W["edge_valid"]
    assert ev.sum() == SMALL["n_kf"] - SMALL["n_observers"] - 1
    assert not ev[:SMALL["n_observers"]].any()
    for i in range(len(ev)):
        if not ev[i]:
            assert W["pre_const"]["dT"][i] == 0
            np.testing.assert_array_equal(W["pre_const"]["dR"][i], np.eye(3))
            continue
        p = JIMU.preintegrate(*[jnp.asarray(W[k][i]) for k in (
            "imu_gyro", "imu_acc", "imu_dt", "imu_mask")], calib,
            jnp.zeros(3), jnp.zeros(3))
        ref = {"dT": p.dT, "dR": p.dR, "dV": p.dV, "dP": p.dP, "JRg": p.JRg,
               "JVg": p.JVg, "JVa": p.JVa, "JPg": p.JPg, "JPa": p.JPa,
               "bg0": p.bias_gyro, "ba0": p.bias_acc}
        for k in PRE_KEYS:
            a, b = W["pre_const"][k][i], np.asarray(ref[k])
            assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1.0), \
                (i, k)
        C9 = np.asarray(p.C)[:9, :9].astype(np.float64) + np.eye(9) * 1e-8
        info = np.linalg.inv(C9)
        assert np.abs(W["imu_info"][i] - info).max() <= 1e-4 * np.abs(
            info).max()


def test_window_shape_and_outliers(windows):
    W = windows[True]
    n_obs, n_lobs = SMALL["n_obs"], SMALL["n_lobs"]
    assert W["obs_kf"].shape == (n_obs,) and W["lobs_kf"].shape == (n_lobs,)
    assert (np.diff(W["obs_kf"]) >= 0).all()
    assert 0 < W["obs_outlier"].sum() < 0.05 * n_obs
    assert W["pt_free"].sum() == n_obs // 4
    assert not W["kf_free"][:SMALL["n_observers"] + 1].any()
    assert W["kf_free"][SMALL["n_observers"] + 1:].all()
    fixed = ~W["kf_free"]
    np.testing.assert_array_equal(W["kf_pose_wb"][fixed],
                                  W["gt_pose_wb"][fixed])


def test_inertial_state_carries_over(windows):
    W = windows[True]
    arrays = dict(pose_wb=W["kf_pose_wb"], vel=W["kf_vel"],
                  bias_g=W["kf_bg"], bias_a=W["kf_ba"],
                  imu_info=W["imu_info"], edge_valid=W["edge_valid"],
                  rw_info_g=W["rw_info_g"], rw_info_a=W["rw_info_a"],
                  **W["pre_const"])
    T = inertial_from_numpy(arrays, "cpu")
    assert sorted(T["pre_const"]) == sorted(PRE_KEYS)
    for k in ("pose_wb", "vel", "imu_info", "rw_info_g"):
        assert T[k].dtype == torch.float32
    np.testing.assert_array_equal(T["pre_const"]["JRg"].numpy(),
                                  W["pre_const"]["JRg"])
    assert T["edge_valid"].dtype == torch.bool
    with pytest.raises(KeyError):
        inertial_from_numpy({"pose": W["kf_pose_wb"]}, "cpu")


# -- one LM step -----------------------------------------------------------

def _jax_problem(B, mask, mask_l, Rcb, tcb):
    """models/kernels.py:1260-1291 on the JAX engine."""
    n_kf, n_pt, n_ln = (B["kf_pose_wb"].shape[0], B["pt_xyz"].shape[0],
                        B["ln_ep6"].shape[0])
    delta = float(np.sqrt(JK.CHI2_MONO))
    i1 = jnp.arange(n_kf - 1, dtype=jnp.int32)
    i2 = i1 + 1
    prob = JE.Problem(linear_solver="cg")
    prob.add_dense("pose", n_kf, 6, JR.retract_pose_wb)
    prob.add_dense("vel", n_kf, 3, JR.retract_additive)
    prob.add_dense("bg", n_kf, 3, JR.retract_additive)
    prob.add_dense("ba", n_kf, 3, JR.retract_additive)
    prob.add_landmarks("pt", n_pt, 3, JR.retract_additive)
    prob.add_term(JE.Term(
        name="reproj", res_fn=JR.point_reproj_body_ba_for(JPK, Rcb, tcb),
        rdim=2, dense_refs=[("pose", B["obs_kf"])],
        lm_ref=("pt", B["obs_pt"]), const={"uv": B["obs_uv"]}, mask=mask,
        info=B["obs_is2"], robust_delta=delta))
    prob.add_landmarks("ln", n_ln, 6, JR.retract_additive)
    prob.add_term(JE.Term(
        name="line", res_fn=JR.make_line_reproj_body_ba(JPK, Rcb, tcb),
        rdim=2, dense_refs=[("pose", B["lobs_kf"])],
        lm_ref=("ln", B["lobs_ln"]), const={"l": B["lobs_eq"]}, mask=mask_l,
        info=jnp.ones(B["lobs_kf"].shape[0], jnp.float32),
        robust_delta=delta))
    prob.add_term(JE.Term(
        name="inertial", res_fn=JR.make_inertial(G), rdim=9,
        dense_refs=[("pose", i1), ("vel", i1), ("bg", i1), ("ba", i1),
                    ("pose", i2), ("vel", i2)],
        const=B["pre_const"], mask=B["edge_valid"], info=B["imu_info"]))
    prob.add_term(JE.Term(name="bg_rw", res_fn=JR.bias_rw, rdim=3,
                          dense_refs=[("bg", i1), ("bg", i2)], const=None,
                          mask=B["edge_valid"], info=B["rw_info_g"]))
    prob.add_term(JE.Term(name="ba_rw", res_fn=JR.bias_rw, rdim=3,
                          dense_refs=[("ba", i1), ("ba", i2)], const=None,
                          mask=B["edge_valid"], info=B["rw_info_a"]))
    return prob


def _states(B):
    return {"pose": B["kf_pose_wb"], "vel": B["kf_vel"], "bg": B["kf_bg"],
            "ba": B["kf_ba"], "pt": B["pt_xyz"], "ln": B["ln_ep6"]}


def _free(B):
    return ({"pose": B["kf_free"], "vel": B["kf_free"],
             "bg": B["kf_free_bias"], "ba": B["kf_free_bias"]},
            {"pt": B["pt_free"], "ln": B["ln_free"]})


def _port_problem(T, dt):
    def c(x):
        return x.to(dt) if x.is_floating_point() else x
    chain = ({k: c(v) for k, v in T["pre_const"].items()}, c(T["imu_info"]),
             T["edge_valid"], c(T["rw_info_g"]), c(T["rw_info_a"]))
    prob = TK._liba_problem(
        K_EUROC, c(T["Rcb"]), c(T["tcb"]), G, T["kf_pose_wb"].shape[0],
        T["pt_xyz"].shape[0], T["ln_ep6"].shape[0],
        (T["obs_kf"].long(), T["obs_pt"].long(), c(T["obs_uv"]),
         c(T["obs_is2"])), T["obs_valid"],
        (T["lobs_kf"].long(), T["lobs_ln"].long(), c(T["lobs_eq"])),
        T["lobs_valid"], chain)
    return prob, {k: c(v) for k, v in _states(T).items()}, _free(T)


def test_liba_lm_step_matches_reference(windows):
    W = windows[True]
    B = _jnp(W)
    Rcb, tcb = B["Rcb"], B["tcb"]

    @jax.jit
    def jstep(B, lam):
        prob = _jax_problem(B, B["obs_valid"], B["lobs_valid"], Rcb, tcb)
        new, cost, _ = prob.solve_step(_states(B), lam, *_free(B))
        return new, cost

    new_j, cost_j = jstep(B, jnp.float32(1e-4))
    T = _t(W)
    out = {}
    for dt in (torch.float32, torch.float64):
        prob, st, free = _port_problem(T, dt)
        out[dt] = prob.solve_step(st, torch.tensor(1e-4, dtype=dt), *free)
    new_t, cost_t, _ = out[torch.float32]
    ref = out[torch.float64][0]
    assert abs(float(cost_t) - float(cost_j)) <= 1e-5 * float(cost_j)
    for k in ("pose", "vel", "bg", "ba"):
        gap_t = float((new_t[k].double() - ref[k]).abs().max())
        gap_j = float((torch.from_numpy(np.array(new_j[k])).double()
                       - ref[k]).abs().max())
        gap = float(np.abs(new_t[k].numpy() - np.asarray(new_j[k])).max())
        assert gap <= 2 * max(gap_t, gap_j) + 1e-6, (k, gap, gap_t, gap_j)


# -- the whole BA ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_liba():
    Rcb, tcb = extrinsics()
    return JK.make_local_inertial_ba(
        JPK, SMALL["n_kf"], SMALL["n_pt"], SMALL["n_obs"],
        Rcb.astype(np.float32), tcb.astype(np.float32), G,
        n_ln=SMALL["n_ln"], n_lobs=SMALL["n_lobs"])


def jax_line_mask(W, pose, ln):
    """The reference's final line inlier mask (its loop's chi2 re-gate at
    the returned state; the JAX function does not return it)."""
    fn = JR.make_line_reproj_body_ba(JPK, jnp.asarray(W["Rcb"]),
                                     jnp.asarray(W["tcb"]))
    z6 = jnp.zeros((W["lobs_kf"].shape[0], 6), jnp.float32)
    r = jax.vmap(fn)((jnp.asarray(pose)[W["lobs_kf"]],
                      jnp.asarray(ln)[W["lobs_ln"]]), (z6, z6),
                     {"l": jnp.asarray(W["lobs_eq"])})
    return np.asarray(W["lobs_valid"]) & (
        np.asarray(jnp.sum(r * r, -1)) < JK.CHI2_MONO)


def errors(W, out):
    """Largest body-position (m), velocity (m/s) and rotation (deg) errors
    against the truth, and the largest bias errors."""
    pose, vel, bg, ba = (np.asarray(o, np.float64) for o in out[:4])
    gt = np.asarray(W["gt_pose_wb"], np.float64)
    dR = np.einsum("kji,kjl->kil", gt[..., :3], pose[..., :3])
    w = np.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0],
                  dR[:, 1, 0] - dR[:, 0, 1]], -1) / 2
    return dict(
        max_pos_m=float(np.linalg.norm(pose[..., 3] - gt[..., 3],
                                       axis=1).max()),
        max_vel_mps=float(np.linalg.norm(vel - W["gt_vel"], axis=1).max()),
        max_rot_deg=float(np.degrees(np.arcsin(np.minimum(
            np.linalg.norm(w, axis=1), 1.0))).max()),
        max_bg=float(np.abs(bg - W["gt_bg"]).max()),
        max_ba=float(np.abs(ba - W["gt_ba"]).max()))


@pytest.mark.parametrize("perturbed", [False, True])
def test_local_inertial_ba_matches_reference(windows, jax_liba, perturbed):
    W = windows[perturbed]
    oj = [np.asarray(a) for a in jax_liba(*[_jnp(W[k]) for k in LIBA_KEYS])]
    stats = []
    run = TK.make_local_inertial_ba(
        K_EUROC, SMALL["n_kf"], SMALL["n_pt"], SMALL["n_obs"], W["Rcb"],
        W["tcb"], G, n_ln=SMALL["n_ln"], n_lobs=SMALL["n_lobs"])
    ot = [a.numpy() for a in run(*[_t(W[k]) for k in LIBA_KEYS],
                                 stats=stats)]
    for i, tol in ((0, 1e-4), (1, 1e-4), (2, 1e-5), (3, 1e-4), (4, 1e-3)):
        assert np.abs(ot[i] - oj[i]).max() <= tol, (i, np.abs(
            ot[i] - oj[i]).max())
    assert (ot[5] == oj[5]).all()
    assert (ot[7] == jax_line_mask(W, oj[0], oj[6])).all()
    assert ot[5].sum() < len(ot[5])
    et, ej = errors(W, ot), errors(W, oj)
    assert abs(et["max_pos_m"] - ej["max_pos_m"]) <= 0.1 * ej["max_pos_m"]
    if perturbed:
        e0 = errors(W, [W[k] for k in ("kf_pose_wb", "kf_vel", "kf_bg",
                                       "kf_ba")])
        assert et["max_pos_m"] < 0.2 * e0["max_pos_m"]
    assert len(stats) == 2


def test_local_inertial_ba_without_lines_matches_reference(windows):
    """The reference's default (n_ln = n_lobs = 0): the point-only window
    solve, same tolerances."""
    W = windows[True]
    Rcb, tcb = (a.astype(np.float32) for a in extrinsics())
    jl = JK.make_local_inertial_ba(JPK, SMALL["n_kf"], SMALL["n_pt"],
                                   SMALL["n_obs"], Rcb, tcb, G)
    keys = LIBA_KEYS[:18]
    oj = [np.asarray(a) for a in jl(*[_jnp(W[k]) for k in keys])]
    run = TK.make_local_inertial_ba(K_EUROC, SMALL["n_kf"], SMALL["n_pt"],
                                    SMALL["n_obs"], Rcb, tcb, G)
    ot = run(*[_t(W[k]) for k in keys])
    assert len(oj) == 6 and ot[6] is None and ot[7] is None
    for i, tol in ((0, 1e-4), (1, 1e-4), (2, 1e-5), (3, 1e-4), (4, 1e-3)):
        assert np.abs(ot[i].numpy() - oj[i]).max() <= tol, i
    assert (ot[5].numpy() == oj[5]).all() and not oj[5].all()


def test_local_inertial_ba_float32_within_float64_band(windows):
    W = windows[True]
    run = TK.make_local_inertial_ba(
        K_EUROC, SMALL["n_kf"], SMALL["n_pt"], SMALL["n_obs"], W["Rcb"],
        W["tcb"], G, n_ln=SMALL["n_ln"], n_lobs=SMALL["n_lobs"])
    out, stats = {}, {}
    for dt in (torch.float32, torch.float64):
        def c(v):
            if isinstance(v, dict):
                return {k: c(x) for k, x in v.items()}
            x = _t(v)
            return x.to(dt) if x.is_floating_point() else x
        stats[dt] = []
        out[dt] = run(*[c(W[k]) for k in LIBA_KEYS], stats=stats[dt])
    assert out[torch.float64][0].dtype == torch.float64
    assert stats[torch.float32] == stats[torch.float64]
    for i in (0, 1):
        gap = float((out[torch.float32][i].double()
                     - out[torch.float64][i]).abs().max())
        assert gap <= 1e-3, (i, gap)
    assert torch.equal(out[torch.float32][5], out[torch.float64][5])


def reference_liba(sizes=(("worst", LIBA_WORST), ("half", LIBA_HALF))):
    """REF_LIBA: per bucket and start, the JAX function's point and line
    inliers and its errors against the truth (`errors`)."""
    out = {}
    Rcb, tcb = (a.astype(np.float32) for a in extrinsics())
    for name, sz in sizes:
        run = JK.make_local_inertial_ba(JPK, 16, sz["n_pt"], sz["n_obs"], Rcb,
                                        tcb, G, n_ln=sz["n_ln"],
                                        n_lobs=sz["n_lobs"])
        for start in ("true", "perturbed"):
            W = {k: _np(v) for k, v in build_inertial_window(
                **sz, device="cpu", perturbed=start == "perturbed").items()}
            o = [np.asarray(a) for a in run(*[_jnp(W[k]) for k in LIBA_KEYS])]
            out[f"{name}_{start}"] = dict(
                n_inliers=int(o[5].sum()),
                n_inliers_l=int(jax_line_mask(W, o[0], o[6]).sum()),
                **errors(W, o))
    return out


if __name__ == "__main__":
    print(json.dumps(reference_liba()))
