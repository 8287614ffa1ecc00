"""The essential graph of the PyTorch port (models/kernels.py
`make_pose_graph_optimizer`, its plain version on the dense engine with
the Cholesky solve) against the JAX package's on the CPU, on the two
drift corrections of tests/test_pose_graph.py: Sim3 (rotation,
translation and scale drift, a strong loop edge) and 4-DoF (yaw and
translation drift).  Rule: every state within 2x the JAX run's distance
to the port's float64 run + max(1e-5, the float32 floor), and the
reference test's own bounds on the port's result.  The float32 floor is
the largest step of the float64 run whose cost change lies below
float32's resolution (relative 1e-6): near the optimum a float32 run
takes or refuses such a step by the rounding of its residuals (the
4-DoF graph's third step, 3.1e-5, which the JAX run takes and the
port's refuses).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plvio_tpu.models import kernels as JKN
from plvio_tpu.utils import lie as JL

from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.solver import engine as E
from plvio_tpu_torch.solver import residuals as RES


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the plain path's many small ops
    gain nothing from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def _rel(a, b):
    """S_b S_a^{-1} by the reference's float32 Sim(3) functions."""
    Rai, tai, sai = JL.sim3_inv(_j(a[0]), _j(a[1]), _j(a[2]))
    R, t, s = JL.sim3_mul(_j(b[0]), _j(b[1]), _j(b[2]), Rai, tai, sai)
    return np.asarray(R), np.asarray(t), float(s)


def _drift_graph(rng, four_dof: bool):
    """tests/test_pose_graph.py's graphs, drawn from rng in their order:
    12 keyframes on a 2 m circle, odometry edges measured from drifted
    estimates, a loop edge (information 100) with the true relative
    pose; the first keyframe fixed.  Returns (arguments, truth,
    estimates)."""
    n = 12
    angles = np.linspace(0, 2 * np.pi * (n - 1) / n, n)
    gt = []
    for a in angles:
        c, s = np.cos(a), np.sin(a)
        R_wk = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        p_wk = np.array([2 * c, 2 * s, 0.0])
        gt.append((R_wk.T, -R_wk.T @ p_wk, 1.0))
    est = [gt[0]]
    for i in range(1, n):
        Rji, tji, sji = _rel(gt[i - 1], gt[i])
        if four_dof:
            dR = np.asarray(JL.so3_exp(_j([0, 0, rng.normal(0, 0.03)])))
            meas = (dR @ Rji, tji + rng.normal(0, 0.05, 3), sji)
        else:
            dR = np.asarray(JL.so3_exp(_j(rng.normal(0, 0.02, 3))))
            meas = (dR @ Rji, tji + rng.normal(0, 0.05, 3),
                    sji * np.exp(rng.normal(0, 0.02)))
        R, t, s = JL.sim3_mul(_j(meas[0]), _j(meas[1]),
                              jnp.asarray(meas[2], jnp.float32),
                              _j(est[-1][0]), _j(est[-1][1]),
                              jnp.asarray(np.float32(est[-1][2])))
        est.append((np.asarray(R), np.asarray(t), float(s)))
    cap_kf, cap_e = 16, 32
    states = np.zeros((cap_kf, 13), np.float32)
    for i in range(n):
        R, t, s = est[i]
        states[i] = np.concatenate([np.asarray(R).reshape(-1),
                                    np.asarray(t), [s]])
    ei, ej, Rs, ts, ss = [], [], [], [], []
    for i in range(1, n):
        Rji, tji, sji = _rel(est[i], est[i - 1])
        ei.append(i), ej.append(i - 1), Rs.append(Rji), ts.append(tji)
        ss.append(sji)
    Rji, tji, sji = _rel(gt[n - 1], gt[0])
    ei.append(n - 1), ej.append(0), Rs.append(Rji), ts.append(tji)
    ss.append(sji)
    ne = len(ei)

    def pad(a, fill=0):
        a = np.asarray(a)
        return np.concatenate([a, np.full((cap_e - ne,) + a.shape[1:], fill,
                                           a.dtype)])
    kf_free = np.zeros(cap_kf, bool)
    kf_free[1:n] = True
    args = [states, kf_free, pad(np.asarray(ei, np.int32)),
            pad(np.asarray(ej, np.int32)),
            pad(np.stack(Rs).astype(np.float32)),
            pad(np.asarray(ts, np.float32)),
            pad(np.asarray(ss, np.float32), 1.0),
            np.arange(cap_e) < ne,
            np.concatenate([np.ones(ne - 1), [100.0],
                            np.zeros(cap_e - ne)]).astype(np.float32)]
    return args, gt, est


def float32_floor(ts, four_dof: bool, iters: int) -> float:
    """The largest state change of a float64 LM step (taken or not) whose
    relative cost change is below 1e-6."""
    d = [t.double() if t.dtype == torch.float32 else t for t in ts]
    prob = E.Problem()
    prob.add_dense("sim3", d[0].shape[0], 7, RES.retract_sim3_4dof
                   if four_dof else RES.retract_sim3)
    prob.add_term(E.Term(
        name="sim3", res_fn=RES.sim3_edge_4dof if four_dof
        else RES.sim3_edge, rdim=7,
        dense_refs=[("sim3", d[2].long()), ("sim3", d[3].long())],
        const={"Rji": d[4], "tji": d[5], "sji": d[6]}, mask=d[7],
        info=d[8]))
    st, free = {"sim3": d[0]}, {"sim3": d[1]}
    cost, _ = prob.cost(st)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    floor = 0.0
    for _ in range(iters):
        new, _, _ = prob.solve_step(st, lam, free)
        nc, _ = prob.cost(new)
        if abs(float(nc - cost)) < 1e-6 * float(cost):
            floor = max(floor, float((new["sim3"] - st["sim3"]).abs().max()))
        acc = bool(nc < cost)
        if acc:
            st, cost = new, nc
        lam = torch.clamp(lam * (0.5 if acc else 4.0), 1e-8, 1e4)
    return floor


def _center(R, t, s):
    return -(np.asarray(R, np.float64).T @ np.asarray(t, np.float64)) / s


@pytest.mark.parametrize("four_dof", [False, True])
def test_drift_correction_against_jax(four_dof):
    args, gt, est = _drift_graph(np.random.default_rng(0), four_dof)
    out_j = np.asarray(JKN.make_pose_graph_optimizer(
        16, 32, iters=20, four_dof=four_dof)(*[jnp.asarray(a)
                                                for a in args]), np.float64)
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    run = KN.make_pose_graph_optimizer(16, 32, iters=20, four_dof=four_dof)
    out_t = run(*ts).double()
    out_64 = run(*[t.double() if t.dtype == torch.float32 else t
                   for t in ts])
    gap_j = float(np.abs(out_j - out_64.numpy()).max())
    gap_t = float((out_t - out_64).abs().max())
    floor = float32_floor(ts, four_dof, 20)
    assert gap_t <= 2 * gap_j + max(1e-5, floor), (gap_t, gap_j, floor)
    # the graph compacted to its 12 active keyframes (as the loop closer
    # calls it) is held to the same rule
    out_c = run(*ts, n_active=12).double()
    gap_c = float((out_c - out_64).abs().max())
    assert gap_c <= 2 * gap_j + max(1e-5, floor), (gap_c, gap_j, floor)
    # the reference test's bounds, on the port's states
    n = 12
    o = out_t.numpy()
    before = np.linalg.norm(_center(*est[-1]) - _center(*gt[-1]))
    after = np.linalg.norm(_center(o[n - 1, :9].reshape(3, 3),
                                   o[n - 1, 9:12], o[n - 1, 12])
                           - _center(*gt[-1]))
    assert before > 0.1 and after < 0.35 * before, (before, after)
    if four_dof:
        np.testing.assert_allclose(o[:n, 12], 1.0, atol=1e-5)
        for i in range(n):
            np.testing.assert_allclose(
                o[i, :9].reshape(3, 3) @ [0, 0, 1.0],
                np.asarray(est[i][0]) @ [0, 0, 1.0], atol=1e-4)
    else:
        assert np.abs(np.log(o[:n, 12])).max() < 0.1
