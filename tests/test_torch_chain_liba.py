"""The chain-partitioned visual-inertial BA of the port
(plvio_tpu_torch/parallel/chain_liba.py) against the JAX package on the
CPU: `partition_chain_vi`, `_route_landmarks` and `gather_results_vi` bit
for bit, and `make_chain_liba` at D = 2 held to JAX's.

JAX's own tests of the solver are `slow` (tests/test_chain_liba.py:134,
193: 24 and 12 keyframes, 3-4 sweeps): its compile unrolls every sweep's
two red-black phases.  Here the chain is tests/test_chain_liba.py's
`_build_problem` cut to 8 keyframes x 200 points x 64 lines, perturbed as
test_chain_liba_matches_single_device, one outer sweep (both phases) of
6 iterations, halo 1.

Tolerances, and why: a float64 run of the port is the yardstick; owned
poses, velocities and biases within 2x JAX's distance to it plus float32
floors (1e-4 a pose entry and m/s, 1e-5 m/s^2 and rad/s), the float64
rule of tests/test_torch_keyframe_step.py.
"""
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from plvio_tpu.io import synthetic as jsyn
from plvio_tpu.parallel import chain_liba as JCL
from plvio_tpu_torch.parallel import chain_liba as CL
from plvio_tpu_torch.parallel.mesh import Mesh

from test_chain_liba import K, _build_problem

N_KF, HALO, SWEEPS, ITERS = 8, 1, 1, 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain():
    rng = np.random.default_rng(0)
    prob = _build_problem(rng, n_kf=N_KF, n_pts=200, n_lns=64)
    pose0, vel0 = prob[0].copy(), prob[1].copy()
    for i in range(1, N_KF):
        pose0[i, :, 3] += rng.normal(0, 0.02, 3)
        vel0[i] += rng.normal(0, 0.03, 3)
    return prob, pose0, vel0


def _partition(mod, D, prob, pose0, vel0, halo=HALO):
    (pose_gt, vel_gt, X, ln_ep, obs_kf, obs_pt, obs_uv,
     lobs_kf, lobs_ln, lobs_eq, pre_stack, infos, ev, rwg, rwa) = prob
    bgba = np.zeros((N_KF, 3), np.float32)
    return mod.partition_chain_vi(
        D, halo, N_KF, pose0, vel0, bgba, bgba, obs_kf, obs_pt, obs_uv,
        np.ones(len(obs_kf), np.float32), X.copy(), pre_stack, infos, ev,
        rwg, rwa, lobs_kf=lobs_kf, lobs_ln=lobs_ln, lobs_eq=lobs_eq,
        ln_ep=ln_ep.copy(), fixed_pos=(0,), free_all_biases=False)


@pytest.mark.parametrize("D,halo", [(2, 1), (3, 2), (4, 1)])
def test_partition_and_gather_bit_equal(chain, D, halo):
    prob, pose0, vel0 = chain
    jd, jl = _partition(JCL, D, prob, pose0, vel0, halo)
    pd, pl = _partition(CL, D, prob, pose0, vel0, halo)
    for f in JCL.ChainLIBAData._fields:
        a, b = getattr(jd, f), getattr(pd, f)
        if f == "pre_const":
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), f)
    for k in jl:
        np.testing.assert_array_equal(jl[k], pl[k], k)
    obs_kf, obs_pt = prob[4], prob[5]
    W = -(-N_KF // D)
    for a, b in zip(JCL._route_landmarks(D, W, W + 2 * halo, halo,
                                         len(prob[2]), obs_kf, obs_pt),
                    CL._route_landmarks(D, W, W + 2 * halo, halo,
                                        len(prob[2]), obs_kf, obs_pt)):
        np.testing.assert_array_equal(a, b)
    g = np.random.default_rng(D)
    outs = [g.normal(size=t.shape).astype(np.float32) for t in
            (pd.kf_pose, pd.kf_vel, pd.kf_bg, pd.kf_ba, pd.pt_xyz,
             pd.ln_ep)]
    kw = dict(n_pts=len(prob[2]), n_lns=len(prob[3]))
    for a, b in zip(JCL.gather_results_vi(jl, *outs, **kw),
                    CL.gather_results_vi(pl, *outs, **kw)):
        np.testing.assert_array_equal(a, b)


def test_chain_liba_against_jax(chain, cpu_devices):
    prob, pose0, vel0 = chain
    D = 2
    jd, jl = _partition(JCL, D, prob, pose0, vel0)
    pd, pl = _partition(CL, D, prob, pose0, vel0)
    assert pl["have_lines"]
    shape = (jl["Wh"], jd.pt_xyz.shape[1], jd.obs_kf.shape[1],
             jd.ln_ep.shape[1], jd.lobs_kf.shape[1])
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jrun = JCL.make_chain_liba(K, JMesh(np.array(cpu_devices[:D]), ("kf",)),
                               "kf", *shape, eye, zero, jsyn.GRAVITY,
                               halo=HALO, outer_sweeps=SWEEPS, iters=ITERS)
    j = JCL.gather_results_vi(jl, *[np.asarray(x) for x in jrun(jd)],
                              n_pts=len(prob[2]), n_lns=len(prob[3]))
    res = []
    for dt in (torch.float32, torch.float64):
        run = CL.make_chain_liba(K, Mesh(["cpu"] * D), *shape, eye, zero,
                                 jsyn.GRAVITY, halo=HALO,
                                 outer_sweeps=SWEEPS, iters=ITERS, dtype=dt)
        o = [x.numpy() for x in run(pd)]
        res.append((o, CL.gather_results_vi(pl, *o, n_pts=len(prob[2]),
                                            n_lns=len(prob[3]))))
    (p_raw, p), (r_raw, _) = res
    # the yardstick unrounded: gather_results_vi writes float32 poses
    r = [np.zeros((N_KF,) + r_raw[i].shape[2:]) for i in range(4)]
    W = jl["W"]
    for d in range(D):
        for jj in range(HALO, HALO + W):
            pos = d * W + (jj - HALO)
            if pos < N_KF:
                for i in range(4):
                    r[i][pos] = r_raw[i][d, jj]
    out = {}
    for i, (name, fl) in enumerate((("pose", 1e-4), ("vel", 1e-4),
                                    ("bg", 1e-5), ("ba", 1e-5))):
        dp = float(np.abs(p[i].astype(np.float64) - r[i]).max())
        dj = float(np.abs(j[i].astype(np.float64) - r[i]).max())
        out[name] = (dp, dj)
        assert dp <= 2 * dj + fl, (name, dp, dj)
    print(out)
    assert np.isfinite(p[5]).all()
    assert np.abs(p[0] - pose0).max() > 1e-3
