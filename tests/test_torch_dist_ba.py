"""The landmark-sharded point BA of the port (plvio_tpu_torch/parallel/
dist_ba.py) against the JAX package on the CPU, mirroring
tests/test_dist_ba.py:52 (recovers the truth) and :87 (agrees with the
single-device engine), and held to JAX's make_dist_ba at D = 2 and 4 on
the suite's virtual mesh.

Tolerances, and why: the truth and the engine by tests/test_dist_ba.py's
own bounds (2 cm, 2 cm median; 2e-3 / 5e-3 atol); against JAX, a float64
run of the port at the same D is the yardstick: poses within 2x JAX's
distance to it + 1e-4 and points + 1e-3 (every point is seen by every
camera), the float64 rule of tests/test_torch_keyframe_step.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from plvio_tpu.parallel import dist_ba as JD
from plvio_tpu_torch.parallel import dist_ba as DB
from plvio_tpu_torch.parallel.mesh import Mesh
from plvio_tpu_torch.solver import engine as E
from plvio_tpu_torch.solver import residuals as RES

from test_dist_ba import K, _problem


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(D, n_cams, n_pts, poses0, X0, obs_kf, obs_pt, obs_uv):
    _, _, obs_pt_l, valid, (okf, ouv), (X0_b, free_b) = \
        DB.bucket_observations(D, n_pts, obs_pt, (obs_kf, obs_uv),
                               (X0, np.ones(n_pts, bool)))
    free = np.arange(n_cams) > 0
    return dict(kf_poses=poses0, kf_free=free, pt_xyz=X0_b, pt_free=free_b,
                obs_kf=okf, obs_pt=obs_pt_l, obs_uv=ouv, obs_valid=valid,
                obs_is2=np.ones(len(valid), np.float32))


def _port(D, d, n_cams, iters, dtype=torch.float32):
    data = DB.DistBAData(**{k: torch.from_numpy(np.asarray(v))
                            for k, v in d.items()})
    run = DB.make_dist_ba(K, Mesh(["cpu"] * D), n_cams, iters=iters,
                          dtype=dtype)
    p, x = run(data)
    return p.numpy(), x.numpy()


def _jax(devs, D, d, n_cams, iters):
    data = JD.DistBAData(**{k: jnp.asarray(v) for k, v in d.items()})
    run = JD.make_dist_ba(K, JMesh(np.array(devs[:D]), ("lm",)), "lm",
                          n_cams, iters=iters)
    p, x = run(data)
    return np.asarray(p), np.asarray(x)


def test_bucket_observations_bit_equal():
    rng = np.random.default_rng(3)
    obs_pt = rng.integers(0, 50, 300)
    arrs = (rng.integers(0, 5, 300).astype(np.int32),
            rng.normal(size=(300, 2)).astype(np.float32))
    pts = (rng.normal(size=(50, 3)).astype(np.float32), np.ones(50, bool))
    for D in (2, 3, 8):
        j = JD.bucket_observations(D, 50, obs_pt, arrs, pts)
        p = DB.bucket_observations(D, 50, obs_pt, arrs, pts)
        assert j[:2] == p[:2]
        for a, b in zip([j[2], j[3]] + j[4] + j[5],
                        [p[2], p[3]] + p[4] + p[5]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("D", [2, 4])
def test_dist_ba_recovers_truth_and_holds_to_jax(cpu_devices, D):
    """tests/test_dist_ba.py:52's scene (4 cameras, 96 points, 12
    iterations): the truth recovered, and the port within the float64
    rule of JAX's make_dist_ba at the same D."""
    rng = np.random.default_rng(0)
    n_cams, n_pts = 4, 96
    poses_gt, X_gt, poses0, X0, obs_kf, obs_pt, obs_uv = _problem(
        rng, n_cams, n_pts)
    d = _data(D, n_cams, n_pts, poses0, X0, obs_kf, obs_pt, obs_uv)
    p, x = _port(D, d, n_cams, 12)
    assert np.abs(p[:, :, 3] - poses_gt[:, :, 3]).max() < 2e-2
    assert np.median(np.linalg.norm(x[:n_pts] - X_gt, axis=-1)) < 2e-2
    j = _jax(cpu_devices, D, d, n_cams, 12)
    r = _port(D, d, n_cams, 12, torch.float64)
    for a, b, c, fl in ((p, j[0], r[0], 1e-4), (x, j[1], r[1], 1e-3)):
        dp = float(np.abs(a - c).max())
        dj = float(np.abs(b.astype(np.float64) - c).max())
        assert dp <= 2 * dj + fl, (D, dp, dj)


def test_dist_ba_agrees_with_engine():
    """tests/test_dist_ba.py:87: the sharded result on 8 shards equals
    the single-device engine's (LM, 12 iterations) within its bounds."""
    rng = np.random.default_rng(0)
    n_cams, n_pts = 3, 64
    poses_gt, X_gt, poses0, X0, obs_kf, obs_pt, obs_uv = _problem(
        rng, n_cams, n_pts)
    prob = E.Problem()
    prob.add_dense("pose", n_cams, 6, RES.retract_pose_cw)
    prob.add_landmarks("pt", n_pts, 3, RES.retract_additive)
    nobs = len(obs_kf)
    prob.add_term(E.Term(
        name="reproj", res_fn=RES.make_point_reproj(K), rdim=2,
        dense_refs=[("pose", torch.from_numpy(obs_kf).long())],
        lm_ref=("pt", torch.from_numpy(obs_pt).long()),
        const={"uv": torch.from_numpy(obs_uv)},
        mask=torch.ones(nobs, dtype=torch.bool),
        info=torch.ones(nobs), robust_delta=float(np.sqrt(5.991))))
    states = {"pose": torch.from_numpy(poses0), "pt": torch.from_numpy(X0)}
    free = {"pose": torch.from_numpy(np.arange(n_cams) > 0)}
    states, _, _ = E.optimize(prob, states, iters=12, dense_free_mask=free,
                              lm_free_mask={"pt": torch.ones(
                                  n_pts, dtype=torch.bool)})
    d = _data(8, n_cams, n_pts, poses0, X0, obs_kf, obs_pt, obs_uv)
    p, x = _port(8, d, n_cams, 12)
    np.testing.assert_allclose(p, states["pose"].numpy(), atol=2e-3)
    np.testing.assert_allclose(x[:n_pts], states["pt"].numpy(), atol=5e-3)
