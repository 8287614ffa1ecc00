"""The chain-partitioned point BA of the port (plvio_tpu_torch/parallel/
chain_ba.py) against the JAX package on the CPU: `partition_chain` and
`gather_results` bit for bit, the halo and ownership rule of
tests/test_chain_ba.py:131, and `make_chain_ba` at D = 2 held to JAX's on
tests/test_chain_ba.py's chain (16 keyframes, 30 points each, the start of
test_chain_ba_converges_to_engine_quality, 6 outer iterations).

Tolerances, and why: a float64 run of the port at D = 2 is the
yardstick; poses within 2x JAX's distance to it + 1e-4 and points seen by
>= 3 keyframes + 1e-3, the float64 rule of
tests/test_torch_keyframe_step.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from plvio_tpu.parallel import chain_ba as JCB
from plvio_tpu.utils import lie
from plvio_tpu_torch.parallel import chain_ba as CB
from plvio_tpu_torch.parallel.mesh import Mesh

from test_chain_ba import K, _chain_problem


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain():
    rng = np.random.default_rng(0)
    C = 16
    poses_gt, pts_gt, obs_kf, obs_pt, obs_uv = _chain_problem(rng, C=C)
    poses0 = poses_gt.copy()
    for c in range(2, C):
        dx = rng.normal(0, 0.01, 6).astype(np.float32)
        Rp, tp = lie.se3_exp(jnp.asarray(dx))
        poses0[c, :, :3] = np.asarray(Rp) @ poses0[c, :, :3]
        poses0[c, :, 3] = np.asarray(Rp) @ poses0[c, :, 3] + np.asarray(tp)
    pts0 = pts_gt + rng.normal(0, 0.05, pts_gt.shape).astype(np.float32)
    return poses0, pts0, obs_kf, obs_pt, obs_uv


@pytest.mark.parametrize("D,halo", [(2, 2), (8, 2), (3, 1)])
def test_partition_and_gather_bit_equal(chain, D, halo):
    poses0, pts0, obs_kf, obs_pt, obs_uv = chain
    C = len(poses0)
    args = (D, halo, np.arange(C), poses0, obs_kf, obs_pt, obs_uv,
            np.ones(len(obs_kf), np.float32), pts0)
    jd, jl = JCB.partition_chain(*args, fixed_kf=np.array([0, 1]))
    pd, pl = CB.partition_chain(*args, fixed_kf=np.array([0, 1]))
    for f in JCB.ChainBAData._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jd, f)),
                                      getattr(pd, f).numpy(), f)
    for k in jl:
        np.testing.assert_array_equal(jl[k], pl[k], k)
    poses = np.random.default_rng(D).normal(
        size=pd.kf_pose.shape).astype(np.float32)
    pts = np.random.default_rng(D + 1).normal(
        size=pd.pt_xyz.shape).astype(np.float32)
    for a, b in zip(JCB.gather_results(jl, poses, pts, len(pts0)),
                    CB.gather_results(pl, poses, pts, len(pts0))):
        np.testing.assert_array_equal(a, b)


def test_partition_respects_halo_and_ownership():
    """tests/test_chain_ba.py:131 on the port's partitioner."""
    from test_chain_ba import _chain_problem as problem
    rng = np.random.default_rng(1)
    C = 16
    poses_gt, pts_gt, obs_kf, obs_pt, obs_uv = problem(rng, C=C,
                                                       pts_per_kf=5)
    data, layout = CB.partition_chain(
        8, 2, np.arange(C), poses_gt, obs_kf, obs_pt, obs_uv,
        np.ones(len(obs_kf), np.float32), pts_gt)
    free = data.kf_free.numpy()
    W, halo = layout["W"], layout["halo"]
    for d in range(8):
        assert free[d, halo:halo + W].all()
        assert not free[d, :halo].any()
        assert not free[d, halo + W:].any()
    okf = data.obs_kf.numpy()
    ov = data.obs_valid.numpy()
    assert (okf[ov] >= 0).all() and (okf[ov] < layout["Wh"]).all()


def test_chain_ba_against_jax(chain, cpu_devices):
    poses0, pts0, obs_kf, obs_pt, obs_uv = chain
    C, D, halo = len(poses0), 2, 2
    args = (D, halo, np.arange(C), poses0, obs_kf, obs_pt, obs_uv,
            np.ones(len(obs_kf), np.float32), pts0)
    jd, jl = JCB.partition_chain(*args, fixed_kf=np.array([0, 1]))
    pd, pl = CB.partition_chain(*args, fixed_kf=np.array([0, 1]))
    jrun = JCB.make_chain_ba(K, JMesh(np.array(cpu_devices[:D]), ("kf",)),
                             "kf", jl["Wh"], jd.pt_xyz.shape[1],
                             jd.obs_kf.shape[1], outer_iters=6, halo=halo)
    jp, jx = (np.asarray(a) for a in jrun(jd))
    outs = []
    for dt in (torch.float32, torch.float64):
        run = CB.make_chain_ba(K, Mesh(["cpu"] * D), pl["Wh"],
                               pd.pt_xyz.shape[1], pd.obs_kf.shape[1],
                               outer_iters=6, halo=halo, dtype=dt)
        outs.append([a.numpy() for a in run(pd)])
    (pp, px), (rp, rx) = outs
    j = JCB.gather_results(jl, jp, jx, len(pts0))
    p = CB.gather_results(pl, pp.astype(np.float32), px.astype(np.float32),
                          len(pts0))
    r = (CB.gather_results(pl, rp, rx, len(pts0)))
    n_views = np.array([len(np.unique(obs_kf[obs_pt == i]))
                        for i in range(len(pts0))])
    sel = n_views >= 3
    # gather_results writes float32: the yardstick's rounding (~1e-7) is
    # far below the floors
    for k, fl, s in ((0, 1e-4, slice(None)), (1, 1e-3, sel)):
        dp = float(np.abs(p[k][s].astype(np.float64) - r[k][s]).max())
        dj = float(np.abs(j[k][s].astype(np.float64) - r[k][s]).max())
        assert dp <= 2 * dj + fl, (k, dp, dj)
    assert np.abs(p[0] - poses0).max() > 1e-3
