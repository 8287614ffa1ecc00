"""Keyframe culling on the port's LocalMapper: the counterparts of
tests/test_kf_culling.py:75-133 (the redundancy rule, the temporal-chain
rewire, the keyframe-database hook, the protected keyframes and the
inertial preintegration merge), each also held to the JAX LocalMapper on
the same map: the same keyframes culled, the same stores after, and the
merged windows' preintegration within 5e-5 relative (the two packages'
float32 preintegrations of the same 100 samples; tests/test_torch_imu.py
holds 10 samples to 1e-5)."""
import numpy as np

from plvio_tpu.config import CameraConfig as JCameraConfig
from plvio_tpu.config import Sensor as JSensor
from plvio_tpu.config import SystemConfig as JSystemConfig
from plvio_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plvio_tpu.models.mapstore import Atlas as JAtlas
from plvio_tpu.models.mapstore import MapStore as JMapStore
from plvio_tpu_torch.config import CameraConfig, Sensor, SystemConfig
from plvio_tpu_torch.models.local_mapping import LocalMapper
from plvio_tpu_torch.models.mapstore import Atlas, MapStore
from plvio_tpu_torch.state import mapstore_to_numpy

KF_ARRAYS = ("kf_valid", "kf_prev", "kf_next", "kf_match_pt", "pt_n_obs",
             "covis", "kf_feat_valid")


def _project(K, pose_cw, X):
    pc = X @ pose_cw[:, :3].T + pose_cw[:, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    return np.stack([K[0] * pc[:, 0] / z + K[2],
                     K[1] * pc[:, 1] / z + K[3]], -1), pc[:, 2]


def _build_redundant_map(store_cls, n_kf=8, n_pts=200, seed=0, n_feat=256):
    """n_kf keyframes all observing the same cloud (the middle ones are
    redundant by the 90% / 3-observer rule), in a store of either
    package."""
    rng = np.random.default_rng(seed)
    K = (458.654, 457.296, 367.215, 248.375)
    X = rng.uniform(-1.5, 1.5, (n_pts, 3)).astype(np.float32)
    X[:, 2] += 5.0
    desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    m = store_cls(max_kf=32, max_pts=1024, max_lines=64, n_feat=n_feat)
    pts = m.alloc_points(n_pts)
    m.pt_xyz[pts] = X
    m.pt_desc[pts] = desc
    for k in range(n_kf):
        kf = m.alloc_kf()
        t = np.array([0.05 * k, 0.0, 0.0], np.float32)
        pose = np.concatenate([np.eye(3, dtype=np.float32), -t[:, None]], 1)
        m.kf_pose_cw[kf] = pose
        m.kf_timestamp[kf] = 0.25 * k
        uv, _ = _project(K, pose, X)
        m.kf_feat_uv[kf, :n_pts] = uv
        m.kf_feat_desc[kf, :n_pts] = desc
        m.kf_feat_valid[kf, :n_pts] = True
        m.kf_feat_octave[kf, :n_pts] = 0
        m.kf_match_pt[kf, :n_pts] = pts
        m.pt_n_obs[pts] += 1
        if k > 0:
            m.kf_prev[kf] = kf - 1
            m.kf_next[kf - 1] = kf
    for k in range(n_kf):
        m.update_covisibility(k)
    return m, pts


class KfdbStub:
    """The keyframe database's hook: records the removed keyframes."""

    def __init__(self):
        self.removed = []

    def remove_keyframe(self, kf):
        self.removed.append(int(kf))


def _mappers(sensor=0):
    """The port's and the JAX mapper (lines off, no distortion) on their
    own copies of the redundant map, each with a database stub."""
    mp_map, pts = _build_redundant_map(MapStore)
    j_map, _ = _build_redundant_map(JMapStore)
    cfg = SystemConfig(sensor=Sensor(sensor), use_lines=False,
                       camera=CameraConfig(dist=(0., 0., 0., 0.)))
    jcfg = JSystemConfig(sensor=JSensor(sensor), use_lines=False,
                         camera=JCameraConfig(dist=(0., 0., 0., 0.)))
    mp = LocalMapper(cfg, Atlas([mp_map]), 256, device="cpu", plain=True)
    jl = JLocalMapper(jcfg, JAtlas([j_map]), 256)
    mp.kfdb, jl.kfdb = KfdbStub(), KfdbStub()
    return mp, jl, pts


def _same_store(mp, jl):
    p, j = mapstore_to_numpy(mp.map), mapstore_to_numpy(jl.map)
    for k in KF_ARRAYS:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    assert p["n_kf"] == j["n_kf"]


def test_cull_removes_redundant_kf():
    mp, jl, pts = _mappers()
    m = mp.map
    n_before = m.n_kf
    removed = mp.cull_keyframes(kf=7)
    assert [r[0] for r in removed] == [r[0] for r in jl.cull_keyframes(kf=7)]
    _same_store(mp, jl)
    assert len(removed) > 0, "no redundant KF culled"
    rm_ids = [r[0] for r in removed]
    # origin, newest two and the target stay
    assert 0 not in rm_ids and 7 not in rm_ids and 6 not in rm_ids
    assert m.n_kf == n_before - len(removed)
    assert mp.kfdb.removed == rm_ids and mp.n_culled == len(rm_ids)
    for rid, pose, ts in removed:
        assert not m.kf_valid[rid]
        assert ts == 0.25 * rid and pose.shape == (3, 4)
    # the chain walks oldest -> newest around the holes
    chain = m.kf_chain()
    assert all(m.kf_valid[c] for c in chain)
    for a, b in zip(chain[:-1], chain[1:]):
        assert m.kf_next[a] == b and m.kf_prev[b] == a
    # observation counts stayed consistent
    live = pts[m.pt_valid[pts]]
    recount = (m.kf_match_pt[m.kf_valid] == live[:, None, None]).sum((1, 2))
    np.testing.assert_array_equal(m.pt_n_obs[live], recount)


def test_cull_protects_listed_kfs():
    mp, jl, _ = _mappers()
    all_mid = {1, 2, 3, 4, 5}
    assert mp.cull_keyframes(kf=7, protect=all_mid) == []
    assert jl.cull_keyframes(kf=7, protect=all_mid) == []
    assert mp.kfdb.removed == []


def test_cull_inertial_merges_preintegration():
    mp, jl, _ = _mappers(sensor=3)
    m = mp.map
    rng = np.random.default_rng(1)
    # raw IMU windows on every chain KF (0.25 s @ 200 Hz each)
    for kf in range(1, 8):
        n = 50
        g = rng.normal(0, 0.01, (n, 3)).astype(np.float32)
        a = (np.array([0, 0, 9.81], np.float32)
             + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
        d = np.full(n, 1.0 / 200, np.float32)
        for x in (mp, jl):
            x.map.kf_imu_raw[kf] = (g, a, d)
            x.map.kf_preint[kf] = x._reintegrate(g, a, d, np.zeros(3),
                                                 np.zeros(3))
    removed = mp.cull_keyframes(kf=7)
    assert [r[0] for r in removed] == [r[0] for r in jl.cull_keyframes(kf=7)]
    _same_store(mp, jl)
    assert len(removed) > 0
    for rid, _, _ in removed:
        assert rid not in m.kf_imu_raw and rid not in m.kf_preint
        nxt = [k for k in range(8) if m.kf_valid[k] and
               m.kf_timestamp[k] > 0.25 * rid]
        assert nxt, "successor vanished"
        succ = min(nxt, key=lambda k: m.kf_timestamp[k])
        # the successor's window absorbed the culled KF's samples
        assert len(m.kf_imu_raw[succ][2]) >= 100
        # its preintegration spans both windows (dT ~ 0.5 s per absorbed
        # cull), as the reference's does
        assert float(m.kf_preint[succ].dT) >= 0.49
        pj = jl.map.kf_preint[succ]
        for f in ("dT", "dR", "dV", "dP", "C"):
            a, b = np.asarray(getattr(m.kf_preint[succ], f)), \
                np.asarray(getattr(pj, f))
            assert np.abs(a - b).max() <= 5e-5 * max(np.abs(b).max(), 1e-6), f
