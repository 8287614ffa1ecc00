"""The port's loop closer (models/loop_closing.py) against the JAX
package's on the CPU, on the hand-made maps of the reference's tests:
the drifted circle (tests/test_loop_closing.py:15) closed through
`process_keyframe`, its essential graph (Sim3 and, on the map marked
inertial, 4-DoF: tests/test_inertial_global.py:28), the chained global BA
(tests/test_loop_closing.py:120), the guided Sim3 refinement (:180), the
601-keyframe chain subsampled beyond the graph's capacity
(tests/test_essential_graph_big.py:62) and the two-map merge
(tests/test_map_merge.py:63) with the tracker rebound by
`on_map_merged`.

Teacher-forced: the port draws the reference's RANSAC samples
(`sim3_sampler`: the JAX key split once per verification) and takes the
reference database's query answers.  The L1 score of two disjoint bags
is float32 noise (+-1.2e-7) whose sign follows the reduction order, and
`query_grouped` admits every candidate scoring above 0; so the port's own
answers are held to the reference's on every candidate above 1e-5 (the
same keyframes and score sequence within 1e-5, in the same order but
among candidates whose scores tie within 1e-5), and the reference's
answers are what both closers act on.

Tolerances: decisions, consistency groups and votes, RANSAC inlier counts
and the merge's slot maps and fused points equal; RANSAC scales within
1e-5 relative; the essential graph's keyframe poses within 1e-4 of the
reference (a pose entry, float32 LM near its optimum); after the global
BA, whose monocular gauge leaves the scale free, the reference tests' own
bounds and the revisit error within 2x the reference's + 1 cm.

Run as a script it prints REF_LOOPCLOSE for chip_smoke.py: the JAX loop
closer at production caps on the drifted circle and the merge.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plvio_tpu.config import CameraConfig as JCameraConfig
from plvio_tpu.config import SystemConfig as JSystemConfig
from plvio_tpu.models import loop_closing as JLC_mod
from plvio_tpu.models import tracking as JTR
from plvio_tpu.models import vocabulary as JV
from plvio_tpu.models.kfdb import AtlasKeyFrameDatabase as JAtlasDB
from plvio_tpu.models.kfdb import KeyFrameDatabase as JDB
from plvio_tpu.models.mapstore import Atlas as JAtlas
from plvio_tpu.models.mapstore import MapStore as JMapStore
from plvio_tpu.ops import pnp as JPNP
from plvio_tpu.utils import lie as JL

from plvio_tpu_torch import config as PC
from plvio_tpu_torch.inputs import (build_big_chain, build_drifted_loop_map,
                                    build_gba_chain, build_merge_maps)
from plvio_tpu_torch.models import tracking as PTR
from plvio_tpu_torch.models import vocabulary as PV
from plvio_tpu_torch.models.kfdb import AtlasKeyFrameDatabase as PAtlasDB
from plvio_tpu_torch.models.kfdb import KeyFrameDatabase as PDB
from plvio_tpu_torch.models.loop_closing import LoopCloser as PLC
from plvio_tpu_torch.models.mapstore import Atlas as PAtlas
from plvio_tpu_torch.state import mapstore_from_numpy, mapstore_to_numpy

from test_loop_closing import _build_drifted_loop_map
from test_torch_sim3 import JaxSim3Samples

NOISE = 1e-5          # scores below: float32 noise of disjoint bags
POSE_TOL = 1e-4       # an essential-graph pose entry against the reference


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the plain path's many small ops
    gain nothing from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    dist = (0.0, 0.0, 0.0, 0.0)
    return (JSystemConfig(camera=JCameraConfig(dist=dist), use_lines=False),
            PC.SystemConfig(camera=PC.CameraConfig(dist=dist),
                            use_lines=False))


class TeacherDB:
    """The port's database, its answers held to the reference's above the
    noise floor; the reference's answers returned."""

    def __init__(self, port, ref):
        self.port, self.ref = port, ref
        self.queries = 0

    def __getattr__(self, name):
        return getattr(self.port, name)

    def query_grouped(self, *args, **kw):
        cp, sp = self.port.query_grouped(*args, **kw)
        cj, sj = self.ref.query_grouped(*args, **kw)
        strong_p = [(int(c), float(s)) for c, s in zip(cp, sp) if s > NOISE]
        strong_j = [(int(c), float(s)) for c, s in zip(cj, sj) if s > NOISE]
        # the same candidates with the same score sequence; candidates
        # whose scores tie within the noise may come in either order
        assert sorted(c for c, _ in strong_p) == \
            sorted(c for c, _ in strong_j), (strong_p, strong_j)
        assert all(abs(a - b) <= NOISE for (_, a), (_, b)
                   in zip(strong_p, strong_j)), (strong_p, strong_j)
        for c, s_ in strong_p:
            assert abs(s_ - dict(strong_j)[c]) <= NOISE, (strong_p, strong_j)
        self.queries += 1
        return cj, sj

    def query_other_maps(self, *args, **kw):
        op = self.port.query_other_maps(*args, **kw)
        oj = self.ref.query_other_maps(*args, **kw)
        sp = [(m, k) for m, k, s in op if s > NOISE]
        sj = [(m, k) for m, k, s in oj if s > NOISE]
        assert sp == sj, (op, oj)
        self.queries += 1
        return oj


class RansacLog:
    """Each side's RANSAC results (inliers, scale), in call order."""

    def __init__(self, monkeypatch, plc):
        self.jax, self.port = [], []
        orig_j = JPNP.sim3_ransac

        def jax_ransac(*a, **kw):
            out = orig_j(*a, **kw)
            self.jax.append((int(out[4]), float(out[0])))
            return out
        monkeypatch.setattr(JPNP, "sim3_ransac", jax_ransac)
        orig_p = plc._ransac

        def port_ransac(*a, **kw):
            r = orig_p(*a, **kw)
            self.port.append((int(r.n), float(r.s)))
            return r
        plc._ransac = port_ransac

    def check(self):
        assert len(self.jax) == len(self.port) > 0
        for (nj, sj), (np_, sp) in zip(self.jax, self.port):
            assert nj == np_ and abs(sj - sp) <= 1e-5 * abs(sj), \
                (self.jax, self.port)


def _groups(lc):
    return [(sorted(int(k) for k in g), int(v)) for g, v in lc.consistency]


def _circle_closers():
    cfg_j, cfg_p = _cfgs()
    m_j, kfs, _ = _build_drifted_loop_map(np.random.default_rng(0))
    m_p, kfs_p, _ = build_drifted_loop_map(0)
    assert kfs == kfs_p
    for name in ("kf_pose_cw", "kf_feat_uv", "kf_feat_desc", "kf_match_pt",
                 "pt_xyz", "pt_desc", "covis"):
        assert np.array_equal(getattr(m_j, name), getattr(m_p, name)), name
    db_j = JDB(JV.random_vocabulary(seed=0), m_j.max_kf, m_j.n_feat)
    db_p = PDB(PV.random_vocabulary(seed=0), m_p.max_kf, m_p.n_feat,
               device="cpu")
    for kf in kfs:
        db_j.add_keyframe(kf, m_j.kf_feat_desc[kf], m_j.kf_feat_valid[kf])
        db_p.add_keyframe(kf, m_p.kf_feat_desc[kf], m_p.kf_feat_valid[kf])
    lc_j = JLC_mod.LoopCloser(cfg_j, JAtlas(maps=[m_j], active=0), db_j,
                              m_j.n_feat, pg_kf_cap=64, pg_edge_cap=256)
    lc_p = PLC(cfg_p, PAtlas(maps=[m_p], active=0), TeacherDB(db_p, db_j),
               m_p.n_feat, pg_kf_cap=64, pg_edge_cap=256, device="cpu",
               sim3_sampler=JaxSim3Samples(cfg_j.seed))
    return lc_j, lc_p, m_j, m_p, kfs


def _centre(m, k):
    return -m.kf_pose_cw[k, :, :3].T @ m.kf_pose_cw[k, :, 3]


def test_drifted_circle_closes_like_jax(monkeypatch):
    lc_j, lc_p, m_j, m_p, kfs = _circle_closers()
    log = RansacLog(monkeypatch, lc_p)
    for kf in kfs[-4:]:
        # the port first: it asks the reference's database before the
        # reference closer acts on the keyframe
        b = lc_p.process_keyframe(kf)
        a = lc_j.process_keyframe(kf)
        assert a == b, kf
        assert _groups(lc_j) == _groups(lc_p), kf
    assert lc_j.n_loops_closed == lc_p.n_loops_closed == 1
    log.check()
    assert lc_p.last_verify["ransac_inliers"] == log.jax[-1][0]
    assert lc_j._loop_edges == lc_p._loop_edges
    err_j = np.linalg.norm(_centre(m_j, kfs[-1]) - _centre(m_j, kfs[0]))
    err_p = np.linalg.norm(_centre(m_p, kfs[-1]) - _centre(m_p, kfs[0]))
    assert err_p < 0.12 and err_p <= 2 * err_j + 0.01, (err_p, err_j)


@pytest.mark.parametrize("inertial", [False, True])
def test_essential_graph_like_jax(inertial):
    """The drifted circle's essential graph with the last keyframe
    welded onto the first one's view (on the map marked inertial, a yaw
    and translation weld): poses within POSE_TOL of the reference; 4-DoF
    on the inertial map, roll and pitch of every keyframe unchanged within
    1e-3."""
    lc_j, lc_p, m_j, m_p, kfs = _circle_closers()
    for m in (m_j, m_p):
        m.imu_initialized = inertial
    chain = m_p.kf_chain()
    pre = {int(k): (m_p.kf_pose_cw[k, :, :3].copy(),
                    m_p.kf_pose_cw[k, :, 3].copy()) for k in chain}
    # an actual weld: the last keyframe onto the first one's view
    R_w = (m_p.kf_pose_cw[kfs[0], :, :3].T
           @ m_p.kf_pose_cw[kfs[-1], :, :3]).astype(np.float64)
    t_w = _centre(m_p, kfs[0]) - R_w @ _centre(m_p, kfs[-1])
    if inertial:
        # a yaw and translation weld: gravity keeps every tilt
        R_w = JL.so3_exp(jnp.asarray([0.0, 0.0, 0.05], jnp.float32))
        R_w, t_w = np.asarray(R_w, np.float64), np.array([0.1, -0.05, 0.0])
    tilt = m_p.kf_pose_cw[chain, :, :3] @ np.array([0, 0, 1.0])
    for lc, m in ((lc_j, m_j), (lc_p, m_p)):
        k = int(kfs[-1])
        Rn = m.kf_pose_cw[k, :, :3] @ R_w.T
        m.kf_pose_cw[k, :, 3] = m.kf_pose_cw[k, :, 3] - Rn @ t_w
        m.kf_pose_cw[k, :, :3] = Rn
        lc._essential_graph(k, int(kfs[0]), 1.0, R_w, t_w,
                            {a: (b[0].copy(), b[1].copy())
                             for a, b in pre.items()}, {k})
    gap = np.abs(m_j.kf_pose_cw[chain] - m_p.kf_pose_cw[chain]).max()
    assert gap <= POSE_TOL, gap
    assert np.abs(m_j.pt_xyz - m_p.pt_xyz).max() <= 10 * POSE_TOL
    assert lc_p.last_graph["four_dof"] == inertial
    assert lc_p.last_graph["n"] == len(chain)
    moved = np.abs(m_p.kf_pose_cw[chain, :, 3]
                   - np.stack([pre[int(k)][1] for k in chain])).max()
    assert moved > 1e-3
    if inertial:
        after = m_p.kf_pose_cw[chain, :, :3] @ np.array([0, 0, 1.0])
        assert np.linalg.norm(after - tilt, axis=1).max() < 1e-3


def test_essential_graph_beyond_cap_like_jax():
    """tests/test_essential_graph_big.py:62: 601 keyframes through a
    64-keyframe graph; the subsampled graph and the rigid propagation
    distribute the loop correction."""
    cfg_j, cfg_p = _cfgs()
    m_p, kfs, gt = build_big_chain()
    m_j = JMapStore(max_kf=640, max_pts=64, max_lines=8, n_feat=8)
    for name, a in mapstore_to_numpy(m_p).items():
        if isinstance(a, np.ndarray):
            setattr(m_j, name, a.copy())
        elif name in ("n_kf", "n_pt", "n_ln", "change_index"):
            setattr(m_j, name, a)
    outs = []
    for lc_cls, m, cfg, kw in (
            (JLC_mod.LoopCloser, m_j, cfg_j, {}),
            (PLC, m_p, cfg_p, dict(device="cpu"))):
        voc = JV.random_vocabulary(seed=0) if lc_cls is not PLC \
            else PV.random_vocabulary(seed=0)
        db = JDB(voc, m.max_kf, m.n_feat) if lc_cls is not PLC \
            else PDB(voc, m.max_kf, m.n_feat, device="cpu")
        atlas = JAtlas(maps=[m], active=0) if lc_cls is not PLC \
            else PAtlas(maps=[m], active=0)
        lc = lc_cls(cfg, atlas, db, m.n_feat, pg_kf_cap=64,
                    pg_edge_cap=2048, **kw)
        chain = m.kf_chain()
        assert len(chain) == 601
        pre = {int(k): (m.kf_pose_cw[k, :, :3].copy(),
                        m.kf_pose_cw[k, :, 3].copy()) for k in chain}
        kf, cand = int(kfs[-1]), int(kfs[0])
        R_gt, t_gt = gt[-1]
        R_pre, t_pre = pre[kf]
        R_w = R_gt.T @ R_pre
        t_w = R_gt.T @ (t_pre - t_gt)
        Rn = m.kf_pose_cw[kf, :, :3] @ R_w.T
        m.kf_pose_cw[kf, :, 3] = m.kf_pose_cw[kf, :, 3] - Rn @ t_w
        m.kf_pose_cw[kf, :, :3] = Rn
        lc._essential_graph(kf, cand, 1.0, R_w, t_w, pre, {kf})
        outs.append(lc)

    def t_err(m):
        return np.asarray([np.linalg.norm(
            -m.kf_pose_cw[k, :, :3].T @ m.kf_pose_cw[k, :, 3]
            - (-gt[i][0].T @ gt[i][1])) for i, k in enumerate(kfs)])
    e_p = t_err(m_p)
    assert outs[1].last_graph["n"] <= 64 < outs[1].last_graph["chain"]
    assert e_p.max() < 0.4 * 0.8 and e_p[-1] < 0.1
    gap = np.abs(m_j.kf_pose_cw[kfs] - m_p.kf_pose_cw[kfs]).max()
    assert gap <= POSE_TOL, gap


def test_chained_gba_like_jax():
    """tests/test_loop_closing.py:120's chain at a 16-keyframe global BA
    capacity: every non-anchor keyframe moves, the mean error shrinks
    below 0.85x (the reference test's own run on its map), and the port
    solves that map as the reference does (the monocular gauge leaves the
    scale free to float32 noise): the mean keyframe translation change
    of the port's solve within 10% of the reference's on the same map."""
    import test_loop_closing as T
    cfg_j, cfg_p = _cfgs()
    rng = np.random.default_rng(0)
    captured = {}
    orig = JLC_mod.LoopCloser.run_global_ba

    def capture(self, fixed_kf, iters=10):
        captured["map"] = mapstore_to_numpy(self.map)
        return orig(self, fixed_kf, iters)
    JLC_mod.LoopCloser.run_global_ba = capture
    try:
        T.test_chained_gba_moves_every_keyframe(rng)
    finally:
        JLC_mod.LoopCloser.run_global_ba = orig
    m_p = mapstore_from_numpy(captured["map"])
    # the port's own generator of the same chain: equal but for the perturbed
    # poses' rotations (torch's so3_exp against JAX's, float32)
    m_b, _ = build_gba_chain(0)
    for name in ("kf_feat_uv", "kf_match_pt", "pt_xyz", "kf_timestamp"):
        assert np.array_equal(getattr(m_b, name), getattr(m_p, name)), name
    assert np.abs(m_b.kf_pose_cw - m_p.kf_pose_cw).max() <= 1e-6
    m_j = JMapStore(max_kf=m_p.max_kf, max_pts=m_p.max_pts, max_lines=8,
                    n_feat=m_p.n_feat)
    for name, a in captured["map"].items():
        if isinstance(a, np.ndarray):
            setattr(m_j, name, a.copy())
    db = PDB(PV.random_vocabulary(seed=0), m_p.max_kf, m_p.n_feat,
             device="cpu")
    lc_p = PLC(cfg_p, PAtlas(maps=[m_p], active=0), db, m_p.n_feat,
               pg_kf_cap=64, pg_edge_cap=128, device="cpu")
    lc_p._gba_caps = (16, 4096, 8192)
    lc_j = JLC_mod.LoopCloser(cfg_j, JAtlas(maps=[m_j], active=0),
                              JDB(JV.random_vocabulary(seed=0), m_j.max_kf,
                                  m_j.n_feat), m_j.n_feat, pg_kf_cap=64,
                              pg_edge_cap=128)
    lc_j._gba_caps = (16, 4096, 8192)
    chain = m_p.kf_chain()
    before = m_p.kf_pose_cw[chain].copy()
    lc_p.run_global_ba(fixed_kf=int(chain[0]))
    lc_j.run_global_ba(fixed_kf=int(chain[0]))
    moved = np.linalg.norm((m_p.kf_pose_cw[chain] - before).reshape(
        len(chain), -1), axis=1)
    assert (moved[1:] > 1e-5).all(), moved
    assert lc_p.metrics.counts["gba/chained"] == 1
    ts = m_p.kf_pose_cw[chain]
    tj = m_j.kf_pose_cw[chain]
    # the two solves' mean translation change
    d_p = np.linalg.norm(ts[:, :, 3] - before[:, :, 3], axis=1).mean()
    d_j = np.linalg.norm(tj[:, :, 3] - before[:, :, 3], axis=1).mean()
    assert abs(d_p - d_j) <= 0.1 * d_j, (d_p, d_j)


def test_guided_refinement_like_jax():
    """tests/test_loop_closing.py:180: the guided refinement grows the
    correspondences; the port's (numpy, the Hamming matrix on the plain
    path) equals the reference's."""
    import test_loop_closing as T
    captured = {}
    orig = JLC_mod.LoopCloser._refine_sim3_guided

    def capture(self, kf, cand, m2, s, R, t, fix_scale, cap=1024):
        out = orig(self, kf, cand, m2, s, R, t, fix_scale, cap)
        captured.update(args=(kf, cand, s, R, t, fix_scale),
                        m_cur=mapstore_to_numpy(self.map),
                        m_old=mapstore_to_numpy(m2), out=out)
        return out
    JLC_mod.LoopCloser._refine_sim3_guided = capture
    try:
        T.test_sim3_guided_refinement_grows_inliers(
            np.random.default_rng(0))
    finally:
        JLC_mod.LoopCloser._refine_sim3_guided = orig
    _, cfg_p = _cfgs()
    m_cur = mapstore_from_numpy(captured["m_cur"])
    m_old = mapstore_from_numpy(captured["m_old"])
    lc = PLC(cfg_p, PAtlas(maps=[m_cur], active=0),
             PDB(PV.random_vocabulary(seed=0), 8, m_cur.n_feat,
                 device="cpu"), m_cur.n_feat, pg_kf_cap=8, pg_edge_cap=16,
             device="cpu")
    kf, cand, s, R, t, fix = captured["args"]
    s1, R1, t1, n1 = lc._refine_sim3_guided(kf, cand, m_old, s, R, t, fix)
    sj, Rj, tj, nj = captured["out"]
    assert n1 == nj >= 100
    assert abs(s1 - sj) <= 1e-9 and np.abs(R1 - Rj).max() <= 1e-9 \
        and np.abs(t1 - tj).max() <= 1e-9


def _jax_maps(maps):
    """The JAX package's map stores holding the arrays of port stores."""
    out = []
    for m in maps:
        a = mapstore_to_numpy(m)
        mm = JMapStore(max_kf=m.max_kf, max_pts=m.max_pts,
                       max_lines=m.max_lines, n_feat=m.n_feat,
                       map_id=m.map_id)
        for name, v in a.items():
            if isinstance(v, np.ndarray):
                setattr(mm, name, v.copy())
            elif name in ("n_kf", "n_pt", "n_ln"):
                setattr(mm, name, v)
        out.append(mm)
    return out


def test_map_merge_like_jax(monkeypatch):
    """tests/test_map_merge.py:63: the young map merges into the old one
    at the same keyframe with the same slot maps, fused points and Atlas;
    the merged keyframes within 8 cm of the truth; the tracker rebound by
    `on_map_merged` as the reference's."""
    m_old_p, m_cur_p, old_kfs, cur_kfs, centres = build_merge_maps(0)
    import test_map_merge as T
    pts, packed = T._world(np.random.default_rng(0))
    assert np.array_equal(pts, m_old_p.pt_xyz[:len(pts)])
    assert np.array_equal(packed, m_old_p.pt_desc[:len(pts)])
    cfg_j, cfg_p = _cfgs()
    m_old_j, m_cur_j = _jax_maps((m_old_p, m_cur_p))
    atlas_j = JAtlas(maps=[m_old_j, m_cur_j], active=1)
    atlas_p = PAtlas(maps=[m_old_p, m_cur_p], active=1)
    db_j = JAtlasDB(JV.random_vocabulary(seed=0), 64, 256, atlas_j)
    db_p = PAtlasDB(PV.random_vocabulary(seed=0), 64, 256, atlas_p,
                    device="cpu")
    for db, maps in ((db_j, (m_old_j, m_cur_j)), (db_p, (m_old_p, m_cur_p))):
        for m, ks in zip(maps, (old_kfs, cur_kfs)):
            for kf in ks:
                db.add_keyframe(kf, m.kf_feat_desc[kf], m.kf_feat_valid[kf],
                                map_id=m.map_id)
    lc_j = JLC_mod.LoopCloser(cfg_j, atlas_j, db_j, 256, pg_kf_cap=64,
                              pg_edge_cap=256, gba_obs_cap=8192)
    lc_p = PLC(cfg_p, atlas_p, TeacherDB(db_p, db_j), 256, pg_kf_cap=64,
               pg_edge_cap=256, gba_obs_cap=8192, device="cpu",
               sim3_sampler=JaxSim3Samples(cfg_j.seed))
    lc_j._gba_caps = lc_p._gba_caps = (64, 8192, 8192)
    log = RansacLog(monkeypatch, lc_p)
    for kf in cur_kfs[-3:]:
        b = lc_p.process_keyframe(kf)
        a = lc_j.process_keyframe(kf)
        assert a == b, kf
        assert lc_j.merge_votes == lc_p.merge_votes
    log.check()
    assert lc_j.n_maps_merged == lc_p.n_maps_merged == 1
    pj, pp = lc_j.pending_merge, lc_p.pending_merge
    for k in ("kf_map", "pt_map", "ln_map"):
        assert np.array_equal(pj[k], pp[k]), k
    for k in ("merged_atlas_index", "new_atlas_index"):
        assert pj[k] == pp[k]
    assert abs(pj["s"] - pp["s"]) <= 1e-5 * pj["s"]
    assert len(atlas_p.maps) == 1 and atlas_p.current is m_old_p
    assert np.array_equal(m_old_j.pt_valid, m_old_p.pt_valid)
    assert np.array_equal(m_old_j.kf_match_pt, m_old_p.kf_match_pt)
    assert m_old_j.n_pt == m_old_p.n_pt
    kf_map = pp["kf_map"]
    c = m_old_p.kf_centers()
    for kf, p in zip(cur_kfs, centres):
        assert np.linalg.norm(c[kf_map[kf]] - p) < 0.08
    # the tracker's rebinding, the reference's and the port's on one state
    rng = np.random.default_rng(1)

    def tracker_stub(rec_cls):
        st = types.SimpleNamespace(
            last_pose_cw=np.concatenate([np.eye(3), rng.normal(0, 1, (3, 1))],
                                        1).astype(np.float32),
            velocity=np.eye(3, 4, dtype=np.float32),
            frame_vel=np.array([0.1, -0.2, 0.3], np.float32),
            last_feat_pt=np.array([0, 5, -1, 7], np.int32),
            last_feat_ln=None, ref_kf=int(cur_kfs[-1]),
            last_created_kf=int(cur_kfs[-1]),
            frames=[rec_cls(0.5 * i, int(cur_kfs[i % 5]),
                            np.eye(3, 4, dtype=np.float32), i % 2)
                    for i in range(6)],
            invalidate_vi_prior=lambda: None)
        return st
    rng_state = rng.bit_generator.state
    sj = tracker_stub(JTR.FrameRecord)
    rng.bit_generator.state = rng_state
    sp = tracker_stub(PTR.FrameRecord)
    JTR.Tracker.on_map_merged(sj, **pj)
    PTR.Tracker.on_map_merged(sp, **pp)
    for k in ("last_pose_cw", "velocity", "frame_vel", "last_feat_pt"):
        assert np.allclose(getattr(sj, k), getattr(sp, k), atol=1e-5), k
    assert (sj.ref_kf, sj.last_created_kf) == (sp.ref_kf, sp.last_created_kf)
    assert [(r.ref_kf, r.map_id) for r in sj.frames] == \
        [(r.ref_kf, r.map_id) for r in sp.frames]


def reference_loop_closure():
    """REF_LOOPCLOSE: the JAX loop closer at production caps (pose graph
    512 x 4096, global BA 128 x 8192 x 32768) on the drifted circle (the
    last 4 keyframes) and the merge (the young map's last 3)."""
    cfg, _ = _cfgs()
    m, kfs, _ = _build_drifted_loop_map(np.random.default_rng(0))
    db = JDB(JV.random_vocabulary(seed=0), m.max_kf, m.n_feat)
    for kf in kfs:
        db.add_keyframe(kf, m.kf_feat_desc[kf], m.kf_feat_valid[kf])
    lc = JLC_mod.LoopCloser(cfg, JAtlas(maps=[m], active=0), db, m.n_feat)
    err0 = float(np.linalg.norm(_centre(m, kfs[-1]) - _centre(m, kfs[0])))
    closed = [bool(lc.process_keyframe(kf)) for kf in kfs[-4:]]
    err = float(np.linalg.norm(_centre(m, kfs[-1]) - _centre(m, kfs[0])))
    out = dict(circle=dict(closed=closed, err_before=err0, err_after=err))
    m_old, m_cur, old_kfs, cur_kfs, centres = build_merge_maps(0)
    ms = _jax_maps((m_old, m_cur))
    atlas = JAtlas(maps=ms, active=1)
    db = JAtlasDB(JV.random_vocabulary(seed=0), 64, 256, atlas)
    for mm, ks in zip(ms, (old_kfs, cur_kfs)):
        for kf in ks:
            db.add_keyframe(kf, mm.kf_feat_desc[kf], mm.kf_feat_valid[kf],
                            map_id=mm.map_id)
    lc = JLC_mod.LoopCloser(cfg, atlas, db, 256)
    closed = [bool(lc.process_keyframe(kf)) for kf in cur_kfs[-3:]]
    kf_map = lc.pending_merge["kf_map"]
    c = atlas.current.kf_centers()
    out["merge"] = dict(
        closed=closed, merges=lc.n_maps_merged,
        points=int(atlas.current.pt_valid.sum()),
        err_after=float(max(np.linalg.norm(c[kf_map[k]] - p)
                            for k, p in zip(cur_kfs, centres))))
    return out


if __name__ == "__main__":
    print("REF_LOOPCLOSE =", reference_loop_closure())
