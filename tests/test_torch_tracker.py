"""Slice 8, the host tracker (`Tracker.process_frame` past the bootstrap),
teacher-forced against the JAX package's `Tracker` on the CPU.

Each case loads one map and one tracker state into both trackers
(`state.mapstore_from_numpy` and the JAX store's attributes,
`state.load_tracker_state`) and feeds both the same frames: the
keyframe sequence's views (`inputs._seq_view`: its scene's points and
segments in view, with octave noise, flipped descriptor bits, 2% 15 px
outliers and noise features, made with numpy from a seed), with each
frame's IMU samples.  The map is `inputs.build_inertial_map` over the
first N_KF keyframes of `inputs.build_keyframe_sequence(0)` (metric,
gravity-aligned, the IMU initialized), changed per case:
1. `pl`: the IMU not initialized, so the point+line branch (the line
   projection match and the point+line pose IRLS) tracks the frame;
2. `vi`: two frames through the VI branch, the first without a live
   prior (the LastKeyFrame flavour), the second with the prior the first
   carried;
3. `wide`: the points' distance range shrunk so that the first
   projection match's frustum gates reject every point, and the widened
   retry (3x the radius, no gates) tracks;
4. `ref_kf`: the points' descriptors scrambled, so that both projection
   matches fail and the reference keyframe's descriptor-only match
   (`hamming_match` at an infinite radius) tracks;
5. `guard`: the VI optimizer's inliers zeroed on both sides (it "rejected
   everything"), so that the divergence guard keeps the prediction;
6. `lost`: every descriptor scrambled, so that the frames fail: two
   RECENTLY_LOST frames of dead reckoning, then LOST (recently_lost_s
   0.1 s), whose `_handle_lost` starts a new Atlas map (12 keyframes), and
   `reset`: the same on a map of 9 keyframes, reset in place;
7. `apply_map_transform` and 8. `reanchor_records` on the loaded state.

Compared after every frame:
- equal: the state, the inlier count, `feat_pt` / `feat_ln`, the
  reference and last created keyframe, the keyframe queue, the frame
  records' keyframes, the map's bindings, live sets, found / visible
  statistics and covisibility (so a created keyframe's fields), the
  Atlas's maps and active map, and whether the prior is carried;
- within the keyframe step's floors (tests/test_torch_keyframe_step.py):
  poses and velocities 1e-4 a pose entry and m/s,
  gyro biases 1e-6 rad/s, accelerometer biases 1e-5 m/s^2 (the two lie
  ~1e-6 apart here).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.config import CameraConfig, ImuConfig, Sensor, SystemConfig
from plvio_tpu.models import tracking as JT
from plvio_tpu.models.mapstore import Atlas as JAtlas
from plvio_tpu.models.mapstore import MapStore as JMapStore
from plvio_tpu.ops.frontend import Features as JFeatures
from plvio_tpu.ops.lines import LineFeatures as JLineFeatures
from plvio_tpu_torch.entry import K_EUROC, mapper_config
from plvio_tpu_torch.inputs import (_seq_view, build_inertial_map,
                                    build_keyframe_sequence)
from plvio_tpu_torch.models import mapstore as MS
from plvio_tpu_torch.models.mapstore import Atlas
from plvio_tpu_torch.models.tracking import Tracker, TrackState
from plvio_tpu_torch.ops import matching as PM
from plvio_tpu_torch.ops.frontend import Features
from plvio_tpu_torch.ops.lines import LineFeatures
from plvio_tpu_torch.state import (load_tracker_state, mapstore_from_numpy,
                                   mapstore_to_numpy, tracker_state)
from plvio_tpu_torch.utils import lie

N_KF = 12
EXACT = ("kf_valid", "kf_match_pt", "kf_match_ln", "kf_prev", "kf_next",
         "pt_valid", "ln_valid", "pt_n_obs", "ln_n_obs", "pt_found",
         "pt_visible", "ln_found", "ln_visible", "covis", "kf_feat_desc",
         "kf_feat_valid", "kf_line_desc")
FLOOR = {"last_pose_cw": 1e-4, "velocity": 1e-4, "frame_vel": 1e-4,
         "frame_bg": 1e-6, "frame_ba": 1e-5}
JCFG = SystemConfig(sensor=Sensor.IMU_MONOCULAR, use_lines=True,
                    camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)),
                    imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))))
PCFG = mapper_config(Sensor.IMU_MONOCULAR, K_EUROC, identity_tbc=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the plain path's many small ops
    gain nothing from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The sequence, the base map's arrays and one tracker of each package
    (each case reloads them: the JAX tracker's jitted factories are
    compiled once)."""
    seq = build_keyframe_sequence(0, n_kf=N_KF + 4)
    base = mapstore_to_numpy(build_inertial_map(seq, N_KF))
    n_feat = int(base["n_feat"])
    jt = JT.Tracker(JCFG, JAtlas([JMapStore(n_feat=n_feat)]), n_feat)
    jt.kfdb = None
    pt = Tracker(PCFG, Atlas([MS.MapStore(n_feat=n_feat)]), n_feat,
                 device="cpu")
    return dict(seq=seq, base=base, jt=jt, pt=pt)


def jax_store(a):
    """A JAX MapStore holding the arrays of `mapstore_to_numpy`."""
    m = JMapStore(max_kf=int(a["max_kf"]), max_pts=int(a["max_pts"]),
                  max_lines=int(a["max_lines"]), n_feat=int(a["n_feat"]),
                  n_line_feat=int(a["n_line_feat"]), map_id=int(a["map_id"]))
    for k in MS.ARRAYS:
        setattr(m, k, np.array(a[k], dtype=getattr(m, k).dtype))
    for k in ("n_kf", "n_pt", "n_ln", "change_index"):
        setattr(m, k, int(a[k]))
    for k in MS.INERTIAL[:3]:
        setattr(m, k, bool(a[k]))
    m.kf_preint = dict(a["kf_preint"])
    m.kf_imu_raw = dict(a["kf_imu_raw"])
    return m


def base_state(a, seq, last=N_KF - 1):
    """The tracker after tracking keyframe `last`'s frame: OK, that
    keyframe its reference and last created one, the motion model from
    the two newest keyframes, the inertial state the keyframe's."""
    P = a["kf_pose_cw"][last].astype(np.float32)
    Q = a["kf_pose_cw"][last - 1]
    R_cl = P[:, :3] @ Q[:, :3].T
    vel = np.concatenate([R_cl, (P[:, 3] - R_cl @ Q[:, 3])[:, None]], 1)
    t = float(seq["t_kf"][last])
    return dict(
        state=int(TrackState.OK), frame_idx=100, last_frame_time=t,
        ref_kf=last, last_created_kf=last, last_kf_frame_idx=97,
        last_kf_time=t, lost_count=0, last_n_inliers=200,
        _prior_frame_idx=-10, init_timestamp=0.0, only_tracking=False,
        _skip_next_kf_imu=False, last_pose_cw=P, velocity=vel,
        last_feat_pt=np.full(int(a["n_feat"]), -1, np.int32),
        last_feat_ln=None, frame_vel=np.array(a["kf_vel"][last]),
        frame_bg=np.array(a["kf_bias_g"][last]),
        frame_ba=np.array(a["kf_bias_a"][last]), prior_H15=None,
        imu_since_kf=[], new_kf_queue=[],
        frames=[(t, last, np.eye(3, 4, dtype=np.float32), 0)])


def load(world, arrays, st, cfg_kw=None):
    """Both trackers on their own copy of the map and the state."""
    jt, pt = world["jt"], world["pt"]
    jt.atlas = JAtlas([jax_store(arrays)])
    pt.atlas = Atlas([mapstore_from_numpy(arrays)])
    for tr in (jt, pt):
        load_tracker_state(tr, st)
        tr.init_feats = tr.last_feats = None
    jt.state = JT.TrackState(st["state"])
    jt.frames = [JT.FrameRecord(t, r, np.array(T), m)
                 for t, r, T, m in st["frames"]]
    jt.cfg = JCFG.replace(tracking=dataclasses.replace(
        JCFG.tracking, **(cfg_kw or {})))
    pt.cfg = dataclasses.replace(PCFG, tracking=dataclasses.replace(
        PCFG.tracking, **(cfg_kw or {})))


def frame_inputs(seq, i, prev_t):
    """Frame i (the sequence's keyframe i's view) in both layouts, and its
    IMU samples since prev_t."""
    feats, lines, _, _ = _seq_view(seq, i, np.random.default_rng([7, i]))
    uv, desc, octv, ang, _ = feats
    n = len(uv)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    ep, ldesc, lvalid, _ = lines
    d = ep[:, 2:] - ep[:, :2]
    angle = (np.arctan2(d[:, 1], d[:, 0]) % np.pi).astype(np.float32)
    length = np.linalg.norm(d, axis=1).astype(np.float32)
    sp = np.concatenate([ep[:, :2], np.ones((len(ep), 1), np.float32)], 1)
    e = np.concatenate([ep[:, 2:], np.ones((len(ep), 1), np.float32)], 1)
    l_ = np.cross(sp, e)
    lineq = (l_ / np.maximum(np.hypot(l_[:, 0], l_[:, 1]), 1e-9)[:, None]
             ).astype(np.float32)
    pdesc, pldesc = t(desc.view(np.int32)), t(ldesc.view(np.int32))
    pf = Features(uv=t(uv), uv_und=t(uv), response=t(np.zeros(n, np.float32)),
                  angle=t(ang), octave=t(octv.astype(np.int32)), desc=pdesc,
                  valid=t(np.ones(n, bool)))
    pl = LineFeatures(ep=t(ep), angle=t(angle), length=t(length),
                      lineq=t(lineq), desc=pldesc, valid=t(lvalid))

    def pm1(x):
        return jnp.asarray(PM.unpack_u32_to_pm1(x).numpy(), jnp.bfloat16)

    jf = JFeatures(uv=jnp.asarray(uv), uv_und=jnp.asarray(uv),
                   response=jnp.zeros(n, jnp.float32),
                   angle=jnp.asarray(ang), octave=jnp.asarray(
                       octv.astype(np.int32)), desc=pm1(pdesc),
                   valid=jnp.ones(n, bool))
    jl = JLineFeatures(ep=jnp.asarray(ep), angle=jnp.asarray(angle),
                       length=jnp.asarray(length), lineq=jnp.asarray(lineq),
                       desc=pm1(pldesc), valid=jnp.asarray(lvalid))
    imu = seq["imu"]
    ts_ = float(seq["t_kf"][i])
    sel = (imu.timestamps > prev_t + 1e-9) & (imu.timestamps <= ts_ + 1e-9)
    batch = (imu.gyro[sel], imu.acc[sel],
             np.diff(np.concatenate([[prev_t], imu.timestamps[sel]])))
    return ts_, batch, (pf, pl), (jf, jl)


def snapshot(tr, pose):
    st = tracker_state(tr)
    st["map"] = mapstore_to_numpy(tr.map)
    st["maps"] = (len(tr.atlas.maps), int(tr.atlas.active),
                  [int(m.n_kf) for m in tr.atlas.maps])
    st["pose"] = None if pose is None else np.array(pose)
    st["have_prior"] = bool(getattr(tr, "_last_have_prior", False))
    return st


def run_frames(world, frames):
    """Both trackers over frames i (keyframe views) in order; per frame
    (JAX snapshot, port snapshot)."""
    jt, pt, seq = world["jt"], world["pt"], world["seq"]
    out = []
    for i in frames:
        ts_, batch, (pf, pl), (jf, jl) = frame_inputs(
            seq, i, float(jt.last_frame_time))
        for tr in (jt, pt):
            tr._last_have_prior = False
        jp = jt.process_frame(jf, ts_, imu=batch, line_feats=jl)
        with torch.no_grad():
            pp = pt.process_frame(pf, ts_, imu=batch, line_feats=pl)
        out.append((snapshot(jt, jp), snapshot(pt, pp)))
    return out


def assert_same(j, p, tag):
    """The decisions equal, the floats within FLOOR."""
    for k in ("state", "last_n_inliers", "ref_kf", "last_created_kf",
              "new_kf_queue", "lost_count", "last_kf_frame_idx", "maps",
              "have_prior"):
        assert p[k] == j[k], (tag, k, p[k], j[k])
    for k in ("last_feat_pt", "last_feat_ln"):
        assert (p[k] is None) == (j[k] is None), (tag, k)
        if j[k] is not None:
            np.testing.assert_array_equal(p[k], j[k], err_msg=f"{tag} {k}")
    assert (p["prior_H15"] is None) == (j["prior_H15"] is None), tag
    assert [f[1] for f in p["frames"]] == [f[1] for f in j["frames"]], tag
    for k in EXACT:
        np.testing.assert_array_equal(p["map"][k], j["map"][k],
                                      err_msg=f"{tag} {k}")
    for k in ("n_kf", "n_pt", "n_ln", "imu_initialized"):
        assert p["map"][k] == j["map"][k], (tag, k)
    kv = j["map"]["kf_valid"]
    for k in ("kf_pose_cw", "kf_vel", "kf_bias_g", "kf_bias_a"):
        d = float(np.abs(p["map"][k][kv] - j["map"][k][kv]).max(initial=0))
        assert d <= FLOOR["frame_bg" if k == "kf_bias_g" else "frame_ba"
                          if k == "kf_bias_a" else "frame_vel"], (tag, k, d)
    for k, tol in FLOOR.items():
        assert (p[k] is None) == (j[k] is None), (tag, k)
        if j[k] is not None:
            d = float(np.abs(np.asarray(p[k], np.float64) - j[k]).max())
            assert d <= tol, (tag, k, d)
    for (_, _, Tp, _), (_, _, Tj, _) in zip(p["frames"], j["frames"]):
        assert float(np.abs(Tp - Tj).max()) <= 1e-4, tag
    assert (p["pose"] is None) == (j["pose"] is None), tag


def mutate(a, case):
    """The base map changed for a case (a copy)."""
    a = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
         for k, v in a.items()}
    rng = np.random.default_rng(11)
    if case == "pl":
        a["imu_initialized"] = a["imu_ba1"] = False
    if case == "wide":
        a["imu_initialized"] = a["imu_ba1"] = False
        a["pt_min_dist"][:] = 1e-3
        a["pt_max_dist"][:] = 1e-2
    if case in ("ref_kf", "lost", "reset"):
        a["pt_desc"] = rng.integers(0, 2 ** 32, a["pt_desc"].shape,
                                    dtype=np.uint32)
    if case in ("lost", "reset"):
        a["kf_feat_desc"] = rng.integers(0, 2 ** 32, a["kf_feat_desc"].shape,
                                         dtype=np.uint32)
        a["ln_desc"] = rng.integers(0, 2 ** 32, a["ln_desc"].shape,
                                    dtype=np.uint32)
    if case == "reset":
        m = mapstore_from_numpy(a)
        for kf in (0, 1, 2):
            m.remove_keyframe(kf)
        a = mapstore_to_numpy(m)
    return a


CASES = {"pl": [N_KF], "vi": [N_KF, N_KF + 1], "wide": [N_KF],
         "ref_kf": [N_KF], "lost": [N_KF, N_KF + 1, N_KF + 2],
         "reset": [N_KF, N_KF + 1, N_KF + 2]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_process_frame_matches_reference(world, case):
    """The tracking branches, teacher-forced: the same map, state and
    frames on both sides, compared after every frame."""
    a = mutate(world["base"], case)
    cfg_kw = {"recently_lost_s": 0.1} if case in ("lost", "reset") else {}
    load(world, a, base_state(a, world["seq"]), cfg_kw)
    recs = run_frames(world, CASES[case])
    for n, (j, p) in enumerate(recs):
        assert_same(j, p, f"{case} frame {n}")
    states = [j["state"] for j, _ in recs]
    print(case, states, [j["last_n_inliers"] for j, _ in recs],
          [p["maps"] for _, p in recs])
    if case in ("pl", "vi", "wide", "ref_kf"):
        assert all(s == int(TrackState.OK) for s in states), states
        assert recs[0][0]["last_n_inliers"] >= 40
    if case == "vi":
        assert not recs[0][1]["have_prior"] and recs[1][1]["have_prior"]
    if case == "lost":
        assert states == [3, 3, 0] and recs[-1][1]["maps"][0] == 2
    if case == "reset":
        assert states == [3, 3, 0] and recs[-1][1]["maps"] == (1, 0, [0])
    if case in ("lost", "reset"):
        # dead reckoning: the RECENTLY_LOST frames keep a predicted pose
        assert all(p["pose"] is not None for _, p in recs[:2])


def test_branch_paths(world):
    """The cases take the branches they are named for on the port: the
    widened retry, the reference-keyframe fallback."""
    pt = world["pt"]
    for case, path in (("wide", "wide"), ("ref_kf", "ref_kf"),
                       ("pl", "proj")):
        a = mutate(world["base"], case)
        load(world, a, base_state(a, world["seq"]))
        with torch.no_grad():
            ts_, batch, (pf, pl), _ = frame_inputs(
                world["seq"], N_KF, float(pt.last_frame_time))
            pt.process_frame(pf, ts_, imu=batch, line_feats=pl)
        assert pt.last_match_path == path, (case, pt.last_match_path)
        assert pt.state == TrackState.OK


def test_divergence_guard(world):
    """The VI optimizer's inliers zeroed on both sides: the guard keeps the
    IMU prediction (state OK, the predicted pose, the prior dropped)."""
    jt, pt = world["jt"], world["pt"]
    a = mutate(world["base"], "vi")
    load(world, a, base_state(a, world["seq"]))
    jopt, popt = jt.vi_pose_opt, pt.vi_pose_opt

    def jzero(*args):
        out = list(jopt(*args))
        out[4] = jnp.zeros_like(out[4])
        out[5] = jnp.zeros_like(out[5])
        return tuple(out)

    def pzero(*args):
        out = list(popt(*args))
        out[4] = torch.zeros_like(out[4])
        out[5] = torch.zeros_like(out[5])
        return tuple(out)

    jt.vi_pose_opt, pt.vi_pose_opt = jzero, pzero
    try:
        (j, p), = run_frames(world, [N_KF])
    finally:
        jt.vi_pose_opt, pt.vi_pose_opt = jopt, popt
    assert_same(j, p, "guard")
    assert pt.last_guard and p["state"] == int(TrackState.OK)
    assert p["prior_H15"] is None and p["last_n_inliers"] >= 15
    np.testing.assert_allclose(p["last_pose_cw"],
                               pt._wb_to_cw(pt._pred_wb), atol=1e-6)


def test_apply_map_transform(world):
    """IMU init's transform on the frame state: pose, velocity, records,
    biases from the newest keyframe, the motion model and prior dropped."""
    jt, pt = world["jt"], world["pt"]
    a = mutate(world["base"], "vi")
    st = base_state(a, world["seq"])
    st["frames"] = [(0.1 * k, k, np.eye(3, 4, dtype=np.float32)
                     + 0.01 * k, 0) for k in range(4)]
    st["prior_H15"] = np.eye(15, dtype=np.float32)
    load(world, a, st)
    R = lie.so3_exp(torch.tensor([0.1, -0.2, 0.3])).numpy()
    jt.apply_map_transform(R, 1.7)
    pt.apply_map_transform(R, 1.7)
    j, p = snapshot(jt, None), snapshot(pt, None)
    assert_same(j, p, "transform")
    assert p["velocity"] is None and p["prior_H15"] is None


def test_reanchor_records(world):
    """Records of a culled keyframe re-expressed against the chain
    keyframe nearest in time, the reference keyframe moved with them."""
    jt, pt = world["jt"], world["pt"]
    a = mutate(world["base"], "vi")
    st = base_state(a, world["seq"], last=5)
    st["frames"] = [(float(world["seq"]["t_kf"][k]) + 0.05, k,
                     np.eye(3, 4, dtype=np.float32), 0) for k in range(8)]
    load(world, a, st)
    culled = [(5, np.array(a["kf_pose_cw"][5]),
               float(world["seq"]["t_kf"][5]))]
    for tr in (jt, pt):
        tr.map.remove_keyframe(5)
        tr.reanchor_records(culled)
    j, p = snapshot(jt, None), snapshot(pt, None)
    assert_same(j, p, "reanchor")
    assert p["ref_kf"] != 5 and 5 not in [f[1] for f in p["frames"]]
    tj, pj, qj = jt.full_trajectory()
    tp, pp_, qp = pt.full_trajectory()
    np.testing.assert_array_equal(tp, tj)
    assert float(np.abs(pp_ - pj).max()) <= 1e-5
    assert float(np.abs(qp - np.asarray(qj)).max()) <= 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_ungated_match_is_window_mode_at_infinite_radius(seed):
    """`_track_reference_kf`'s match (`match_nn_ratio` with no gate, ratio
    0.75, max 60, mutual) is `hamming_match`'s window mode at an infinite
    radius: every pair passes d2 <= inf.  Held against the JAX function
    on seeded descriptors with planted near-duplicates, masks and
    arbitrary positions."""
    from plvio_tpu.ops import matching as JM
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (200, 8), dtype=np.uint32)
    b[:120] = a[rng.permutation(300)[:120]] ^ rng.integers(
        0, 2, (120, 8), dtype=np.uint32) * (1 << rng.integers(0, 32, (120, 8),
                                                              dtype=np.uint32))
    va, vb = rng.random(300) < 0.9, rng.random(200) < 0.95
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    idx, ok = PM.hamming_match_plain(
        ta, tb, torch.from_numpy(va), torch.from_numpy(vb),
        torch.from_numpy(rng.uniform(-1e4, 1e4, (300, 2)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0, 752, (200, 2)).astype(np.float32)),
        radius=float("inf"), max_dist=60.0, ratio=0.75)
    dist = JM.hamming_matrix(JM.unpack_u32_to_pm1(jnp.asarray(a)),
                             JM.unpack_u32_to_pm1(jnp.asarray(b)))
    ij, okj = JM.match_nn_ratio(dist, jnp.asarray(va), jnp.asarray(vb), None,
                                max_dist=60.0, ratio=0.75, mutual=True)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(ok.numpy(), okj)
    np.testing.assert_array_equal(idx.numpy()[okj], np.asarray(ij)[okj])
    assert okj.sum() >= 50
