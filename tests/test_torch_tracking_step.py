"""The port's tracked frame against the reference's, end to end (CPU), and
the package boundaries: no JAX is loaded by the port, and a request for
the card on a machine without one raises.

tracking_step_pl at 240x376, 300 features, 256 map points, 32 map lines,
64 line features, over 3 synthetic frames with the pose carried; both
sides get the same numpy inputs (the port's own synthetic map).
Tolerances: inliers per frame within 3%, camera centre within 2 mm and
rotation within 0.05 deg of the reference's pose (the front ends differ
in a few keypoints and segments, see the per-module tests)."""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as G
from plvio_tpu_torch import entry as E
from plvio_tpu_torch import inputs as IN
from plvio_tpu_torch.entry import entry, tracking_step, tracking_step_pl
from plvio_tpu_torch.inputs import build_inputs
from plvio_tpu_torch.ops import frontend as FE
from plvio_tpu_torch.ops import lines as LN
from plvio_tpu_torch.state import from_numpy

H, W, NF, CP, CL, NL, NFR = 240, 376, 300, 256, 32, 64, 3
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def inputs():
    return build_inputs(NFR, CP, CL, H, W, n_features=NF, device="cpu")


def _centre_rot(P, Q):
    P, Q = np.asarray(P, np.float64), np.asarray(Q, np.float64)
    c = -P[:, :3].T @ P[:, 3]
    cq = -Q[:, :3].T @ Q[:, 3]
    dR = P[:, :3] @ Q[:, :3].T
    ang = math.degrees(math.acos(min(1.0, max(-1.0,
                                              (np.trace(dR) - 1) / 2))))
    return np.linalg.norm(c - cq), ang


def _run(inputs, pl):
    frames, poses, pxyz, pdesc, pvalid, lep, ldesc, lvalid, _ = inputs
    if pl:
        fj, _ = G._tracking_step_pl_fn(H, W, NF, CP, CL, NL)
        step, _ = tracking_step_pl(H, W, NF, CP, CL, NL, device="cpu")
        jmap = (pxyz, pdesc, pvalid, lep, ldesc, lvalid)
    else:
        fj, _ = G._tracking_step_fn(H, W, NF, CP)
        step, _ = tracking_step(H, W, NF, CP, device="cpu")
        jmap = (pxyz, pdesc, pvalid)
    fj = jax.jit(fj)
    st = from_numpy(dict(pt_xyz=pxyz, pt_desc=pdesc, pt_valid=pvalid,
                         ln_ep6=lep, ln_desc=ldesc, ln_valid=lvalid), "cpu")
    tmap = (st["pt_xyz"], st["pt_desc"], st["pt_valid"])
    if pl:
        tmap += (st["ln_ep6"], st["ln_desc"], st["ln_valid"])
    pj, pt = jnp.asarray(poses[0]), torch.from_numpy(poses[0])
    out = []
    for img in frames:
        pj, nj = fj(jnp.asarray(img), pj, *[jnp.asarray(a) for a in jmap])
        with torch.no_grad():
            pt, nt = step(torch.from_numpy(img), pt, *tmap)
        out.append((np.asarray(pj), int(nj), pt.numpy(), int(nt)))
    return out, poses


@pytest.mark.parametrize("pl", [True, False])
def test_tracking_step_matches_reference(inputs, pl):
    out, _ = _run(inputs, pl)
    print("inliers (port, JAX):", [(nt, nj) for _, nj, _, nt in out],
          "centre / rotation gaps:", [_centre_rot(pt, pj)
                                      for pj, _, pt, _ in out])
    for pj, nj, pt, nt in out:
        assert nj >= 10, nj
        assert abs(nt - nj) <= 0.03 * nj, (nt, nj)
        dc, dr = _centre_rot(pt, pj)
        assert dc <= 2e-3 and dr <= 0.05, (dc, dr)


def test_entry_example_runs():
    step, args = entry("cpu")
    assert len(args) == 8 and args[0].shape == (480, 752)
    assert step.orb.specs[0].n_keep + sum(s.n_keep for s in
                                          step.orb.specs[1:]) == 1000
    small, sargs = tracking_step_pl(96, 160, 60, 32, 8, 16, device="cpu")
    pose, n = small(*sargs)
    assert pose.shape == (3, 4) and bool(torch.isfinite(pose).all())
    assert n.dtype == torch.int32


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_inputs(1, 8, 4, 96, 160, device="cuda")


DEFAULTS_TO_CARD = {
    "tracking_step": lambda: tracking_step(96, 160, 60, 32),
    "tracking_step_pl": lambda: tracking_step_pl(96, 160, 60, 32, 8, 16),
    "tracking_step_vi": lambda: E.tracking_step_vi(96, 160, 60, 16, 16),
    "entry": lambda: entry(),
    "mapping_step": lambda: E.mapping_step(4, 256, 512, 128, 32, 64),
    "build_inputs": lambda: build_inputs(1, 8, 4, 96, 160),
    "build_mapping_inputs": lambda: IN.build_mapping_inputs(
        4, 256, 512, 128, 32, 64),
    "make_extractor": lambda: FE.make_extractor(96, 160, 60),
    "make_line_extractor": lambda: LN.make_line_extractor(16),
    "inertial_ba_step": lambda: E.inertial_ba_step(256, 512, 32, 64,
                                                   n_kf=8, n_observers=3),
    "imu_init": lambda: E.imu_init(),
    "build_inertial_window": lambda: IN.build_inertial_window(
        256, 512, 32, 64, n_kf=8, n_observers=3),
    "build_imu_init_inputs": lambda: IN.build_imu_init_inputs(),
    "neighborhood_step": lambda: E.neighborhood_step(),
    "bootstrap_step": lambda: E.bootstrap_step(),
    "tracked_sequence": lambda: E.tracked_sequence(n_frames=2),
    "kb8_vi_replay": lambda: E.kb8_vi_replay(replay_kw=dict(n_frames=1)),
    "line_mode_replay": lambda: E.line_mode_replay(
        1, replay_kw=dict(n_frames=1)),
    "ed_replay": lambda: E.ed_replay(reloc=False,
                                     replay_kw=dict(n_frames=1)),
    "ed_stereo_room": lambda: E.ed_stereo_room(1),
    "PriorMapRelocalizer": lambda: _prior_relocalizer(),
}


def _prior_relocalizer():
    from plvio_tpu_torch.config import SystemConfig
    from plvio_tpu_torch.models.mapstore import Atlas
    from plvio_tpu_torch.models.relocalization import PriorMapRelocalizer
    return PriorMapRelocalizer(SystemConfig(), Atlas(), None, 1000)


@pytest.mark.parametrize("name", sorted(DEFAULTS_TO_CARD))
def test_entry_points_default_to_the_card(name):
    """Every entry point and factory runs on the card unless the caller
    passes device="cpu": without a card, the default raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULTS_TO_CARD[name]()


# the entry points `test_port_never_loads_jax` drives, by group, each in
# a process of its own (the code after `_NO_JAX_PRELUDE`)
_NO_JAX_PRELUDE = (
        "import sys\n"
        "import torch\n"
        "from plvio_tpu_torch.config import MapConfig, OrbConfig\n"
        "small = dict(orb=OrbConfig(n_features=300), map=MapConfig("
        "max_keyframes=16, max_points=2048, max_lines=256), caps=dict("
        "ba_kf_cap=8, ba_pt_cap=512, ba_obs_cap=1024))\n")
_NO_JAX_GROUPS = {
    "frames": (
        "import chip_smoke\n"
        "import plvio_tpu_torch.profile_frames\n"
        "import plvio_tpu_torch.kernel_digest\n"
        "from plvio_tpu_torch.entry import tracking_step_pl\n"
        "from plvio_tpu_torch.inputs import build_inputs\n"
        "step, args = tracking_step_pl(96, 160, 60, 32, 8, 16, "
        "device='cpu')\n"
        "pose, n = step(*args)\n"
        "fr = build_inputs(3, 16, 4, 96, 160, n_features=60, "
        "device='cpu')\n"
        "assert pose.shape == (3, 4)\n"
        "from plvio_tpu_torch.entry import mapping_step, tracking_step_vi\n"
        "from plvio_tpu_torch.inputs import build_imu_windows\n"
        "ms, A = mapping_step(4, 256, 512, 128, 32, 64, device='cpu')\n"
        "out = ms(A)\n"
        "assert out.kf_poses.shape == (4, 3, 4) and int(out.n_good) > 0\n"
        "g, a, d, c0 = build_imu_windows(fr[-1], 3)\n"
        "vi, _ = tracking_step_vi(96, 160, 60, 16, 16, device='cpu')\n"
        "m = [torch.from_numpy(x) for x in fr[2:8]]\n"
        "m[1], m[4] = m[1].view(torch.int32), m[4].view(torch.int32)\n"
        "xs = tuple(torch.from_numpy(x) for x in (fr[0][1], g[0], a[0], "
        "d[0]))\n"
        "c, _ = vi(tuple(torch.from_numpy(x) for x in c0), xs, *m)\n"
        "assert c[0].shape == (3, 4) and c[4].shape == (15, 15)\n"
        "from plvio_tpu_torch.entry import imu_init, inertial_ba_step\n"
        "lb, W = inertial_ba_step(256, 512, 32, 64, n_kf=8, n_observers=3, "
        "device='cpu')\n"
        "o = lb(W)\n"
        "assert o.pose_wb.shape == (8, 3, 4) and int(o.inlier.sum()) > 0\n"
        "ii, B = imu_init(device='cpu')\n"
        "Rwg, s, bg, ba, v = ii(B)\n"
        "Rwg2, s2 = ii.refine(B)\n"
        "assert abs(float(s) - 2.0) < 0.1 and abs(float(s2) - 1 / 1.03) < "
        "0.01\n"
        "from plvio_tpu_torch.entry import neighborhood_step\n"
        "ns, mst = neighborhood_step(device='cpu', ba_kf_cap=8, "
        "ba_pt_cap=1024, ba_obs_cap=2048)\n"
        "o = ns(mst)\n"
        "assert o.new_lines > 0 and o.n_merged > 0 and o.ba_path == 'pt'\n"
        "from plvio_tpu_torch.entry import bootstrap_step\n"
        "bs, BB = bootstrap_step(device='cpu')\n"
        "bo = bs(BB)\n"
        "assert bo.init_frame >= 1 and bo.points >= 60 and bo.lines > 0\n"),
    "sequences": (
        "from plvio_tpu_torch.entry import keyframe_sequence\n"
        "ks, S = keyframe_sequence(device='cpu', store=dict(max_kf=16, "
        "max_pts=2048, max_lines=512), caps=dict(ba_kf_cap=16, "
        "ba_pt_cap=512, ba_obs_cap=1024), seq_kw=dict(n_kf=15, "
        "n_feat=128))\n"
        "so = ks(S)\n"
        "assert so.init_kf == 13 and so.map.imu_initialized\n"
        "assert [c[0] for c in so.steps[-2].ba] == ['liba', 'liba']\n"
        "from plvio_tpu_torch.entry import tracked_sequence\n"
        "tq, TS = tracked_sequence(device='cpu', n_frames=7, "
        "n_features=300, store=dict(max_kf=16, max_pts=2048, "
        "max_lines=256), caps=dict(ba_kf_cap=8, ba_pt_cap=512, "
        "ba_obs_cap=1024))\n"
        "to = tq(TS)\n"
        "assert 2 <= to.init_frame <= 3 and to.n_tracked == 7 - "
        "to.init_frame\n"
        "assert to.keyframes >= 2 and min(f.inliers for f in "
        "to.frames[to.init_frame + 1:]) > 30\n"),
    "system": (
        "from plvio_tpu_torch.entry import mh_replay\n"
        "mr, MS = mh_replay(1.0, device='cpu', replay_kw=dict(n_points=500, "
        "n_lines=50, n_frames=3), orb=OrbConfig(n_features=300), "
        "map=MapConfig(max_keyframes=16, max_points=2048, max_lines=256), "
        "caps=dict(ba_kf_cap=8, ba_pt_cap=512, ba_obs_cap=1024))\n"
        "mo = mr(MS)\n"
        "assert len(mo.frames) == 3 and mo.maps == 1\n"
        "assert mo.metrics['extract_orb']['calls'] == 3\n"
        "assert mo.system.kfdb.db().present.sum() == mo.keyframes\n"
        "from plvio_tpu_torch.entry import rgbd_room, stereo_replay, "
        "stereo_room\n"
        "sr, SS = stereo_replay(1.0, device='cpu', replay_kw=dict("
        "n_points=500, n_lines=50, n_frames=3), **small)\n"
        "so = sr(SS)\n"
        "assert so.init_frame == 0 and so.n_tracked == 3 and so.maps == 1\n"
        "assert so.metrics['stereo_match']['calls'] == 3\n"
        "for fn, kw in ((stereo_room, {}), (rgbd_room, {}), (stereo_room, "
        "dict(use_lines=False)), (rgbd_room, dict(bf=40.0))):\n"
        "    rr, RS = fn(3, device='cpu', **small, **kw)\n"
        "    ro = rr(RS)\n"
        "    assert ro.n_tracked == 3 and ro.ate_se3 < 0.05\n"
        "from plvio_tpu_torch.entry import kb8_room\n"
        "kr, KS = kb8_room(3, device='cpu', **small)\n"
        "ko = kr(KS)\n"
        "assert len(ko.frames) == 3 and ko.system.tracker.kb8 is not None\n"),
    "modes": (
        "from plvio_tpu_torch.entry import kb8_vi_replay, "
        "line_mode_replay\n"
        "kv, KV = kb8_vi_replay(1.0, device='cpu', replay_kw=dict("
        "n_frames=3), **small)\n"
        "kvo = kv(KV)\n"
        "assert len(kvo.frames) == 3 and kvo.system.mapper.ba_K == "
        "kvo.system.tracker.kb8 is not None\n"
        "lm, LS = line_mode_replay(3, 1.0, device='cpu', replay_kw=dict("
        "n_points=500, n_lines=50, n_frames=3), **small)\n"
        "lmo = lm(LS)\n"
        "assert len(lmo.frames) == 3 and "
        "lmo.system.tracker.pose_opt_line_only is not None\n"
        "from plvio_tpu_torch.entry import ed_replay\n"
        "er, ES = ed_replay(device='cpu', replay_kw=dict(n_points=500, "
        "n_lines=50, n_frames=3), **small)\n"
        "eo = er(ES)\n"
        "r0 = eo.system.relocalizer\n"
        "assert len(eo.frames) == 3 and eo.system.extract_lines.detector "
        "== 1 and len(r0.prior_frames) == 6\n"
        "from plvio_tpu_torch.config import CameraConfig\n"
        "from plvio_tpu_torch.inputs import place_prior_keyframes\n"
        "from plvio_tpu_torch.models.mapstore import Atlas, MapStore\n"
        "from plvio_tpu_torch.models.relocalization import "
        "PriorMapRelocalizer\n"
        "nf = r0.prior_frames[0].uv.shape[0]\n"
        "rl = PriorMapRelocalizer(eo.system.cfg.replace(camera=CameraConfig("
        "width=640, height=480, fx=518.0, fy=519.0, cx=325.5, cy=253.5, "
        "dist=())), Atlas([MapStore(max_kf=8, n_feat=nf)]), r0.voc, nf, "
        "device='cpu')\n"
        "rl.prior_frames, rl._prior_dev = r0.prior_frames, r0._prior_dev\n"
        "for i, kf in enumerate(place_prior_keyframes(rl.atlas.current, "
        "rl.prior_frames)):\n"
        "    rl.process_keyframe(kf, float(i))\n"
        "assert rl.T_prior_from_live is not None and "
        "len(rl.relocalized_poses) == 6\n"
        "from plvio_tpu_torch.entry import mapping_step\n"
        "mk, MK = mapping_step(4, 256, 512, 128, 32, 64, device='cpu', "
        "kb8=True)\n"
        "assert int(mk(MK).n_inliers) > 0\n"),
    "loop_dist": (
        "from plvio_tpu_torch.entry import loop_closure\n"
        "lq, LI = loop_closure('circle', device='cpu', gba_caps=(32, 2048, "
        "4096))\n"
        "lo = lq(LI)\n"
        "assert lo.loops == 1 and lo.err_after < 0.12 and "
        "lo.verifications >= 1\n"
        "import plvio_tpu_torch.parallel.multihost\n"
        "from plvio_tpu_torch.entry import dist_replay, dist_window\n"
        "dw, DW, _ = dist_window(2, device='cpu', sizes=dict(n_pt=256, "
        "n_obs=512, n_ln=16, n_lobs=32, n_kf=8, n_observers=3))\n"
        "do = dw(DW)\n"
        "assert do[0].shape == (8, 3, 4) and dw.runner.n_solves == 1\n"
        "dr, DR = dist_replay(2, device='cpu', replay_kw=dict(n_points=500, "
        "n_lines=50, n_frames=3), **small)\n"
        "dro = dr(DR)\n"
        "assert len(dro.frames) == 3 and "
        "dro.system.mapper._dist_runner.D == 2\n"),
}


@pytest.mark.parametrize("group", sorted(_NO_JAX_GROUPS))
def test_port_never_loads_jax(group):
    """The port, chip_smoke.py, the profile and the kernel digest load
    neither JAX nor the JAX package while driving every entry point on the
    CPU, a group of them in a process of its own: `frames` (imports
    chip_smoke, the profile and the kernel digest; the PL and VI frames,
    the mapping step, the inertial window, IMU init, the neighbourhood
    step, the bootstrap); `sequences` (the keyframe sequence at a reduced
    size: 15 keyframes of 128 features, through IMU init and the first
    inertial window; the tracked sequence's first 7 frames at 300
    features: the bootstrap on frame 2 or 3, then tracking); `system`
    (`System` through `mh_replay` on 3 frames of a small hall;
    `track_stereo` through `stereo_replay` on 3 pairs of it and
    `stereo_room` (with and without lines), `track_rgbd` through
    `rgbd_room` (bf 0 and 40), `track_monocular` with the KB8 camera
    through `kb8_room`); `modes` (with the IMU and lines through
    `kb8_vi_replay`, SLAM mode 3 through `line_mode_replay`, and the ED
    line detector with the prior-map relocalizer through `ed_replay`, 3
    frames each; the relocalizer aligned on a hand-made live map of its
    prior set (`inputs.place_prior_keyframes`); the mapping step of the
    KB8 camera); `loop_dist` (the loop closer on the drifted circle, its
    global BA at 32 keyframes; one sharded inertial window of 8 keyframes
    on 2 shards through `dist_window`, and `dist_replay` on 3 frames)."""
    code = (_NO_JAX_PRELUDE + _NO_JAX_GROUPS[group]
            + "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'plvio_tpu'))\n"
            "assert not bad, bad\n"
            "print('no jax')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PLVIO_MATMUL_PRECISION", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = str(REPO)
    # one thread: the suite's workers already share the cores, and torch's
    # default of one thread per core then thrashes
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no jax" in r.stdout
