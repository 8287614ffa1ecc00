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
}


@pytest.mark.parametrize("name", sorted(DEFAULTS_TO_CARD))
def test_entry_points_default_to_the_card(name):
    """Every entry point and factory runs on the card unless the caller
    passes device="cpu": without a card, the default raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULTS_TO_CARD[name]()


def test_port_never_loads_jax():
    """The port, chip_smoke.py, the profile and the kernel digest load
    neither JAX nor the JAX package while driving every entry point on the
    CPU (the keyframe sequence at a reduced size: 15 keyframes of 128
    features, through IMU init and the first inertial window)."""
    code = (
        "import sys\n"
        "import torch\n"
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
        "assert bo.init_frame >= 1 and bo.points >= 60 and bo.lines > 0\n"
        "from plvio_tpu_torch.entry import keyframe_sequence\n"
        "ks, S = keyframe_sequence(device='cpu', store=dict(max_kf=16, "
        "max_pts=2048, max_lines=512), caps=dict(ba_kf_cap=16, "
        "ba_pt_cap=512, ba_obs_cap=1024), seq_kw=dict(n_kf=15, "
        "n_feat=128))\n"
        "so = ks(S)\n"
        "assert so.init_kf == 13 and so.map.imu_initialized\n"
        "assert [c[0] for c in so.steps[-2].ba] == ['liba', 'liba']\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'plvio_tpu'))\n"
        "assert not bad, bad\n"
        "print('no jax')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PLVIO_MATMUL_PRECISION", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = str(REPO)
    # one thread: the suite's workers already share the cores, and torch's
    # default of one thread per core then thrashes (this run takes ~14 s
    # alone either way)
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no jax" in r.stdout
