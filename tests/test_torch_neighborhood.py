"""Slice 5, the keyframe step's neighbourhood work, against the JAX package
on the CPU: `inputs.build_keyframe_map` makes a 14-keyframe map as numpy
arrays; a JAX `MapStore` takes them as its attributes and the port's
store takes them through `state.mapstore_from_numpy`; the JAX
`LocalMapper` (monocular, lines on, no distortion) and the port's
(`NeighborhoodStep`'s mapper, plain path) then run `create_new_lines`,
`search_in_neighbors` and `local_ba` on the new keyframe, each compared
after its call, with and without confirmed map lines, at BA caps small
enough for the CPU (8 KF / 1024 points / 2048 observations; the fuse and
the line caps are production's).

Tolerances, and why:
- new lines: count, `kf_match_ln` and `ln_valid` equal; `ln_ep` within
  5e-5 of each endpoint's magnitude.  The endpoints are ray-plane
  intersections whose interpretation planes meet at ~1 deg, which
  amplifies float32 rounding ~100x: the two float32 implementations (XLA
  contracts multiply-adds, the port does not) lie 1.1e-5 m apart at the
  median and 2.2e-4 m (2.1e-5 relative) at most on this map, both as far
  from a float64 run.
- fusion: `kf_match_pt`, `pt_valid`, `pt_n_obs`, the fused count and the
  covisibility rows equal (the JAX store's native covisibility against
  the port's numpy path).
- BA: the path taken equal, KF poses within 1e-3 (a pose entry, as the
  slice-3 BA at 4 KF), the bindings after the chi2 gate and the orphan
  removal equal, and every bound point's reprojection within 0.1 px of
  the reference's.

Run as a script, it prints REF_NBH for chip_smoke.py: the JAX mapper at
production caps on both maps (JAX_PLATFORMS=cpu PYTHONPATH=. python3
tests/test_torch_neighborhood.py).
"""
import json
import sys

import numpy as np
import pytest

from plvio_tpu.config import CameraConfig, Sensor, SystemConfig
from plvio_tpu.models.local_mapping import LocalMapper as JLocalMapper
from plvio_tpu.models.mapstore import Atlas
from plvio_tpu.models.mapstore import MapStore as JMapStore
from plvio_tpu_torch.entry import K_EUROC as K
from plvio_tpu_torch.entry import NeighborhoodStep
from plvio_tpu_torch.inputs import build_keyframe_map
from plvio_tpu_torch.models import mapstore as MS
from plvio_tpu_torch.state import mapstore_from_numpy, mapstore_to_numpy

SMALL_CAPS = dict(ba_kf_cap=8, ba_pt_cap=1024, ba_obs_cap=2048)
FULL_CAPS = dict(ba_kf_cap=16, ba_pt_cap=4096, ba_obs_cap=8192)
CFG = SystemConfig(sensor=Sensor.MONOCULAR, use_lines=True,
                   camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)))


def jax_store(arrays):
    """The JAX package's MapStore holding `arrays`."""
    m = JMapStore(max_kf=arrays["max_kf"], max_pts=arrays["max_pts"],
                  max_lines=arrays["max_lines"], n_feat=arrays["n_feat"],
                  n_line_feat=arrays["n_line_feat"])
    for k in MS.ARRAYS:
        setattr(m, k, np.array(arrays[k]))
    for k in ("n_kf", "n_pt", "n_ln", "change_index"):
        setattr(m, k, int(arrays[k]))
    return m


def ba_path(m, kf, kf_cap):
    """"pl" where the reference's local_ba takes make_local_ba_pl (>= 8
    window lines with >= 3 observations, models/local_mapping.py:770-780),
    else "pt"."""
    window = m.covisible_kfs(kf, n=kf_cap - 6, min_weight=5)
    window = np.concatenate([[kf], window[m.kf_valid[window]]])[:kf_cap]
    ln = np.unique(m.kf_match_ln[window])
    ln = ln[ln >= 0]
    ln = ln[m.ln_valid[ln]]
    return "pl" if (m.ln_n_obs[ln] >= 3).sum() >= 8 else "pt"


def centre_err(poses, truth):
    """Largest camera-centre error (m) of the map's 14 keyframes."""
    P = np.asarray(poses[:len(truth)], np.float64)
    G = np.asarray(truth, np.float64)
    c = -np.einsum("kji,kj->ki", P[..., :3], P[..., 3])
    cg = -np.einsum("kji,kj->ki", G[..., :3], G[..., 3])
    return float(np.linalg.norm(c - cg, axis=1).max())


def run_reference(confirmed, caps, jl=None):
    """The JAX mapper's three calls on a fresh map: (snapshots of its store
    after each call, counts, the mapper)."""
    arrays, truth = build_keyframe_map(confirmed)
    jm = jax_store(arrays)
    if jl is None:
        jl = JLocalMapper(CFG, Atlas([jm]), 1000, **caps)
    else:
        jl.atlas = Atlas([jm])
    kf = truth["new_kf"]
    snaps, counts = {}, {}
    n_ln = jm.n_ln
    jl.create_new_lines(kf)
    counts["new_lines"] = jm.n_ln - n_ln
    snaps["lines"] = mapstore_to_numpy(jm)
    n_pt, fused = jm.n_pt, jl.n_fused
    jl.search_in_neighbors(kf)
    counts["n_fused"] = jl.n_fused - fused
    counts["n_merged"] = n_pt - jm.n_pt
    counts["n_bound"] = counts["n_fused"] - counts["n_merged"]
    snaps["fuse"] = mapstore_to_numpy(jm)
    counts["ba_path"] = ba_path(jm, kf, caps["ba_kf_cap"])
    bound = int((jm.kf_match_pt >= 0).sum())
    jl.local_ba(kf)
    counts["unbound_by_ba"] = bound - int((jm.kf_match_pt >= 0).sum())
    snaps["ba"] = mapstore_to_numpy(jm)
    counts.update(n_pt=jm.n_pt, n_ln=jm.n_ln,
                  start_max_centre_m=centre_err(arrays["kf_pose_cw"],
                                                truth["kf_pose_cw"]),
                  max_centre_m=centre_err(jm.kf_pose_cw, truth["kf_pose_cw"]))
    return snaps, counts, jl


def run_port(confirmed, caps):
    arrays, truth = build_keyframe_map(confirmed)
    m = mapstore_from_numpy(arrays)
    mp = NeighborhoodStep(plain=True, device="cpu", **caps).mapper
    mp.map = m
    kf = truth["new_kf"]
    snaps = {}
    mp.create_new_lines(kf)
    snaps["lines"] = mapstore_to_numpy(m)
    mp.search_in_neighbors(kf)
    snaps["fuse"] = mapstore_to_numpy(m)
    mp.local_ba(kf)
    snaps["ba"] = mapstore_to_numpy(m)
    return snaps, mp, truth


@pytest.fixture(scope="module")
def jax_mappers():
    return {}


@pytest.fixture(scope="module", params=[False, True],
                ids=["points", "confirmed_lines"])
def runs(request, jax_mappers):
    jr, counts, jl = run_reference(request.param, SMALL_CAPS,
                                   jax_mappers.get("m"))
    jax_mappers["m"] = jl
    pr, mp, truth = run_port(request.param, SMALL_CAPS)
    return dict(confirmed=request.param, jax=jr, port=pr, counts=counts,
                mapper=mp, truth=truth)


def test_new_lines_match_reference(runs):
    j, p = runs["jax"]["lines"], runs["port"]["lines"]
    assert runs["counts"]["new_lines"] > 50
    assert p["n_ln"] == j["n_ln"]
    np.testing.assert_array_equal(p["kf_match_ln"], j["kf_match_ln"])
    np.testing.assert_array_equal(p["ln_valid"], j["ln_valid"])
    np.testing.assert_array_equal(p["ln_n_obs"], j["ln_n_obs"])
    v = p["ln_valid"]
    ep_p = p["ln_ep"][v].reshape(-1, 3).astype(np.float64)
    ep_j = j["ln_ep"][v].reshape(-1, 3).astype(np.float64)
    gap = np.linalg.norm(ep_p - ep_j, axis=1)
    assert (gap <= 5e-5 * np.linalg.norm(ep_j, axis=1)).all(), gap.max()


def test_fusion_matches_reference(runs):
    j, p, mp = runs["jax"]["fuse"], runs["port"]["fuse"], runs["mapper"]
    np.testing.assert_array_equal(p["kf_match_pt"], j["kf_match_pt"])
    np.testing.assert_array_equal(p["pt_valid"], j["pt_valid"])
    np.testing.assert_array_equal(p["pt_n_obs"], j["pt_n_obs"])
    assert p["n_pt"] == j["n_pt"]
    c = runs["counts"]
    assert mp.n_fused == c["n_fused"]
    assert (mp.n_bound, mp.n_merged) == (c["n_bound"], c["n_merged"])
    # every branch of the fuse decides some matches
    assert mp.n_bound > 0 and mp.n_merged > 0 and mp.n_refused > 0


def test_covisibility_numpy_path_matches_reference(runs):
    """The port's numpy covisibility against the JAX store's (its native
    library where built), after the fuse updated the new keyframe's
    row."""
    for stage in ("fuse", "ba"):
        np.testing.assert_array_equal(runs["port"][stage]["covis"],
                                      runs["jax"][stage]["covis"])


def _reprojection(s, kfs):
    """Pixel residuals of every bound feature of the keyframes `kfs`."""
    out = []
    for k in kfs:
        f = np.nonzero(s["kf_match_pt"][k] >= 0)[0]
        X = s["pt_xyz"][s["kf_match_pt"][k, f]].astype(np.float64)
        P = s["kf_pose_cw"][k].astype(np.float64)
        pc = X @ P[:, :3].T + P[:, 3]
        uv = np.stack([K.fx * pc[:, 0] / pc[:, 2] + K.cx,
                       K.fy * pc[:, 1] / pc[:, 2] + K.cy], -1)
        out.append(uv - s["kf_feat_uv"][k, f])
    return np.concatenate(out)


def test_local_ba_matches_reference(runs):
    j, p, mp = runs["jax"]["ba"], runs["port"]["ba"], runs["mapper"]
    want = "pl" if runs["confirmed"] else "pt"
    assert mp.ba_path == runs["counts"]["ba_path"] == want
    assert float(np.abs(p["kf_pose_cw"] - j["kf_pose_cw"]).max()) <= 1e-3
    np.testing.assert_array_equal(p["kf_match_pt"], j["kf_match_pt"])
    np.testing.assert_array_equal(p["pt_valid"], j["pt_valid"])
    np.testing.assert_array_equal(p["pt_n_obs"], j["pt_n_obs"])
    assert runs["counts"]["unbound_by_ba"] > 0
    kfs = np.nonzero(p["kf_valid"])[0]
    gap = np.abs(_reprojection(p, kfs) - _reprojection(j, kfs)).max()
    assert gap <= 0.1, gap
    if runs["confirmed"]:
        v = p["ln_valid"]
        assert float(np.abs(p["ln_ep"][v] - j["ln_ep"][v]).max()) <= 1e-2
    c = runs["counts"]
    assert c["max_centre_m"] < c["start_max_centre_m"]


def test_forward_runs_the_three_calls():
    """NeighborhoodStep.forward on a fresh store leaves it as the three
    calls do one by one, and reports what they did."""
    arrays, truth = build_keyframe_map(False)
    m = mapstore_from_numpy(arrays)
    step = NeighborhoodStep(plain=True, device="cpu", **SMALL_CAPS)
    out = step(m)
    ref, mp, _ = run_port(False, SMALL_CAPS)
    got = mapstore_to_numpy(m)
    for k in MS.ARRAYS:
        np.testing.assert_array_equal(got[k], ref["ba"][k], err_msg=k)
    assert out.new_lines == ref["lines"]["n_ln"] - arrays["n_ln"]
    assert (out.n_bound, out.n_merged, out.n_refused) == \
        (mp.n_bound, mp.n_merged, mp.n_refused)
    assert out.ba_path == "pt" and len(out.lm_iters) == 2
    assert out.host_syncs == 0            # the CPU reads nothing back


def test_keyframe_map_reaches_every_branch():
    """What the builder promises at production caps: the forward fuse's
    candidates above its cap of 2048, half the new keyframe's features
    unbound, 10 neighbours, a BA window above 4096 points and 8192
    observations, and >= 8 confirmed window lines in the second map."""
    for confirmed in (False, True):
        arrays, truth = build_keyframe_map(confirmed)
        m = mapstore_from_numpy(arrays)
        kf = truth["new_kf"]
        assert m.n_kf == 14 and kf == 13
        n1 = m.covisible_kfs(kf, n=10, min_weight=5)
        assert len(n1) == 10
        cand = np.unique(m.kf_match_pt[n1])
        assert (cand >= 0).sum() > 2048
        bound = int((m.kf_match_pt[kf] >= 0).sum())
        assert 400 <= bound <= 600 and m.kf_feat_valid[kf].sum() == 1000
        assert (m.kf_match_ln[kf] >= 0).sum() == 0
        window = np.concatenate([[kf], n1])
        pts = np.unique(m.kf_match_pt[window])
        pts = pts[pts >= 0][:4096]
        assert len(pts) == 4096
        assert np.isin(m.kf_match_pt[m.kf_valid], pts).sum() > 8192
        assert ba_path(m, kf, 16) == ("pl" if confirmed else "pt")
        assert (m.kf_line_valid[:14].sum(1) >= 150).all()


def test_mapstore_round_trip():
    arrays, _ = build_keyframe_map(True)
    back = mapstore_to_numpy(mapstore_from_numpy(arrays))
    for k in MS.ARRAYS + MS.SCALARS:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
        assert np.asarray(back[k]).dtype == np.asarray(arrays[k]).dtype


def reference_nbh():
    """REF_NBH: the JAX mapper at production caps on both maps."""
    out = {}
    for confirmed in (False, True):
        _, counts, _ = run_reference(confirmed, FULL_CAPS)
        out["confirmed_lines" if confirmed else "points"] = counts
    return out


if __name__ == "__main__":
    print("REF_NBH = " + json.dumps(reference_nbh(), indent=1))
    sys.exit(0)
