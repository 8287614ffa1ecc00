"""Slice 14, path B: the settings file, the prior keyframe set's images and
the prior-map relocalizer of plvio_tpu_torch (CPU) against the JAX package.

Run as a script, it prints REF_ED for chip_smoke.py: the JAX `System` over
the MH replay's frames (tests/test_torch_system.py `jax_mh_inputs`) with
the ED line detector (`extractor: 1`), IMU_MONOCULAR with lines, loop
closing on, the prior-map relocalizer on `inputs.build_prior_set`'s prior
set, `cfg.seed` 0..9, three processes at a time (~35 min, ~2.5 GB each):

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 tests/test_torch_prior_reloc.py

As tests (torch on one thread), each against the JAX package on the same
inputs:

(a) `load_config` on a settings file written to tmp_path (`%YAML:1.0`,
    `!!opencv-matrix Tbc`, `extractor: 1`, `bRelocalization: 1`): every
    field of the port's configuration equal to the JAX one's;
(b) `load_image_gray` bit-equal to the reference's PIL read on 8-bit grey,
    RGB and RGBA PNGs, and the 16-bit PGM read equal to PIL's;
(c) `load_prior_dir` on a synthetic prior set in both pose.txt forms (7
    columns and the TUM 8), the JAX relocalizer fed the port's ORB
    features of each prior image (the two packages' ORB differs in ~0.2%
    of the keypoints, tests/test_torch_pyramid.py): counts equal; per
    frame uv, valid, desc_packed, bow and has_depth bit-equal, xyz_w
    within 1e-5 relative, T_wc within 1e-6;
(d) `_try_align` on a hand-made live map (as tests/test_prior_reloc.py:
    68-135 builds one, on the synthetic frames) with JAX's PnP draws
    injected: the same prior frame chosen, T_prior_from_live within 2x
    JAX's distance to a float64 run of the port + 1e-5, the
    `process_keyframe` poses within 1e-5, `save_trajectory`'s rows within
    1e-6 of the JAX one's on the same poses (the poses' own gap, ~2e-6,
    shows in the files' positions otherwise);
(e) `System(cfg.reloc.enabled)` constructs on the CPU, and
    `save_relocalized_trajectory` writes a TUM file that `read_tum` reads.
"""
import json
import sys

import numpy as np
import pytest

ED_SECONDS = 8.0
N_SEEDS = 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields_equal(port, ref, where=""):
    """Every field of the port's dataclass equal to the JAX one's field of
    the same name (nested dataclasses field by field, enums by value)."""
    import dataclasses
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _fields_equal(a, b, f"{where}{f.name}.")
        else:
            assert a == b and type(a) is type(b) or (int(a) == int(b)), \
                (where + f.name, a, b)


SETTINGS = """%YAML:1.0
Camera.type: "PinHole"
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.k1: -0.28340811
Camera.k2: 0.07395907
Camera.p1: 0.00019359
Camera.p2: 1.76187114e-05
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.RGB: 1
ThDepth: 40.0
Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0e-03
IMU.Frequency: 200
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
nfeatures: 150
levels: 2
scale: 2.0
lsd_scale: 0.8
extractor: 1
SLAM: 0
bRelocalization: 1
Relocalization.data: "{prior}"
"""


def test_load_config_as_reference(tmp_path):
    """A reference settings file with the ED detector and the prior-map
    relocalizer: every field equal to the JAX package's."""
    from plvio_tpu.config import Sensor
    from plvio_tpu.config import load_config as jax_load
    from plvio_tpu_torch.config import Sensor as PSensor
    from plvio_tpu_torch.config import load_config
    path = tmp_path / "EuRoC.yaml"
    path.write_text(SETTINGS.replace("{prior}", str(tmp_path / "prior")))
    got = load_config(str(path), PSensor.IMU_MONOCULAR)
    ref = jax_load(str(path), Sensor.IMU_MONOCULAR)
    _fields_equal(got, ref)
    assert got.line.detector == 1 and got.reloc.enabled
    assert got.reloc.prior_data_dir == str(tmp_path / "prior")
    assert got.imu.Tbc == ref.imu.Tbc and got.orb.n_features == 1200


def test_image_reads_as_reference(tmp_path):
    """Grey, RGB and RGBA PNGs as the reference's PIL read, bit for bit;
    the 16-bit PGM as PIL reads it."""
    from PIL import Image
    from plvio_tpu.io.euroc import load_image_gray as jax_gray
    from plvio_tpu_torch.inputs import _write_pgm16
    from plvio_tpu_torch.io.euroc import load_image_gray, read_pgm
    rng = np.random.default_rng(0)
    for mode, shape in (("L", (48, 64)), ("RGB", (48, 64, 3)),
                        ("RGBA", (48, 64, 4))):
        p = str(tmp_path / f"{mode}.png")
        Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode).save(p)
        got, ref = load_image_gray(p), jax_gray(p)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    d = rng.integers(0, 65536, (30, 40)).astype(np.uint16)
    p = str(tmp_path / "d.pgm")
    _write_pgm16(p, d)
    np.testing.assert_array_equal(read_pgm(p), d)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), d)


@pytest.fixture(scope="module")
def prior_sets(tmp_path_factory):
    """The synthetic prior set in both pose.txt forms, four and two of
    its frames."""
    from plvio_tpu_torch.inputs import PRIOR_FRAMES, build_prior_set
    out = {}
    for tum in (False, True):
        d = tmp_path_factory.mktemp("tum" if tum else "xyzq")
        out[tum] = (str(d), build_prior_set(
            d, tum=tum, frames=PRIOR_FRAMES[:2] if tum else PRIOR_FRAMES[:4]))
    return out


@pytest.fixture(scope="module")
def loaded(prior_sets):
    """Both relocalizers on each prior set (`_relocalizers`)."""
    return {tum: _relocalizers(d) for tum, (d, _) in prior_sets.items()}


def _relocalizers(prior_dir, n_feat=1000):
    """The port's relocalizer (CPU) and the JAX one on the same prior set,
    the JAX one fed the port's ORB features of each prior image."""
    import torch
    from plvio_tpu.config import CameraConfig, RelocConfig, SystemConfig
    from plvio_tpu.models import vocabulary as JV
    from plvio_tpu.models.mapstore import Atlas as JAtlas
    from plvio_tpu.models.mapstore import MapStore as JMapStore
    from plvio_tpu.models.relocalization import PriorMapRelocalizer as JR
    from plvio_tpu_torch.config import CameraConfig as PCam
    from plvio_tpu_torch.config import RelocConfig as PReloc
    from plvio_tpu_torch.config import SystemConfig as PCfg
    from plvio_tpu_torch.models import vocabulary as V
    from plvio_tpu_torch.models.mapstore import Atlas, MapStore
    from plvio_tpu_torch.models.relocalization import PriorMapRelocalizer
    from plvio_tpu_torch.ops.frontend import make_extractor
    from test_torch_stereo_system import _layout
    cam = dict(width=640, height=480, fx=518.0, fy=519.0, cx=325.5,
               cy=253.5, dist=())
    port = PriorMapRelocalizer(
        PCfg(camera=PCam(**cam), reloc=PReloc(enabled=True)),
        Atlas([MapStore(max_kf=16, n_feat=n_feat)]),
        V.default_vocabulary("orb"), n_feat, device="cpu")
    ref = JR(SystemConfig(camera=CameraConfig(**cam),
                          reloc=RelocConfig(enabled=True)),
             JAtlas(maps=[JMapStore(max_kf=16, n_feat=n_feat)]),
             JV.default_vocabulary("orb"), n_feat)
    extract, _ = make_extractor(480, 640, 1000, device="cpu")

    def fed(img):
        with torch.no_grad():
            return _layout(extract(torch.from_numpy(np.array(img))),
                           None)[0]
    ref._extract = fed
    assert port.load_prior_dir(prior_dir) == ref.load_prior_dir(prior_dir)
    return port, ref, extract


@pytest.mark.parametrize("tum", [False, True])
def test_load_prior_dir_as_reference(prior_sets, loaded, tum):
    """Both pose.txt forms: the frames, their features, bags, depths, 3D
    points and poses as the JAX relocalizer's."""
    _, info = prior_sets[tum]
    port, ref, _ = loaded[tum]
    assert len(port.prior_frames) == len(ref.prior_frames) \
        == len(info["frames"])
    for p, j, T in zip(port.prior_frames, ref.prior_frames, info["T_wc"]):
        for k in ("uv", "valid", "desc_packed", "bow", "has_depth"):
            a, b = getattr(p, k), np.asarray(getattr(j, k))
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        gap = np.abs(p.xyz_w - j.xyz_w).max() / np.abs(j.xyz_w).max()
        assert gap <= 1e-5, gap
        assert np.abs(p.T_wc - j.T_wc).max() <= 1e-6
        assert np.abs(p.T_wc - T).max() <= 1e-5
        assert p.has_depth.sum() >= 100


def _jitted_pnp():
    """The JAX PnP under jax.jit (the same functions; eagerly a call takes
    seconds).  Returns the restore."""
    import jax
    from plvio_tpu.ops import pnp as JP
    orig = (JP.pnp_ransac, JP.mlpnp_refine)
    ransac = jax.jit(orig[0], static_argnames=("iters",))
    refine = jax.jit(orig[1])
    JP.pnp_ransac = lambda K, uv, X, v, key, iters=128, chi2_th=5.991: \
        ransac(K, uv, X, v, key, iters=iters, chi2_th=chi2_th)
    JP.mlpnp_refine = lambda *a: refine(*a)
    return orig


def test_try_align_as_reference(loaded, tmp_path):
    """A hand-made live map whose keyframes carry the prior images'
    features at poses in a live world offset from the prior world, then
    `process_keyframe` on each: both align on the same prior frame with
    the same matches; the port's T_prior_from_live within 2x JAX's
    distance to a float64 run of the port + 1e-5 (JAX's draws injected),
    the relocalized poses within 1e-5; `save_trajectory` on the same
    poses writes rows within 1e-6 of the JAX one's."""
    import jax
    import torch
    from plvio_tpu.ops import pnp as JP
    from plvio_tpu_torch.inputs import place_prior_keyframes, prior_live_offset
    from plvio_tpu_torch.io.trajectory import read_tum
    from plvio_tpu_torch.ops import pnp as PNP
    from test_torch_pnp import jax_samples
    port, ref, _ = loaded[False]
    key = {"k": jax.random.PRNGKey(port.cfg.seed + 13)}

    def sampler(valid):
        key["k"], sub = jax.random.split(key["k"])
        return np.array(jax_samples(sub, valid))
    port.sampler = sampler
    calls = {"port": [], "jax": []}
    ransac, refine = port._pnp, port._ml

    def port_pnp(K, uv, X, v, samples):
        calls["port"].append((uv, X, v, samples))
        return ransac(K, uv, X, v, samples)
    port._pnp = port_pnp
    orig = _jitted_pnp()
    jax_ransac = JP.pnp_ransac

    def jax_pnp(K, uv, X, v, k, **kw):
        calls["jax"].append(np.asarray(X))
        return jax_ransac(K, uv, X, v, k, **kw)
    JP.pnp_ransac = jax_pnp
    R_lp, t_lp = prior_live_offset()
    try:
        for r in (port, ref):
            kfs = place_prior_keyframes(r.atlas.current, port.prior_frames)
            for i, kf in enumerate(kfs):
                with torch.no_grad():
                    r.process_keyframe(kf, float(i))
    finally:
        JP.pnp_ransac, JP.mlpnp_refine = orig
    assert ref.T_prior_from_live is not None
    assert port.T_prior_from_live is not None and port.aligned_at == 1
    # the same attempts on the same prior points (the same frames tried)
    assert len(calls["port"]) == len(calls["jax"]) >= 1
    for (_, X, _, _), Xj in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(X.numpy(), Xj)
    # the alignment against a float64 run of the port's plain PnP on the
    # aligning attempt's inputs and samples
    uv, X, v, samples = calls["port"][-1]
    K = port.K
    res = PNP.pnp_ransac_plain(K, uv.double(), X.double(), v, samples)
    R64, t64, _, _ = PNP.mlpnp_refine_plain(K, uv.double(), X.double(),
                                            res.inliers, res.R, res.t)
    m = port.atlas.current
    kf = port.aligned_kf
    R_wc = R64.numpy().T
    T64 = np.concatenate([R_wc @ m.kf_pose_cw[kf, :, :3].astype(np.float64),
                          (R_wc @ m.kf_pose_cw[kf, :, 3]
                           - R_wc @ t64.numpy())[:, None]], 1)
    gap = np.abs(port.T_prior_from_live - ref.T_prior_from_live).max()
    ref_gap = np.abs(ref.T_prior_from_live - T64).max()
    print(f"T_prior_from_live: port - JAX {gap:.2e}, JAX - float64 "
          f"{ref_gap:.2e}")
    assert gap <= 2 * ref_gap + 1e-5
    # the offset recovered
    R_T = port.T_prior_from_live[:, :3]
    ang = np.arccos(np.clip((np.trace(R_T @ R_lp) - 1) / 2, -1, 1))
    assert ang < 0.01 and np.linalg.norm(
        port.T_prior_from_live[:, 3] + R_lp.T @ t_lp) < 0.02
    assert sorted(port.relocalized_poses) == sorted(ref.relocalized_poses)
    for t in ref.relocalized_poses:
        assert np.abs(port.relocalized_poses[t]
                      - ref.relocalized_poses[t]).max() <= 1e-5
    fp, fj = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    port.save_trajectory(fp)
    ref.relocalized_poses = {t: T.copy()
                             for t, T in port.relocalized_poses.items()}
    ref.save_trajectory(fj)
    a, b = np.loadtxt(fp, ndmin=2), np.loadtxt(fj, ndmin=2)
    assert a.shape == b.shape == (len(port.prior_frames), 8)
    assert np.abs(a - b).max() <= 1e-6
    assert len(read_tum(fp)) == len(port.prior_frames)


def test_system_with_prior_relocalizer(prior_sets, tmp_path):
    """`System` with `cfg.reloc.enabled` (and the ED detector) constructs
    on the CPU and loads the prior set; `save_relocalized_trajectory`
    writes a TUM file that `read_tum` reads."""
    import torch
    from plvio_tpu_torch.config import MapConfig, OrbConfig
    from plvio_tpu_torch.entry import ed_config
    from plvio_tpu_torch.io.trajectory import read_tum
    from plvio_tpu_torch.models.system import System
    d, info = prior_sets[True]
    s = System(ed_config(d, orb=OrbConfig(n_features=300),
                         map=MapConfig(max_keyframes=16, max_points=2048,
                                       max_lines=256)), device="cpu")
    r = s.relocalizer
    assert s.extract_lines.detector == 1
    assert len(r.prior_frames) == len(info["frames"])
    m = s.atlas.current
    kf = m.alloc_kf()
    m.kf_pose_cw[kf] = np.eye(4, dtype=np.float32)[:3]
    r.T_prior_from_live = info["T_wc"][0].astype(np.float32)
    with torch.no_grad():
        r.process_keyframe(kf, 1.5)
    path = str(tmp_path / "R_KeyFrameTrajectory.txt")
    s.save_relocalized_trajectory(path)
    traj = read_tum(path)
    assert len(traj) == 1 and traj.timestamps[0] == 1.5
    np.testing.assert_allclose(traj.positions[0], info["T_wc"][0][:, 3],
                               atol=1e-6)



def jax_ed_config(seed: int, prior_dir=None):
    """`entry.ed_config`'s configuration in the JAX package."""
    from plvio_tpu.config import (CameraConfig, ImuConfig, LineConfig,
                                  RelocConfig, Sensor, SystemConfig)
    reloc = RelocConfig(enabled=prior_dir is not None,
                        prior_data_dir=None if prior_dir is None
                        else str(prior_dir))
    return SystemConfig(sensor=Sensor.IMU_MONOCULAR,
                        camera=CameraConfig(dist=(0.0, 0.0, 0.0, 0.0)),
                        imu=ImuConfig(Tbc=tuple(np.eye(4).reshape(-1))),
                        line=LineConfig(detector=1), reloc=reloc, seed=seed)


def reference_ed(seed: int, prior_dir, seconds: float = ED_SECONDS) -> dict:
    """The JAX `System` over the MH replay with the ED detector and the
    relocalizer on the prior set in prior_dir (written by
    `inputs.build_prior_set`): `test_torch_kb8_inertial.reference_replay`'s
    counts, whether it aligned, the keyframes processed when it did
    (`align_kf`, -1 if never), the keyframes relocalized and their
    position error against the truth in the prior world."""
    import test_torch_system as TS
    from test_torch_kb8_inertial import reference_replay
    from plvio_tpu_torch.entry import prior_error
    from plvio_tpu_torch.inputs import prior_from_replay
    made, rec = [], {"calls": 0, "align_kf": -1}
    orig = TS.recording_system

    def recording(cfg):
        s = orig(cfg)
        made.append(s)
        r = s.relocalizer
        process = r.process_keyframe

        def counted(kf, timestamp):
            rec["calls"] += 1
            aligned = r.T_prior_from_live is not None
            process(kf, timestamp)
            if not aligned and r.T_prior_from_live is not None:
                rec["align_kf"] = rec["calls"]
                print(f"  aligned at keyframe call {rec['calls']}",
                      file=sys.stderr, flush=True)
        r.process_keyframe = counted
        return s
    TS.recording_system = recording
    try:
        out = reference_replay(jax_ed_config(seed, prior_dir),
                               TS.jax_mh_inputs(seconds), True)
    finally:
        TS.recording_system = orig
    r = made[0].relocalizer
    out.update(aligned=r.T_prior_from_live is not None,
               align_kf=rec["align_kf"],
               n_relocalized=len(r.relocalized_poses),
               reloc_err=prior_error(r.relocalized_poses,
                                     prior_from_replay()))
    return out


def ref_ed(ref: dict) -> dict:
    """`seed_ranges`' summary with the relocalizer's: which runs aligned,
    the ranges of the alignment keyframe and of the keyframes relocalized
    and the worst position error over the runs that aligned."""
    runs = [r for r in ref["per_seed"] if r["aligned"]]
    for k in ("align_kf", "n_relocalized"):
        ref[k + "_range"] = [min(r[k] for r in runs),
                             max(r[k] for r in runs)] if runs else None
    ref["reloc_err_worst"] = max(r["reloc_err"] for r in runs) \
        if runs else None
    ref["aligned"] = [r["aligned"] for r in ref["per_seed"]]
    return ref


if __name__ == "__main__":
    if sys.argv[1:2] == ["--seed"]:
        import tempfile
        from plvio_tpu_torch.inputs import build_prior_set
        d = tempfile.mkdtemp(prefix="prior_set_")
        build_prior_set(d)
        print("ED_SEED = " + json.dumps(reference_ed(int(sys.argv[2]), d)))
    else:
        from test_torch_kb8_inertial import seed_ranges
        print("REF_ED = " + json.dumps(ref_ed(seed_ranges(
            __file__, [], "ED_SEED = ", n_seeds=N_SEEDS))))
