"""Slice 14, path A: the ED line detector (detector 1, the reference's
`extractor: 1`) of plvio_tpu_torch (CPU) against plvio_tpu.ops.lines
`detect_lines_ed`, single level and through the 2-level pyramid, on a
rendered room frame and on images of dense random segments, and `System`
with detector 1 against the JAX `System`.

The walks are chaotic (a one-ulp change of a direction can change a probe's
choice and then the whole path), and XLA may hold bf16 intermediates in
float32 or contract multiply-adds where torch rounds every op, so the port
is held to JAX as segment sets, as detector 0 is (tests/test_torch_lines.py):
>= 95% of JAX's valid segments have a valid port segment with both
endpoints within 0.5 px (either orientation), matched LBD bits agree
>= 97%, and the anchors' positions agree on >= 98% of the slots (the
measured share: 100% on these images).  A flat image gives no segment.

`System` under detector 1: the STEREO room with lines of
tests/test_stereo.py (200 lines in place of its 60, so that the ED
detector finds ~20 segments a view) over 8 pairs, both packages fed the
port's features
(its ED segments; ORB alone differs in ~0.2% of the keypoints between the
packages, tests/test_torch_pyramid.py), as tests/test_torch_stereo_system.py
feeds them: every frame's state, inliers, keyframes made and map counts
equal, the pose within 1e-4.

Run as a script, it prints ROOM_ED for chip_smoke.py's REF_ED: the JAX
`System` (STEREO with lines, detector 1, loop closing off) over the 15
pairs of tests/test_stereo.py's room (tests/test_torch_stereo_system.py
`jax_room_inputs`, the 60-line room), its own front end:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 tests/test_torch_lines_ed.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvio_tpu.ops import lines as JL
from plvio_tpu_torch.ops import lines as TL
from plvio_tpu_torch.ops import matching as TM
from test_torch_lines import _frame, _match_segments, _segments_image

ANCHOR_SHARE = 0.98
SEG_SHARE = 0.95
BIT_SHARE = 0.97


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    return {"room0": _frame(0), "seg240": _segments_image(0),
            "seg480": _segments_image(1, 480, 752, 120),
            "flat": np.full((480, 752), 77.0, np.float32)}


def _jax_anchors(img, grad_th=12.0, anchor_th=4.0, n_anchors=512):
    """The anchor stage of the reference's `detect_lines_ed`
    (plvio_tpu/ops/lines.py:281-313), which the function does not return:
    (ax, ay, score) of the top n_anchors cells."""
    H, W = img.shape
    gx, gy = JL._gradients(img)
    mag = jnp.sqrt(gx * gx + gy * gy)
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    interior = (ys >= 4) & (ys < H - 4) & (xs >= 4) & (xs < W - 4)
    mag = jnp.where(interior, mag, 0.0)
    horiz = jnp.abs(gx) >= jnp.abs(gy)
    shl = jnp.pad(mag, ((0, 0), (1, 0)))[:, :-1]
    shr = jnp.pad(mag, ((0, 0), (0, 1)))[:, 1:]
    shu = jnp.pad(mag, ((1, 0), (0, 0)))[:-1]
    shd = jnp.pad(mag, ((0, 1), (0, 0)))[1:]
    nms = jnp.where(horiz, (mag > shl) & (mag >= shr),
                    (mag > shu) & (mag >= shd))
    score = jnp.where(nms & (mag > grad_th + anchor_th), mag, 0.0)
    CB = 8
    Hc, Wc = H // CB, W // CB
    cells = score[:Hc * CB, :Wc * CB].reshape(Hc, CB, Wc, CB) \
        .transpose(0, 2, 1, 3).reshape(Hc * Wc, CB * CB)
    best = cells.argmax(-1)
    cs = jnp.take_along_axis(cells, best[:, None], -1)[:, 0]
    ax = (jnp.arange(Hc * Wc) % Wc * CB + best % CB).astype(jnp.float32)
    ay = (jnp.arange(Hc * Wc) // Wc * CB + best // CB).astype(jnp.float32)
    top_s, top_i = jax.lax.top_k(cs, n_anchors)
    return ax[top_i], ay[top_i], top_s


@pytest.mark.parametrize("image", ["room0", "seg240", "seg480"])
def test_ed_anchors_and_segments_match_reference(images, image):
    """One level of `detect_lines_ed`: the anchors, then the segments."""
    img = images[image]
    jax_a = jax.jit(_jax_anchors)(jnp.asarray(img))
    _, _, _, score = TL.ed_anchor_field(torch.from_numpy(img))
    ax, ay, ts = TL.ed_cells(score)
    same = (np.asarray(jax_a[0]) == ax.numpy()) \
        & (np.asarray(jax_a[1]) == ay.numpy())
    alive = np.asarray(jax_a[2].astype(jnp.float32)) > 0
    assert alive.sum() >= 100
    assert same.mean() >= ANCHOR_SHARE, same.mean()
    fj = jax.jit(lambda im: JL.detect_lines_ed(im, 192))(jnp.asarray(img))
    ft = TL.detect_lines_ed(torch.from_numpy(img), 192)
    ej, vj = np.asarray(fj[0]), np.asarray(fj[3])
    et, vt = ft[0].numpy(), ft[3].numpy()
    assert vj.sum() >= 10
    m = _match_segments(ej, vj, et, vt)
    frac = (m >= 0).sum() / vj.sum()
    print(f"{image}: anchors {same.mean():.4f} equal, segments "
          f"{frac:.4f} matched ({vj.sum()} / {vt.sum()} valid)")
    assert frac >= SEG_SHARE, (frac, vj.sum(), vt.sum())
    # the outputs' layout: lengths descending, angles in [0, pi)
    assert np.all(np.diff(ft[2].numpy()) <= 0)
    assert float(ft[1].min()) >= 0.0 and float(ft[1].max()) < np.pi
    np.testing.assert_array_equal(ft[3].numpy(), ft[2].numpy() > 0)


@pytest.mark.parametrize("image,levels,max_lines",
                         [("room0", 2, 256), ("seg480", 2, 256),
                          ("seg240", 1, 128)])
def test_ed_extract_lines_match_reference(images, image, levels, max_lines):
    """The whole line front end under detector 1: segments and LBD bits."""
    img = images[image]
    if levels == 2:
        fj = jax.jit(lambda im: JL.extract_lines_pyramid(
            im, max_lines, detector=1))(jnp.asarray(img))
    else:
        fj = jax.jit(lambda im: JL.extract_lines(im, max_lines, detector=1))(
            jnp.asarray(img))
    with torch.no_grad():
        ft = TL.LineExtractor(max_lines, levels, detector=1)(
            torch.from_numpy(img))
    ej, vj = np.asarray(fj.ep), np.asarray(fj.valid)
    et, vt = ft.ep.numpy(), ft.valid.numpy()
    assert vj.sum() >= 10
    m = _match_segments(ej, vj, et, vt)
    frac = (m >= 0).sum() / vj.sum()
    assert frac >= SEG_SHARE, (frac, vj.sum(), vt.sum())
    rows = np.nonzero(m >= 0)[0]
    bits_j = np.asarray(fj.desc)[rows] > 0
    bits_t = TM.unpack_u32_to_pm1(ft.desc[torch.from_numpy(m[rows])]
                                  ).numpy() > 0
    agree = (bits_j == bits_t).mean()
    print(f"{image} x {levels}: segments {frac:.4f} matched, LBD bits "
          f"{agree:.4f}")
    assert agree >= BIT_SHARE, agree


def test_ed_flat_image_has_no_segment(images):
    """No gradient, no anchor: every slot invalid, on both packages, and
    the kernel wrapper takes the plain version for a CPU image."""
    img = images["flat"]
    fj = jax.jit(lambda im: JL.detect_lines_ed(im, 192))(jnp.asarray(img))
    out = TL.line_detect_ed(torch.from_numpy(img), 192)
    assert not np.asarray(fj[3]).any() and not bool(out[3].any())
    f = TL.LineExtractor(256, 2, detector=1)(torch.from_numpy(img))
    assert not bool(f.valid.any())
    with pytest.raises(ValueError, match="cells"):
        TL.detect_lines_ed(torch.zeros(64, 64), 16)
    with pytest.raises(ValueError, match="detector"):
        TL.LineExtractor(256, 2, detector=2)


def test_system_with_ed_detector_as_reference():
    """`System` with detector 1 (STEREO with lines over the room of
    tests/test_stereo.py with 200 lines, 8 pairs), both packages on the
    port's features: every frame as the JAX System's."""
    from plvio_tpu.config import LineConfig, MapConfig, OrbConfig, Sensor
    from plvio_tpu.models import tracking as JT
    from plvio_tpu_torch.config import LineConfig as PLine
    from plvio_tpu_torch.config import MapConfig as PMap
    from plvio_tpu_torch.config import OrbConfig as POrb
    from plvio_tpu_torch.entry import stereo_config as port_config
    from plvio_tpu_torch.inputs import build_stereo_room
    from plvio_tpu_torch.models.system import System
    from test_torch_stereo_system import (_capture_front_end,
                                          _jax_stereo_inputs, _jax_track,
                                          stereo_config)
    from test_torch_system import (CAPS, MAP, N_FEATURES, POSE_TOL, VIBA,
                                   _record, jax_system_with_database)
    n = 8
    port = System(port_config(Sensor.STEREO, orb=POrb(n_features=N_FEATURES),
                              map=PMap(**MAP), use_loop_closing=False,
                              line=PLine(detector=1)),
                  device="cpu", caps=CAPS, viba_caps=VIBA)
    assert port.extract_lines.detector == 1
    js = jax_system_with_database(stereo_config(
        Sensor.STEREO, orb=OrbConfig(n_features=N_FEATURES),
        map=MapConfig(**MAP), use_loop_closing=False,
        line=LineConfig(detector=1)))
    S = build_stereo_room(0, n, n_lines=200)
    bf = port.cfg.camera.baseline * port.cfg.camera.fx
    made_p = []
    process = port.mapper.process_keyframe

    def recording(kf, protect=()):
        made_p.append(int(kf))
        return process(kf, protect=protect)
    port.mapper.process_keyframe = recording
    got = _capture_front_end(port)
    worst, n_lines = 0.0, 0
    for i in range(n):
        t = float(S["timestamps"][i])
        del made_p[:]
        with torch.no_grad():
            port.track_stereo(S["frames"][i], S["right"][i], t, None)
        feats = got["stereo_features"][1]
        n_lines += int(feats[2].valid.sum())
        jf, jl, depth, line_depth = _jax_stereo_inputs(feats, bf)
        p = _record(port.tracker, made_p)
        n0 = len(js.processed)
        _jax_track(js, jf, jl, t, None, depth, line_depth)
        j = _record(js.tracker, js.processed[n0:])
        assert j["state"] == int(JT.TrackState.OK), i
        for k in ("state", "made", "inliers", "counts"):
            assert p[k] == j[k], (i, k, p[k], j[k])
        d = float(np.abs(p["pose"] - j["pose"]).max())
        worst = max(worst, d)
        assert d <= POSE_TOL, (i, d)
    print(f"ED System: {n_lines} segments over {n} left views, largest pose "
          f"difference {worst:.2e}")
    assert n_lines >= 10 * n and port.atlas.current.n_ln > 0


def reference_room_ed() -> dict:
    """The JAX `System` over the STEREO room under the ED detector."""
    from plvio_tpu.config import LineConfig, Sensor
    from plvio_tpu.models.system import System as JSystem
    from test_torch_stereo_system import (ROOM_STEREO_PAIRS, _ate,
                                          jax_room_inputs, stereo_config)
    n = ROOM_STEREO_PAIRS
    S = jax_room_inputs("stereo", n)
    js = JSystem(stereo_config(Sensor.STEREO, use_loop_closing=False,
                               line=LineConfig(detector=1)))
    n_ok = sum(js.track_stereo(S["frames"][i], S["second"][i],
                               float(S["timestamps"][i])) is not None
               for i in range(n))
    m = js.atlas.current
    ate = _ate(js, S)
    return {"n_frames": n, "n_tracked": n_ok, "keyframes": int(m.n_kf),
            "points": int(m.n_pt), "lines": int(m.n_ln),
            "ate_sim3": ate[0], "ate_se3": ate[1],
            "final_state": int(js.tracker.state)}


if __name__ == "__main__":
    import json
    print("ROOM_ED = " + json.dumps(reference_room_ed()))
