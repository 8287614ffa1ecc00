"""Parity of the ORB front end of plvio_tpu_torch (plain versions, CPU)
with plvio_tpu.ops.frontend on a rendered synthetic frame.

The centre 240x376 crop of a rendered 480x752 room frame, 4 levels,
300 features.
Tolerances: level-0 keypoints exact (level 0 is the input image itself);
>= 98% of keypoints equal over all levels (levels 1-3 are the same
resize function summed in another order, within 1e-4 grey levels since
the port's pyramid computes jax.image.resize's weights; before, PyTorch's
own antialiased resize differed by ~1e-3);
>= 99% descriptor bits equal on common keypoints (bits near a tie flip
under float32 reassociation of the blur and sampling sums); the fixed
patterns array-equal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plvio_tpu.io import synthetic as syn
from plvio_tpu.ops import frontend as JF
from plvio_tpu.ops import lines as JL
from plvio_tpu_torch import state
from plvio_tpu_torch.ops import frontend as TF
from plvio_tpu_torch.ops import lines as TL
from plvio_tpu_torch.ops import matching as TM

H, W, NF, NL = 240, 376, 300, 4


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(0)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=200)
    traj = syn.make_orbit_trajectory(duration=0.2, fps=20.0, radius=0.6)
    full = syn.render_frame(scene, traj.R_wb[1], traj.p_wb[1], rng=rng)
    return np.ascontiguousarray(full[120:120 + H, 188:188 + W], np.float32)


@pytest.fixture(scope="module")
def both(frame):
    specs = tuple(JF.make_level_specs(H, W, NF, n_levels=NL))
    fj = jax.jit(lambda im: JF.extract_orb(im, specs))(jnp.asarray(frame))
    with torch.no_grad():
        ft = TF.extract_orb(torch.from_numpy(frame), specs)
    return specs, fj, ft


def test_patterns_array_equal():
    np.testing.assert_array_equal(TF.brief_pattern(), JF.brief_pattern())
    np.testing.assert_array_equal(TL._band_pair_pattern(),
                                  JL._band_pair_pattern())
    st = state.from_numpy({}, "cpu")
    np.testing.assert_array_equal(st["brief_pattern"].numpy(),
                                  JF.brief_pattern())
    np.testing.assert_array_equal(st["lbd_pairs"].numpy(),
                                  JL._band_pair_pattern())


def test_level_specs_equal():
    for args in ((480, 752, 1000), (H, W, NF, NL)):
        assert TF.make_level_specs(*args) == [
            tuple(s) for s in JF.make_level_specs(*args)]


def test_fast_grid_level0_cells_exact(frame):
    """orb_fast_grid's plain version against the reference's FAST, NMS,
    blend, border mask and per-cell argmax on level 0."""
    img = jnp.asarray(frame)
    f_hi, f_lo = JF.fast_response2(img, 20.0, 7.0)
    r_hi, r_lo = JF.nms3x3(f_hi), JF.nms3x3(f_lo)
    resp = np.asarray(jnp.where(r_hi > 0, r_hi + 1e4, r_lo))
    ys, xs = np.mgrid[:H, :W]
    ok = (ys >= 19) & (ys < H - 19) & (xs >= 19) & (xs < W - 19)
    r = np.where(ok, resp, 0.0)
    Hc, Wc = H // 16, W // 16
    rc = r[:Hc * 16, :Wc * 16].reshape(Hc, 16, Wc, 16).transpose(0, 2, 1, 3)
    rc = rc.reshape(Hc * Wc, 256)
    best, arg = TF.orb_fast_grid(torch.from_numpy(frame), 20.0, 7.0)
    np.testing.assert_array_equal(arg.numpy(), rc.argmax(1))
    np.testing.assert_allclose(best.numpy(), rc.max(1), rtol=1e-6, atol=0)


def test_keypoints(both):
    specs, fj, ft = both
    uj, ut = np.asarray(fj.uv), ft.uv.numpy()
    vj, vt = np.asarray(fj.valid), ft.valid.numpy()
    n0 = specs[0].n_keep
    np.testing.assert_array_equal(ut[:n0], uj[:n0])
    np.testing.assert_array_equal(vt[:n0], vj[:n0])
    np.testing.assert_array_equal(ft.octave.numpy(), np.asarray(fj.octave))
    same = (np.abs(ut - uj).max(1) < 1e-3) & (vt == vj)
    assert same.mean() >= 0.98, same.mean()
    assert vt.sum() > 0.8 * len(vt)


def test_descriptors_and_angles(both):
    _, fj, ft = both
    common = (np.abs(ft.uv.numpy() - np.asarray(fj.uv)).max(1) < 1e-3) \
        & ft.valid.numpy() & np.asarray(fj.valid)
    bits_j = np.asarray(fj.desc) > 0
    bits_t = TM.unpack_u32_to_pm1(ft.desc).numpy() > 0
    agree = (bits_j == bits_t)[common].mean()
    assert agree >= 0.99, agree
    dang = np.abs(ft.angle.numpy() - np.asarray(fj.angle))[common]
    dang = np.minimum(dang, 360.0 - dang)
    assert np.percentile(dang, 99) < 0.05, np.percentile(dang, 99)


def test_extract_patches_equal_bf16_gather(frame):
    """The one-hot bf16 matmuls of the reference cut exactly bf16(img)."""
    xy = np.array([[19, 19], [100, 60], [3, 5], [W - 2, H - 1]], np.float32)
    pj = np.asarray(JF.extract_patches(jnp.asarray(frame), jnp.asarray(xy)))
    pt = TF.extract_patches([torch.from_numpy(frame)], torch.from_numpy(xy),
                            torch.zeros(4, dtype=torch.int32))
    np.testing.assert_array_equal(pt.numpy(), pj)
