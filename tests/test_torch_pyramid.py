"""The ORB image pyramid and the line front end's level 1 of
plvio_tpu_torch (the plain versions of the `pyramid` kernel, CPU) against
plvio_tpu.ops.frontend.build_pyramid and the level-1 box mean of
plvio_tpu.ops.lines.extract_lines_pyramid, and the ORB features through
the new pyramid against the reference's, at full width (480x752, 8
levels, 1000 features).

The reference resizes with jax.image.resize under jit, which builds its
per-axis weights in float32 with the sample contracted into one fused
multiply-add where a weight is computed, but recomputed unfused where the
column total is summed; `resize_weights` builds the same matrices (each
entry within 2 float32 ulps) and `resize_plain` contracts rows, then
columns, as XLA's einsum does.

Tolerances, and why: every pyramid level within 2e-4 grey levels (0-255)
of the reference on a rendered and on a seeded random frame (the two
contractions sum in other orders: the reading is 7.6e-5); the line level
within 1e-4; the weights within 2.5e-7; keypoints equal on >= 99.8% of
the slots over all levels, octaves and validity equal, descriptor bits
>= 99.9% equal on the common keypoints (bits near a tie of the blurred
patch flip under float32 reassociation, slice 1)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax._src.image import scale as JS

from plvio_tpu.io import synthetic as syn
from plvio_tpu.ops import frontend as JF
from plvio_tpu_torch.ops import frontend as TF
from plvio_tpu_torch.ops import lines as TL
from plvio_tpu_torch.ops import matching as TM

H, W, NF = 480, 752, 1000
SPECS = tuple(JF.make_level_specs(H, W, NF))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=60)
    traj = syn.make_orbit_trajectory(duration=0.2, fps=20.0, radius=0.6)
    rendered = np.asarray(syn.render_frame(scene, traj.R_wb[2], traj.p_wb[2],
                                           rng=rng), np.float32)
    noise = np.random.default_rng(1).uniform(0, 255, (H, W)).astype(
        np.float32)
    return {"rendered": rendered, "random": noise}


def test_resize_weights_match_jit():
    """Every level's per-axis weights as the jitted reference builds
    them."""
    for a, b in zip(SPECS[:-1], SPECS[1:]):
        for n_in, n_out in ((a.height, b.height), (a.width, b.width)):
            wj = np.asarray(jax.jit(lambda: JS.compute_weight_mat(
                n_in, n_out, n_out / n_in, 0.0, JS._fill_triangle_kernel,
                True))())
            wt = TF.resize_weights(n_in, n_out, "cpu").numpy()
            assert float(np.abs(wt - wj).max()) <= 2.5e-7, (n_in, n_out)
            inv, ks = TF.resize_axis(n_in, n_out)
            assert inv == np.float32(1.0 / (n_out / n_in)) and ks == inv


@pytest.mark.parametrize("name", ["rendered", "random"])
def test_pyramid_levels(frames, name):
    img = frames[name]
    pj = jax.jit(lambda x: JF.build_pyramid(x, SPECS))(jnp.asarray(img))
    pt = TF.build_pyramid_plain(torch.from_numpy(img), SPECS)
    errs = [float(np.abs(np.asarray(a) - b.numpy()).max())
            for a, b in zip(pj, pt)]
    print(name, errs)
    assert errs[0] == 0.0 and max(errs) <= 2e-4, errs
    # a CPU image takes the plain version through the kernel's wrapper
    pw = TF.build_pyramid(torch.from_numpy(img), SPECS)
    for a, b in zip(pw, pt):
        assert torch.equal(a, b)
    for lv, spec in enumerate(SPECS):
        assert tuple(pt[lv].shape) == (spec.height, spec.width)


@pytest.mark.parametrize("name", ["rendered", "random"])
def test_line_level(frames, name):
    """The level the line front end detects its level 1 on."""
    img = frames[name]
    ref = np.asarray(jax.jit(lambda x: x[:H // 2 * 2, :W // 2 * 2].reshape(
        H // 2, 2, W // 2, 2).mean((1, 3)))(jnp.asarray(img)))
    got = TF.line_level(torch.from_numpy(img)).numpy()
    assert got.shape == (H // 2, W // 2)
    assert float(np.abs(got - ref).max()) <= 1e-4
    odd = torch.from_numpy(img[:-1, :-3].copy())
    assert tuple(TF.line_level(odd).shape) == ((H - 1) // 2, (W - 3) // 2)
    np.testing.assert_array_equal(TF.line_level_plain(odd).numpy(),
                                  TF.line_level(odd).numpy())
    assert TL.line_level is TF.line_level


def test_orb_features_through_pyramid(frames):
    """ORB on the rendered frame at full width: keypoints, octaves and
    descriptors against the reference's extractor."""
    img = frames["rendered"]
    fj = jax.jit(lambda im: JF.extract_orb(im, SPECS))(jnp.asarray(img))
    with torch.no_grad():
        ft = TF.extract_orb(torch.from_numpy(img), SPECS)
    uj, ut = np.asarray(fj.uv), ft.uv.numpy()
    np.testing.assert_array_equal(ft.octave.numpy(), np.asarray(fj.octave))
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    same = np.abs(ut - uj).max(1) < 1e-3
    common = same & ft.valid.numpy()
    bits_j = np.asarray(fj.desc) > 0
    bits_t = TM.unpack_u32_to_pm1(ft.desc).numpy() > 0
    agree = (bits_j == bits_t)[common].mean()
    print(f"keypoints equal {same.mean():.5f}, bits {agree:.6f}")
    assert same.mean() >= 0.998, same.mean()
    assert agree >= 0.999, agree
