"""Slice 18 on the CPU: the global path's stored-entry rule and the ORB
detector's plain path.

- The global path of `schur_solve` (csrc/schur_solve.cu
  `assemble_rows_kernel`, `cg_cluster_kernel`) stores each row's
  `row_segs` columns; `KN.stored_pattern`, the Python mirror of that rule,
  equals the system's structural non-zeros `KN.cg_pattern` at 23, 30 and
  64 keyframes in the 15-DoF window and at 38 and 128 in the point-only
  one (so skipping the other entries moves no sum), and the cluster's
  split (`KN.cluster_rows`) holds the paths' windows in shared memory.
- The detector's plain path (`orb_detect_plain`, the card kernel's
  yardstick) against JAX `extract_orb` on a rendered 480x752 frame at
  1000 features: level-0 coordinates, response, valid and octave equal on
  the reference's pyramid levels; the coordinates, valid and octave also
  on the port's own pyramid.
- The top-k's tie rule (`select_top_cells`, and the kernel's sort key)
  on a hand-made level of equal cell scores: the stable descending order,
  lax.top_k's, index for index.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plvio_tpu.io import synthetic as syn
from plvio_tpu.ops import frontend as JF
from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.ops import frontend as TF

SMEM = 232448                    # bytes of shared memory a block can use


@pytest.mark.parametrize("n_kf,body", [(23, True), (30, True), (64, True),
                                       (38, False), (128, False)])
def test_global_stored_pattern_is_the_structural_nonzeros(n_kf, body):
    S = (15 if body else 6) * n_kf
    assert not KN.solve_fits(n_kf, body)
    pat = KN.stored_pattern(n_kf, body)
    assert pat.shape == (S, S)
    assert torch.equal(pat, KN.cg_pattern(n_kf, body))
    # each row's segments in increasing column order, none overlapping
    for i in range(S):
        segs = KN.row_segs(i, n_kf, body)
        ends = [c0 + n for c0, n in segs]
        assert all(e <= c for e, (c, _) in zip(ends, segs[1:]))
    # the workspace holds the rows; on the 16-CTA cluster each CTA's rows,
    # p, the warp sums and the mbarriers fit its shared memory
    _, _, floats = KN.row_layout(n_kf, body)
    assert KN.cg_workspace_floats(n_kf, body) == floats
    w, per_cta = KN.cluster_rows(n_kf, body)
    assert sum(per_cta) == floats
    assert 32 * w * KN.CLUSTER_CTAS >= S
    nw = -(-S // 32)
    assert max(per_cta) * 4 + (S + 2 * nw) * 4 + 64 <= SMEM


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(0)
    scene = syn.make_room_scene(rng, n_points=4000, n_lines=200)
    traj = syn.make_orbit_trajectory(duration=0.2, fps=20.0, radius=0.6)
    return np.asarray(syn.render_frame(scene, traj.R_wb[1], traj.p_wb[1],
                                       rng=rng), np.float32)


def test_detector_plain_path_equals_jax_extract_orb(frame):
    """On the reference's pyramid levels every output is equal; on the
    port's own pyramid (levels 1-7 the same resize summed in another
    order, ~1e-4 grey levels apart) the keypoints, valid and octave."""
    jspecs = tuple(JF.make_level_specs(480, 752, 1000))
    specs = TF.make_level_specs(480, 752, 1000)
    im = jnp.asarray(frame)
    fj = jax.jit(lambda im: JF.extract_orb(im, jspecs))(im)
    pyr_j = jax.jit(lambda im: JF.build_pyramid(im, list(jspecs)))(im)
    with torch.no_grad():
        d = TF.orb_detect([torch.from_numpy(np.array(lv)) for lv in pyr_j],
                          specs, 20.0, 7.0)           # the CPU: plain path
        own = TF.orb_detect(TF.build_pyramid(torch.from_numpy(frame),
                                             specs), specs, 20.0, 7.0)
    for name in ("uv", "response", "valid", "octave"):
        np.testing.assert_array_equal(getattr(d, name).numpy(),
                                      np.asarray(getattr(fj, name)), name)
    for name in ("uv", "valid", "octave"):
        np.testing.assert_array_equal(getattr(own, name).numpy(),
                                      np.asarray(getattr(fj, name)), name)
    scale = np.array([sp.scale for sp in specs], np.float32)
    np.testing.assert_array_equal(
        d.xy.numpy() * scale[d.octave.numpy()][:, None], d.uv.numpy())
    assert int(d.valid.sum()) > 900


def test_top_cells_tie_rule_is_exact():
    # 6 x 8 cells: three score levels, runs of equal scores, zeros (below
    # any corner) included; in-cell winners chosen by hand
    rng = np.random.default_rng(3)
    best = rng.choice(np.float32([0.0, 35.5, 1e4 + 12.25]), 48)
    best[[5, 9, 40]] = np.float32(1e4 + 12.25)
    arg = rng.integers(0, 256, 48).astype(np.int32)
    Wc = 8
    for k in (1, 7, 20, 48, 60):
        xy, score, valid = TF.select_top_cells(
            torch.from_numpy(best), torch.from_numpy(arg), Wc, k)
        kk = min(k, 48)
        # the rule: score descending, then cell index ascending
        order = sorted(range(48), key=lambda c: (-float(best[c]), c))[:kk]
        _, top = jax.lax.top_k(jnp.asarray(best), kk)
        assert list(np.asarray(top)) == order
        want = np.array([[(c % Wc) * 16 + arg[c] % 16,
                          (c // Wc) * 16 + arg[c] // 16] for c in order],
                        np.float32)
        np.testing.assert_array_equal(xy.numpy(), want)
        np.testing.assert_array_equal(score.numpy(), best[order])
        np.testing.assert_array_equal(valid.numpy(), best[order] > 0)
        # the kernel's 64-bit key (complemented score bits, then the cell)
        # sorts ascending into the same order
        bits = best.view(np.uint32).astype(np.uint64)
        key = ((~bits & np.uint64(0xffffffff)) << np.uint64(32)) \
            | np.arange(48, dtype=np.uint64)
        assert list(np.argsort(key, kind="stable")[:kk]) == order
