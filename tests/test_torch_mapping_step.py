"""The port's keyframe mapping step (`entry.mapping_step`) against
bench.build_mapping_step (CPU), at 4 KF / 256 points / 512 observations /
128 features / 32 lines / 64 line observations:

- `inputs.build_mapping_inputs` against the arrays bench.py builds: equal
  but for the KF rotations' float32 so3_exp (JAX's and torch's sin/cos may
  differ in the last bit), so poses within 1e-6 and the pixels derived
  from them within 1e-4 px;
- the whole step, from the true and from the perturbed start
  (`inputs.perturb_window`): triangulated and inlier counts equal, KF poses
  within 1e-3 (CG and accept/reject on sums in another order, see
  tests/test_torch_local_ba.py), camera-centre error within 10% of the
  reference's.

Run as a script, it prints REF_MAP, the guard of chip_smoke.py: the JAX
step on the CPU at both full sizes (worst case and typical bucket), from
the true and the perturbed start:

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_mapping_step.py
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from plvio_tpu.models import kernels as JK
from plvio_tpu.solver.residuals import PinholeK as JPin
from plvio_tpu_torch.entry import (K_EUROC, MAPPING_TYPICAL, MAPPING_WORST,
                                   mapping_step)
from plvio_tpu_torch.inputs import build_mapping_inputs, perturb_window

SMALL = dict(n_kf=4, n_pt=256, n_obs=512, n_feat=128, n_ln=32, n_lobs=64)
LBA_KEYS = ("kf_poses", "kf_free", "pt_xyz", "pt_free", "obs_kf", "obs_pt",
            "obs_uv", "obs_valid", "obs_is2", "ln_ep6", "ln_free", "lobs_kf",
            "lobs_ln", "lobs_eq", "lobs_valid", "lobs_is2")


def centre_err(P, G):
    """Largest camera-centre distance between two KF pose stacks T_cw."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    c = -np.einsum("kji,kj->ki", P[..., :3], P[..., 3])
    cg = -np.einsum("kji,kj->ki", G[..., :3], G[..., 3])
    return float(np.linalg.norm(c - cg, axis=1).max())


def jax_step(sz):
    """bench.build_mapping_step's step (eps = 0), also returning the line
    inliers: (poses, n_good, n_inliers, n_inliers_l) jitted, and A."""
    _, A = bench.build_mapping_step(**sz)
    K = JPin(*K_EUROC)
    epi = JK.make_epipolar_matcher(K, sz["n_feat"])
    tri = JK.make_triangulator(K, sz["n_feat"])
    lba = JK.make_local_ba_pl(K, sz["n_kf"], sz["n_pt"], sz["n_obs"],
                              sz["n_ln"], sz["n_lobs"])

    @jax.jit
    def step(A):
        idx2, ok2 = epi(A["pose_a"], A["pose_b"], A["uv_a"], A["desc"],
                        A["ok"], A["uv_b"], A["desc"], A["ok"], A["ang"],
                        A["ang"])
        _, good = tri(A["pose_a"], A["pose_b"], A["uv_a"], A["uv_b"][idx2],
                      ok2)
        poses, _, _, inl, inl_l = lba(*[A[k] for k in LBA_KEYS])
        return poses, jnp.sum(good), jnp.sum(inl), jnp.sum(inl_l)
    return step, A


def perturbed(A):
    B = dict(A)
    P, X = perturb_window(np.asarray(A["kf_poses"]), np.asarray(A["pt_xyz"]))
    B["kf_poses"], B["pt_xyz"] = jnp.asarray(P), jnp.asarray(X)
    return B


def reference_map(sizes=(("worst", MAPPING_WORST),
                         ("typical", MAPPING_TYPICAL))):
    """REF_MAP: per size, the JAX step's counts from the true start and the
    largest camera-centre errors (m) against the true KF poses, before and
    after, from both starts."""
    out = {}
    for name, sz in sizes:
        step, A = jax_step(sz)
        poses, n_good, n_inl, n_inl_l = step(A)
        poses_p, _, _, _ = step(perturbed(A))
        out[name] = dict(
            n_good=int(n_good), n_inliers=int(n_inl),
            n_inliers_l=int(n_inl_l),
            true_max_centre_m=centre_err(poses, A["kf_poses"]),
            perturbed_start_m=centre_err(perturbed(A)["kf_poses"],
                                         A["kf_poses"]),
            perturbed_max_centre_m=centre_err(poses_p, A["kf_poses"]))
    return out


@pytest.fixture(scope="module")
def reference():
    return jax_step(SMALL)


def test_mapping_inputs_match_bench(reference):
    _, A = reference
    T = build_mapping_inputs(**SMALL, device="cpu")
    assert sorted(T) == sorted(A)
    for k, v in A.items():
        a = np.asarray(v)
        b = T[k].numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        tol = {"kf_poses": 1e-6, "pose_a": 1e-6, "pose_b": 1e-6,
               "obs_uv": 1e-4, "uv_a": 1e-4, "uv_b": 1e-4,
               "lobs_eq": 1e-5}.get(k, 0.0)
        err = np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
        assert err <= tol, (k, err)


@pytest.mark.parametrize("start", ["true", "perturbed"])
def test_mapping_step_matches_reference(reference, start):
    jstep, A = reference
    B = perturbed(A) if start == "perturbed" else A
    pj, gj, nj, nlj = [np.asarray(a) for a in jstep(B)]
    step, T = mapping_step(**SMALL, device="cpu")
    if start == "perturbed":
        T["kf_poses"] = torch.from_numpy(np.array(B["kf_poses"]))
        T["pt_xyz"] = torch.from_numpy(np.array(B["pt_xyz"]))
    with torch.no_grad():
        out = step(T)
    assert int(out.n_good) == int(gj) >= 100
    assert int(out.n_inliers) == int(nj) and int(out.n_inliers_l) == int(nlj)
    assert np.abs(out.kf_poses.numpy() - pj).max() <= 1e-3
    ej, et = (centre_err(p, A["kf_poses"]) for p in (pj, out.kf_poses))
    assert abs(et - ej) <= 0.1 * ej, (et, ej)
    assert out.pt_xyz.shape == (SMALL["n_pt"], 3)
    assert bool(torch.isfinite(out.pt_xyz).all())


if __name__ == "__main__":
    print(json.dumps(reference_map()))
