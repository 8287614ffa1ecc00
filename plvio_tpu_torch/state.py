"""Carry what the JAX package holds (the map, a pose, the inertial
window's state) over to the port's tensors."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.kernels import PRE_KEYS
from .ops.frontend import brief_pattern
from .ops.lines import _band_pair_pattern

_BOOL = ("pt_valid", "ln_valid")
_DESC = ("pt_desc", "ln_desc")
_FLOAT = ("pt_xyz", "ln_ep6", "pose")


def from_numpy(arrays: Dict[str, np.ndarray],
               device) -> Dict[str, torch.Tensor]:
    """Map and pose arrays of the JAX package -> the port's tensors.

    Takes any of pt_xyz [P,3], pt_desc [P,8] uint32, pt_valid [P], ln_ep6
    [L,6], ln_desc [L,8] uint32, ln_valid [L] and pose [3,4] (T_cw).
    Descriptors become int32 with the same bits (a view, no arithmetic).
    Adds the two fixed patterns the port rebuilds from the reference's
    numpy recipes: 'brief_pattern' [256,2,2] float32 (seed 7,
    ops/frontend.py:271-281) and 'lbd_pairs' [256,2,2] int32 (seed 11,
    ops/lines.py:432-442)."""
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        if k in _DESC:
            if a.dtype != np.uint32 or a.shape[-1] != 8:
                raise ValueError(f"{k}: expected [*,8] uint32, got "
                                 f"{a.dtype} {a.shape}")
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
        elif k in _BOOL:
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=bool))
        elif k in _FLOAT:
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        else:
            raise KeyError(f"from_numpy: unknown array {k!r}")
        out[k] = t.to(device)
    out["brief_pattern"] = torch.from_numpy(brief_pattern()).to(device)
    out["lbd_pairs"] = torch.from_numpy(_band_pair_pattern()).to(device)
    return out


_INERTIAL_FLOAT = ("pose_wb", "vel", "bias_g", "bias_a", "imu_info",
                   "rw_info_g", "rw_info_a")


def inertial_from_numpy(arrays: Dict[str, np.ndarray],
                        device) -> Dict[str, torch.Tensor]:
    """The JAX package's inertial window state -> the port's tensors.

    Takes any of the keyframes' pose_wb [W,3,4], vel, bias_g, bias_a
    [W,3], the stacked preintegration constants of
    `LocalMapper._pre_const` (models/local_mapping.py:892-896: dT, dR, dV,
    dP, JRg, JVg, JVa, JPg, JPa, bg0, ba0, each [W-1, ...]; top-level keys
    or a 'pre_const' dict), imu_info [W-1,9,9], edge_valid [W-1] and
    rw_info_g / rw_info_a [W-1].  Float arrays become float32, edge_valid
    bool; the constants are returned as out['pre_const']."""
    out: Dict[str, torch.Tensor] = {}
    pre = dict(arrays.get("pre_const", {}))
    for k, v in arrays.items():
        if k == "pre_const":
            continue
        if k in PRE_KEYS:
            pre[k] = v
        elif k in _INERTIAL_FLOAT:
            out[k] = torch.from_numpy(np.ascontiguousarray(
                v, dtype=np.float32)).to(device)
        elif k == "edge_valid":
            out[k] = torch.from_numpy(np.ascontiguousarray(
                v, dtype=bool)).to(device)
        else:
            raise KeyError(f"inertial_from_numpy: unknown array {k!r}")
    if pre:
        missing = [k for k in PRE_KEYS if k not in pre]
        if missing:
            raise KeyError(f"inertial_from_numpy: pre_const lacks {missing}")
        out["pre_const"] = {k: torch.from_numpy(np.ascontiguousarray(
            pre[k], dtype=np.float32)).to(device) for k in PRE_KEYS}
    return out
