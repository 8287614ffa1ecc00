"""The dense part of the masked Gauss-Newton / Levenberg-Marquardt engine
(port of plvio_tpu/solver/engine.py: `BlockDef`, `DenseLayout`, `Term`,
`_whiten` :115, `Problem.add_dense/add_term/_linearize/
build_normal_equations/solve_step/_residuals_only/cost` :311-621 and
`optimize` :624, dense blocks only).

This is the plain version of the VI pose optimizer's kernel
(csrc/vi_pose_lm.cu): every residual is linearized by automatic
differentiation at delta = 0, as the reference does with `jax.jacfwd`.
The port takes `torch.func.vmap(torch.func.jacrev(...))`: the same exact
Jacobian, but PyTorch's forward mode gives a float32 tensor times a
Python float a float64 tangent, which a float32 matmul then refuses
(torch 2.13 on the CPU).  The Huber weight is w = min(1, delta/sqrt(chi2))
on the whitened chi2, recomputed at every evaluation, and the LM cost is
sum(w * chi2).  The landmark (Schur) families wait for the mapping slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import jacrev, vmap


@dataclass(frozen=True)
class BlockDef:
    """A family of dense state blocks (e.g. 'pose' x N)."""
    name: str
    count: int
    dof: int


class DenseLayout:
    """Static offsets of each block family in the dense state vector."""

    def __init__(self, blocks: Sequence[BlockDef]):
        self.blocks = {b.name: b for b in blocks}
        self.offsets: Dict[str, int] = {}
        off = 0
        for b in blocks:
            self.offsets[b.name] = off
            off += b.count * b.dof
        self.total = off

    def offset_of(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        return self.offsets[name] + idx * self.blocks[name].dof

    def slice_delta(self, delta: torch.Tensor, name: str) -> torch.Tensor:
        b = self.blocks[name]
        off = self.offsets[name]
        return delta[off:off + b.count * b.dof].reshape(b.count, b.dof)


@dataclass
class Term:
    """A batch of K identical residuals: res_fn(blocks, deltas, const) ->
    r [rdim]; dense_refs = [(family, idx [K])]; info [K] | [K,rdim] |
    [K,rdim,rdim]; robust_delta 0 = no robustifier."""
    name: str
    res_fn: Callable
    rdim: int
    dense_refs: List[Tuple[str, torch.Tensor]]
    const: Any = None
    mask: Optional[torch.Tensor] = None
    info: Optional[torch.Tensor] = None
    robust_delta: float = 0.0


def _whiten(r, J, info):
    """Apply sqrt-information to r [K,d] and J [K,d,n]; a full matrix is
    applied as L^T of its Cholesky factor, |L^T r|^2 = r^T Info r."""
    if info is None:
        return r, J
    if info.ndim == 1:
        s = torch.sqrt(info)[:, None]
        return r * s, J * s[..., None]
    if info.ndim == 2:
        s = torch.sqrt(info)
        return r * s, J * s[..., None]
    Lt = _cholesky_nan(info).transpose(-1, -2)
    return (torch.einsum("kij,kj->ki", Lt, r),
            torch.einsum("kij,kjn->kin", Lt, J))


def _cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where A is not positive definite (as
    jnp.linalg.cholesky; torch.linalg.cholesky would raise)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def _robust_weight(term: Term, chi2: torch.Tensor) -> torch.Tensor:
    if term.robust_delta > 0:
        w = torch.clamp_max(term.robust_delta
                            / torch.sqrt(torch.clamp_min(chi2, 1e-18)), 1.0)
    else:
        w = torch.ones_like(chi2)
    if term.mask is not None:
        w = w * term.mask.to(w.dtype)
    return w


class Problem:
    """A nonlinear least-squares problem over dense state blocks.
    states: dict name -> tensor [count, ...raw shape]."""

    def __init__(self):
        self._dense: List[BlockDef] = []
        self._retract: Dict[str, Callable] = {}
        self._dofs: Dict[str, int] = {}
        self.terms: List[Term] = []

    def add_dense(self, name: str, count: int, dof: int, retract: Callable):
        self._dense.append(BlockDef(name, count, dof))
        self._retract[name] = retract
        self._dofs[name] = dof

    def add_term(self, term: Term):
        self.terms.append(term)

    def _eval(self, term: Term, states, jac: bool):
        refs = term.dense_refs
        gathered = tuple(states[name][idx] for name, idx in refs)
        dofs = [self._dofs[name] for name, _ in refs]
        K = refs[0][1].shape[0]
        zeros = torch.zeros(K, sum(dofs), dtype=torch.float32,
                            device=refs[0][1].device)
        const = {} if term.const is None else term.const

        def f_single(delta, blocks, c):
            deltas = torch.split(delta, dofs)
            r = term.res_fn(blocks, deltas, c if term.const is not None
                            else None)
            return r, r

        if jac:
            J, r = vmap(jacrev(f_single, has_aux=True))(zeros, gathered,
                                                        const)
            return r, J, dofs
        r, _ = vmap(f_single)(zeros, gathered, const)
        return r, None, dofs

    def _linearize(self, term: Term, states):
        r, J, dofs = self._eval(term, states, jac=True)
        r_w, J_w = _whiten(r, J, term.info)
        chi2 = (r_w * r_w).sum(-1)
        return r_w, J_w, _robust_weight(term, chi2), chi2, dofs

    def build_normal_equations(self, states):
        """Assemble H [S,S] and g [S] (undamped).  Returns (layout, H, g,
        {} (no landmark systems), total_cost, chi2_by_term)."""
        layout = DenseLayout(self._dense)
        S = max(layout.total, 1)
        dev = self.terms[0].dense_refs[0][1].device
        H = torch.zeros(S, S, dtype=torch.float32, device=dev)
        g = torch.zeros(S, dtype=torch.float32, device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        chi2_by_term = {}
        for term in self.terms:
            r, J, w, chi2, dofs = self._linearize(term, states)
            chi2_by_term[term.name] = chi2
            total = total + (w * chi2).sum()
            Jparts = torch.split(J, dofs, dim=2)
            nd = len(term.dense_refs)
            if nd == 1 and term.dense_refs[0][1].shape[0] >= 64:
                name_a, idx_a = term.dense_refs[0]
                fam = layout.blocks[name_a]
                off0 = layout.offsets[name_a]
                da = dofs[0]
                Jaw = Jparts[0] * w[:, None, None]
                Hab = torch.einsum("kdi,kdj->kij", Jaw, Jparts[0])
                ga = -torch.einsum("kdi,kd->ki", Jaw, r)
                Hk = torch.zeros(fam.count, da, da, dtype=H.dtype,
                                 device=dev).index_add_(0, idx_a, Hab)
                gk = torch.zeros(fam.count, da, dtype=H.dtype,
                                 device=dev).index_add_(0, idx_a, ga)
                n = fam.count * da
                H[off0:off0 + n, off0:off0 + n] += torch.block_diag(
                    *Hk.unbind(0))
                g[off0:off0 + n] += gk.reshape(n)
                continue
            for a in range(nd):
                name_a, idx_a = term.dense_refs[a]
                rows = layout.offset_of(name_a, idx_a)[:, None] \
                    + torch.arange(dofs[a], device=dev)[None, :]
                Jaw = Jparts[a] * w[:, None, None]
                g.index_put_((rows,), -torch.einsum("kdi,kd->ki", Jaw, r),
                             accumulate=True)
                for b in range(nd):
                    name_b, idx_b = term.dense_refs[b]
                    cols = layout.offset_of(name_b, idx_b)[:, None] \
                        + torch.arange(dofs[b], device=dev)[None, :]
                    Hab = torch.einsum("kdi,kdj->kij", Jaw, Jparts[b])
                    H.index_put_((rows[:, :, None], cols[:, None, :]), Hab,
                                 accumulate=True)
        return layout, H, g, {}, total, chi2_by_term

    def solve_step(self, states, lam: torch.Tensor,
                   dense_free_mask: Optional[Dict[str, torch.Tensor]] = None):
        """One damped step: returns (new_states, cost, chi2_by_term).
        dense_free_mask[name]: [count] bool, False freezes that block."""
        layout, H, g, _, cost, chi2s = self.build_normal_equations(states)
        S = H.shape[0]
        free = torch.ones(S, dtype=torch.float32, device=H.device)
        if dense_free_mask:
            for name, m in dense_free_mask.items():
                b = layout.blocks[name]
                off = layout.offsets[name]
                free[off:off + b.count * b.dof] = torch.repeat_interleave(
                    m.to(torch.float32), b.dof)
        H = H + torch.diag(torch.diagonal(H) * lam + 1e-6)
        H = H * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        rhs = g * free
        L, info = torch.linalg.cholesky_ex(H)
        dx = torch.cholesky_solve(rhs[:, None], L)[:, 0]
        # a failed factorization gives NaN, as the reference's cho_factor
        dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))
        dx = dx * free
        new_states = dict(states)
        for bd in self._dense:
            new_states[bd.name] = self._retract[bd.name](
                states[bd.name], layout.slice_delta(dx, bd.name))
        return new_states, cost, chi2s

    def _residuals_only(self, term: Term, states):
        """Whitened chi2 and robust weight of a term, without Jacobians."""
        r, _, _ = self._eval(term, states, jac=False)
        info = term.info
        if info is not None:
            if info.ndim == 1:
                r = r * torch.sqrt(info)[:, None]
            elif info.ndim == 2:
                r = r * torch.sqrt(info)
            else:
                Lt = _cholesky_nan(info).transpose(-1, -2)
                r = torch.einsum("kij,kj->ki", Lt, r)
        chi2 = (r * r).sum(-1)
        return _robust_weight(term, chi2), chi2

    def cost(self, states):
        dev = self.terms[0].dense_refs[0][1].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        chi2s = {}
        for term in self.terms:
            w, chi2 = self._residuals_only(term, states)
            chi2s[term.name] = chi2
            total = total + (w * chi2).sum()
        return total, chi2s


def optimize(problem: Problem, states, iters: int = 10, lam0: float = 1e-4,
             dense_free_mask=None, early_tol: float = 0.0):
    """LM with accept/reject (lam * 0.5 on accept, * 4 on reject, clipped
    to [1e-8, 1e4]).  With early_tol > 0 the loop stops once an attempted
    step changes the cost by less than early_tol relative.  Returns
    (states, final cost, chi2_by_term).  The early exit reads the cost on
    the host (the kernel path decides it on the device)."""
    cost_prev, _ = problem.cost(states)
    lam = torch.tensor(lam0, dtype=torch.float32, device=cost_prev.device)
    for _ in range(iters):
        new_states, _, _ = problem.solve_step(states, lam, dense_free_mask)
        new_cost, _ = problem.cost(new_states)
        accept = new_cost < cost_prev
        states = {k: torch.where(accept, new_states[k], states[k])
                  for k in states}
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-8, 1e4)
        rel = torch.abs(new_cost - cost_prev) \
            / torch.clamp_min(cost_prev, 1e-20)
        cost_prev = torch.where(accept, new_cost, cost_prev)
        if early_tol > 0.0 and bool(rel < early_tol):
            break
    final_cost, chi2s = problem.cost(states)
    return states, final_cost, chi2s
