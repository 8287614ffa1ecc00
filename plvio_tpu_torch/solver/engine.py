"""The masked Gauss-Newton / Levenberg-Marquardt engine (port of
plvio_tpu/solver/engine.py: `BlockDef`, `DenseLayout`, `Term`,
`LandmarkFamily`, `_whiten` :115, `_chol3` :185, `_tri_inv3` :205,
`chol_invT_blocks` :221, `_cg_solve` :256, `Problem.add_dense/
add_landmarks/add_term/_linearize/build_normal_equations/solve_step/
_residuals_only/cost` :311-621 and `optimize` :624).

Dense state blocks (keyframe poses, velocities, biases) form one dense
system; landmark families (3-DoF points, 6-DoF line endpoints) are
Schur-eliminated with the reference's per-landmark damping floor,
`occupied` gate, `blk_ok` guard and Gram-form fill-in, and the reduced
system is solved by Cholesky or by the reference's fixed-step CG
(`Problem(linear_solver="cg")`).

This is the plain version of the VI pose optimizer's kernel
(csrc/vi_pose_lm.cu) and of the windowed BA's kernels
(csrc/ba_linearize.cu, csrc/schur_solve.cu): every residual is linearized by automatic
differentiation at delta = 0, as the reference does with `jax.jacfwd`.
The port takes `torch.func.vmap(torch.func.jacrev(...))`: the same exact
Jacobian, but PyTorch's forward mode gives a float32 tensor times a
Python float a float64 tangent, which a float32 matmul then refuses
(torch 2.13 on the CPU).  The Huber weight is w = min(1, delta/sqrt(chi2))
on the whitened chi2, recomputed at every evaluation, and the LM cost is
sum(w * chi2).

The normal equations' sums over observations (`accumulate`) are
`index_add_` / `index_put_(accumulate=True)` on the CPU, where they run
in observation order.  On the card those are float atomics, whose order
changes from run to run; there the sums go through `segment_sum`: one
stable sort by destination, then fixed-shape sums of chunks of SEG_CHUNK
rows, level by level, so that every run adds the same numbers in the same
order.
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
    lm_ref: Optional[Tuple[str, torch.Tensor]] = None
    const: Any = None
    mask: Optional[torch.Tensor] = None
    info: Optional[torch.Tensor] = None
    robust_delta: float = 0.0


@dataclass(frozen=True)
class LandmarkFamily:
    name: str
    count: int
    dof: int    # 3 for points, 6 for line endpoints


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


def _chol3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 Cholesky (lower L), the square-root
    arguments floored at 1e-20 as the reference's."""
    eps = 1e-20
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l11 = torch.sqrt(torch.clamp_min(a11, eps))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(torch.clamp_min(a22 - l21 * l21, eps))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp_min(a33 - l31 * l31 - l32 * l32, eps))
    z = torch.zeros_like(l11)
    return torch.stack([torch.stack([l11, z, z], -1),
                        torch.stack([l21, l22, z], -1),
                        torch.stack([l31, l32, l33], -1)], -2)


def _tri_inv3(L: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched lower-triangular 3x3 blocks."""
    l11, l21, l31 = L[..., 0, 0], L[..., 1, 0], L[..., 2, 0]
    l22, l32, l33 = L[..., 1, 1], L[..., 2, 1], L[..., 2, 2]
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i33 = 1.0 / l33
    i21 = -l21 * i11 * i22
    i32 = -l32 * i22 * i33
    i31 = (l21 * l32 - l31 * l22) * i11 * i22 * i33
    z = torch.zeros_like(i11)
    return torch.stack([torch.stack([i11, z, z], -1),
                        torch.stack([i21, i22, z], -1),
                        torch.stack([i31, i32, i33], -1)], -2)


def chol_invT_blocks(A: torch.Tensor) -> torch.Tensor:
    """Batched factor F with F F^T = A^{-1} for damped-SPD 3x3 or 6x6
    blocks: F = chol(A)^{-T}, the 6x6 case by 3x3 blocks."""
    d = A.shape[-1]
    if d == 3:
        return _tri_inv3(_chol3(A)).transpose(-1, -2)
    if d == 6:
        A21 = A[..., 3:, :3]
        L11i = _tri_inv3(_chol3(A[..., :3, :3]))
        L21 = A21 @ L11i.transpose(-1, -2)
        L22i = _tri_inv3(_chol3(A[..., 3:, 3:] - L21 @ L21.transpose(-1, -2)))
        BLi = -L22i @ L21 @ L11i
        z = torch.zeros_like(L11i)
        Li = torch.cat([torch.cat([L11i, z], -1),
                        torch.cat([BLi, L22i], -1)], -2)
        return Li.transpose(-1, -2)
    raise ValueError(f"chol_invT_blocks: blocks are 3x3 or 6x6, not {d}x{d}")


def _cg_solve(H: torch.Tensor, g: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-trip-count conjugate gradients on the reduced system (the
    reference's, with its max(., 1e-20) guards), not run to convergence."""
    x = torch.zeros_like(g)
    r = g
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        Hp = H @ p
        alpha = rs / torch.clamp_min(torch.dot(p, Hp), 1e-20)
        x = x + alpha * p
        r = r - alpha * Hp
        rs_new = torch.dot(r, r)
        beta = rs_new / torch.clamp_min(rs, 1e-20)
        p = r + beta * p
        rs = rs_new
    return x


SEG_CHUNK = 64          # rows summed together at each level of segment_sum


def segment_sum(keys: torch.Tensor, vals: torch.Tensor):
    """Deterministic sums of the rows vals [N,W] by keys [N]: (the distinct
    keys in ascending order [U], their sums [U,W]).  One stable sort, then
    per level each key's rows in chunks of SEG_CHUNK: every chunk is
    written to its own slots of a zero buffer (no two rows share a slot)
    and summed along a fixed axis; the chunks' sums are the next level's
    rows, until each key has one row.  The order of the additions depends
    on the keys alone, not on the scheduling of the card."""
    dev = keys.device
    order = torch.argsort(keys, stable=True)
    k, v = keys[order], vals[order]
    while True:
        uniq, counts = torch.unique_consecutive(k, return_counts=True)
        if k.numel() == uniq.numel():
            return uniq, v
        start = torch.cumsum(counts, 0) - counts
        seg = torch.repeat_interleave(
            torch.arange(uniq.numel(), device=dev), counts)
        pos = torch.arange(k.numel(), device=dev) - start[seg]
        n_chunk = (counts + SEG_CHUNK - 1) // SEG_CHUNK
        chunk = (torch.cumsum(n_chunk, 0) - n_chunk)[seg] + pos // SEG_CHUNK
        buf = torch.zeros(int(n_chunk.sum()), SEG_CHUNK, v.shape[1],
                          dtype=v.dtype, device=dev)
        buf[chunk, pos % SEG_CHUNK] = v
        v = buf.sum(1)
        k = torch.repeat_interleave(uniq, n_chunk)


def accumulate(out: torch.Tensor, indices, values: torch.Tensor,
               sorted_sums: Optional[bool] = None) -> None:
    """out[indices] += values with repeated indices summed, as
    `out.index_put_(indices, values, accumulate=True)` (indices a tuple of
    index tensors over out's leading dimensions, broadcast together; values
    of their shape + out's remaining dimensions).  CPU tensors take
    `index_add_` (one 1-D index) or `index_put_`, which sum in observation
    order; CUDA tensors (or `sorted_sums=True`) sum by `segment_sum` and
    add each distinct destination once."""
    if sorted_sums is None:
        sorted_sums = out.device.type != "cpu"
    if not sorted_sums:
        if len(indices) == 1 and indices[0].ndim == 1:
            out.index_add_(0, indices[0], values)
        else:
            out.index_put_(indices, values, accumulate=True)
        return
    n = len(indices)
    idx = torch.broadcast_tensors(*indices)
    key = torch.zeros(idx[0].shape, dtype=torch.long, device=out.device)
    for d in range(n):
        key = key * out.shape[d] + idx[d].long()
    rest = out.shape[n:]
    width = 1
    for r in rest:
        width *= r
    vals = values.expand(*idx[0].shape, *rest).reshape(-1, width)
    uniq, sums = segment_sum(key.reshape(-1), vals)
    flat = out.view(-1, width)
    flat[uniq] = flat[uniq] + sums


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
    """A nonlinear least-squares problem over dense state blocks and
    Schur-eliminated landmark families.  states: dict name -> tensor
    [count, ...raw shape]; linear_solver "chol" | "cg" for the reduced
    system."""

    def __init__(self, linear_solver: str = "chol"):
        self._dense: List[BlockDef] = []
        self._lm: Dict[str, LandmarkFamily] = {}
        self._retract: Dict[str, Callable] = {}
        self._dofs: Dict[str, int] = {}
        self.terms: List[Term] = []
        self.linear_solver = linear_solver

    def add_dense(self, name: str, count: int, dof: int, retract: Callable):
        self._dense.append(BlockDef(name, count, dof))
        self._retract[name] = retract
        self._dofs[name] = dof

    def add_landmarks(self, name: str, count: int, dof: int,
                      retract: Callable):
        self._lm[name] = LandmarkFamily(name, count, dof)
        self._retract[name] = retract
        self._dofs[name] = dof

    def add_term(self, term: Term):
        self.terms.append(term)

    def _eval(self, term: Term, states, jac: bool):
        refs = list(term.dense_refs) + ([term.lm_ref] if term.lm_ref else [])
        gathered = tuple(states[name][idx] for name, idx in refs)
        dofs = [self._dofs[name] for name, _ in refs]
        K = refs[0][1].shape[0]
        zeros = torch.zeros(K, sum(dofs), dtype=gathered[0].dtype,
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
        """Assemble H [S,S] and g [S] (undamped), and per landmark family
        (Hpp [P,d,d], gp [P,d], B [S, P*d]).  Returns (layout, H, g,
        lm_sys, total_cost, chi2_by_term)."""
        layout = DenseLayout(self._dense)
        S = max(layout.total, 1)
        dev = self.terms[0].dense_refs[0][1].device
        dt = _dtype(states)
        H = torch.zeros(S, S, dtype=dt, device=dev)
        g = torch.zeros(S, dtype=dt, device=dev)
        lm_sys = {name: [
            torch.zeros(f.count, f.dof, f.dof, dtype=dt, device=dev),
            torch.zeros(f.count, f.dof, dtype=dt, device=dev),
            torch.zeros(S, f.count * f.dof, dtype=dt, device=dev)]
            for name, f in self._lm.items()}
        total = torch.zeros((), dtype=dt, device=dev)
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
                                 device=dev)
                accumulate(Hk, (idx_a,), Hab)
                gk = torch.zeros(fam.count, da, dtype=H.dtype, device=dev)
                accumulate(gk, (idx_a,), ga)
                n = fam.count * da
                H[off0:off0 + n, off0:off0 + n] += torch.block_diag(
                    *Hk.unbind(0))
                g[off0:off0 + n] += gk.reshape(n)
            else:
                self._scatter_dense(layout, term, Jparts, w, r, H, g)
            if term.lm_ref is not None:
                self._couple_landmark(layout, term, Jparts, w, r, lm_sys)
        return layout, H, g, lm_sys, total, chi2_by_term

    @staticmethod
    def _scatter_dense(layout, term, Jparts, w, r, H, g):
        """Dense blocks of a multi-reference term, scattered into H, g."""
        dev = H.device
        refs = term.dense_refs
        for a, (name_a, idx_a) in enumerate(refs):
            rows = layout.offset_of(name_a, idx_a)[:, None] \
                + torch.arange(Jparts[a].shape[2], device=dev)[None, :]
            Jaw = Jparts[a] * w[:, None, None]
            accumulate(g, (rows,), -torch.einsum("kdi,kd->ki", Jaw, r))
            for b, (name_b, idx_b) in enumerate(refs):
                cols = layout.offset_of(name_b, idx_b)[:, None] \
                    + torch.arange(Jparts[b].shape[2], device=dev)[None, :]
                Hab = torch.einsum("kdi,kdj->kij", Jaw, Jparts[b])
                accumulate(H, (rows[:, :, None], cols[:, None, :]), Hab)

    def _couple_landmark(self, layout, term, Jparts, w, r, lm_sys):
        """Hpp, gp and the coupling B of a term's landmark reference."""
        lname, lidx = term.lm_ref
        dl = self._lm[lname].dof
        nd = len(term.dense_refs)
        Jl = Jparts[nd]
        Jlw = Jl * w[:, None, None]
        Hpp, gp, B = lm_sys[lname]
        accumulate(Hpp, (lidx,), torch.einsum("kdi,kdj->kij", Jlw, Jl))
        accumulate(gp, (lidx,), -torch.einsum("kdi,kd->ki", Jlw, r))
        dev = B.device
        cols = (lidx[:, None] * dl + torch.arange(dl, device=dev))[:, None, :]
        for a in range(nd):
            name_a, idx_a = term.dense_refs[a]
            da = Jparts[a].shape[2]
            rows = (layout.offset_of(name_a, idx_a)[:, None]
                    + torch.arange(da, device=dev))[:, :, None]
            Hal = torch.einsum("kdi,kdj->kij", Jparts[a] * w[:, None, None],
                               Jl)
            accumulate(B, (rows, cols), Hal)

    def solve_step(self, states, lam: torch.Tensor,
                   dense_free_mask: Optional[Dict[str, torch.Tensor]] = None,
                   lm_free_mask: Optional[Dict[str, torch.Tensor]] = None):
        """One damped step: returns (new_states, cost, chi2_by_term).
        dense_free_mask[name]: [count] bool, False freezes that block;
        lm_free_mask likewise for landmarks."""
        layout, H, g, lm_sys, cost, chi2s = self.build_normal_equations(
            states)
        new_states = self.step_from_system(layout, H, g, lm_sys, states, lam,
                                           dense_free_mask, lm_free_mask)
        return new_states, cost, chi2s

    def step_from_system(self, layout, H, g, lm_sys, states, lam,
                         dense_free_mask=None, lm_free_mask=None):
        """The damped step from an assembled system (`solve_step` after
        `build_normal_equations`): damping, Schur reduction, the reduced
        solve, back-substitution and retraction.  Returns new_states."""
        H, rhs, schur, free = self.reduce_system(layout, H, g, lm_sys, lam,
                                                 dense_free_mask,
                                                 lm_free_mask)
        dx = self.solve_reduced(H, rhs, free)
        return self.back_substitute(layout, states, dx, schur)

    def reduce_system(self, layout, H, g, lm_sys, lam, dense_free_mask=None,
                      lm_free_mask=None):
        """Damping, the Schur reduction of every landmark family and the
        freeze of the fixed rows: (H, rhs, schur, free).  On a mesh this
        is one shard's partial (reference engine.py:467-538)."""
        S = H.shape[0]
        free = torch.ones(S, dtype=H.dtype, device=H.device)
        if dense_free_mask:
            for name, m in dense_free_mask.items():
                b = layout.blocks[name]
                off = layout.offsets[name]
                free[off:off + b.count * b.dof] = torch.repeat_interleave(
                    m.to(H.dtype), b.dof)
        H = H + torch.diag(torch.diagonal(H) * lam + 1e-6)
        rhs = g
        schur = {}
        for name, (Hpp, gp, B) in lm_sys.items():
            H, rhs, schur[name] = self._schur_reduce(
                name, Hpp, gp, B, H, rhs, lam,
                None if not lm_free_mask else lm_free_mask.get(name))
        # freeze fixed dense blocks after the reduction, so that the
        # fill-in does not couple them back into the solve
        H = H * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        rhs = rhs * free
        return H, rhs, schur, free

    def solve_reduced(self, H, rhs, free):
        """The reduced solve (CG or Cholesky), dx times the free mask."""
        S = H.shape[0]
        if self.linear_solver == "cg":
            dx = _cg_solve(H, rhs, iters=min(max(S // 2, 16), 128))
        else:
            L, info = torch.linalg.cholesky_ex(H)
            dx = torch.cholesky_solve(rhs[:, None], L)[:, 0]
            # a failed factorization gives NaN, as the reference's
            # cho_factor
            dx = torch.where(info == 0, dx,
                             torch.full_like(dx, float("nan")))
        return dx * free

    def back_substitute(self, layout, states, dx, schur):
        """The landmarks' back-substitution and every block's retraction
        by the reduced step dx: new_states."""
        new_states = dict(states)
        for name, (Dinv, B3, gp, occupied) in schur.items():
            rhs_p = gp - torch.einsum("spi,s->pi", B3, dx)
            dxp = torch.einsum("pij,pj->pi", Dinv, rhs_p)
            dxp = dxp * occupied[:, None].to(dxp.dtype)
            new_states[name] = self._retract[name](states[name], dxp)
        for bd in self._dense:
            new_states[bd.name] = self._retract[bd.name](
                states[bd.name], layout.slice_delta(dx, bd.name))
        return new_states

    def _schur_reduce(self, name, Hpp, gp, B, H, rhs, lam, lfree):
        """Eliminate one landmark family from (H, rhs).  Returns (H, rhs,
        (Dinv, B3, gp, occupied)) for the back-substitution."""
        fam = self._lm[name]
        dl = fam.dof
        S = H.shape[0]
        if lfree is not None:
            lf = lfree.to(H.dtype)
            Hpp = Hpp * lf[:, None, None]
            gp = gp * lf[:, None]
        dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        # per-landmark damping floor at 1e-4 of the block's own diagonal
        # scale: landmark null directions (a line endpoint sliding along
        # its line, a low-parallax point's depth) keep a bounded factor
        floor = 1e-4 * dpp.mean(-1, keepdim=True)
        Hpp_d = Hpp + torch.diag_embed(dpp * lam + floor + 1e-6)
        occupied = dpp.sum(-1) > 1e-9
        if lfree is not None:
            occupied = occupied & lfree
        eye = torch.eye(dl, dtype=H.dtype, device=H.device)
        Hpp_d = torch.where(occupied[:, None, None], Hpp_d, eye)
        # Gram-form fill-in: F F^T = Hpp_d^{-1}, G = B F, H -= G G^T
        Ffac = chol_invT_blocks(Hpp_d)
        # a block that slips past the occupied gate with a huge or
        # non-finite factor is held fixed for this iteration
        blk_ok = torch.isfinite(Ffac).all(-1).all(-1) \
            & (Ffac.abs().amax((-2, -1)) < 1e3)
        occupied = occupied & blk_ok
        Ffac = torch.where(occupied[:, None, None], Ffac,
                           torch.zeros_like(Ffac))
        Dinv = torch.einsum("pij,pkj->pik", Ffac, Ffac)
        B3 = B.reshape(S, fam.count, dl)
        if lfree is not None:
            B3 = B3 * lfree.to(H.dtype)[None, :, None]
        G = torch.einsum("spi,pij->spj", B3, Ffac)
        Gm = G.reshape(S, fam.count * dl)
        H = H - Gm @ Gm.T
        rhs = rhs - torch.einsum("spj,pj->s", G,
                                 torch.einsum("pij,pi->pj", Ffac, gp))
        return H, rhs, (Dinv, B3, gp, occupied)

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
        total = torch.zeros((), dtype=_dtype(states), device=dev)
        chi2s = {}
        for term in self.terms:
            w, chi2 = self._residuals_only(term, states)
            chi2s[term.name] = chi2
            total = total + (w * chi2).sum()
        return total, chi2s


def _dtype(states) -> torch.dtype:
    """The floating dtype the states (and so the whole solve) carry."""
    return next(iter(states.values())).dtype


def optimize(problem: Problem, states, iters: int = 10, lam0: float = 1e-4,
             dense_free_mask=None, lm_free_mask=None,
             early_tol: float = 0.0, stats: Optional[list] = None):
    """LM with accept/reject (lam * 0.5 on accept, * 4 on reject, clipped
    to [1e-8, 1e4]).  With early_tol > 0 the loop stops once an attempted
    step changes the cost by less than early_tol relative.  Returns
    (states, final cost, chi2_by_term).  The early exit reads the cost on
    the host (the kernel path decides it on the device).  `stats`, if
    given, gets the number of iterations run appended.  The one-shard case
    of `optimize_sharded`."""
    st, cost, chi2s = optimize_sharded(
        None, [problem], [states], iters, lam0,
        None if dense_free_mask is None else [dense_free_mask],
        None if lm_free_mask is None else [lm_free_mask], early_tol, stats)
    return st[0], cost, chi2s[0]


def _psum(mesh, parts):
    """The mesh's sum of the local shards' partials (mesh None: one shard,
    its partial as it is)."""
    return parts[0] if mesh is None else mesh.psum(parts)


def _replicate(mesh, x):
    """x on every local shard's device (mesh None: one shard)."""
    return [x] if mesh is None else mesh.replicate(x)


def solve_step_sharded(mesh, problems, states, lam, dense_free_mask=None,
                       lm_free_mask=None):
    """One damped step of a problem on `mesh` (the reference's
    `psum_axis`), from the local shards' partial problems `problems` (the
    dense states replicated, each shard its own landmark families and
    their observations) and their states: each shard builds and reduces
    its own partial system (damped by its own diagonal, its landmarks
    eliminated, its fixed rows frozen: the reduced system sums D x 1e-6
    and a D diagonal on the fixed rows, as the reference's psum does),
    the mesh sums the reduced systems, the first shard's device solves
    the sum once (every JAX device solves the same sum), and each shard
    back-substitutes its own landmarks with the same step.  mesh None is
    one problem on one device (`Problem.solve_step`'s operations).
    Returns the new states, one dict a local shard."""
    parts = []
    for i, prob in enumerate(problems):
        layout, H, g, lm_sys, _, _ = prob.build_normal_equations(states[i])
        parts.append((layout,) + prob.reduce_system(
            layout, H, g, lm_sys, lam[i],
            None if dense_free_mask is None else dense_free_mask[i],
            None if lm_free_mask is None else lm_free_mask[i]))
    H = _psum(mesh, [p[1] for p in parts])
    rhs = _psum(mesh, [p[2] for p in parts])
    dx = problems[0].solve_reduced(H, rhs, parts[0][4].to(H.device))
    dxs = _replicate(mesh, dx)
    return [prob.back_substitute(parts[i][0], states[i], dxs[i], parts[i][3])
            for i, prob in enumerate(problems)]


def cost_sharded(mesh, problems, states):
    """(the mesh's summed cost, replicated on every local shard's device;
    each shard's chi2 by term)."""
    costs, chi2s = zip(*[p.cost(st) for p, st in zip(problems, states)])
    return _replicate(mesh, _psum(mesh, list(costs))), list(chi2s)


def optimize_sharded(mesh, problems, states, iters: int = 10,
                     lam0: float = 1e-4, dense_free_mask=None,
                     lm_free_mask=None, early_tol: float = 0.0,
                     stats: Optional[list] = None):
    """`optimize` over `mesh`: problems, states, dense_free_mask and
    lm_free_mask are lists over the local shards, every LM decision reads
    the mesh's summed cost, so every shard takes the same one.  Returns
    (states, final cost, chi2_by_term), the first and last one entry a
    local shard."""
    states = list(states)
    cost_prev, _ = cost_sharded(mesh, problems, states)
    lam = [torch.tensor(lam0, dtype=c.dtype, device=c.device)
           for c in cost_prev]
    it = 0
    for it in range(1, iters + 1):
        new_states = solve_step_sharded(mesh, problems, states, lam,
                                        dense_free_mask, lm_free_mask)
        new_cost, _ = cost_sharded(mesh, problems, new_states)
        for i in range(len(problems)):
            accept = new_cost[i] < cost_prev[i]
            states[i] = {k: torch.where(accept, new_states[i][k],
                                        states[i][k]) for k in states[i]}
            lam[i] = torch.clamp(torch.where(accept, lam[i] * 0.5,
                                             lam[i] * 4.0), 1e-8, 1e4)
            rel = torch.abs(new_cost[i] - cost_prev[i]) \
                / torch.clamp_min(cost_prev[i], 1e-20)
            cost_prev[i] = torch.where(accept, new_cost[i], cost_prev[i])
        if early_tol > 0.0 and bool(rel < early_tol):
            break
    if stats is not None:
        stats.append(it)
    final_cost, chi2s = cost_sharded(mesh, problems, states)
    return states, final_cost[0], chi2s
