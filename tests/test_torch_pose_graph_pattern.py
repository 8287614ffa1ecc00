"""The host fill pattern of the essential graph's block Cholesky
(models/kernels.py `pg_pattern`, the schedule csrc/pose_graph.cu walks)
against torch.linalg.cholesky in float64, on the CPU.

Each graph is the normal matrix of `pose_graph_plain`'s engine (Sim(3)
edges measured from random states with noise, damped and frozen as the
engine does) over chain graphs drawn from a numpy seed: covisibility bands,
past-loop arrows, fixed keyframes (in the middle too, which splits the
elimination tree into independent subtrees), a dense graph, and the loop
closer's own graph over the 61-keyframe chain of `inputs.build_big_chain`.
Rules, exact: every 7x7 block of the float64 factor outside the pattern is
zero, and every block inside it is not (in the keyframes' order and in the
kernel's level order); the schedule lists each update L_ij -= L_ik L_jk^T
that the factorization needs once, at the level of its column k, and the
kernel's walk of it (emulated in numpy) solves the system to 1e-10
relative.
"""
import numpy as np
import pytest
import torch

from plvio_tpu_torch.models import kernels as KN
from plvio_tpu_torch.solver import engine as E
from plvio_tpu_torch.solver import residuals as RES
from plvio_tpu_torch.utils import lie


def _graph(n, pairs, fixed, seed):
    """States, free mask and edges measured from the states with noise."""
    r = np.random.default_rng(seed)
    st = np.zeros((n, 13))
    for i in range(n):
        R = lie.so3_exp(torch.tensor(r.normal(0, .5, 3))).numpy()
        st[i] = np.concatenate([R.reshape(-1), r.normal(0, 1, 3),
                                [np.exp(r.normal(0, .05))]])
    Rs, ts, ss = [], [], []
    for i, j in pairs:
        Si = [torch.tensor(st[i, :9]).view(3, 3), torch.tensor(st[i, 9:12]),
              torch.tensor(st[i, 12])]
        Sj = [torch.tensor(st[j, :9]).view(3, 3), torch.tensor(st[j, 9:12]),
              torch.tensor(st[j, 12])]
        Rm, tm, sm = lie.sim3_mul(*Sj, *lie.sim3_inv(*Si))
        dR = lie.so3_exp(torch.tensor(r.normal(0, .03, 3))).double()
        Rs.append((dR @ Rm).numpy())
        ts.append(tm.numpy() + r.normal(0, .05, 3))
        ss.append(float(sm) * np.exp(r.normal(0, .02)))
    free = np.ones(n, bool)
    free[list(fixed)] = False
    ei = np.array([p[0] for p in pairs], np.int64)
    ej = np.array([p[1] for p in pairs], np.int64)
    return st, free, ei, ej, np.stack(Rs), np.stack(ts), np.array(ss), \
        r.uniform(0.3, 1, len(pairs))


def _case(name):
    r = np.random.default_rng(len(name))
    if name == "closer_chain":
        return _closer_graph()
    if name == "dense":
        n = 12
        pairs = [(i, j) for i in range(n) for j in range(i)]
        return _graph(n, pairs, [0], 3)
    n = {"band": 30, "arrows": 40, "fixed_middle": 36}[name]
    pairs = [(i, i - 1) for i in range(1, n)]
    pairs += [(i, i - 2) for i in range(2, n) if r.random() < 0.6]
    pairs += [(n - 1, 0)]                  # the loop edge, to the fixed cand
    fixed = [0]
    if name == "arrows":                   # three past loops
        pairs += [(int(a), int(b)) for a, b in ((35, 4), (22, 9), (39, 17))]
    if name == "fixed_middle":
        fixed += [12, 25]
    return _graph(n, pairs, fixed, 5)


def _closer_graph():
    """The loop closer's essential graph over `build_big_chain(60)` (61
    keyframes, the last revisiting the first), as `_essential_graph` hands
    it to the optimizer."""
    from plvio_tpu_torch.config import CameraConfig, SystemConfig
    from plvio_tpu_torch.inputs import build_big_chain
    from plvio_tpu_torch.models.loop_closing import LoopCloser
    from plvio_tpu_torch.models.mapstore import Atlas
    m, kfs, gt = build_big_chain(n_kf=60)
    lc = LoopCloser(SystemConfig(camera=CameraConfig(dist=(0.0,) * 4),
                                 use_lines=False), Atlas(maps=[m], active=0),
                    None, m.n_feat, device="cpu")
    got = {}

    def rec(*a, n_active=None):
        got["a"], got["n"] = a, n_active
        return a[0]
    lc.pose_graph = rec
    chain = m.kf_chain()
    pre = {int(k): (m.kf_pose_cw[k, :, :3].astype(np.float64),
                    m.kf_pose_cw[k, :, 3].astype(np.float64)) for k in chain}
    kf, cand = int(kfs[-1]), int(kfs[0])
    R_w = gt[-1][0].T @ pre[kf][0]
    t_w = gt[-1][0].T @ (pre[kf][1] - gt[-1][1])
    lc._essential_graph(kf, cand, 1.0, R_w, t_w, pre, {kf})
    a, n = got["a"], got["n"]
    ok = a[7].numpy()
    return (a[0][:n].double().numpy(), a[1][:n].numpy(), a[2].numpy()[ok],
            a[3].numpy()[ok], a[4].double().numpy()[ok],
            a[5].double().numpy()[ok], a[6].double().numpy()[ok],
            a[8].double().numpy()[ok])


def _normal_matrix(g, lam=1e-4):
    """The damped, frozen normal matrix and right-hand side of
    `pose_graph_plain`'s engine at the graph's states, float64."""
    st, free, ei, ej, R, t, s, info = g
    T = torch.from_numpy
    prob = E.Problem()
    prob.add_dense("sim3", len(st), 7, RES.retract_sim3)
    prob.add_term(E.Term(
        name="sim3", res_fn=RES.sim3_edge, rdim=7,
        dense_refs=[("sim3", T(ei)), ("sim3", T(ej))],
        const={"Rji": T(R), "tji": T(t), "sji": T(s)},
        mask=torch.ones(len(ei), dtype=torch.bool), info=T(info)))
    layout, H, gv, lm, _, _ = prob.build_normal_equations({"sim3": T(st)})
    H, rhs, _, _ = prob.reduce_system(layout, H, gv, lm,
                                      torch.tensor(lam, dtype=H.dtype),
                                      {"sim3": T(free)})
    return H.numpy(), rhs.numpy()


CASES = ["band", "arrows", "fixed_middle", "dense", "closer_chain"]


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name in CASES:
        g = _case(name)
        n = len(g[0])
        H, rhs = _normal_matrix(g)
        out[name] = (g, n, H, rhs, KN.pg_pattern(g[2], g[3], g[1], n))
    return out


def _blocks_nonzero(L, n):
    return np.abs(L.reshape(n, 7, n, 7)).sum((1, 3)) != 0


@pytest.mark.parametrize("name", CASES)
def test_pattern_holds_the_factor(cases, name):
    _, n, H, _, pat = cases[name]
    perm = pat["col_kf"].astype(np.int64)
    # the pattern in the kernel's order and in the keyframes' order
    want_k = np.eye(n, dtype=bool)
    for k, rows in enumerate(pat["struct"]):
        want_k[rows, k] = True
    want = np.zeros((n, n), bool)
    want[np.ix_(perm, perm)] = want_k
    want = want | want.T
    for order, mask in ((np.arange(n), want), (perm, want_k | want_k.T)):
        idx = (7 * order[:, None] + np.arange(7)).reshape(-1)
        L = torch.linalg.cholesky(torch.from_numpy(H[np.ix_(idx, idx)]))
        nz = _blocks_nonzero(L.numpy(), n)
        low = np.tri(n, dtype=bool)
        assert not (nz & ~mask & low).any(), "a nonzero block outside"
        assert (nz | ~mask | ~low).all(), "a pattern block that is zero"
    # the level order is a topological order of the elimination tree
    lvl = pat["level"]
    par = pat["parent"]
    kc = pat["kf_col"]
    for j in range(n):
        if par[j] >= 0:
            assert lvl[kc[par[j]]] > lvl[kc[j]] and par[j] > j
    if name == "fixed_middle":
        assert (np.diff(pat["lvl_col"]) > 1).any()   # columns side by side
    if name == "closer_chain":
        assert (np.diff(pat["lvl_col"]) <= 2).all() and pat["nb"] <= 4 * n


@pytest.mark.parametrize("name", CASES)
def test_schedule_lists_each_update_once(cases, name):
    g, n, _, _, pat = cases[name]
    colptr, rowidx, bcol = pat["colptr"], pat["rowidx"], pat["bcol"]
    blk = {(int(rowidx[b]), int(bcol[b])): b for b in range(pat["nb"])}
    need = []
    for k in range(n):
        below = list(range(colptr[k] + 1, colptr[k + 1]))
        assert rowidx[colptr[k]] == k and rowidx[below[-1]] == n
        for x in below:
            for y in below:
                if rowidx[x] >= rowidx[y] and rowidx[y] != n:
                    need.append((blk[(int(rowidx[x]), int(rowidx[y]))], k,
                                 x, y))
    level_of_col = np.searchsorted(pat["lvl_col"], np.arange(n), "right") - 1
    got = []
    for lv in range(len(pat["lvl_col"]) - 1):
        for t in range(pat["lvl_tgt"][lv], pat["lvl_tgt"][lv + 1]):
            cols = []
            for s in range(pat["tgt_ptr"][t], pat["tgt_ptr"][t + 1]):
                x, y = (int(v) for v in pat["src"][s])
                k = int(bcol[x])
                assert bcol[y] == k and level_of_col[k] == lv
                cols.append(k)
                got.append((int(pat["tgt"][t]), k, x, y))
            # a target is final only at its own, later level; the next
            # level's targets come first (the kernel applies the rest
            # while it factors the next level)
            tl = level_of_col[bcol[pat["tgt"][t]]]
            assert tl == lv + 1 if t < pat["lvl_mid"][lv] else tl > lv + 1
            assert cols == sorted(cols)
    assert sorted(got) == sorted(need) and len(set(got)) == len(got)
    assert pat["n_updates"] == len(need)


def _kernel_walk(pat, H, rhs, n):
    """csrc/pose_graph.cu's factorization and solves on the pattern, in
    numpy: levels up with the border row, then levels down."""
    colptr, rowidx, bcol = pat["colptr"], pat["rowidx"], pat["bcol"]
    ck = pat["col_kf"]
    L = np.zeros((pat["nb"], 7, 7))
    for b in range(pat["nb"]):
        c, r = bcol[b], rowidx[b]
        if r == n:
            L[b, 0] = rhs[7 * ck[c]:7 * ck[c] + 7]
        else:
            L[b] = H[7 * ck[r]:7 * ck[r] + 7, 7 * ck[c]:7 * ck[c] + 7]
    lvl_col = pat["lvl_col"]
    for lv in range(len(lvl_col) - 1):
        for c in range(lvl_col[lv], lvl_col[lv + 1]):
            d = colptr[c]
            Di = np.linalg.inv(np.linalg.cholesky(np.tril(L[d])
                                                  + np.tril(L[d], -1).T))
            L[d] = Di
            L[d + 1:colptr[c + 1]] = L[d + 1:colptr[c + 1]] @ Di.T
        for t in range(pat["lvl_tgt"][lv], pat["lvl_tgt"][lv + 1]):
            for s in range(pat["tgt_ptr"][t], pat["tgt_ptr"][t + 1]):
                x, y = pat["src"][s]
                L[pat["tgt"][t]] -= L[x] @ L[y].T
    xs = np.zeros(7 * n)
    for lv in range(len(lvl_col) - 2, -1, -1):
        for c in range(lvl_col[lv], lvl_col[lv + 1]):
            bs, be = colptr[c], colptr[c + 1]
            r = L[be - 1, 0].copy()
            for b in range(bs + 1, be - 1):
                r -= L[b].T @ xs[7 * rowidx[b]:7 * rowidx[b] + 7]
            xs[7 * c:7 * c + 7] = L[bs].T @ r
    return xs.reshape(n, 7)[pat["kf_col"]].reshape(-1)


@pytest.mark.parametrize("name", CASES)
def test_kernel_walk_solves(cases, name):
    g, n, H, rhs, pat = cases[name]
    x = _kernel_walk(pat, H, rhs, n)
    ref = np.linalg.solve(H, rhs)
    assert np.abs(x - ref).max() <= 1e-10 * max(np.abs(ref).max(), 1e-12)
    # the fixed keyframes do not move
    assert (x.reshape(n, 7)[~g[1]] == 0).all()


@pytest.mark.parametrize("name", CASES)
def test_grid_phases_touch_disjoint_blocks(cases, name):
    """The kernel's grid path (2) runs each level in two phases between
    grid barriers, its work spread over every block: (1) the level's
    columns (diagonal blocks read, blocks below read and written) beside
    the previous level's remaining updates, (2) the inverses written over
    the level's diagonal blocks beside its updates to the next level's
    columns.  No block written in a phase is read or written by other
    work of the same phase, and no update reads its own target."""
    _, n, _, _, pat = cases[name]
    colptr, lvl_col = pat["colptr"], pat["lvl_col"]
    tgt, tgt_ptr, src = pat["tgt"], pat["tgt_ptr"], pat["src"]

    def updates(t0, t1):
        w = [int(tgt[t]) for t in range(t0, t1)]
        r = {int(b) for t in range(t0, t1)
             for s in range(tgt_ptr[t], tgt_ptr[t + 1]) for b in src[s]}
        assert len(set(w)) == len(w) and not set(w) & r
        return set(w), r
    for lv in range(len(lvl_col) - 1):
        cols = range(lvl_col[lv], lvl_col[lv + 1])
        diag = {int(colptr[c]) for c in cols}
        below = {b for c in cols for b in range(colptr[c] + 1, colptr[c + 1])}
        if lv > 0:
            w, r = updates(pat["lvl_mid"][lv - 1], pat["lvl_tgt"][lv])
            assert not below & (w | r) and not w & diag
        w, r = updates(pat["lvl_tgt"][lv], pat["lvl_mid"][lv])
        assert not diag & (w | r)


@pytest.mark.parametrize("graph,want", [
    ("random 17+20", 0), ("band 512", 1), ("revisit 512/50", 2),
    ("random 200+400", 2)])
def test_pg_path_rule(graph, want):
    """`KN.pg_path`: the factor resident in shared memory where it fits
    (the circle's size), one block streaming it for a band (the closer's
    chains), the whole grid where long-range edges fill it (a revisited
    map, random edges over 200 keyframes)."""
    from plvio_tpu_torch.kernel_digest import random_graph, revisit_graph
    if graph == "band 512":
        g = revisit_graph(512, 0, 5)
    elif graph.startswith("revisit"):
        g = revisit_graph(512, 50, 5)
    else:
        n, x = (int(v) for v in graph.split()[1].split("+"))
        g = random_graph(n, x, n)
    pat = KN.pg_pattern(g[2], g[3], g[1], len(g[0]))
    assert KN.pg_path(pat) == want
