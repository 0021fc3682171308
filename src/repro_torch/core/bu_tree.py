"""BU-Tree construction (paper Algorithms 2 & 3).

The BU-Tree is the *mirror model*: a bottom-up tree whose node layout is found
by greedy piecewise-linear merging under the paper's cache-aware cost model
(Eq. 2/5/6/7).  DILI later copies the per-level node counts of this tree
(build.py) but re-divides ranges equally so internal models become exact.

Everything here is host-side numpy: bulk loading is a one-time offline stage
(exactly as in the paper, where construction takes minutes); the *search* path
is the device-side JAX/Pallas code in search.py / kernels/.

Incremental-statistics implementation notes
-------------------------------------------
Each piece I_i^k keeps sufficient statistics (n, Sx, Sy, Sxx, Sxy, Syy) so the
least-squares loss gamma(I) of a piece and of a tentative merge I_i U I_{i+1}
is O(1).  A lazy heap holds merge candidates d_i = m_i - s_i - s_{i+1}
(Alg. 3 line 9).  The estimated accumulated search cost T_ea (Eq. 7) is
maintained incrementally: only the merged piece's contribution changes per
iteration, so evaluating epsilon_k for every k costs O(piece) per merge,
O(n log n) in total -- matching the paper's complexity claim.

For internal levels the paper sums t_E over *all* N underlying keys; we weight
each boundary point by the number of underlying keys it covers (`weights`),
which computes the same sum exactly when per-piece errors are evaluated at the
boundary points (documented approximation in DESIGN.md section 7).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# Cost-model constants (paper section 7.1).  Units: CPU cycles in the paper; on
# TPU we keep the *ratios* (they shape the layout) and expose them as knobs.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CostModel:
    theta_n: float = 130.0   # load a node (one cache line / one HBM gather)
    theta_c: float = 130.0   # fetch child pointer
    theta_e: float = 130.0   # access a pair during local search
    eta_lin: float = 25.0    # execute a linear function
    mu_l: float = 5.0        # misc ops, linear search
    mu_e: float = 17.0       # misc ops, exponential search iteration
    rho: float = 0.2         # decay of higher levels' impact on leaf layout (Eq. 5)
    omega: int = 4096        # max average fanout (Alg. 3); paper uses 2048-4096

    def t_exp_search(self, log2_err: np.ndarray) -> np.ndarray:
        """t_E: exponential-search cost given log2 of prediction error (Eq. 2)."""
        return 2.0 * log2_err * (self.mu_e + self.theta_e)


DEFAULT_COST = CostModel()


# ---------------------------------------------------------------------------
# Sufficient statistics for least squares on (x, y) with integer y = index.
# ---------------------------------------------------------------------------


@dataclass
class SegStats:
    n: float = 0.0
    sx: float = 0.0
    sy: float = 0.0
    sxx: float = 0.0
    sxy: float = 0.0
    syy: float = 0.0

    @staticmethod
    def of(x: np.ndarray, y: np.ndarray, w: np.ndarray | None = None) -> "SegStats":
        if w is None:
            w = np.ones_like(x)
        return SegStats(
            n=float(w.sum()),
            sx=float((w * x).sum()),
            sy=float((w * y).sum()),
            sxx=float((w * x * x).sum()),
            sxy=float((w * x * y).sum()),
            syy=float((w * y * y).sum()),
        )

    def merge(self, o: "SegStats") -> "SegStats":
        return SegStats(self.n + o.n, self.sx + o.sx, self.sy + o.sy,
                        self.sxx + o.sxx, self.sxy + o.sxy, self.syy + o.syy)

    def fit(self) -> tuple[float, float]:
        """Return (a, b) minimizing sum w*(y - (a + b x))^2."""
        if self.n <= 1:
            return (self.sy / max(self.n, 1.0), 0.0)
        den = self.n * self.sxx - self.sx * self.sx
        if den <= 0 or not math.isfinite(den):
            return (self.sy / self.n, 0.0)
        b = (self.n * self.sxy - self.sx * self.sy) / den
        a = (self.sy - b * self.sx) / self.n
        return (a, b)

    def sse(self) -> float:
        """Sum of squared errors of the least-squares fit (O(1))."""
        a, b = self.fit()
        # sum (y - a - b x)^2 expanded over sufficient statistics
        v = (self.syy + self.n * a * a + b * b * self.sxx
             - 2 * a * self.sy - 2 * b * self.sxy + 2 * a * b * self.sx)
        return max(v, 0.0)

    def rmse(self) -> float:
        return math.sqrt(self.sse() / max(self.n, 1.0))


def least_squares(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """LEASTSQUARES(X, Y) -> (a, b) with y ~ a + b*x (paper Definition 2).

    Centered computation: `n*Sxx - Sx^2` cancels catastrophically for tightly
    clustered keys (e.g. two keys 1e-9 apart), which would return b=0 and make
    conflict leaves unable to separate their keys.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(x) == 0:
        return (0.0, 0.0)
    mx = float(x.mean())
    my = float(y.mean())
    dx = x - mx
    den = float((dx * dx).sum())
    if den <= 0.0 or not math.isfinite(den):
        return (my, 0.0)
    b = float((dx * (y - my)).sum()) / den
    return (my - b * mx, b)


# ---------------------------------------------------------------------------
# BU nodes
# ---------------------------------------------------------------------------


@dataclass
class BUNode:
    lb: float
    ub: float
    a: float
    b: float
    height: int
    # internal: children + boundary array B (paper section 4.1)
    children: list["BUNode"] = field(default_factory=list)
    boundaries: np.ndarray | None = None
    # leaf: the slice [lo, hi) of the global sorted pair array it covers
    lo: int = 0
    hi: int = 0

    @property
    def fanout(self) -> int:
        return len(self.children)

    @property
    def is_leaf(self) -> bool:
        return not self.children


@dataclass
class BUTree:
    root: BUNode
    levels: list[list[BUNode]]          # levels[0] = leaves ... levels[-1] = [root]
    keys: np.ndarray                    # the full sorted key array

    @property
    def height(self) -> int:
        return len(self.levels)


# ---------------------------------------------------------------------------
# Greedy merging (Algorithm 3)
# ---------------------------------------------------------------------------


def _piece_cost(stats: SegStats, xs: np.ndarray, ys: np.ndarray,
                ws: np.ndarray, cm: CostModel) -> float:
    """Sum over keys in the piece of t_E-style local-search cost (weighted).

    t_E ~ 2*log2(eps) * (mu_E + theta_E); eps clamped to >= 1 so a perfect
    model contributes 0.
    """
    a, b = stats.fit()
    err = np.abs(a + b * xs - ys)
    log2e = np.log2(np.maximum(err, 1.0))
    return float((ws * cm.t_exp_search(log2e)).sum())


def greedy_merging(
    x: np.ndarray,
    weights: np.ndarray | None,
    n_total_keys: int,
    cm: CostModel = DEFAULT_COST,
    sample_stride: int = 1,
) -> tuple[int, np.ndarray, list[tuple[int, int, float, float]]]:
    """Algorithm 3: find the best piece count n_h and break points X_h.

    Parameters
    ----------
    x: sorted inputs at this level (all keys for h=0, node lower bounds above).
    weights: #underlying keys per element (None -> 1 each).
    n_total_keys: N, for averaging the accumulated cost.
    sample_stride: appendix A.7 sampling -- evaluate piece costs on every
        `sample_stride`-th element of large pieces.

    Returns (n_h, break_points, pieces) where pieces is a list of
    (lo, hi, a, b) covering [lo, hi) of `x` with the fitted model.
    """
    n = len(x)
    if n <= 2:
        a, b = least_squares(x, np.arange(n, dtype=np.float64))
        return 1, np.array([x[0]]), [(0, n, a, b)]
    x = np.asarray(x, np.float64)
    y = np.arange(n, dtype=np.float64)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)

    # --- initial pieces of 2 (last may take 3) -----------------------------
    k0 = n // 2
    starts = list(range(0, 2 * k0, 2))
    ends = [s + 2 for s in starts]
    ends[-1] = n
    pieces: list[list[int]] = [[s, e] for s, e in zip(starts, ends)]

    def seg(i: int) -> SegStats:
        s, e = pieces[i]
        sl = slice(s, e, sample_stride if (e - s) > 8 else 1)
        return SegStats.of(x[sl], y[sl], w[sl])

    stats = [seg(i) for i in range(len(pieces))]
    # s_i = loss of piece i (Alg.3 line 5); local-search cost contribution c_i
    s_loss = [st.sse() for st in stats]

    def contrib(i: int) -> float:
        s, e = pieces[i]
        sl = slice(s, e, sample_stride if (e - s) > 8 else 1)
        sub = w[sl].sum()
        c = _piece_cost(stats[i], x[sl], y[sl], w[sl], cm)
        # rescale sampled cost to the full piece weight
        full = w[s:e].sum()
        return c * (full / max(sub, 1e-12))

    c_contrib = [contrib(i) for i in range(len(pieces))]
    total_te = float(sum(c_contrib))

    # merge candidate heap: (delta_loss, version, left_index)
    alive = [True] * len(pieces)
    right = {i: i + 1 for i in range(len(pieces) - 1)}   # neighbor links
    left = {i + 1: i for i in range(len(pieces) - 1)}
    version = [0] * len(pieces)

    heap: list[tuple[float, int, int]] = []

    max_piece = 2 * cm.omega

    def push(i: int) -> None:
        j = right.get(i)
        if j is None:
            return
        si, sj = pieces[i], pieces[j]
        if (sj[1] - si[0]) > max_piece:      # cap piece size (Alg.3 remark)
            return
        m = stats[i].merge(stats[j]).sse()
        d = m - s_loss[i] - s_loss[j]
        heapq.heappush(heap, (d, version[i], i))

    for i in range(len(pieces)):
        push(i)

    k = len(pieces)
    k_min = max(1, int(math.ceil(n / cm.omega)))

    theta = cm.theta_n + cm.eta_lin   # per-level constant of T_ns (Eq. 5)

    def eval_eps(k_now: int) -> float:
        """T_ea(B_k, X) (Eq. 7) with the same-fanout assumption."""
        if k_now <= 1:
            depth = 1.0
        else:
            ratio = n / k_now           # avg fanout below this level
            if ratio <= 1.0 + 1e-9:
                depth = 1.0
            else:
                depth = math.log(n, ratio) if n > 1 else 1.0
        depth = max(depth, 1.0)
        # sum_{h'=0..ceil(depth)} min(1, depth+1-h') * (theta + rho^h' * tE_avg)
        te_avg = total_te / max(n_total_keys, 1)
        acc = 0.0
        hmax = int(math.ceil(depth))
        for hp in range(0, hmax + 1):
            f = min(1.0, depth + 1.0 - hp)
            acc += f * (theta + (cm.rho ** hp) * te_avg)
        return acc

    best = (eval_eps(k), k)
    snapshots: dict[int, float] = {k: best[0]}

    while k > k_min and heap:
        d, ver, i = heapq.heappop(heap)
        if not alive[i] or version[i] != ver or right.get(i) is None:
            continue
        j = right[i]
        if not alive[j]:
            continue
        # ---- merge j into i -------------------------------------------------
        total_te -= c_contrib[i] + c_contrib[j]
        pieces[i] = [pieces[i][0], pieces[j][1]]
        stats[i] = seg(i)
        s_loss[i] = stats[i].sse()
        c_contrib[i] = contrib(i)
        total_te += c_contrib[i]
        alive[j] = False
        version[i] += 1
        rj = right.pop(j, None)
        if rj is not None:
            right[i] = rj
            left[rj] = i
        else:
            right.pop(i, None)
        li = left.get(i)
        if li is not None:
            version[li] += 1
            push(li)
        push(i)
        k -= 1
        eps = eval_eps(k)
        snapshots[k] = eps
        if eps < best[0]:
            best = (eps, k)

    # rebuild the best partition: we kept only the final pieces, so rerun the
    # deterministic merge to the recorded best k if it differs from final k.
    target_k = best[1]
    if target_k != k:
        return _greedy_to_k(x, y, w, target_k, cm, sample_stride, n_total_keys)

    out_pieces = []
    i = 0
    order = [idx for idx in range(len(alive)) if alive[idx]]
    order.sort(key=lambda idx: pieces[idx][0])
    bps = []
    for idx in order:
        s, e = pieces[idx]
        a, b = stats[idx].fit()
        out_pieces.append((s, e, a, b))
        bps.append(x[s])
    return len(out_pieces), np.asarray(bps), out_pieces


def _greedy_to_k(x, y, w, target_k, cm, sample_stride, n_total_keys):
    """Re-run the merge deterministically down to exactly target_k pieces."""
    n = len(x)
    k0 = n // 2
    starts = list(range(0, 2 * k0, 2))
    ends = [s + 2 for s in starts]
    ends[-1] = n
    pieces = [[s, e] for s, e in zip(starts, ends)]

    def seg_of(s, e):
        sl = slice(s, e, sample_stride if (e - s) > 8 else 1)
        return SegStats.of(x[sl], y[sl], w[sl])

    stats = [seg_of(s, e) for s, e in pieces]
    s_loss = [st.sse() for st in stats]
    alive = [True] * len(pieces)
    right = {i: i + 1 for i in range(len(pieces) - 1)}
    left = {i + 1: i for i in range(len(pieces) - 1)}
    version = [0] * len(pieces)
    heap = []
    max_piece = 2 * cm.omega

    def push(i):
        j = right.get(i)
        if j is None:
            return
        if (pieces[j][1] - pieces[i][0]) > max_piece:
            return
        m = stats[i].merge(stats[j]).sse()
        heapq.heappush(heap, (m - s_loss[i] - s_loss[j], version[i], i))

    for i in range(len(pieces)):
        push(i)
    k = len(pieces)
    while k > target_k and heap:
        d, ver, i = heapq.heappop(heap)
        if not alive[i] or version[i] != ver or right.get(i) is None:
            continue
        j = right[i]
        if not alive[j]:
            continue
        pieces[i] = [pieces[i][0], pieces[j][1]]
        stats[i] = seg_of(*pieces[i])
        s_loss[i] = stats[i].sse()
        alive[j] = False
        version[i] += 1
        rj = right.pop(j, None)
        if rj is not None:
            right[i] = rj
            left[rj] = i
        else:
            right.pop(i, None)
        li = left.get(i)
        if li is not None:
            version[li] += 1
            push(li)
        push(i)
        k -= 1
    order = [idx for idx in range(len(alive)) if alive[idx]]
    order.sort(key=lambda idx: pieces[idx][0])
    out, bps = [], []
    for idx in order:
        s, e = pieces[idx]
        a, b = stats[idx].fit()
        out.append((s, e, a, b))
        bps.append(x[s])
    return len(out), np.asarray(bps), out


# ---------------------------------------------------------------------------
# BuildBUTree (Algorithm 2)
# ---------------------------------------------------------------------------


def build_bu_tree(keys: np.ndarray, cm: CostModel = DEFAULT_COST,
                  sample_stride: int = 1, max_height: int = 12) -> BUTree:
    keys = np.asarray(keys, np.float64)
    n_total = len(keys)
    assert n_total >= 2, "need at least 2 keys"
    assert bool(np.all(np.diff(keys) > 0)), "keys must be sorted and unique"

    # --- leaves (h = 0) ------------------------------------------------------
    n0, bps0, pieces0 = greedy_merging(keys, None, n_total, cm, sample_stride)
    key_sup = float(keys[-1]) + max(1.0, abs(float(keys[-1])) * 1e-9)
    leaves: list[BUNode] = []
    for idx, (lo, hi, a, b) in enumerate(pieces0):
        lb = float(keys[lo])
        ub = float(keys[hi]) if hi < n_total else key_sup
        # leaf model maps keys -> local indices (Eq. 3: F(x) - l)
        leaves.append(BUNode(lb=lb, ub=ub, a=a - lo, b=b, height=0, lo=lo, hi=hi))
    # stretch first leaf's lb down to the true range start
    leaves[0].lb = float(keys[0])

    levels = [leaves]
    weights = np.array([lf.hi - lf.lo for lf in leaves], np.float64)

    h = 0
    while len(levels[-1]) > 1 and h < max_height:
        cur = levels[-1]
        xs = np.array([nd.lb for nd in cur], np.float64)
        n_cur = len(cur)

        # Option A: immediate root over the current level (generateRoot)
        a_r, b_r = least_squares(xs, np.arange(n_cur, dtype=np.float64))
        pred = a_r + b_r * xs
        err = np.abs(pred - np.arange(n_cur))
        te = float((weights * (cm.rho ** (h + 1))
                    * cm.t_exp_search(np.log2(np.maximum(err, 1.0)))).sum())
        eps_root = (cm.theta_n + cm.eta_lin) + te / n_total

        if n_cur <= 2:
            eps_grow = math.inf
            merged = None
        else:
            # Option B: grow one more level via greedy merging
            n_h, bps, pieces = greedy_merging(xs, weights, n_total, cm, sample_stride)
            merged = (n_h, bps, pieces)
            # cost of this extra level per key + estimated remaining depth
            ratio = max(n_cur / max(n_h, 1), 1.0 + 1e-9)
            depth_above = max(math.log(max(n_h, 2), ratio), 1.0)
            eps_grow = (depth_above + 1.0) * (cm.theta_n + cm.eta_lin)
            if n_h >= n_cur:          # merging made no progress -> must root
                eps_grow = math.inf

        if eps_root <= eps_grow or merged is None or merged[0] <= 1:
            root = BUNode(lb=float(levels[0][0].lb), ub=float(levels[0][-1].ub),
                          a=a_r, b=b_r, height=h + 1,
                          children=list(cur),
                          boundaries=xs.copy())
            levels.append([root])
            return BUTree(root=root, levels=levels, keys=keys)

        n_h, bps, pieces = merged
        nxt: list[BUNode] = []
        new_w = []
        for (lo, hi, a, b) in pieces:
            lb = float(xs[lo])
            ub = float(xs[hi]) if hi < n_cur else float(levels[0][-1].ub)
            node = BUNode(lb=lb, ub=ub, a=a - lo, b=b, height=h + 1,
                          children=cur[lo:hi],
                          boundaries=xs[lo:hi].copy())
            nxt.append(node)
            new_w.append(float(weights[lo:hi].sum()))
        nxt[0].lb = float(levels[0][0].lb)
        levels.append(nxt)
        weights = np.asarray(new_w)
        h += 1

    if len(levels[-1]) > 1:   # max height reached: force a root
        cur = levels[-1]
        xs = np.array([nd.lb for nd in cur], np.float64)
        a_r, b_r = least_squares(xs, np.arange(len(cur), dtype=np.float64))
        root = BUNode(lb=float(levels[0][0].lb), ub=float(levels[0][-1].ub),
                      a=a_r, b=b_r, height=len(levels), children=list(cur),
                      boundaries=xs.copy())
        levels.append([root])
    return BUTree(root=levels[-1][0], levels=levels, keys=keys)


# ---------------------------------------------------------------------------
# Reference search in the BU-Tree (used by Table 9 benchmark)
# ---------------------------------------------------------------------------


def bu_search(tree: BUTree, pairs_keys: np.ndarray, x: float) -> tuple[int, int, int]:
    """Search key x.  Returns (position or -1, nodes_visited, probe_steps)."""
    node = tree.root
    nodes = 0
    probes = 0
    while not node.is_leaf:
        nodes += 1
        b = node.boundaries
        j = int(np.clip(math.floor(node.a + node.b * x), 0, len(b) - 1))
        # local search in boundary array from predicted j (binary fallback)
        i = int(np.searchsorted(b, x, side="right") - 1)
        probes += int(np.ceil(np.log2(max(abs(i - j), 1) + 1)))
        i = max(i, 0)
        node = node.children[i]
    nodes += 1
    lo, hi = node.lo, node.hi
    j = int(np.clip(math.floor(node.a + node.b * x), lo, hi - 1))
    i = int(np.searchsorted(pairs_keys[lo:hi], x)) + lo
    probes += int(np.ceil(np.log2(max(abs(i - j), 1) + 1)))
    if i < hi and pairs_keys[i] == x:
        return i, nodes, probes
    return -1, nodes, probes
