"""Host-side DILI structure: bulk loading (Alg. 4), local optimization (Alg. 5),
search (Alg. 1 & 6), insertion (Alg. 7), deletion (Alg. 8).

This is the *writer* side of the writer/reader split (DESIGN.md section 2): a
faithful, mutable implementation of the paper's algorithms.  `flat.py`
publishes immutable device snapshots for the batched JAX/Pallas reader path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .bu_tree import BUTree, CostModel, DEFAULT_COST, build_bu_tree, least_squares

# Enlarging ratio eta (Alg. 5 line 2); adjustment threshold lambda (Alg. 7);
# phi(alpha) = min(eta + 0.1 * alpha, 4) (section 6.1).
ETA = 2.0
LAMBDA = 2.0


def phi(alpha: int, eta: float = ETA) -> float:
    return min(eta + 0.1 * alpha, 4.0)


# ULP safety margin for slot predictions.  XLA/Mosaic may contract a + b*x
# into an FMA whose single rounding differs from numpy's mul-then-add when the
# exact value sits on an integer boundary — the *slot assignment* would then
# differ between construction (host) and search (device).  We therefore nudge
# every model's intercept until each covered key's prediction is at least
# SAFE_ULPS ulps away from an integer, making floor() invariant to any
# evaluation order with <= a-few-ulp error.  See DESIGN.md section 7.
SAFE_ULPS = 32.0

# Placement dtype: the arithmetic precision in which slot predictions are
# evaluated (host construction AND device search must match).  float64 for the
# pure-JAX x64 path; float32 for the Pallas TPU kernel path (TPU has no f64) —
# set via `placement_dtype(np.float32)` around bulk_load.
PLACE_DTYPE = np.float64


class placement_dtype:
    def __init__(self, dtype):
        self.dtype = np.dtype(dtype).type

    def __enter__(self):
        global PLACE_DTYPE
        self._old = PLACE_DTYPE
        PLACE_DTYPE = self.dtype
        return self

    def __exit__(self, *exc):
        global PLACE_DTYPE
        PLACE_DTYPE = self._old


def nudge_boundary_safe(a: float, b: float,
                        xs: np.ndarray) -> tuple[float, bool]:
    """Return (a', ok) with a' close to a such that floor(a' + b*xs) is
    robust to any <=few-ulp evaluation-order difference (FMA contraction).

    The error scale of evaluating a + b*x is ulp(max(|a|, |b*x|)) — NOT
    ulp(y): when a ~ -b*x the sum cancels and y is tiny while the roundoff
    stays at product magnitude.  A good least-squares leaf fit maps keys to
    near-exact integers *by design*, so without this nudge boundary hits are
    systematic, not rare.
    """
    if len(xs) == 0 or b == 0.0:
        return a, True
    dt = PLACE_DTYPE
    a = float(dt(a))
    bq = dt(b)
    xq = np.asarray(xs, dt)
    p = bq * xq
    scale = np.maximum(np.maximum(np.abs(p), abs(a)), dt(1.0)).astype(dt)
    ulp = np.spacing(scale)
    if float(ulp.max()) * SAFE_ULPS >= 0.125:
        return a, False          # slots unresolvable at this precision
    for _ in range(40):
        y = dt(a) + p
        d = np.abs(y - np.rint(y))
        bad = d <= SAFE_ULPS * ulp
        if not bad.any():
            return a, True
        a = float(dt(a + 4.0 * SAFE_ULPS * float(ulp[bad].max())))
    return a, False


def predict_np(a: float, b: float, xs: np.ndarray) -> np.ndarray:
    """Host-side slot prediction: mul-then-add, floor, in PLACE_DTYPE —
    the canonical layout arithmetic that device search must reproduce."""
    dt = PLACE_DTYPE
    return np.floor(dt(a) + dt(b) * np.asarray(xs, dt)).astype(np.float64)


def _ulp_safe(a: float, b: float, x: float) -> bool:
    dt = PLACE_DTYPE
    p = dt(b) * dt(x)
    y = dt(a) + p
    scale = dt(max(abs(float(p)), abs(a), 1.0))
    return abs(float(y) - round(float(y))) > SAFE_ULPS * float(np.spacing(scale))


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@dataclass
class Internal:
    lb: float
    ub: float
    a: float
    b: float
    children: list = field(default_factory=list)

    @property
    def fanout(self) -> int:
        return len(self.children)

    def child_index(self, x: float) -> int:
        dt = PLACE_DTYPE
        y = math.floor(float(dt(self.a) + dt(self.b) * dt(x)))
        return int(np.clip(y, 0, self.fanout - 1))


@dataclass
class Leaf:
    lb: float
    ub: float
    a: float = 0.0
    b: float = 0.0
    fo: int = 0
    slots: list = field(default_factory=list)   # None | (key, val) | Leaf
    omega: int = 0      # Omega: #pairs covered
    delta: int = 0      # Delta: total probe count to reach every pair
    kappa: float = 1.0  # avg probes/pair at last local optimization
    alpha: int = 0      # #adjustments so far
    dense: bool = False  # DILI-LO variant: tightly packed pairs, no local opt

    def predict(self, x: float) -> int:
        dt = PLACE_DTYPE
        y = math.floor(float(dt(self.a) + dt(self.b) * dt(x)))
        return int(np.clip(y, 0, max(self.fo - 1, 0)))


Node = Internal | Leaf


# ---------------------------------------------------------------------------
# Local optimization (Algorithm 5)
# ---------------------------------------------------------------------------


def local_opt(leaf: Leaf, pairs: list[tuple[float, int]], eta: float = ETA,
              fo: int | None = None, depth: int = 0) -> None:
    """LOCALOPT(N_D, P_D): place pairs at predicted slots; conflicts spawn
    child leaves.  `leaf.a/b` must already map keys -> [0, len(pairs)); we
    scale by eta here (consistent with Alg. 7 line 24)."""
    m = len(pairs)
    leaf.omega = m
    leaf.delta = 0
    if m == 0:
        leaf.fo = 1
        leaf.slots = [None]
        leaf.kappa = 1.0
        return
    if fo is None:
        fo = max(int(math.ceil(eta * m)), 1)
        leaf.a *= (fo / m)
        leaf.b *= (fo / m)
    leaf.fo = fo
    leaf.dense = False

    keys = np.array([p[0] for p in pairs], np.float64)
    leaf.b = float(PLACE_DTYPE(leaf.b))
    leaf.a, ok = nudge_boundary_safe(leaf.a, leaf.b, keys)
    if not ok:
        # slots unresolvable at f64 precision: fall back to a dense leaf
        # (comparison-based search needs no floor consistency)
        dense = make_dense_leaf(leaf.lb, leaf.ub, sorted(pairs))
        leaf.__dict__.update(dense.__dict__)
        return
    pos = np.clip(predict_np(leaf.a, leaf.b, keys).astype(np.int64), 0, fo - 1)
    slots: list = [None] * fo
    order = np.argsort(pos, kind="stable")
    i = 0
    n = m
    while i < n:
        j = i
        t = pos[order[i]]
        while j < n and pos[order[j]] == t:
            j += 1
        group = [pairs[order[g]] for g in range(i, j)]
        if len(group) == 1:
            slots[t] = group[0]
            leaf.delta += 1
        else:
            child = _make_conflict_leaf(group, eta, depth + 1)
            slots[t] = child
            leaf.delta += len(group) + child.delta
        i = j
    leaf.slots = slots
    leaf.kappa = leaf.delta / max(leaf.omega, 1)


def _make_conflict_leaf(group: list[tuple[float, int]], eta: float,
                        depth: int) -> Leaf:
    ks = np.array([p[0] for p in group], np.float64)
    lb, ub = float(ks[0]), float(ks[-1])
    child = Leaf(lb=lb, ub=ub)
    # Cap conflict-chain depth: beyond it (or for unseparable clusters where
    # a+b*x can no longer resolve slots in f64) fall back to a tiny dense leaf
    # — bounds tree height like the paper's adjustment strategy does.
    span = ks[-1] - ks[0]
    if depth > 8 or span <= 0 or not np.isfinite(span) or \
            span <= abs(ks[0]) * 1e-13 * len(group):
        # degenerate cluster: fall back to a dense leaf with exact slots
        child.a, child.b = 0.0, 0.0
        child.fo = len(group)
        child.slots = list(group)
        child.omega = len(group)
        child.delta = len(group)
        child.kappa = 1.0
        child.dense = True
        return child
    a, b = least_squares(ks, np.arange(len(group), dtype=np.float64))
    child.a, child.b = a, b
    local_opt(child, group, eta, depth=depth)
    return child


def make_dense_leaf(lb: float, ub: float, pairs: list[tuple[float, int]]) -> Leaf:
    """DILI-LO variant leaf: tightly packed array + model (Alg. 1 search)."""
    leaf = Leaf(lb=lb, ub=ub, dense=True)
    m = len(pairs)
    leaf.omega = m
    leaf.fo = max(m, 1)
    leaf.slots = list(pairs) if m else [None]
    if m >= 2:
        ks = np.array([p[0] for p in pairs], np.float64)
        leaf.a, leaf.b = least_squares(ks, np.arange(m, dtype=np.float64))
    leaf.delta = m
    leaf.kappa = 1.0
    return leaf


# ---------------------------------------------------------------------------
# DILI tree
# ---------------------------------------------------------------------------


@dataclass
class DILI:
    root: Node
    n_keys: int
    cm: CostModel
    eta: float = ETA
    lam: float = LAMBDA
    local_optimized: bool = True
    sample_stride: int = 1     # retained so subtree rebuilds match the build
    # statistics
    n_conflicts: int = 0
    n_adjustments: int = 0
    # ids of leaves located by mutation entry points since the last
    # `take_dirty()` — the dirty plumbing of the incremental flattener
    # (repro.maintain.flattener); cheap enough to keep always-on
    dirty_ids: set = field(default_factory=set, repr=False)

    # -- search ------------------------------------------------------------

    def locate_leaf(self, x: float) -> tuple[Leaf, int]:
        node = self.root
        depth = 1
        while isinstance(node, Internal):
            node = node.children[node.child_index(x)]
            depth += 1
        return node, depth

    def search(self, x: float) -> int | None:
        """Algorithm 6 (Algorithm 1 for dense leaves). Returns payload or None."""
        node, _ = self.locate_leaf(x)
        while True:
            if node.dense:
                return _dense_leaf_search(node, x)
            pos = node.predict(x)
            p = node.slots[pos] if node.fo else None
            if isinstance(p, Leaf):
                node = p
            elif p is not None and p[0] == x:
                return p[1]
            else:
                return None

    def search_stats(self, x: float) -> tuple[int | None, int, int]:
        """Search returning (payload, nodes_visited, entry_probes)."""
        node = self.root
        nodes = 1
        while isinstance(node, Internal):
            node = node.children[node.child_index(x)]
            nodes += 1
        probes = 0
        while True:
            if node.dense:
                v, pr = _dense_leaf_search_stats(node, x)
                return v, nodes, probes + pr
            pos = node.predict(x)
            p = node.slots[pos] if node.fo else None
            probes += 1
            if isinstance(p, Leaf):
                node = p
                nodes += 1
            elif p is not None and p[0] == x:
                return p[1], nodes, probes
            else:
                return None, nodes, probes

    def range_query(self, lo: float, hi: float) -> list[tuple[float, int]]:
        """Scan pairs with lo <= key < hi (section 7.2, Fig. 6b)."""
        out: list[tuple[float, int]] = []
        _range_collect(self.root, lo, hi, out)
        out.sort()
        return out

    # -- updates -------------------------------------------------------------

    def take_dirty(self) -> set:
        """Drain the dirty-leaf id set (mutations since the last call)."""
        d, self.dirty_ids = self.dirty_ids, set()
        return d

    def insert(self, key: float, val: int) -> bool:
        """Algorithm 7. Returns True if the key was newly inserted."""
        leaf, _ = self.locate_leaf(key)
        self.dirty_ids.add(id(leaf))
        return self._insert_to_leaf(leaf, key, val)

    def _insert_to_leaf(self, leaf: Leaf, key: float, val: int) -> bool:
        if leaf.dense:
            # returns False on a duplicate so upsert() knows to _set_payload
            return _dense_leaf_insert(leaf, key, val)
        pos = leaf.predict(key)
        p = leaf.slots[pos]
        not_exist = True
        if p is None:
            if _ulp_safe(leaf.a, leaf.b, key):
                leaf.slots[pos] = (key, val)
                leaf.delta += 1
            else:
                # the new key's prediction sits on an integer boundary: wrap it
                # in a single-pair child leaf so device-side FMA evaluation
                # cannot land it in the wrong slot (DESIGN.md section 7)
                child = Leaf(lb=key, ub=key, a=0.0, b=0.0, fo=1,
                             slots=[(key, val)], omega=1, delta=1, kappa=1.0)
                leaf.slots[pos] = child
                leaf.delta += 2
        elif isinstance(p, Leaf):
            d0 = p.delta
            not_exist = self._insert_to_leaf(p, key, val)
            leaf.delta += 1 + p.delta - d0
        elif p[0] == key:
            not_exist = False
        else:  # conflict: new leaf covering p and (key, val) (lines 15-18)
            self.n_conflicts += 1
            group = sorted([p, (key, val)])
            child = Leaf(lb=group[0][0], ub=group[1][0])
            ks = np.array([g[0] for g in group])
            child.a, child.b = least_squares(ks, np.arange(2, dtype=np.float64))
            local_opt(child, group, self.eta)   # sets omega=2, delta (>=2)
            leaf.slots[pos] = child
            leaf.delta += 1 + child.delta
        if not_exist:
            leaf.omega += 1
            self.n_keys += 1
        # -- node adjustment (lines 20-26) ----------------------------------
        if not_exist and leaf.omega > 0 and \
                leaf.delta / leaf.omega > self.lam * leaf.kappa:
            self.adjust_leaf(leaf)
        return not_exist

    def upsert(self, key: float, val: int) -> bool:
        """Insert (Alg. 7) or, when the key already exists, replace its
        payload in place.  Returns True if the key was newly inserted."""
        if self.insert(key, val):
            return True
        self._set_payload(key, val)
        return False

    def _set_payload(self, x: float, val: int) -> bool:
        node, _ = self.locate_leaf(x)
        self.dirty_ids.add(id(node))
        return self._set_payload_at(node, x, val)

    def _set_payload_at(self, node: Leaf, x: float, val: int) -> bool:
        """Replace x's payload within an already-located leaf subtree
        (callers that located the leaf themselves skip the second walk)."""
        while True:
            if node.dense:
                for i, s in enumerate(node.slots[: node.omega]):
                    if s is not None and s[0] == x:
                        node.slots[i] = (x, val)
                        return True
                return False
            pos = node.predict(x)
            p = node.slots[pos] if node.fo else None
            if isinstance(p, Leaf):
                node = p
            elif p is not None and p[0] == x:
                node.slots[pos] = (x, val)
                return True
            else:
                return False

    def adjust_leaf(self, leaf: Leaf) -> None:
        self.n_adjustments += 1
        pairs = collect_pairs(leaf)
        r = phi(leaf.alpha, self.eta)
        leaf.alpha += 1
        m = len(pairs)
        ks = np.array([p[0] for p in pairs], np.float64)
        a, b = least_squares(ks, np.arange(m, dtype=np.float64))
        leaf.a, leaf.b = a * r, b * r          # Alg. 7 line 24
        fo = max(int(math.ceil(m * r)), 1)
        local_opt(leaf, pairs, self.eta, fo=fo)
        leaf.kappa = leaf.delta / max(leaf.omega, 1)

    def delete(self, key: float) -> bool:
        """Algorithm 8. Returns True if the key existed."""
        leaf, _ = self.locate_leaf(key)
        self.dirty_ids.add(id(leaf))
        return self._delete_from_leaf(leaf, key)

    def _delete_from_leaf(self, leaf: Leaf, key: float) -> bool:
        if leaf.dense:
            return _dense_leaf_delete(leaf, key)
        pos = leaf.predict(key)
        p = leaf.slots[pos]
        exist = True
        if p is None:
            return False
        if isinstance(p, Leaf):
            d0 = p.delta
            exist = self._delete_from_leaf(p, key)
            leaf.delta -= 1 + d0 - p.delta
            if exist and p.omega == 1:       # trim single-pair leaf (lines 13-15)
                rem = collect_pairs(p)
                if rem and not _ulp_safe(leaf.a, leaf.b, rem[0][0]):
                    pass                     # keep the wrapper: unsafe boundary
                else:
                    leaf.slots[pos] = rem[0] if rem else None
                    leaf.delta -= 1
        elif p[0] == key:
            leaf.slots[pos] = None
            leaf.delta -= 1
        else:
            return False
        if exist:
            leaf.omega -= 1
            self.n_keys -= 1
            leaf.kappa = leaf.delta / max(leaf.omega, 1)
        return exist

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        depths: list[int] = []
        n_internal = n_leaf = n_slots = n_pairs = 0
        stack: list[tuple[Node, int]] = [(self.root, 1)]
        while stack:
            node, d = stack.pop()
            if isinstance(node, Internal):
                n_internal += 1
                for c in node.children:
                    stack.append((c, d + 1))
            else:
                n_leaf += 1
                n_slots += node.fo
                for s in node.slots:
                    if isinstance(s, Leaf):
                        stack.append((s, d + 1))
                    elif s is not None:
                        n_pairs += 1
                        depths.append(d)
        depths_a = np.asarray(depths if depths else [1])
        return dict(
            n_internal=n_internal, n_leaf=n_leaf, n_slots=n_slots,
            n_pairs=n_pairs, min_height=int(depths_a.min()),
            max_height=int(depths_a.max()), avg_height=float(depths_a.mean()),
            conflicts=self.n_conflicts, adjustments=self.n_adjustments,
            memory_bytes=self.memory_bytes(n_internal, n_leaf, n_slots),
        )

    @staticmethod
    def memory_bytes(n_internal: int, n_leaf: int, n_slots: int) -> int:
        # flat-snapshot accounting: node row = a,b (f64) + base,fo (i32) + tag
        node_row = 8 + 8 + 4 + 4 + 1
        slot_row = 8 + 8 + 1          # key f64 + val i64 + tag
        return (n_internal + n_leaf) * node_row + n_slots * slot_row


# ---------------------------------------------------------------------------
# dense-leaf (DILI-LO) helpers: model + exponential search (Algorithm 1)
# ---------------------------------------------------------------------------


def _dense_keys(leaf: Leaf) -> np.ndarray:
    return np.array([s[0] for s in leaf.slots if s is not None], np.float64)


def _dense_leaf_search(leaf: Leaf, x: float):
    v, _ = _dense_leaf_search_stats(leaf, x)
    return v


def _dense_leaf_search_stats(leaf: Leaf, x: float):
    m = leaf.omega
    if m == 0:
        return None, 0
    pred = int(np.clip(math.floor(leaf.a + leaf.b * x), 0, m - 1))
    # exponential search outward from pred (2*log2(err) probes, Eq. 2)
    keys = [s[0] for s in leaf.slots[:m]]
    lo, hi, probes = pred, pred, 1
    step = 1
    if keys[pred] < x:
        while hi < m - 1 and keys[min(hi + step, m - 1)] < x:
            hi = min(hi + step, m - 1)
            step *= 2
            probes += 1
        lo, hi = hi, min(hi + step, m - 1)
    elif keys[pred] > x:
        while lo > 0 and keys[max(lo - step, 0)] > x:
            lo = max(lo - step, 0)
            step *= 2
            probes += 1
        lo, hi = max(lo - step, 0), lo
    while lo < hi:
        mid = (lo + hi) // 2
        probes += 1
        if keys[mid] < x:
            lo = mid + 1
        else:
            hi = mid
    if keys[lo] == x:
        return leaf.slots[lo][1], probes
    return None, probes


def _dense_leaf_insert(leaf: Leaf, key: float, val: int) -> bool:
    """B+Tree-style shifted insert (what DILI *avoids*; kept for DILI-LO).
    Returns True iff the key was newly inserted."""
    pairs = [s for s in leaf.slots[:leaf.omega] if s is not None]
    import bisect
    i = bisect.bisect_left([p[0] for p in pairs], key)
    if i < len(pairs) and pairs[i][0] == key:
        return False
    pairs.insert(i, (key, val))
    leaf.slots = pairs
    leaf.omega = len(pairs)
    leaf.fo = len(pairs)
    ks = np.array([p[0] for p in pairs], np.float64)
    if len(pairs) >= 2:
        leaf.a, leaf.b = least_squares(ks, np.arange(len(pairs), dtype=np.float64))
    return True


def _dense_leaf_delete(leaf: Leaf, key: float) -> bool:
    pairs = [s for s in leaf.slots[:leaf.omega] if s is not None]
    ks = [p[0] for p in pairs]
    import bisect
    i = bisect.bisect_left(ks, key)
    if i >= len(pairs) or pairs[i][0] != key:
        return False
    pairs.pop(i)
    leaf.slots = pairs if pairs else [None]
    leaf.omega = len(pairs)
    leaf.fo = max(len(pairs), 1)
    return True


def collect_pairs(leaf: Leaf) -> list[tuple[float, int]]:
    out: list[tuple[float, int]] = []
    stack = [leaf]
    while stack:
        nd = stack.pop()
        for s in nd.slots:
            if isinstance(s, Leaf):
                stack.append(s)
            elif s is not None:
                out.append(s)
    out.sort()
    return out


def _range_collect(node: Node, lo: float, hi: float, out: list) -> None:
    if isinstance(node, Internal):
        i0 = node.child_index(lo)
        i1 = node.child_index(min(hi, node.ub - 1e-300))
        for i in range(i0, min(i1 + 1, node.fanout)):
            _range_collect(node.children[i], lo, hi, out)
    else:
        for s in node.slots:
            if isinstance(s, Leaf):
                if s.ub >= lo and s.lb <= hi:
                    _range_collect(s, lo, hi, out)
            elif s is not None and lo <= s[0] < hi:
                out.append(s)


# ---------------------------------------------------------------------------
# Bulk loading (Algorithm 4)
# ---------------------------------------------------------------------------


def bulk_load(keys: np.ndarray, vals: np.ndarray | None = None,
              cm: CostModel = DEFAULT_COST, eta: float = ETA,
              lam: float = LAMBDA, local_optimized: bool = True,
              sample_stride: int = 1,
              bu: BUTree | None = None) -> DILI:
    """BulkLoading(P): build the BU-Tree, then grow DILI top-down copying the
    BU-Tree's per-level node counts with equal-width children (Alg. 4)."""
    keys = np.asarray(keys, np.float64)
    n = len(keys)
    if vals is None:
        vals = np.arange(n, dtype=np.int64)
    if bu is None:
        bu = build_bu_tree(keys, cm, sample_stride)

    # theta^i = lower bounds of BU nodes at height i (Alg. 4 lines 4-5)
    thetas = [np.array([nd.lb for nd in level], np.float64)
              for level in bu.levels[:-1]]   # exclude root level
    height = len(bu.levels)                  # leaf level .. root level

    root_lb = float(bu.root.lb)
    root_ub = float(bu.root.ub)

    dili = DILI(root=None, n_keys=n, cm=cm, eta=eta, lam=lam,  # type: ignore
                local_optimized=local_optimized,
                sample_stride=sample_stride)

    def create_leaf(lb: float, ub: float, lo: int, hi: int) -> Leaf:
        pd = [(float(keys[i]), int(vals[i])) for i in range(lo, hi)]
        if not local_optimized:
            return make_dense_leaf(lb, ub, pd)
        leaf = Leaf(lb=lb, ub=ub)
        m = len(pd)
        if m >= 2:
            a, b = least_squares(keys[lo:hi], np.arange(m, dtype=np.float64))
            leaf.a, leaf.b = a, b
        elif m == 1:
            leaf.a, leaf.b = 0.0, 0.0
        before = _count_conflicts_estimate(leaf, pd, eta)
        dili.n_conflicts += before
        local_opt(leaf, pd, eta)
        return leaf

    def create_internal(lb: float, ub: float, h: int, lo: int, hi: int) -> Node:
        theta = thetas[h - 1]
        fo = int(np.searchsorted(theta, ub, side="left")
                 - np.searchsorted(theta, lb, side="left"))
        fo = max(fo, 1)
        if fo == 1 and h == 1:
            # degenerate internal with a single leaf child: collapse one level
            return create_leaf(lb, ub, lo, hi)
        node = Internal(lb=lb, ub=ub, a=0.0, b=0.0)
        node.b = float(PLACE_DTYPE(fo / (ub - lb)))   # Eq. 1
        node.a = -node.b * lb
        # Partition the covered keys BY the (nudged) floor function itself so
        # construction and any-device search agree on child assignment.
        node.a, _ = nudge_boundary_safe(node.a, node.b, keys[lo:hi])
        pos = np.clip(predict_np(node.a, node.b, keys[lo:hi]).astype(np.int64),
                      0, fo - 1)
        starts = lo + np.searchsorted(pos, np.arange(fo), side="left")
        ends = lo + np.searchsorted(pos, np.arange(fo), side="right")
        for i in range(fo):
            l = lb + i * (ub - lb) / fo
            u = lb + (i + 1) * (ub - lb) / fo
            clo, chi = int(starts[i]), int(ends[i])
            if h == 1:
                node.children.append(create_leaf(l, u, clo, chi))
            else:
                node.children.append(create_internal(l, u, h - 1, clo, chi))
        return node

    if height <= 1:
        dili.root = create_leaf(root_lb, root_ub, 0, n)
    else:
        dili.root = create_internal(root_lb, root_ub, height - 1, 0, n)
    return dili


def rebuild_subtree(dili: DILI, leaf: Leaf) -> Node | None:
    """Local retrain: re-run the paper's top-down fanout individualization
    (Alg. 4/5) on ONE leaf subtree and splice the result back in place.

    Alg. 7's per-leaf adjustment re-spreads a region with `phi(alpha)`
    growth, but under sustained drift the repeated local fixes degrade the
    region globally (deep conflict chains, sparse slots).  Rebuilding the
    subtree from its live pairs — exactly the bulk-loading machinery, over
    just this key range — restores the build-time layout quality without
    touching the rest of the tree.  Returns the new subtree root (possibly
    an `Internal` — callers route through it transparently), or None when
    the leaf holds too few pairs to be worth rebuilding or can no longer
    be located from the root (already replaced).

    The replacement preserves the leaf's routing region bounds (widened to
    cover any out-of-region keys the parent's clipping routed here), keeps
    `dili.n_keys` unchanged, and marks nothing: the caller's flattener
    sees a new object where the old leaf was — a cache miss, hence dirty
    by identity.
    """
    pairs = collect_pairs(leaf)
    if len(pairs) < 2:
        return None
    # find the splice point FIRST — if the leaf is no longer reachable
    # (already replaced), bail before paying the bulk_load (and before
    # polluting n_conflicts with a rebuild that never lands).  The walk
    # follows a key the leaf owns: pairs live where the static routing
    # puts them, so this reaches the leaf when it is still in the tree.
    rep = float(pairs[len(pairs) // 2][0])
    parent: Internal | None = None
    child_i = -1
    if dili.root is not leaf:
        cur: Node = dili.root
        while isinstance(cur, Internal):
            i = cur.child_index(rep)
            child = cur.children[i]
            if child is leaf:
                parent, child_i = cur, i
                break
            cur = child
        if parent is None:
            return None

    keys = np.array([p[0] for p in pairs], np.float64)
    vals = np.array([p[1] for p in pairs], np.int64)
    sub = bulk_load(keys, vals, cm=dili.cm, eta=dili.eta, lam=dili.lam,
                    local_optimized=dili.local_optimized,
                    sample_stride=dili.sample_stride)
    node = sub.root
    node.lb = min(float(leaf.lb), float(keys[0]))
    node.ub = max(float(leaf.ub), float(keys[-1]))
    dili.n_conflicts += sub.n_conflicts

    if parent is None:
        dili.root = node
    else:
        parent.children[child_i] = node
    return node


def split_leaf(dili: DILI, leaf: Leaf, n_children: int) -> Internal | None:
    """Locality re-clustering primitive: replace ONE write-hot leaf with an
    equal-width `Internal` of `n_children` freshly-fit leaf children.

    `rebuild_subtree` restores model quality but lets the BU-tree cost
    model pick the layout — which happily keeps a large region as one big
    leaf, i.e. ONE incremental-flatten segment whose every row re-flattens
    whenever any key in it is written.  Under zipfian skew with hashed
    rank-scatter that makes nearly every merge O(n).  This splits the
    region into `n_children` leaves, each its own splice segment, so
    subsequent writes dirty only the small child they land in.

    The mutation is the same shape `rebuild_subtree` performs — one parent
    child-pointer swap; no existing Internal's children list is touched —
    so the incremental flattener's contract is preserved: the old leaf is
    a cache miss by identity and everything else splices from cache,
    bit-identical to a full `flatten()`.  Construction mirrors Alg. 4's
    `create_internal`/`create_leaf` (Eq. 1 equal-division model, boundary
    nudge, clip-partition, least-squares + LOCALOPT per child) so routing
    agrees between host construction and device search.  Returns the new
    Internal, or None when the leaf is too small, spans no key range, or
    can no longer be located from the root (already replaced)."""
    pairs = collect_pairs(leaf)
    if len(pairs) < 2 or n_children < 2:
        return None
    # locate the splice point FIRST (same bail-before-building discipline
    # as rebuild_subtree)
    rep = float(pairs[len(pairs) // 2][0])
    parent: Internal | None = None
    child_i = -1
    if dili.root is not leaf:
        cur: Node = dili.root
        while isinstance(cur, Internal):
            i = cur.child_index(rep)
            child = cur.children[i]
            if child is leaf:
                parent, child_i = cur, i
                break
            cur = child
        if parent is None:
            return None

    keys = np.array([p[0] for p in pairs], np.float64)
    vals = np.array([p[1] for p in pairs], np.int64)
    lb = min(float(leaf.lb), float(keys[0]))
    ub = max(float(leaf.ub), float(keys[-1]))
    if not (ub > lb) or not np.isfinite(ub - lb):
        return None
    fo = int(n_children)
    node = Internal(lb=lb, ub=ub, a=0.0, b=0.0)
    node.b = float(PLACE_DTYPE(fo / (ub - lb)))          # Eq. 1
    node.a = -node.b * lb
    node.a, _ = nudge_boundary_safe(node.a, node.b, keys)
    pos = np.clip(predict_np(node.a, node.b, keys).astype(np.int64),
                  0, fo - 1)
    starts = np.searchsorted(pos, np.arange(fo), side="left")
    ends = np.searchsorted(pos, np.arange(fo), side="right")
    eta = dili.eta
    for i in range(fo):
        clo, chi = int(starts[i]), int(ends[i])
        l = lb + i * (ub - lb) / fo
        u = lb + (i + 1) * (ub - lb) / fo
        pd = [(float(keys[j]), int(vals[j])) for j in range(clo, chi)]
        if not dili.local_optimized:
            node.children.append(make_dense_leaf(l, u, pd))
            continue
        child = Leaf(lb=l, ub=u)
        m = len(pd)
        if m >= 2:
            child.a, child.b = least_squares(
                keys[clo:chi], np.arange(m, dtype=np.float64))
        dili.n_conflicts += _count_conflicts_estimate(child, pd, eta)
        local_opt(child, pd, eta)
        node.children.append(child)

    if parent is None:
        dili.root = node
    else:
        parent.children[child_i] = node
    return node


def _count_conflicts_estimate(leaf: Leaf, pd: list, eta: float) -> int:
    m = len(pd)
    if m < 2:
        return 0
    fo = max(int(math.ceil(eta * m)), 1)
    ks = np.array([p[0] for p in pd])
    pos = np.clip(np.floor((leaf.a + leaf.b * ks) * (fo / m)).astype(np.int64),
                  0, fo - 1)
    uniq, counts = np.unique(pos, return_counts=True)
    return int((counts > 1).sum())
