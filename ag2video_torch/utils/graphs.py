"""Scene-graph algebra for graph canonicalization experiments (a copy of
ag2video_tpu/utils/graphs.py; numpy only).

Reference: scripts/graphs_utils.py:4-119 — triplets <-> adjacency matrix,
transitive closure (Warshall-style `path`), transitive reduction (Hsu),
random transitive-edge dropout, symmetric/antisymmetric edge generation.
Vectorized numpy (the reference uses nested Python loops); semantics
verified against the reference's own inline test
(test_reduce_transitive_edges, graphs_utils.py:122-151).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def triplets_to_adj_matrix(triplets) -> np.ndarray:
    """[s, p, o] rows -> dense 0/1 adjacency over nodes 0..max_idx."""
    t = np.asarray(triplets)
    so = np.concatenate([t[:, :1], t[:, 2:3]], axis=1).astype(np.int64)
    n = int(so.max()) + 1
    m = np.zeros((n, n), np.uint8)
    m[so[:, 0], so[:, 1]] = 1
    return m


def matrix_to_triplets(m: np.ndarray, rel_idx: int) -> np.ndarray:
    rows, cols = np.where(np.asarray(m, np.uint8) == 1)
    rels = np.full(len(rows), rel_idx)
    return np.stack([rows, rels, cols], axis=1)


def transitive_closure(m: np.ndarray) -> np.ndarray:
    """Reachability ('path matrix'); matches reference `path`
    (graphs_utils.py:13-25) including its row-update ordering."""
    p = np.asarray(m, np.uint8).copy()
    n = p.shape[0]
    for i in range(n):
        # Every row j that reaches i inherits i's current row.
        reach_i = p[:, i].astype(bool).copy()
        reach_i[i] = False
        p[reach_i] |= p[i]
    return p


def transitive_reduction(m: np.ndarray) -> np.ndarray:
    """Hsu's minimal equivalent graph of a closed DAG (reference `hsu`,
    graphs_utils.py:28-36): remove i->k whenever i->j->k exists."""
    m = np.asarray(m, np.uint8).copy()
    n = m.shape[0]
    for j in range(n):
        src = m[:, j].astype(bool)
        if not src.any():
            continue
        dst = m[j].astype(bool)
        m[np.ix_(src, dst)] = 0
    return m


def get_minimal_graph(m: np.ndarray) -> np.ndarray:
    return transitive_reduction(transitive_closure(m))


def triplets_to_minimal(triplets) -> np.ndarray:
    t = np.asarray(triplets)
    if len(t) < 3:
        return t
    return matrix_to_triplets(get_minimal_graph(triplets_to_adj_matrix(t)),
                              int(t[0][1]))


def reduce_transitive_edges(triplets, p_keep: float = 0.5,
                            rng: Optional[np.random.RandomState] = None
                            ) -> np.ndarray:
    """Keep the minimal graph plus each redundant (transitive) edge with
    probability `p_keep`.

    Documented divergence: the reference's version (graphs_utils.py:73-80)
    has inverted p_keep semantics — its own inline test
    (test_reduce_transitive_edges, :122-151) FAILS upstream because
    `p_keep=1` keeps every transitive edge while the test expects the
    minimal graph. Here p_keep=0 yields the minimal graph and p_keep=1 the
    full graph, which is what the name says.
    """
    t = np.asarray(triplets)
    if len(t) < 3:
        return t
    rng = rng or np.random
    mat = triplets_to_adj_matrix(t)
    mini = get_minimal_graph(mat)
    prob = rng.uniform(0, 1, mat.shape)
    redundant = (mat.astype(int) - mini.astype(int)) > 0
    extra = redundant & (prob < p_keep)
    return matrix_to_triplets(extra.astype(np.uint8) | mini, int(t[0][1]))


def get_maximal_transitive_triplets(triplets) -> np.ndarray:
    t = np.asarray(triplets)
    if len(t) < 2:
        return t
    return matrix_to_triplets(
        transitive_closure(triplets_to_adj_matrix(t)), int(t[0][1]))


def get_minimal_and_transitive_triplets(triplets) -> Tuple[np.ndarray, np.ndarray]:
    t = np.asarray(triplets)
    mat = triplets_to_adj_matrix(t)
    mini = get_minimal_graph(mat)
    maxi = transitive_closure(mat)
    return (matrix_to_triplets(mini, int(t[0][1])),
            matrix_to_triplets(maxi.astype(int) - mini.astype(int),
                               int(t[0][1])))


def get_symmetric_triplets(triplets) -> np.ndarray:
    """Reverse each triplet [s, p, o] -> [o, p, s]
    (reference graphs_utils.py:107-109)."""
    return np.asarray(triplets)[:, ::-1]


def get_edge_antisymmetric_triplets(triplets, vocab: Dict) -> List[np.ndarray]:
    """Reversed edges relabeled with every *other* predicate — negative
    edges for contrastive experiments (reference graphs_utils.py:112-119)."""
    t = np.asarray(triplets)
    pred_id = int(t[0, 1])
    out = []
    for p in set(vocab["pred_name_to_idx"].values()) - {pred_id}:
        rev = t.copy()[:, ::-1]
        rev[:, 1] = p
        out.extend(rev)
    return out
