"""Host-side linear assignment for tracking-by-detection.

Equivalent of the reference's OR-Tools binary program (`solvers.ortools_solve`
called at `voxelnet_second_endtoend_spatio.py:1631-1634`): each previous-frame
detection either links to one current-frame detection or ends; each current
detection either links or starts a new track; the solver maximizes total
(link / new / end) score. Expressed as one rectangular assignment on an
augmented square cost matrix and solved exactly with the Hungarian algorithm
(scipy linear_sum_assignment) — small N per frame, host-side, outside jit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

_NEG = -1e6


def solve_frame_pair(link_scores, end_scores, new_scores,
                     link_mask=None, det_scores_prev=None,
                     det_scores_cur=None):
    """Maximize Σ link + Σ end + Σ new (+ Σ det keep rewards) over a pair.

    link_scores: [N1, N2]; end_scores: [N1] (prev det terminates);
    new_scores: [N2] (cur det starts a track); link_mask: optional [N1, N2]
    bool of allowed links.

    Without det scores every detection is kept: each prev det links or ends,
    each cur det links or starts, and the call returns matches [M, 2]
    (prev_idx, cur_idx) — the historical behavior.

    With `det_scores_prev` [N1] / `det_scores_cur` [N2] the program gains
    keep-variables (the reference's `ortools_solve(det_scores, ...)`,
    `voxelnet_second_endtoend_spatio.py:1631-1634`): a kept det contributes
    its det score, a DROPPED det contributes nothing and incurs no
    link/new/end term. kept(prev) ⇔ linked or ended; kept(cur) ⇔ linked or
    new. Substituting the flow constraints, the objective becomes
        Σ y_link (l_ij + dp_i + dc_j) + Σ y_end (e_i + dp_i)
        + Σ y_new (n_j + dc_j)
    with each prev choosing {link, end, drop} and each cur {link, new,
    drop} — still one rectangular assignment (drop = the 0-valued slack
    diagonal), solved exactly. Returns (matches, kept_prev [N1] bool,
    kept_cur [N2] bool).
    """
    joint = det_scores_prev is not None or det_scores_cur is not None
    link = np.asarray(link_scores, np.float64)
    end = np.asarray(end_scores, np.float64)
    new = np.asarray(new_scores, np.float64)
    n1, n2 = link.shape
    if n1 == 0 or n2 == 0:
        matches = np.zeros((0, 2), np.int64)
        if not joint:
            return matches
        dc = np.zeros(n2) if det_scores_cur is None else \
            np.asarray(det_scores_cur, np.float64)
        dp = np.zeros(n1) if det_scores_prev is None else \
            np.asarray(det_scores_prev, np.float64)
        return matches, (end + dp) > 0, (new + dc) > 0
    if link_mask is not None:
        link = np.where(link_mask, link, _NEG)
    if joint:
        dp = np.zeros(n1) if det_scores_prev is None else \
            np.asarray(det_scores_prev, np.float64)
        dc = np.zeros(n2) if det_scores_cur is None else \
            np.asarray(det_scores_cur, np.float64)
        link = link + dp[:, None] + dc[None, :]
        end_kept = end + dp          # value of keeping prev i via "end"
        new_kept = new + dc          # value of keeping cur j via "new"
        end_diag = np.maximum(end_kept, 0.0)   # end vs drop: terminal, so max
        new_diag = np.maximum(new_kept, 0.0)
    else:
        end_diag, new_diag = end, new

    # augmented square matrix:
    #   [ link        diag(end) ]
    #   [ diag(new)   0         ]
    size = n1 + n2
    cost = np.full((size, size), _NEG)
    cost[:n1, :n2] = link
    cost[:n1, n2:] = _NEG
    cost[n1:, :n2] = _NEG
    np.fill_diagonal(cost[:n1, n2:], end_diag)
    np.fill_diagonal(cost[n1:, :n2], new_diag)
    cost[n1:, n2:] = 0.0
    rows, cols = linear_sum_assignment(-cost)
    matches = [(r, c) for r, c in zip(rows, cols)
               if r < n1 and c < n2 and cost[r, c] > _NEG / 2]
    matches = np.array(matches, np.int64).reshape(-1, 2)
    if not joint:
        return matches
    kept_prev = end_kept > 0
    kept_cur = new_kept > 0
    if len(matches):
        kept_prev[matches[:, 0]] = True
        kept_cur[matches[:, 1]] = True
    return matches, kept_prev, kept_cur


def greedy_solve(link_scores, threshold=0.0) -> np.ndarray:
    """Greedy fallback: repeatedly take the best remaining link above
    threshold."""
    link = np.asarray(link_scores, np.float64).copy()
    matches = []
    while link.size and link.max() > threshold:
        r, c = np.unravel_index(np.argmax(link), link.shape)
        matches.append((r, c))
        link[r, :] = -np.inf
        link[:, c] = -np.inf
    return np.array(matches, np.int64).reshape(-1, 2)
