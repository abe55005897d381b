"""Tracking-by-detection branch — the port of
`second_tpu/models/tracking.py`: appearance and point features, detection scoring and pairwise affinity
(`AppearanceNet`, `PointNetFeat`, `FusionModule`, `DetScoreHead`,
`AffinityHead`, `TrackNet`, `SequenceTrackNet`), and the host-side id
management (`Tracker`, `MemoryTracker`, `SequenceStitcher`, numpy, copied
as they are).

The nets are small dense layers and convs (cuDNN and cuBLAS on the card).
They take JAX's layouts: image crops [..., H, W, C] channels last (the
convs run NCHW inside), point sets [..., P, 3]. Their submodules carry
flax's automatic names, so `convert.tracking_state_dict_from_jax` maps a
JAX parameter tree onto them one to one: `appearance.Conv_0..7`,
`Dense_0`; `point_net.Dense_0..2`; `fusion.Dense_0..1`;
`w_det.Dense_0..1`; `w_link.Dense_0`, `Dense_1`, `end_mlp`, `w_end`,
`new_mlp`, `w_new`. A Linear's input width is given, as flax infers it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


class AppearanceNet(nn.Module):
    """Small VGG-style conv net on detection image crops → embedding: four
    blocks of two 3x3 convs with ReLU and a 2x2 max pool (its floor: 24 →
    12 → 6 → 3 → 1, as flax's VALID pool), a global average pool, a
    Dense."""

    def __init__(self, out_features: int = 512, in_channels: int = 3):
        super().__init__()
        c = in_channels
        for i, f in enumerate((32, 64, 128, 256)):
            setattr(self, f"Conv_{2 * i}", nn.Conv2d(c, f, 3, padding=1))
            setattr(self, f"Conv_{2 * i + 1}", nn.Conv2d(f, f, 3, padding=1))
            c = f
        self.Dense_0 = nn.Linear(c, out_features)

    def forward(self, crops):
        """crops [N, H, W, C] → [N, out_features]."""
        x = crops.permute(0, 3, 1, 2)
        for i in range(4):
            x = torch.relu(getattr(self, f"Conv_{2 * i}")(x))
            x = torch.relu(getattr(self, f"Conv_{2 * i + 1}")(x))
            x = F.max_pool2d(x, 2, 2)
        return self.Dense_0(x.mean(dim=(2, 3)))


class PointNetFeat(nn.Module):
    """PointNet on per-detection point sets [N, P, 3] with mask [N, P] →
    [N, out_features]: three Dense + ReLU, a max over the masked points,
    0 where a set has none."""

    def __init__(self, out_features: int = 512, in_features: int = 3):
        super().__init__()
        widths = (in_features, 64, 128, out_features)
        for i in range(3):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, points, mask):
        x = points
        for i in range(3):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        x = torch.where(mask[..., None], x, float("-inf")).amax(-2)
        return torch.where(torch.isfinite(x), x, 0.0)


class FusionModule(nn.Module):
    """Gated fusion of appearance and point embeddings
    (fusion_module_A)."""

    def __init__(self, out_features: int = 512):
        super().__init__()
        self.Dense_0 = nn.Linear(2 * out_features, out_features)
        self.Dense_1 = nn.Linear(out_features, out_features)

    def forward(self, appear, pts):
        gate = torch.sigmoid(self.Dense_0(torch.cat([appear, pts], -1)))
        fused = gate * appear + (1 - gate) * pts
        return torch.relu(self.Dense_1(fused))


class DetScoreHead(nn.Module):
    """w_det: per-detection confidence logit."""

    def __init__(self, in_features: int = 512):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, 256)
        self.Dense_1 = nn.Linear(256, 1)

    def forward(self, feats):
        return self.Dense_1(torch.relu(self.Dense_0(feats)))[..., 0]


class AffinityHead(nn.Module):
    """w_link (multiply affinity) + new/end indicator logits.

    feats1 [..., N1, F] (frame t), feats2 [..., N2, F] (frame t+1) → link
    logits [..., N1, N2], end logits [..., N1], new logits [..., N2]."""

    def __init__(self, in_features: int = 512):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, 256)
        self.Dense_1 = nn.Linear(256, 1)
        self.end_mlp = nn.Linear(in_features, 256)
        self.w_end = nn.Linear(256, 1)
        self.new_mlp = nn.Linear(in_features, 256)
        self.w_new = nn.Linear(256, 1)

    def forward(self, feats1, feats2):
        prod = feats1[..., :, None, :] * feats2[..., None, :, :]
        link = self.Dense_1(torch.relu(self.Dense_0(prod)))[..., 0]
        end = self.w_end(torch.relu(self.end_mlp(feats1)))[..., 0]
        new = self.w_new(torch.relu(self.new_mlp(feats2)))[..., 0]
        return link, end, new


class _Embed(nn.Module):
    """The submodules TrackNet and SequenceTrackNet share, by JAX's
    names."""

    def __init__(self, feature_dim: int = 512, crop_channels: int = 3):
        super().__init__()
        self.feature_dim = feature_dim
        self.appearance = AppearanceNet(feature_dim, crop_channels)
        self.point_net = PointNetFeat(feature_dim)
        self.fusion = FusionModule(feature_dim)
        self.w_det = DetScoreHead(feature_dim)
        self.w_link = AffinityHead(feature_dim)

    def embed(self, crops, points, pmask):
        """[N, H, W, C], [N, P, 3], [N, P] → fused features [N, F]."""
        return self.fusion(self.appearance(crops),
                           self.point_net(points, pmask))


class TrackNet(_Embed):
    """Full per-pair tracking net: embeddings + det scores + affinities."""

    def forward(self, crops1, points1, pmask1, crops2, points2, pmask2):
        f1 = self.embed(crops1, points1, pmask1)
        f2 = self.embed(crops2, points2, pmask2)
        link, end, new = self.w_link(f1, f2)
        return {"feats1": f1, "feats2": f2,
                "det_scores1": self.w_det(f1), "det_scores2": self.w_det(f2),
                "link_scores": link, "end_scores": end, "new_scores": new}


class SequenceTrackNet(_Embed):
    """TrackNet over a whole padded sequence: per-frame embeddings computed
    once, affinities for every consecutive frame pair.

    Inputs: crops [T, D, H, W, C], points [T, D, P, 3], pmask [T, D, P].
    Returns feats [T, D, F], det logits [T, D], link [T-1, D, D], end/new
    [T-1, D] — the shapes `tracking_train.tracking_loss` consumes."""

    def forward(self, crops, points, pmask):
        t, d = crops.shape[:2]
        feats = self.embed(crops.reshape(t * d, *crops.shape[2:]),
                           points.reshape(t * d, *points.shape[2:]),
                           pmask.reshape(t * d, *pmask.shape[2:]))
        feats = feats.reshape(t, d, self.feature_dim)
        link, end, new = self.w_link(feats[:-1], feats[1:])
        return {"feats": feats, "det_logits": self.w_det(feats),
                "link_logits": link, "end_logits": end, "new_logits": new}


class Tracker:
    """Host-side track-id management over frame pairs
    (assign_det_id / align_id / mem_assign_det_id semantics)."""

    def __init__(self, link_threshold: float = 0.0):
        self._next_id = 0
        self._prev_ids: Optional[np.ndarray] = None
        self._link_threshold = link_threshold

    def reset(self):
        self._next_id = 0
        self._prev_ids = None

    def step(self, matches, num_dets: int) -> np.ndarray:
        """Advance one frame.

        matches: [M, 2] (prev_det_idx, cur_det_idx) pairs from the solver.
        Returns track ids [num_dets] for the current frame.
        """
        ids = -np.ones(num_dets, np.int64)
        if self._prev_ids is not None:
            for p, c in matches:
                if 0 <= p < len(self._prev_ids) and 0 <= c < num_dets:
                    ids[c] = self._prev_ids[p]
        for i in range(num_dets):
            if ids[i] < 0:
                ids[i] = self._next_id
                self._next_id += 1
        if self._prev_ids is None:
            self._next_id = max(self._next_id, num_dets)
        self._prev_ids = ids
        return ids


class MemoryTracker:
    """Track-memory variant (`mem_assign_det_id`, spatio `:384-406`): tracks
    carry an embedding; a current det whose solver-chosen link column points
    at track t inherits t's id and refreshes its feature, otherwise it opens
    a new track."""

    def __init__(self):
        self.track_feats: list = []      # one embedding per ever-created id
        self.last_id = -1
        self._active_ids: Optional[np.ndarray] = None

    def reset(self):
        self.track_feats.clear()
        self.last_id = -1
        self._active_ids = None

    @property
    def active_feats(self) -> Optional[np.ndarray]:
        if self._active_ids is None or len(self._active_ids) == 0:
            return None
        return np.stack([self.track_feats[i] for i in self._active_ids])

    def step(self, matches, det_feats) -> np.ndarray:
        """matches: [M, 2] (active_track_idx, det_idx); det_feats [D, F].
        Returns track ids [D]."""
        det_feats = np.asarray(det_feats)
        num = len(det_feats)
        ids = -np.ones(num, np.int64)
        if self._active_ids is not None:
            for t, d in matches:
                if 0 <= t < len(self._active_ids) and 0 <= d < num:
                    ids[d] = self._active_ids[t]
        for d in range(num):
            if ids[d] < 0:
                self.last_id += 1
                ids[d] = self.last_id
                self.track_feats.append(det_feats[d])
            else:
                self.track_feats[ids[d]] = det_feats[d]
        self._active_ids = ids
        return ids


class SequenceStitcher:
    """Stitch per-window track ids into sequence-global ids — the
    reference's ``align_id`` (spatio `:407-516`) with its three cases:

    - sequence start: adopt the window's ids verbatim;
    - discontinuity (window does not start at the last stitched frame + 1
      overlap): offset every window id past the largest id seen;
    - one-frame overlap: pair dets of the shared frame by exact box
      identity, map overlap ids onto the already-stitched ids, allocate
      fresh ids for window ids with no pairing.

    `frames_id` / `frames_det` accumulate the per-frame stitched output in
    the shape `viewer`/result-writer code consumes.
    """

    def __init__(self):
        self.frames_id: list = []        # list of np.ndarray per frame
        self.frames_det: list = []       # list of det dicts per frame
        self.last_id = -1

    def reset(self):
        self.frames_id.clear()
        self.frames_det.clear()
        self.last_id = -1

    # overlap-frame detections come from two window evaluations of the SAME
    # frame, so they should coincide — but post-processing may differ at
    # float precision between windows; pair by proximity, not bit-equality
    MATCH_TOL = 0.5          # metres on location / px on bbox corners

    @classmethod
    def _same_det(cls, det_a: dict, i: int, det_b: dict, j: int) -> bool:
        matched_any = False
        for key in ("location", "bbox"):
            if key in det_a and key in det_b:
                a, b = np.asarray(det_a[key]), np.asarray(det_b[key])
                if len(a) and len(b):
                    if np.abs(np.asarray(a[i], np.float64) -
                              np.asarray(b[j], np.float64)).max() \
                            > cls.MATCH_TOL:
                        return False
                    matched_any = True
        return matched_any or not ("location" in det_a or "bbox" in det_a)

    def _bump(self, ids) -> None:
        for arr in ids:
            if len(arr):
                self.last_id = max(self.last_id, int(np.max(arr)))

    def update(self, window_ids, window_dets, frame_indices):
        """window_ids: list of per-frame int arrays from a tracking window;
        window_dets: parallel list of det dicts (must carry 'frame_idx' and
        the keys used for overlap pairing); frame_indices: global frame
        numbers of the window. Returns stitched ids for the frames newly
        appended."""
        window_ids = [np.asarray(w, np.int64).copy() for w in window_ids]
        if not self.frames_det:
            self.frames_id += window_ids
            self.frames_det += list(window_dets)
            self._bump(window_ids)
            return window_ids
        prev_frame = self.frames_det[-1].get("frame_idx")
        if prev_frame != window_dets[0].get("frame_idx"):
            # discontinuous: shift the whole window past every used id
            offset = self.last_id + 1
            shifted = [w + offset if len(w) else w for w in window_ids]
            self.frames_id += shifted
            self.frames_det += list(window_dets)
            self._bump(shifted)
            return shifted
        # one-frame overlap: map ids of the shared frame
        id_pairs = {}
        prev_ids = self.frames_id[-1]
        prev_det = self.frames_det[-1]
        for i, wid in enumerate(window_ids[0]):
            matched = False
            for j in range(len(prev_ids)):
                if self._same_det(window_dets[0], i, prev_det, j):
                    id_pairs[int(wid)] = int(prev_ids[j])
                    matched = True
                    break
            if not matched:
                self.last_id += 1
                id_pairs[int(wid)] = self.last_id
        out = []
        for w, det in zip(window_ids[1:], list(window_dets)[1:]):
            new_ids = w.copy()
            for k in range(len(w)):
                key = int(w[k])
                if key not in id_pairs:
                    self.last_id += 1
                    id_pairs[key] = self.last_id
                new_ids[k] = id_pairs[key]
            out.append(new_ids)
            self.frames_id.append(new_ids)
            self.frames_det.append(det)
            self._bump([new_ids])
        return out
