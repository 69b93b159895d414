"""Greedy keypoint-to-person grouping (port of ``tpupose/ops/grouping.py``).

Connections are folded one at a time (limbs in topology order, accepted
connections in greedy order) into a fixed table of person subsets, with the
reference's four cases and its order: new subsets take the next free slot
and merged-away slots go inactive, so slots are visited in the reference's
creation order.

The fold is sequential.  On the card it is one kernel launch for all the
frames (``ops/group_fold.py``, ``csrc/group_fold.cu``), which loops on the
device as the JAX package's ``while_loop`` does.  ``fold_connections``
below is its plain version: its trip count, the number of valid
connections, is read to the host once per frame, together with their
compacted order; every step then runs as branch-free tensor ops on the
tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpupose_torch.config import InferenceConfig
from tpupose_torch.ops.paf import Connections
from tpupose_torch.ops.peaks import Peaks
from tpupose_torch.topology import COCO18, Topology


class Subsets(NamedTuple):
    """Fixed-shape person-subset table.

    joint_slot: (..., S, J) int64 — peak slot per joint, -1 if absent
    score:      (..., S) float32 — accumulated peak + connection score
    count:      (..., S) float32 — joint count.  Float because the
                reference's merge adds the connection score to it too
                (``pose_detector.py:215-217``), a quirk kept for parity.
    valid:      (..., S) bool — survives the final limb-count/score filter
    spawns_suppressed: (...) int64 — spawns refused by a full table
    """

    joint_slot: torch.Tensor
    score: torch.Tensor
    count: torch.Tensor
    valid: torch.Tensor
    spawns_suppressed: torch.Tensor


def group_keypoints(connections: Connections, peaks: Peaks,
                    cfg: InferenceConfig,
                    topology: Topology = COCO18) -> Subsets:
    """Fold all valid connections into subsets (the plain version, on
    every device; the pipeline calls ``ops/library.py::group_keypoints``)."""
    return fold_connections(connections.a_slot, connections.b_slot,
                            connections.score, connections.valid,
                            peaks.score, cfg.max_subsets,
                            cfg.n_subset_limbs_thresh,
                            cfg.subset_score_thresh, topology)


def fold_connections(a_slot: torch.Tensor, b_slot: torch.Tensor,
                     conn_scores: torch.Tensor, conn_valid: torch.Tensor,
                     peak_score: torch.Tensor, max_subsets: int,
                     n_subset_limbs_thresh, subset_score_thresh,
                     topology: Topology = COCO18) -> Subsets:
    """:func:`group_keypoints` on the tensors it reads: the connections'
    (..., L, K) slots, scores and validity, the peaks' (..., J, K) scores,
    and the config's table size and final filter; frame by frame over the
    leading axes.  Pair ``l`` joins parts ``topology.limbs[l]``.  The plain
    version of ``ops/group_fold.py``'s kernel."""
    lead = a_slot.shape[:-2]
    if lead:
        frames = [_fold_frame(*(t.reshape(-1, *t.shape[-2:])[i] for t in (
            a_slot, b_slot, conn_scores, conn_valid, peak_score)),
            max_subsets, n_subset_limbs_thresh, subset_score_thresh,
            topology)
            for i in range(int(np.prod(lead, dtype=np.int64)))]
        return Subsets(*(torch.stack(f).reshape(*lead, *f[0].shape)
                         for f in zip(*frames)))
    return _fold_frame(a_slot, b_slot, conn_scores, conn_valid, peak_score,
                       max_subsets, n_subset_limbs_thresh,
                       subset_score_thresh, topology)


def _fold_frame(a_slot, b_slot, conn_scores, conn_valid, peak_score,
                max_subsets, n_subset_limbs_thresh, subset_score_thresh,
                topology: Topology) -> Subsets:
    """One frame's fold: (L, K) connections, (J, K) peak scores."""
    k = a_slot.shape[1]
    s_cap = max_subsets
    dev = a_slot.device

    flat_valid = conn_valid.reshape(-1)
    # Stable partition: valid connections first, in (limb, greedy) order.
    # The one host sync of the fold: its trip count and visiting order.
    order = torch.argsort((~flat_valid).to(torch.uint8), stable=True)
    host = torch.cat([flat_valid.sum()[None], order]).tolist()
    order = host[1:1 + host[0]]

    a_slot = a_slot.reshape(-1)
    b_slot = b_slot.reshape(-1)
    conn_scores = conn_scores.reshape(-1)
    rows = torch.arange(s_cap, device=dev)

    joint_slot = torch.full((s_cap, topology.num_joints), -1,
                            dtype=torch.long, device=dev)
    score = torch.zeros(s_cap, dtype=torch.float32, device=dev)
    count = torch.zeros(s_cap, dtype=torch.float32, device=dev)
    active = torch.zeros(s_cap, dtype=torch.bool, device=dev)
    n_created = torch.zeros((), dtype=torch.long, device=dev)
    n_suppressed = torch.zeros((), dtype=torch.long, device=dev)

    for idx in order:
        limb = idx // k
        ja, jb = topology.limbs[limb]
        ind_a, ind_b = a_slot[idx], b_slot[idx]
        conn_score = conn_scores[idx]
        peak_score_a = peak_score[ja][ind_a]
        peak_score_b = peak_score[jb][ind_b]

        match = active & ((joint_slot[:, ja] == ind_a)
                          | (joint_slot[:, jb] == ind_b))
        cnt = match.sum()
        s1 = torch.argmax(match.to(torch.uint8))        # first match
        s2 = torch.argmax((match & (rows != s1)).to(torch.uint8))  # second
        at1 = rows == s1
        at2 = rows == s2

        # --- case 1: one subset holds an endpoint -> attach joint_b ---
        do1 = (cnt == 1) & (joint_slot[s1, jb] != ind_b)
        sel = at1 & do1
        joint_slot[:, jb] = torch.where(sel, ind_b, joint_slot[:, jb])
        count = count + sel.float()
        score = torch.where(sel, score + (peak_score_b + conn_score), score)

        # --- case 2: two subsets ---
        is2 = cnt == 2
        disjoint = ~((joint_slot[s1] >= 0) & (joint_slot[s2] >= 0)).any()
        # 2a: merge s2 into s1, deactivate s2.  The count column takes the
        # connection score too (reference quirk).
        do_merge = is2 & disjoint
        merged = joint_slot[s1] + joint_slot[s2] + 1
        m1 = (at1 & do_merge)[:, None]
        m2 = (at2 & do_merge)[:, None]
        joint_slot = torch.where(m1, merged[None, :], joint_slot)
        joint_slot = torch.where(m2, -1, joint_slot)
        score = torch.where(m1[:, 0], score + (score[s2] + conn_score),
                            score)
        count = torch.where(m1[:, 0], count + (count[s2] + conn_score),
                            count)
        score = torch.where(m2[:, 0], 0.0, score)
        count = torch.where(m2[:, 0], 0.0, count)
        active = active & ~m2[:, 0]

        # 2b: overlapping membership -> in each of s1, s2 set joint_a if it
        # is missing, else joint_b if that is missing.
        do_fill = is2 & ~disjoint
        for slot, at in ((s1, at1), (s2, at2)):
            a_missing = joint_slot[slot, ja] == -1
            b_missing = joint_slot[slot, jb] == -1
            set_a = at & (do_fill & a_missing)
            set_b = at & (do_fill & ~a_missing & b_missing)
            joint_slot[:, ja] = torch.where(set_a, ind_a, joint_slot[:, ja])
            joint_slot[:, jb] = torch.where(set_b, ind_b, joint_slot[:, jb])
            add = torch.where(set_a, peak_score_a + conn_score,
                              torch.where(set_b, peak_score_b + conn_score,
                                          0.0))
            count = count + (set_a | set_b).float()
            score = score + add

        # --- case 0: spawn a new subset (not for shoulder-ear limbs) ---
        if limb not in topology.non_spawning:
            want_new = cnt == 0
            do_new = want_new & (n_created < s_cap)
            n_suppressed = n_suppressed + (want_new
                                           & (n_created >= s_cap)).long()
            new = (rows == torch.clamp(n_created, max=s_cap - 1)) & do_new
            joint_slot[:, ja] = torch.where(new, ind_a, joint_slot[:, ja])
            joint_slot[:, jb] = torch.where(new, ind_b, joint_slot[:, jb])
            count = torch.where(new, 2.0, count)
            score = torch.where(
                new, peak_score_a + peak_score_b + conn_score, score)
            active = active | new
            n_created = n_created + do_new.long()

    # Final filter (ref ``pose_detector.py:248``).
    safe_count = torch.clamp(count, min=1.0)
    keep = (active & (count >= n_subset_limbs_thresh)
            & (score / safe_count >= subset_score_thresh))
    return Subsets(joint_slot=joint_slot, score=score, count=count,
                   valid=keep, spawns_suppressed=n_suppressed)


def subsets_to_poses(subsets: Subsets, peaks: Peaks
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subset table -> (poses (..., S, J, 3) of (x, y, v), person_valid
    (..., S)).

    v = 2 for present joints; absent joints and invalid persons are zero
    rows.  Scores stay ``subsets.score`` (the raw accumulated score)."""
    slots = subsets.joint_slot.clamp(min=0)

    def at_slots(table):        # (..., J, K) -> (..., S, J)
        return torch.gather(table.transpose(-1, -2), -2, slots)

    xs, ys = at_slots(peaks.x), at_slots(peaks.y)
    present = (subsets.joint_slot >= 0) & subsets.valid[..., None]
    zero = torch.zeros_like(xs)
    poses = torch.stack([torch.where(present, xs, zero),
                         torch.where(present, ys, zero),
                         torch.where(present, 2.0, zero)], dim=-1)
    return poses, subsets.valid
