"""Planted tables for the greedy matcher and the grouping fold, made with
numpy from a seed (no JAX, so ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` use them on the card too).

Matcher cases (``match_tables``): quantized scores that tie exactly,
tables with nothing valid, every score ``-inf``, ``n_a = 0``, and a full
limb (every candidate valid and distinct, K connections taken).  Fold cases
(``fold_tables``): dense random connections over few slots, so that
subsets collide: merges, two-subset fills, connections that match three
subsets, the non-spawning limbs and, with a small table, spawns refused by
a full one; ``fold_steps`` replays which case each connection takes.
Over ``WIDE_SLOTS`` slots ``fold_tables`` spawns over 32 subsets a frame.
The crowd (``crowd_tables``): 32 people at K = 32, every limb of every
person connected, the most fold steps the default K allows (19 x 32 =
608); ``full_limb`` at K = 32 is the matcher's crowd (32 steps a limb).
"""

import numpy as np

from tpupose_torch.config import (LIMBS_FROM, LIMBS_TO, NON_SPAWNING_LIMBS,
                                  NUM_JOINTS, NUM_LIMBS)

MATCH_CASES = ("ties", "none_valid", "all_neg_inf", "n_a_zero", "full_limb")
# (seed, max_subsets): the small table saturates
FOLD_CASES = tuple((seed, cap) for seed in (0, 1, 2) for cap in (4, 64))
FOLD_SLOTS = 4
WIDE_SLOTS = 12  # fold_tables over 12 slots: over 32 subsets a frame


def match_tables(rng, name, lead=(3, NUM_LIMBS), k=8):
    """(score (*lead, K, K) float32, valid bool, n_a (*lead), n_b int64)."""
    lead = tuple(lead)
    score = rng.randint(0, 4, lead + (k, k)).astype(np.float32) / 4.0
    n_a = rng.randint(0, k + 1, lead)
    n_b = rng.randint(0, k + 1, lead)
    valid = rng.rand(*lead, k, k) < rng.uniform(0.2, 0.9, lead + (1, 1))
    if name == "none_valid":
        valid[:] = False
    elif name == "all_neg_inf":
        score[:] = -np.inf
    elif name == "n_a_zero":
        n_a[:] = 0
    elif name == "full_limb":
        score = rng.permutation(score.size).reshape(score.shape).astype(
            np.float32) / (k * k)
        valid[:] = True
        n_a[:] = n_b[:] = k
    elif name != "ties":
        raise ValueError(name)
    if name != "full_limb":
        for idx in np.ndindex(*lead):
            valid[idx][n_a[idx]:, :] = False
            valid[idx][:, n_b[idx]:] = False
    return score, valid, n_a.astype(np.int64), n_b.astype(np.int64)


def fold_tables(rng, lead=(3,), k=FOLD_SLOTS, n_limbs=NUM_LIMBS,
                n_joints=NUM_JOINTS):
    """(a_slot, b_slot (*lead, L, K) int64, conn score float32, valid bool,
    peak scores (*lead, J, K) float32); valid entries anywhere in a row,
    slots in [0, K), -1 where invalid.  L and J are COCO's unless given."""
    shape = tuple(lead) + (n_limbs, k)
    a = rng.randint(0, k, shape)
    b = rng.randint(0, k, shape)
    valid = rng.rand(*shape) < 0.7
    a[~valid] = -1
    b[~valid] = -1
    score = rng.uniform(0.05, 1.0, shape).astype(np.float32)
    peaks = rng.uniform(0.05, 1.0, tuple(lead) + (n_joints, k)).astype(
        np.float32)
    return a.astype(np.int64), b.astype(np.int64), score, valid, peaks


def crowd_tables(rng, lead=(1,), people=32, k=32, n_limbs=NUM_LIMBS,
                 n_joints=NUM_JOINTS):
    """A crowd in ``fold_tables``' layout: person p holds peak slot p on
    every joint, and every limb carries the valid connection (p, p) with a
    seeded score, so each limb row holds ``people`` valid connections."""
    shape = tuple(lead) + (n_limbs, k)
    slots = np.broadcast_to(np.arange(k), shape)
    valid = slots < people
    a = np.where(valid, slots, -1).astype(np.int64)
    score = rng.uniform(0.05, 1.0, shape).astype(np.float32)
    peaks = rng.uniform(0.05, 1.0, tuple(lead) + (n_joints, k)).astype(
        np.float32)
    return a, a.copy(), score, valid.copy(), peaks


FOLD_CASE_NAMES = ("spawn", "attach", "merge", "fill", "ignore", "no spawn")


def fold_steps(a, b, valid):
    """The case (an index of ``FOLD_CASE_NAMES``) each valid connection of
    one frame's (L, K) table takes in the fold, by a replay of the subset
    membership alone (an unbounded table)."""
    rows, cases = [], []
    for l in range(a.shape[0]):
        ja, jb = LIMBS_FROM[l], LIMBS_TO[l]
        for c in range(a.shape[1]):
            if not valid[l, c]:
                continue
            ia, ib = a[l, c], b[l, c]
            hit = [r for r in rows if r[ja] == ia or r[jb] == ib]
            if len(hit) == 1:
                hit[0][jb] = ib
                cases.append(1)
            elif len(hit) == 2:
                r1, r2 = hit
                if all(x < 0 or y < 0 for x, y in zip(r1, r2)):
                    r1[:] = [x + y + 1 for x, y in zip(r1, r2)]
                    rows.remove(r2)
                    cases.append(2)
                else:
                    for r in hit:
                        if r[ja] == -1:
                            r[ja] = ia
                        elif r[jb] == -1:
                            r[jb] = ib
                    cases.append(3)
            elif hit:
                cases.append(4)
            elif l in NON_SPAWNING_LIMBS:
                cases.append(5)
            else:
                row = [-1] * NUM_JOINTS
                row[ja], row[jb] = ia, ib
                rows.append(row)
                cases.append(0)
    return cases
