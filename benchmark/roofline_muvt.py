"""The least time of one grand-canonical cycle of the sweep kernel on one
H100: roofline.py's arithmetic (its peaks, operation counts and `bound`)
applied to one box with an activity mask and exchange attempts, counted
as `roofline.gibbs_bound` counts one of its two boxes.

A cycle of one chain is one launch: each of the t.M slots is visited
once, an active slot's move summing its old and new poses against the
other active atoms and every k-vector (an empty slot's null move does no
pair or k-space work), then n_exch exchange attempts, half insertions
and half deletions.  An attempt sums one pose (the trial insertion, or
the deletion candidate's present pose) against the active atoms and
every k-vector; a deletion first scores the active slots with Philox to
pick its candidate.  The bytes are the chain state read and written
once, the uniforms and constants read once, counted over the real atoms
of the configuration (not the padded width of the port's layout).
"""

from benchmark.roofline import (
    OPS_COULOMB,
    OPS_GEOMETRY,
    OPS_K_MOVE,
    OPS_LJ,
    OPS_PHILOX,
    bound,
    k_pose_ops,
)


def muvt_bound(t, C, K, n, frac, near, n_exch):
    """The least time (ms) of one muVT cycle of C chains, and what sets it
    ("bytes" | "operations").

    t: the roofline.Block of the species (t.M the slots); K the
    k-vectors; n (C,) the active slots of each chain; frac the share of
    the active site pairs inside the cutoff, near the share within a
    pose's reach (roofline.cutoff_fraction, reach_fraction); n_exch the
    exchange attempts of a cycle.

    Terms, per chain:
      bytes   the state in and out once: x, y, z and activity of the
              t.M t.P atoms, centre (3), quaternion (4) and activity of
              the slots, the S(k) row (2 K); the slot moves' uniforms (10
              a slot) and the attempts' (8 each); box, temperature, step
              sizes (4), the activity and the two exchange constants (3)
              and the statistics written (9);
      moves   each active slot once: its old and new poses, each one
              distance to every other active molecule's centre
              (OPS_GEOMETRY) and, for the share near within reach, t.P
              site distances a site, with the terms of the share frac
              inside the cutoff; two S(k) rows and the energy cross term
              over K (k_pose_ops, OPS_K_MOVE);
      attempts  one pose at the same per-pair cost against the active
              molecules (an insertion's n, a deletion's n - 1 others:
              n - 1/2 on average), one S(k) row and the cross term, and
              half of them (the deletions) Philox scores of the active
              slots.
    """
    lj = t.n_lj
    qf = t.n_q if t.coulomb != "none" else 0
    ewald = t.coulomb == "ewald"
    A = t.M * t.P
    state = 4 * A + 8 * t.M + 2 * K
    nbytes = 4 * C * (2 * state + 10 * t.M + 8 * n_exch + 4 + 3 + 9)
    n = n.double()
    c_pair = OPS_GEOMETRY + near * t.P * OPS_GEOMETRY + frac * (
        lj * OPS_LJ + qf * OPS_COULOMB)
    pairs = float((n * (n - 1.0)).sum()) * t.P * c_pair
    k_move = 2 * k_pose_ops(K, t.nk, qf) + K * OPS_K_MOVE if ewald else 0
    ops = 2 * pairs + float(n.sum()) * k_move
    k_pose = k_pose_ops(K, t.nk, qf) + K * OPS_K_MOVE if ewald else 0
    n_mean = float(n.mean())
    ops += C * n_exch * (max(n_mean - 0.5, 0.0) * t.P * c_pair + k_pose
                         + 0.5 * n_mean * OPS_PHILOX)
    return bound(nbytes, ops)
