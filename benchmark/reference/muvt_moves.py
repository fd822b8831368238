"""Plain reference for what the grand-canonical (muVT) cells' moves accept:
the expected acceptance E[min(1, a)] of each kind of trial move at given
configurations, estimated in float64 from trial moves drawn from a
generator of its own (rigid_moves.py's estimator, with the exchanges of
one box at a fixed activity in place of its Gibbs transfers).  Written
afresh from the configuration and traffic files; it imports nothing of
the port.

Translations and rotations are rigid_moves.py's (`displacement`): every
active molecule is attempted alike, so a row weighs by its molecule
count.  An exchange attempt is an insertion or a deletion with
probability 1/2 each, and every chain attempts alike, so

    xfer = 1/2 (p_ins + p_del), averaged over the rows,

with z the activity (A^-3), V = L^3, N the row's active molecules and
beta = 1 / T:

* insertion: a uniform position in the box and a uniform random
  orientation, a = z V / (N + 1) exp(-beta dU); p_ins = E[min(1, a)] over
  such trials, 0 at N = capacity (no free slot);
* deletion: an active molecule picked uniformly, a = N / (z V)
  exp(-beta dU); p_del = E[min(1, a)] over such picks, 0 at N = 0.  The
  expectation is taken exactly, as the mean over every active molecule
  of the row (no draw), so that only the insertions carry sampling noise.

dU follows rigid_ewald's energy: the molecule's site pairs with the other
active molecules inside the cutoff at the minimum image (LJ and real-
space Ewald), the change of the reciprocal sum from the molecule's S(k)
row, its self and intramolecular terms (+ on insertion, - on deletion),
and the LJ tail's change with N where the configuration asks for it.
The port refuses an insertion that puts two opposite charges closer than
0.707 A; such a pose also brings two oxygens within 1.71 A, whose LJ
repulsion alone makes beta dU exceed 1000 at these temperatures, so its
a is 0 in float64 here too and the veto needs no term of its own.
"""

import torch

from benchmark.reference.rigid_ewald import evaluate, rotation
from benchmark.reference.rigid_moves import (
    F64,
    _Model,
    _u,
    _unit,
    displacement,
    seeded,
)

__all__ = ["insertion", "deletion", "expected", "seeded"]


def _exchange_terms(mdl, st, ev):
    """(box, active, N, cf, self + intra, tail coefficient) of the rows
    of st."""
    box = st["box"].double()
    act = st["active"]
    return (box, act, act.sum(1).double(), mdl.cf(box), mdl.self_intra(box),
            mdl.lrc_coef(box))


def insertion(mdl, st, ev, temp, z, n, gen):
    """(B,) mean acceptance of n insertion trials of each row (module
    docstring); st a check row (com, quat, box, active), ev rigid_ewald's
    float64 evaluation of it."""
    box, act, nb, cf, si, lc = _exchange_terms(mdl, st, ev)
    B, cap = act.shape
    dev = box.device
    s_re, s_im = ev["sfac"][..., 0], ev["sfac"][..., 1]
    pos = _u((B, n, 3), gen, dev) * box[:, None, None]
    rot = rotation(_unit((B, n), gen, dev, 4))               # (B, n, 3, 3)
    x = pos[:, :, None, :] + torch.einsum("btij,pj->btpi", rot, mdl.body)
    u = mdl.pair(x, ev["sites"], act[:, None, :].expand(B, n, cap), box)
    i_re, i_im = mdl.sfac_rows(x, box)
    du = u + mdl.recip_delta(s_re, s_im, i_re, i_im, cf) \
        + (si + lc * (2.0 * nb + 1.0))[:, None]
    log_a = torch.log(z * box ** 3 / (nb + 1.0))[:, None] - du / temp
    p = torch.exp(torch.clamp_max(log_a, 0.0)).mean(1)
    return torch.where(nb < cap - 0.5, p, 0.0)


def deletion(mdl, st, ev, temp, z):
    """(B,) mean acceptance of the deletion of each active molecule of
    each row (module docstring)."""
    box, act, nb, cf, si, lc = _exchange_terms(mdl, st, ev)
    B, cap = act.shape
    dev = box.device
    s_re, s_im = ev["sfac"][..., 0], ev["sfac"][..., 1]
    x = ev["sites"]                                           # (B, M, P, 3)
    slots = torch.arange(cap, device=dev)
    on = act[:, None, :] & (slots[None, :, None] != slots[None, None, :])
    u = mdl.pair(x, ev["sites"], on, box)
    d_re, d_im = mdl.sfac_rows(x, box)
    du = -u + mdl.recip_delta(s_re, s_im, -d_re, -d_im, cf) \
        + (-si + lc * (-2.0 * nb + 1.0))[:, None]
    log_a = torch.log(torch.clamp_min(nb, 1.0) / (z * box ** 3))[:, None] \
        - du / temp
    p = torch.where(act, torch.exp(torch.clamp_max(log_a, 0.0)), 0.0)
    return p.sum(1) / torch.clamp_min(nb, 1.0)


def expected(ensemble, state, config, moves, trials, gen):
    """{kind: expected acceptance} at one state (a check row: com, quat,
    box, active) of a muVT cell: "trans" and "rot" weighed by the rows'
    molecule counts, "xfer" the rows' mean of (p_ins + p_del) / 2.  moves:
    the traffic's move mix; trials: per row, "move" translations and as
    many rotations, "exchange" insertions (the deletions are every active
    molecule)."""
    if ensemble != "muvt":
        raise ValueError(f"ensemble {ensemble!r}: muvt_moves has muvt")
    model, params = config["model"], config["params"]
    dev = state["com"].device
    mdl = _Model(model, params, dev)
    temp, z = float(config["temperature"]), float(config["activity"])
    ev = evaluate(state["com"], state["quat"], state["box"], state["active"],
                  model, params, F64)
    p_t, p_r, n_mol = displacement(mdl, state, ev, temp,
                                   float(moves["dr_max"]),
                                   float(moves["dphi_max"]),
                                   int(trials["move"]), gen)
    w = n_mol / n_mol.sum().clamp_min(1.0)
    out = {"trans": float((w * p_t).sum())}
    if mdl.P > 1 and float(moves["p_translate"]) < 1.0:
        out["rot"] = float((w * p_r).sum())
    n_x = int(trials["exchange"])
    p_ins = insertion(mdl, state, ev, temp, z, n_x, gen)
    p_del = deletion(mdl, state, ev, temp, z)
    out["xfer"] = float((0.5 * (p_ins + p_del)).mean())
    return out
