"""Plain reference for what the cells' Metropolis moves accept: the
expected acceptance E[min(1, a)] of each kind of trial move at given
configurations, estimated from trial moves drawn from a generator of its
own, in float64.  A correct sampler accepts, of the attempts of one kind
over a block, the share this expectation gives averaged over the states
the block passes through; check.py holds the program's acceptance counts
against it, taken at the states around each block.  Written afresh from
the configuration and traffic files; it imports nothing of the port.

Trial moves (symmetric proposals) and their acceptance a:

* translation: the centre moved by (u - 1/2) dr_max along each axis;
  rotation: the molecule turned about its centre by (2 u - 1) dphi_max
  about a uniform random axis; a = exp(-beta dU).  Every active molecule
  is attempted alike, so a box's trials pick its molecules uniformly and
  boxes weigh by their molecule counts;
* volume at fixed N and pressure P: ln V' = ln V + (2 u - 1) dv_max, the
  centres scaled with the box, a = exp(-beta (dU + P dV) + (N + 1)
  ln(V'/V)); a box under the minimum-image wall is refused (a = 0);
* Gibbs volume exchange at fixed total volume: V_0' = V_0 + dV, V_1' =
  V_1 - dV with dV = (2 u - 1) dv_max (V_0 + V_1), a = prod_b (V_b' /
  V_b)^N_b exp(-beta dU); a box at or under the wall, or V' <= 0, is
  refused;
* Gibbs transfer: the source box either box with probability 1/2, one of
  its molecules picked uniformly, inserted into the other box at a
  uniform position with a uniform random orientation; a = N_s V_d /
  ((N_d + 1) V_s) exp(-beta dU); refused when the source is empty or the
  destination full.

dU follows rigid_ewald's energy: a molecule's site pairs with the other
active molecules inside the cutoff at the minimum image (LJ and real-
space Ewald), the change of the reciprocal sum from the molecule's S(k)
row, and, where a molecule enters or leaves a box, its self and
intramolecular terms and the LJ tail's change with N; a volume move
evaluates the scaled configurations whole.
"""

import math

import torch

from benchmark.reference.rigid_ewald import (
    COULOMB_K_A, Precision, _lrc_sum, _site_arrays, body_frame, evaluate,
    kvectors, rotation)

F64 = Precision("float64")
K_B = 1.380649e-23              # J / K
BAR_IN_K_PER_A3 = 1.0e5 / K_B * 1.0e-30


class _Model:
    """A configuration's site constants, k-vectors and cutoff, float64 on
    one device."""

    def __init__(self, model, params, dev):
        dt = torch.float64
        self.model, self.params = model, params
        self.body = torch.as_tensor(body_frame(model), dtype=dt, device=dev)
        self.P = self.body.shape[0]
        self.q, self.eps, self.sig = _site_arrays(model, dev, dt)
        nvec, wts = kvectors(int(params["nk"]), int(params["ksq_max"]))
        self.n = torch.as_tensor(nvec, dtype=dt, device=dev)
        self.w = torch.as_tensor(wts, dtype=dt, device=dev)
        self.rc = float(params["r_cut"])
        self.kappa_l = float(params["kappa_L"])
        self.lrc = _lrc_sum(self.eps.cpu(), self.sig.cpu(), self.rc) \
            if params.get("use_lrc", False) else 0.0
        strict = params.get("strict_min_image", True)
        self.wall = 2.0 * self.rc if strict else 0.0

    def kappa(self, box):
        return self.kappa_l / box

    def cf(self, box):
        """(B, K) reciprocal coefficients without the Coulomb factor."""
        tpl = 2.0 * math.pi / box
        k2 = tpl[:, None] ** 2 * (self.n * self.n).sum(-1)[None, :]
        kap = self.kappa(box)[:, None]
        return self.w[None, :] * (2.0 * math.pi / box ** 3)[:, None] \
            * torch.exp(-k2 / (4.0 * kap * kap)) / k2

    def self_intra(self, box):
        """(B,) one molecule's Ewald self and intramolecular terms."""
        kap = self.kappa(box)
        e = -kap / math.sqrt(math.pi) * float((self.q * self.q).sum())
        for i in range(self.P):
            for j in range(i + 1, self.P):
                r = float(torch.linalg.vector_norm(self.body[i]
                                                   - self.body[j]))
                e = e - float(self.q[i] * self.q[j]) \
                    * torch.special.erf(kap * r) / r
        return COULOMB_K_A * e

    def lrc_coef(self, box):
        """(B,) the LJ tail per N^2."""
        return 8.0 * math.pi / (3.0 * box ** 3) * self.lrc

    def sfac_rows(self, x, box):
        """S(k) rows (re, im), each (B, T, K), of molecules x (B, T, P, 3)."""
        ph = (2.0 * math.pi / box)[:, None, None, None] \
            * torch.einsum("btpd,kd->btpk", x, self.n)
        return (torch.einsum("p,btpk->btk", self.q, torch.cos(ph)),
                torch.einsum("p,btpk->btk", self.q, torch.sin(ph)))

    def pair(self, x, sites, on, box, chunk=1 << 22):
        """(B, T) LJ and real-space Ewald energy of each trial molecule x
        (B, T, P, 3) with the molecules of its configuration sites (B, M,
        P, 3) that on (B, T, M) marks."""
        B, T, P = x.shape[:3]
        M = sites.shape[1]
        A = M * P
        xa = sites.reshape(B, A, 3)
        qa, ea, sa = (v.repeat(M) for v in (self.q, self.eps, self.sig))
        qq = self.q[:, None] * qa[None, :]
        e_ij = torch.sqrt(self.eps[:, None] * ea[None, :])
        s_ij = 0.5 * (self.sig[:, None] + sa[None, :])
        kap = self.kappa(box)
        out = torch.zeros((B, T), dtype=x.dtype, device=x.device)
        per = max(1, chunk // (P * A))        # (row, trial) pairs a step
        bs = min(B, per)
        ts = max(1, per // bs)
        for b0 in range(0, B, bs):
            b1 = min(B, b0 + bs)
            L = box[b0:b1, None, None, None, None]
            k = kap[b0:b1, None, None, None]
            for t0 in range(0, T, ts):
                t1 = min(T, t0 + ts)
                d = x[b0:b1, t0:t1, :, None, :] - xa[b0:b1, None, None]
                d = d - L * torch.round(d / L)
                d2 = (d * d).sum(-1)                      # (b, t, P, A)
                inside = on[b0:b1, t0:t1].repeat_interleave(P, dim=2)[
                    :, :, None, :] & (d2 < self.rc * self.rc)
                d2 = torch.where(inside, d2, torch.ones_like(d2))
                r = torch.sqrt(d2)
                coul = qq * torch.special.erfc(k * r) / r
                s6 = (s_ij * s_ij / d2) ** 3
                lj = 4.0 * e_ij * (s6 * s6 - s6)
                term = torch.where(inside, COULOMB_K_A * coul + lj, 0.0)
                out[b0:b1, t0:t1] = term.sum((2, 3))
        return out

    def recip_delta(self, s_re, s_im, d_re, d_im, cf):
        """Change of the reciprocal energy when the rows (d_re, d_im) (B,
        T, K) add to S (B, K)."""
        n_re, n_im = s_re[:, None] + d_re, s_im[:, None] + d_im
        return COULOMB_K_A * (cf[:, None] * (n_re * n_re + n_im * n_im
                                             - (s_re * s_re + s_im
                                                * s_im)[:, None])).sum(-1)


def _pick(active, n, gen):
    """(B, n) molecules drawn uniformly from each row's active ones (from
    every slot where a row has none: such a row's trials weigh nothing)."""
    w = active.to(torch.float64)
    w = torch.where(w.sum(1, keepdim=True) > 0, w, torch.ones_like(w))
    return torch.multinomial(w, n, replacement=True, generator=gen)


def _unit(shape, gen, dev, dim):
    g = torch.randn(shape + (dim,), generator=gen, device=dev,
                    dtype=torch.float64)
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


def _u(shape, gen, dev):
    return torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)


def _rotate(v, axis, ang):
    """v (..., 3) turned by ang (...) about the unit axis (..., 3)
    (Rodrigues)."""
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    return v * c + torch.cross(axis, v, dim=-1) * s \
        + axis * (axis * v).sum(-1, keepdim=True) * (1.0 - c)


def _gather(x, idx):
    """x (B, M, ...) at idx (B, T) -> (B, T, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def displacement(mdl, st, ev, temp, dr_max, dphi_max, n, gen):
    """Per row of st: ((B,) mean acceptance of translations, (B,) of
    rotations, (B,) active molecules).  ev is rigid_ewald's float64
    evaluation of st (sites, sfac)."""
    com, box = st["com"].double(), st["box"].double()
    B, M = com.shape[:2]
    dev = com.device
    active = st["active"] if st["active"] is not None \
        else torch.ones((B, M), dtype=torch.bool, device=dev)
    sites = ev["sites"]
    s_re, s_im = ev["sfac"][..., 0], ev["sfac"][..., 1]
    cf = mdl.cf(box)
    beta = 1.0 / temp
    out = []
    for kind in ("trans", "rot"):
        m = _pick(active, n, gen)                                 # (B, n)
        old = _gather(sites, m)                                   # (B, n, P, 3)
        c_m = _gather(com, m)[:, :, None, :]
        if kind == "trans":
            new = old + (_u((B, n, 3), gen, dev) - 0.5)[:, :, None, :] \
                * dr_max
        else:
            axis = _unit((B, n), gen, dev, 3)[:, :, None, :]
            ang = ((2.0 * _u((B, n), gen, dev) - 1.0) * dphi_max)[:, :, None]
            new = c_m + _rotate(old - c_m, axis.expand_as(old), ang)
        on = active[:, None, :] & (torch.arange(M, device=dev)[None, None, :]
                                   != m[:, :, None])
        du = mdl.pair(new, sites, on, box) - mdl.pair(old, sites, on, box)
        o_re, o_im = mdl.sfac_rows(old, box)
        n_re, n_im = mdl.sfac_rows(new, box)
        du = du + mdl.recip_delta(s_re, s_im, n_re - o_re, n_im - o_im, cf)
        p = torch.exp(-beta * torch.clamp_min(du, 0.0))
        out.append(p.mean(1))
    return out[0], out[1], active.sum(1).double()


def _scaled_energy(mdl, com, quat, box, box_new, active, rows):
    s = (box_new / box)[:, None, None]
    return evaluate(com * s, quat, box_new, active, mdl.model, mdl.params,
                    F64, rows=rows)["energy"]


def volume_npt(mdl, st, ev, temp, pressure, dv_max, n, gen, rows=8):
    """(B,) mean acceptance of n volume trials of each row (module
    docstring)."""
    com, quat, box = st["com"].double(), st["quat"].double(), \
        st["box"].double()
    B, M = com.shape[:2]
    dev = com.device
    dlnv = (2.0 * _u((B, n), gen, dev) - 1.0) * dv_max
    box_new = box[:, None] * torch.exp(dlnv / 3.0)
    rep = (lambda x: x.repeat_interleave(n, dim=0))
    e_new = _scaled_energy(mdl, rep(com), rep(quat), rep(box),
                           box_new.reshape(-1), None, rows).reshape(B, n)
    v, v_new = box[:, None] ** 3, box_new ** 3
    arg = -(e_new - ev["energy"][:, None] + pressure * (v_new - v)) / temp \
        + (M + 1.0) * dlnv
    p = torch.exp(torch.clamp_max(arg, 0.0))
    p = torch.where(box_new >= mdl.wall - 1e-9, p, 0.0)
    return p.mean(1)


def volume_gibbs(mdl, st, ev, temp, dv_max, n, gen, rows=32):
    """(C,) mean acceptance of n volume exchanges of each chain; st's rows
    are box-major per chain (2 C rows)."""
    com, quat, box = st["com"].double(), st["quat"].double(), \
        st["box"].double()
    C = box.shape[0] // 2
    dev = com.device
    act = st["active"]
    v = (box ** 3).reshape(C, 2)
    dv = (2.0 * _u((C, n), gen, dev) - 1.0) * dv_max * v.sum(1)[:, None]
    v_new = torch.stack([v[:, 0:1] + dv, v[:, 1:2] - dv], -1)  # (C, n, 2)
    legal = (v_new > 0.0).all(-1)
    box_new = torch.pow(torch.clamp_min(v_new, 1e-30), 1.0 / 3.0)
    legal = legal & (box_new > mdl.wall).all(-1)
    rep = (lambda x: x.reshape((C, 2) + x.shape[1:])[:, None]
           .expand((C, n, 2) + x.shape[1:]).reshape((-1,) + x.shape[1:]))
    e_new = _scaled_energy(mdl, rep(com), rep(quat), rep(box),
                           box_new.reshape(-1), rep(act), rows) \
        .reshape(C, n, 2)
    nb = act.sum(1).double().reshape(C, 1, 2)
    e_old = ev["energy"].reshape(C, 1, 2)
    log_a = (nb * torch.log(torch.where(legal[..., None], v_new / v[:, None],
                                        1.0))).sum(-1) \
        - (e_new - e_old).sum(-1) / temp
    p = torch.where(legal, torch.exp(torch.clamp_max(log_a, 0.0)), 0.0)
    return p.mean(1)


def transfer_gibbs(mdl, st, ev, temp, n, gen):
    """(C,) mean acceptance of n transfer trials of each chain; st's rows
    box-major per chain (2 C rows)."""
    com, box = st["com"].double(), st["box"].double()
    act = st["active"]
    B, cap = act.shape
    C = B // 2
    dev = com.device
    beta = 1.0 / temp
    sites = ev["sites"]
    s_re, s_im = ev["sfac"][..., 0], ev["sfac"][..., 1]
    cf = mdl.cf(box)
    si = mdl.self_intra(box)
    lc = mdl.lrc_coef(box)
    nb = act.sum(1).double()
    ar = torch.arange(C, device=dev)
    src_b = (_u((C, n), gen, dev) < 0.5).long()            # 0 or 1
    src = 2 * ar[:, None] + src_b                         # rows (C, n)
    dst = 2 * ar[:, None] + 1 - src_b
    n_s, n_d = nb[src], nb[dst]
    # removal from the source: a uniform active molecule of its row
    m = torch.stack([_pick(act[2 * ar + b], n, gen) for b in (0, 1)], 0)
    m = torch.where(src_b == 0, m[0], m[1])                # (C, n)
    src_f, dst_f, m_f = src.reshape(-1), dst.reshape(-1), m.reshape(-1)
    x_del = sites[src_f, m_f].reshape(C * n, 1, mdl.P, 3)
    on_del = act[src_f] & (torch.arange(cap, device=dev)[None, :]
                           != m_f[:, None])
    u_del = mdl.pair(x_del, sites[src_f], on_del[:, None, :], box[src_f])
    d_re, d_im = mdl.sfac_rows(x_del, box[src_f])
    du_s = -u_del[:, 0] + mdl.recip_delta(
        s_re[src_f], s_im[src_f], -d_re, -d_im, cf[src_f])[:, 0] \
        - si[src_f] + lc[src_f] * (-2.0 * nb[src_f] + 1.0)
    # insertion into the destination: uniform position and orientation
    pos = _u((C * n, 3), gen, dev) * box[dst_f][:, None]
    rot = rotation(_unit((C * n,), gen, dev, 4))           # (Cn, 3, 3)
    x_ins = (pos[:, None, :] + torch.einsum("bij,pj->bpi", rot, mdl.body)) \
        [:, None]
    u_ins = mdl.pair(x_ins, sites[dst_f], act[dst_f][:, None, :], box[dst_f])
    i_re, i_im = mdl.sfac_rows(x_ins, box[dst_f])
    du_d = u_ins[:, 0] + mdl.recip_delta(
        s_re[dst_f], s_im[dst_f], i_re, i_im, cf[dst_f])[:, 0] \
        + si[dst_f] + lc[dst_f] * (2.0 * nb[dst_f] + 1.0)
    log_a = torch.log(torch.clamp_min(n_s, 1.0)) - torch.log(n_d + 1.0) \
        + 3.0 * (torch.log(box[dst]) - torch.log(box[src])) \
        - beta * (du_s + du_d).reshape(C, n)
    ok = (n_s > 0.5) & (n_d < cap - 0.5)
    p = torch.where(ok, torch.exp(torch.clamp_max(log_a, 0.0)), 0.0)
    return p.mean(1)


def expected(ensemble, state, config, moves, trials, gen):
    """{kind: expected acceptance} at one state (a check row: com, quat,
    box, active) of a cell's ensemble ("fixed_n" or "gibbs"), averaged as
    the attempts of that kind weigh the rows.  moves: the traffic's move
    mix; trials: trial counts per row (translation and rotation each) or
    per chain ("volume", "transfer")."""
    model, params = config["model"], config["params"]
    dev = state["com"].device
    mdl = _Model(model, params, dev)
    temp = float(config["temperature"])
    ev = evaluate(state["com"], state["quat"], state["box"], state["active"],
                  model, params, F64)
    p_t, p_r, n_mol = displacement(mdl, state, ev, temp,
                                   float(moves["dr_max"]),
                                   float(moves["dphi_max"]),
                                   int(trials["move"]), gen)
    w = n_mol / n_mol.sum()
    out = {"trans": float((w * p_t).sum())}
    if mdl.P > 1 and float(moves["p_translate"]) < 1.0:
        out["rot"] = float((w * p_r).sum())
    if ensemble == "fixed_n":
        if "pressure_bar" in moves:
            out["vol"] = float(volume_npt(
                mdl, state, ev, temp,
                float(moves["pressure_bar"]) * BAR_IN_K_PER_A3,
                float(moves["dv_max"]), int(trials["volume"]), gen).mean())
    elif ensemble == "gibbs":
        if float(moves.get("p_volume", 0.0)) > 0.0:
            out["vol"] = float(volume_gibbs(
                mdl, state, ev, temp, float(moves["dv_max"]),
                int(trials["volume"]), gen).mean())
        out["xfer"] = float(transfer_gibbs(mdl, state, ev, temp,
                                           int(trials["transfer"]),
                                           gen).mean())
    else:
        raise ValueError(f"ensemble {ensemble!r}")
    return out


def seeded(seed, device):
    """The reference's own generator for the trials of a run seeded
    `seed` (a stream apart from the program's)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2654435761 + 97) % (1 << 63))
    return gen

