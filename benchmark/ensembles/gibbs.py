"""Two-box Gibbs cells: the port's `MolGibbsEnsemble.run_block(state,
n_steps)`, the call a user's coexistence run makes.

Set-up: the configuration's water builder at the per-box capacity,
`MolGibbsEnsemble` on the card (float32, the traffic's route) with a
generator seeded from --seed, `init` on cubic lattices of both boxes
with random orientations (its recompute warms the block-end recompute),
then the traffic's warm blocks (they build and load the Gibbs kernel and
warm the volume move).  A block asks for `block_moves` moves; the port
rounds that to whole cycles of 2 cap slot moves + x_per transfer
attempts, with volume moves on its cadence between cycles, and so does
the count here: per cycle every active molecule is attempted once (an
empty slot's move is not an attempt) and x_per transfers, plus each
volume attempt.  The total number of molecules is conserved, so this
count is the same for every chain, and the attempt counters of every
chain must grow by it.

The port's cadence puts a volume move after every cycle, so a block ends
on one, and an accepted move replaces the chains' carried energies and
S(k) by a recompute.  So that the check reaches what the Gibbs kernel
carried, the state that goes into each volume move (gibbs_mol's
module-level `volume_step`, which the port looks up when it moves the
volume) is kept too, the block's last one checked beside the block end.
The acceptance counters of all chains, summed over each block, are held
against the reference's expectation at the sampled chains' states before
and after it (check.py).
"""

import torch

from benchmark import roofline
from benchmark.ensembles import sample_chains
from benchmark.reference.rigid_ewald import kvectors


class Cell:
    unit = "cycle"

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.rate_metric = traffic["rate"]
        self.volume_events = 0       # volume moves (each of every chain)
        self.seed, self.device = int(seed), torch.device(device)
        self.app = self.state = None
        self.rows, self.bad, self.n_bad = [], [], []
        self.states, self.acc, self.att = [], [], []
        self._pre_volume = None
        self._restore = None

    # ---------------- set-up ----------------

    def setup(self):
        from metropolismontecarlo_tpu_torch.mc.gibbs_mol import (
            MolGibbsEnsemble,
        )
        from metropolismontecarlo_tpu_torch.models import water
        from metropolismontecarlo_tpu_torch.models.system import RunParams

        cfg, tr = self.config, self.traffic
        mv, p = tr["moves"], cfg["params"]
        params = RunParams(
            temperature=cfg["temperature"], r_cut=p["r_cut"],
            cutoff_mode=p["cutoff_mode"], coulomb=p["coulomb"],
            kappa_L=p["kappa_L"], nk=p["nk"], ksq_max=p["ksq_max"],
            lj_shift=p["lj_shift"], use_lrc=p["use_lrc"],
            strict_min_image=p["strict_min_image"],
            p_translate=mv["p_translate"], dr_max=mv["dr_max"],
            dphi_max=mv["dphi_max"], p_volume=mv["p_volume"])
        self.cap = int(cfg["capacity"])
        system = getattr(water, cfg["model"]["builder"])(self.cap)
        self.P = system.atoms_per_mol
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed % (1 << 63))
        if mv["route"] != "full":
            raise ValueError("the Gibbs cells count the in-kernel route's "
                             f"cycles; route {mv['route']!r}")
        self.app = MolGibbsEnsemble(
            system, params, dv_max=mv["dv_max"], p_transfer=mv["p_transfer"],
            dtype=torch.float32, mega="full", device=self.device,
            generator=gen)
        C = int(tr["chains"])
        self.n_total = int(sum(cfg["n_init"]))
        self.v_total = float(sum(b ** 3 for b in cfg["boxes"]))
        state = self.app.init(boxes=tuple(cfg["boxes"]),
                              n_init=tuple(cfg["n_init"]), n_chains=C)
        for _ in range(int(tr.get("warm_blocks", 0))):
            state, _ = self.app.run_block(state, int(tr["block_moves"]))
        self.state = state
        self.cycles, self.moves = self._schedule(int(tr["block_moves"]))
        self.sample = sample_chains(C, int(tr["check_chains"]), self.seed,
                                    self.device)

    def _schedule(self, n_steps):
        """(cycles, attempted moves per chain) of run_steps(state, n_steps)
        on the in-kernel route: the port's rounding to whole cycles and
        its volume cadence, counted from the move mix."""
        mv = self.traffic["moves"]
        px, p_v = float(mv["p_transfer"]), float(mv["p_volume"])
        x_per = max(1, int(round(2 * self.cap * px / (1.0 - px))))
        att_pc = 2 * self.cap + x_per
        n_cyc = max(1, int(round(n_steps / att_pc)))
        if p_v > 0:
            vol_pc = p_v * att_pc
            if vol_pc >= 1.0:
                k_vol, vol_every = max(1, int(round(vol_pc))), 1
            else:
                k_vol, vol_every = 1, max(1, int(round(1.0 / vol_pc)))
            n_vol = (n_cyc // vol_every) * k_vol
        else:
            n_vol = 0
        self.x_per = x_per
        return n_cyc, n_cyc * (self.n_total + x_per) + n_vol

    def units(self, n_steps, *_):
        """Cycles in one run_steps(state, n_steps) call."""
        return self._schedule(int(n_steps))[0]

    # ---------------- the window ----------------

    def install(self, spans):
        from metropolismontecarlo_tpu_torch.mc import gibbs_mol

        app = self.app
        inner_steps, inner_fe = app.run_steps, app.full_energy
        inner_vol = gibbs_mol.volume_step

        def volume_step(state, *args, **kw):
            self.volume_events += 1
            self._pre_volume = self._rows_of(state)
            return inner_vol(state, *args, **kw)

        gibbs_mol.volume_step = volume_step
        self._restore = (gibbs_mol, inner_vol)

        def run_steps(state, n_steps):
            with spans.span("run_steps", self.units(n_steps)):
                return inner_steps(state, n_steps)

        def full_energy(state):
            self._capture_carried(state)
            with spans.span("full_energy", 1):
                return inner_fe(state)

        app.run_steps, app.full_energy = run_steps, full_energy
        self.states.append(self._state_row(self.state))

    def _state_row(self, state):
        """The sampled chains' configurations, box-major per chain."""
        i = self.sample
        n = len(i)
        return {"com": state.com[i].reshape(2 * n, self.cap, 3),
                "quat": state.quat[i].reshape(2 * n, self.cap, 4),
                "box": state.box[i].reshape(2 * n),
                "active": state.active[i].reshape(2 * n, self.cap)}

    def _capture_carried(self, state):
        if self._pre_volume is not None:
            self.rows.append(self._pre_volume)
            self._pre_volume = None
        self.rows.append(self._rows_of(state))

    def _rows_of(self, state):
        """The sampled chains' boxes as check rows (box-major per chain)."""
        i = self.sample
        n = len(i)
        A = self.cap * self.P
        coords = state.coords[i][:, :, :, :A].transpose(2, 3).reshape(
            2 * n, self.cap, self.P, 3)
        return {
            **self._state_row(state),
            "coords": coords,
            "e_carried": state.energy[i].reshape(2 * n),
            "sk_carried": state.sfac[i].reshape((2 * n,)
                                                + state.sfac.shape[2:]),
            "boxes": state.box[i]}

    def block(self):
        """One block; returns the moves it asked for, over all chains."""
        acc0, att0 = self.state.acc, self.state.att
        self.state, _ = self.app.run_block(self.state,
                                           int(self.traffic["block_moves"]))
        n = len(self.sample)
        self.rows[-1].update(
            e_resync=self.state.energy[self.sample].reshape(2 * n),
            sk_resync=self.state.sfac[self.sample].reshape(
                (2 * n,) + self.state.sfac.shape[2:]))
        d_att = self.state.att - att0
        self.bad.append((d_att.sum(1) != self.moves).sum())
        self.acc.append((self.state.acc - acc0).sum(0))
        self.att.append(d_att.sum(0))
        self.states.append(self._state_row(self.state))
        self.n_bad.append((self.state.active.sum((1, 2)) != self.n_total)
                          .sum())
        return self.state.com.shape[0] * self.moves

    def exact_counts(self):
        """Per block the chains whose attempt counters differ from the
        count the block asked for, and those whose total N changed."""
        return {"attempts": [int(b) for b in self.bad],
                "n_total": [int(b) for b in self.n_bad]}

    def check_rows(self):
        return self.rows

    def acceptance(self):
        """What the check holds against the acceptance reference: the
        states around the blocks (the window's start, then each block's
        end) and, per kind of move, the accepted and attempted counts of
        all chains over the window (counter columns: displacement,
        rotation, volume, transfer)."""
        acc = torch.stack(self.acc).sum(0).tolist()
        att = torch.stack(self.att).sum(0).tolist()
        return {"ensemble": "gibbs", "states": self.states,
                "realized": {k: (acc[c], att[c]) for c, k in
                             enumerate(("trans", "rot", "vol", "xfer"))},
                "moves": self.traffic["moves"],
                "trials": self.traffic["accept_trials"]}

    # ---------------- yardstick inputs ----------------

    def bounds(self):
        """Least times (ms) at the window's first configuration: one Gibbs
        launch of every chain ("unit") and one recompute of both boxes of
        every chain ("recompute": the block end's, and a volume move's)."""
        st, p = self.state, self.config["params"]
        C = st.com.shape[0]
        A = self.cap * self.P
        frac, near = [], []
        for b in range(2):
            sites = st.coords[:, b, :, :A].transpose(1, 2).reshape(
                C, self.cap, self.P, 3).double()
            frac.append(roofline.cutoff_fraction(
                sites, st.box[:, b].double(), p["r_cut"], st.active[:, b]))
            near.append(roofline.reach_fraction(
                sites, st.com[:, b].double(), st.box[:, b].double(),
                p["r_cut"], st.active[:, b]))
        K = len(kvectors(p["nk"], p["ksq_max"])[0])
        blk = roofline.block_of(self.config["model"], self.cap, p)
        n_box = st.active.sum(2)
        unit, _ = roofline.gibbs_bound(blk, C, K, n_box, frac, near,
                                       self.x_per)
        rec, _ = roofline.recompute_bound(
            blk, [(n_box[:, b], frac[b]) for b in range(2)], K)
        return {"unit": unit, "recompute": rec}

    def free(self):
        if self._restore is not None:
            module, fn = self._restore
            module.volume_step = fn
            self._restore = None
        self.app = self.state = None
