"""Fixed-N cells (NVT, and NPT with volume moves): the port's
`MonteCarlo.run_block(state, n_sweeps, adjust=False)`, the call a user's
production loop makes.

Set-up: the configuration's water builder, `MonteCarlo` on the card with
a generator seeded from --seed, `init_state` from a cubic lattice with
random orientations (its recompute loads and warms the block-end
recompute and the NPT volume move's, which has its shapes), then the
traffic's melt sweeps at the traffic's step sizes (they load the sweep
kernel; no adaptation, so that every chain moves by the step sizes the
traffic states, from which the check's acceptance reference draws).  A
block is `block_sweeps` sweeps of every chain; its work is chains x
sweeps.  Under NPT the volume moves come every
round(1/p_volume)-th sweep counted from the start: a melt of half that
puts each block's volume move in its middle, so that the block end
checks what the kernel carried after it (an accepted volume move
replaces the carried energy and S(k) by a recompute).  The attempt
counters of every chain must grow by n_mol per sweep plus one per
scheduled volume move.  The acceptance counters of all chains, summed
over each block, are held against the reference's expectation at the
sampled chains' states before and after it (check.py).
"""

import torch

from benchmark import roofline
from benchmark.ensembles import sample_chains
from benchmark.reference.rigid_ewald import kvectors

BAR_IN_K_PER_A3 = 1.0e5 / 1.380649e-23 * 1.0e-30


class Cell:
    unit = "sweep"

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.rate_metric = traffic["rate"]
        self.seed, self.device = int(seed), torch.device(device)
        self.n_sweeps = int(traffic["block_sweeps"])
        self.mc = self.state = None
        self.rows, self.bad = [], []
        self.states, self.acc, self.att = [], [], []
        self.sweeps_done = 0
        self.volume_events = 0       # volume moves (each of every chain)

    # ---------------- set-up ----------------

    def setup(self):
        from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
        from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
        from metropolismontecarlo_tpu_torch.models import water
        from metropolismontecarlo_tpu_torch.models.system import RunParams

        cfg, tr = self.config, self.traffic
        mv, p = tr["moves"], cfg["params"]
        kw = dict(temperature=cfg["temperature"], r_cut=p["r_cut"],
                  cutoff_mode=p["cutoff_mode"], coulomb=p["coulomb"],
                  kappa_L=p["kappa_L"], nk=p["nk"], ksq_max=p["ksq_max"],
                  lj_shift=p["lj_shift"], use_lrc=p["use_lrc"],
                  p_translate=mv["p_translate"], dr_max=mv["dr_max"],
                  dphi_max=mv["dphi_max"])
        if "pressure_bar" in mv:
            kw.update(pressure=mv["pressure_bar"] * BAR_IN_K_PER_A3,
                      p_volume=mv["p_volume"], dv_max=mv["dv_max"])
        self.params = RunParams(**kw)
        model = cfg["model"]
        system = getattr(water, model["builder"])(int(model["n_mol"]))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed % (1 << 63))
        self.mc = MonteCarlo(system, self.params, device=self.device,
                             generator=gen, dtype=torch.float32)
        C, box = int(tr["chains"]), float(cfg["box"])
        self.M, self.P = system.n_mol, system.atoms_per_mol
        state = self.mc.init_state(cubic_lattice(self.M, box), box=box,
                                   n_chains=C)
        melt = int(tr.get("melt_sweeps", 0))
        if melt:
            state = self.mc.run_steps(state, melt, adjust=False)
        self.sweeps_done = melt
        self.state = state
        self.sample = sample_chains(C, int(tr["check_chains"]), self.seed,
                                    self.device)

    def volume_moves(self, first, n):
        """Volume moves scheduled in sweeps first + 1 .. first + n (the
        driver moves the volume after every round(1/p_volume)-th sweep)."""
        if "pressure_bar" not in self.traffic["moves"]:
            return 0
        period = max(1, int(round(1.0 / self.params.p_volume)))
        return (first + n) // period - first // period

    def units(self, n_steps, *_):
        """Sweeps in one run_steps(state, n_steps) call."""
        return int(n_steps)

    # ---------------- the window ----------------

    def install(self, spans):
        """Wrap the two calls run_block makes through the instance:
        run_steps (a span) and full_energy (a span, and the capture of
        the block-end state for the check)."""
        mc = self.mc
        inner_steps, inner_fe = mc.run_steps, mc.full_energy

        def run_steps(state, n_steps, adjust=False):
            with spans.span("run_steps", self.units(n_steps)):
                return inner_steps(state, n_steps, adjust)

        def full_energy(state):
            self._capture_carried(state)
            with spans.span("full_energy", 1):
                return inner_fe(state)

        mc.run_steps, mc.full_energy = run_steps, full_energy
        self.states.append(self._state_row(self.state))

    def _state_row(self, state):
        """The sampled chains' configurations."""
        i = self.sample
        return {"com": state.com[i], "quat": state.quat[i],
                "box": state.box[i], "active": None}

    def _capture_carried(self, state):
        i = self.sample
        A = self.M * self.P
        coords = state.coords[i, :, :A].transpose(1, 2).reshape(
            len(i), self.M, self.P, 3)
        self.rows.append(dict(self._state_row(state), coords=coords,
                              e_carried=state.energy[i],
                              sk_carried=state.sfac[i]))

    def block(self):
        """One block; returns the chain-sweeps it asked for."""
        acc0, att0 = self.state.acc, self.state.att
        n_vol = self.volume_moves(self.sweeps_done, self.n_sweeps)
        expect = self.M * self.n_sweeps + n_vol
        self.volume_events += n_vol
        self.state, _ = self.mc.run_block(self.state, self.n_sweeps,
                                          adjust=False)
        self.sweeps_done += self.n_sweeps
        self.rows[-1].update(e_resync=self.state.energy[self.sample],
                             sk_resync=self.state.sfac[self.sample])
        d_att = self.state.att - att0
        self.bad.append((d_att.sum(1) != expect).sum())
        self.acc.append((self.state.acc - acc0).sum(0))
        self.att.append(d_att.sum(0))
        self.states.append(self._state_row(self.state))
        return self.state.com.shape[0] * self.n_sweeps

    def exact_counts(self):
        """Per block the chains whose attempt counters differ from the
        count the block asked for."""
        return {"attempts": [int(b) for b in self.bad]}

    def check_rows(self):
        return self.rows

    def acceptance(self):
        """What the check holds against the acceptance reference: the
        states around the blocks (the window's start, then each block's
        end) and, per kind of move, the accepted and attempted counts of
        all chains over the window (counter columns: translation,
        rotation, volume)."""
        acc = torch.stack(self.acc).sum(0).tolist()
        att = torch.stack(self.att).sum(0).tolist()
        return {"ensemble": "fixed_n", "states": self.states,
                "realized": {k: (acc[c], att[c]) for c, k in
                             enumerate(("trans", "rot", "vol"))},
                "moves": self.traffic["moves"],
                "trials": self.traffic["accept_trials"]}

    # ---------------- yardstick inputs ----------------

    def bounds(self):
        """Least times (ms) at the window's first configuration: one sweep
        of every chain ("unit") and one recompute of every chain
        ("recompute": the block end's, and a volume move's)."""
        st, p = self.state, self.config["params"]
        C = st.com.shape[0]
        A = self.M * self.P
        sites = st.coords[:, :, :A].transpose(1, 2).reshape(
            C, self.M, self.P, 3).double()
        rc = max(p["r_cut"], p.get("qq_r_cut") or p["r_cut"])
        frac = roofline.cutoff_fraction(sites, st.box.double(), p["r_cut"])
        near = roofline.reach_fraction(sites, st.com.double(),
                                       st.box.double(), rc)
        K = len(kvectors(p["nk"], p["ksq_max"])[0]) \
            if p["coulomb"] == "ewald" else 1
        blk = roofline.block_of(self.config["model"], self.M, p)
        n_mol = torch.full((C,), self.M)
        return {"unit": roofline.sweep_bound([blk], C, K, frac, [near])[0],
                "recompute": roofline.recompute_bound(blk, [(n_mol, frac)],
                                                      K)[0]}

    def free(self):
        self.mc = self.state = None

