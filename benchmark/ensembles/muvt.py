"""Grand-canonical (muVT) cells: the port's `MolGCMC.run_block(state,
n_steps)` on the in-kernel exchange route (mega="full"), the call a
user's muVT run makes.

Set-up: the configuration's water builder at the slot capacity,
`MolGCMC` on the card (float32, the configuration's activity and
recompute chunk, the traffic's exchange share and step sizes) with a
generator seeded from --seed, `init` on a cubic lattice of the slots
with random orientations and the traffic's first n_init slots active
(its recompute warms the block-end recompute), then the configuration's
melt at fixed N, then the traffic's warm blocks (they build and load the
sweep kernel's exchange instantiation and bring N to its level at the
activity).  The melt is the same app with no exchanges (`MolGCMC(mega=
True, p_exchange=0)`, the activity-masked sweep alone) on the same
state and generator: a lattice start that exchanges from its first cycle
evaporates, its poorly bound molecules deleted faster than a liquid forms.
A block asks for `block_steps` steps; the port rounds that to whole
cycles of one launch each: the capacity's slot moves (an empty slot's
null move is not an attempt) and x_per exchange attempts.  A block's
work is what the chains' four attempt counters (translation, rotation,
insertion, deletion) grew by, summed over the chains.

Exact counts per block: the chains whose insertion and deletion attempts
together did not grow by cycles x x_per, and those whose N did not change
by their accepted insertions less their accepted deletions.  The check
rows are the sampled chains' configurations with what the kernel carried
into the block-end `full_energy` and what that recompute gave.  The
acceptance counters of the sampled chains, summed over each block, are
held against the reference's expectation (reference/muvt_moves.py) at
the same chains' states before and after it, the exchanges as one kind,
"xfer".  The counters are the sampled chains' and not all chains' (as
the fixed-N and Gibbs cells take them) because N differs from chain to
chain (a spread of ~11 about ~415 in the cell) and both exchange
acceptances follow N steeply: the expectation at a sample of the chains
would differ from the acceptance of all chains by the sample's own
spread (~2% at 64 of 2048 chains), more than a wrong activity moves
the combined share.  `n_means` keeps the chain-mean N after each warm
block and each block of the window.

The port's spans (utils/profiling.py) are fed into the harness's Spans
while the cell is installed (`PortSink`), so that the per-layer readers
see the port's `recompute`, `chunk` and `gcmc.cycle` spans beside the
harness's own.
"""

import contextlib

import torch

from benchmark import roofline
from benchmark.ensembles import sample_chains
from benchmark.reference.rigid_ewald import kvectors
from benchmark.roofline_muvt import muvt_bound

_NULL = contextlib.nullcontext()


class PortSink:
    """The port's span sink (profiling.attach) that feeds the harness's
    Spans: a span the port marks sync=True is the harness's span of the
    same name and units in every pass; a sync=False one, nested in a
    synchronised span, does nothing in the timing pass (its own sync
    would serialise the launches it times) and counts its units in the
    counting pass.  In the noting pass the port's spans are not marked on
    the profiler's clock: where the torch on the card reports no activity
    type, tracing.Trace tells annotations from device work by the names
    of tracing.NOTES alone, and would count the card-side ranges of the
    port's spans as busy time; the harness's own spans name the gaps."""

    def __init__(self, spans):
        self.spans = spans

    def span(self, name, units, sync):
        mode = self.spans.mode
        if mode in ("quiet", "note") or (mode == "time" and not sync):
            return _NULL
        return self.spans.span(name, units)


class Cell:
    unit = "muvt_cycle"

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.rate_metric = traffic["rate"]
        self.volume_events = 0       # no volume moves in this ensemble
        self.seed, self.device = int(seed), torch.device(device)
        self.app = self.state = None
        self.rows, self.bad_x, self.bad_n = [], [], []
        self.states, self.acc, self.att = [], [], []
        self.n_means = []
        self._attached = False

    # ---------------- set-up ----------------

    def setup(self):
        from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
        from metropolismontecarlo_tpu_torch.models import water
        from metropolismontecarlo_tpu_torch.models.system import RunParams

        cfg, tr = self.config, self.traffic
        mv, p = tr["moves"], cfg["params"]
        if mv["route"] != "full":
            raise ValueError("the muVT cells count the in-kernel route's "
                             f"cycles; route {mv['route']!r}")
        params = RunParams(
            temperature=cfg["temperature"], r_cut=p["r_cut"],
            cutoff_mode=p["cutoff_mode"], coulomb=p["coulomb"],
            kappa_L=p["kappa_L"], nk=p["nk"], ksq_max=p["ksq_max"],
            lj_shift=p["lj_shift"], use_lrc=p["use_lrc"],
            strict_min_image=p["strict_min_image"],
            p_translate=mv["p_translate"], dr_max=mv["dr_max"],
            dphi_max=mv["dphi_max"])
        self.cap = int(cfg["capacity"])
        system = getattr(water, cfg["model"]["builder"])(self.cap)
        self.P = system.atoms_per_mol
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed % (1 << 63))
        px = float(mv["p_exchange"])
        self.app = MolGCMC(system, params, activity=float(cfg["activity"]),
                           p_exchange=px, dtype=torch.float32,
                           chunk=int(cfg["chunk"]), mega="full",
                           device=self.device, generator=gen)
        self.x_per = max(1, int(round(self.cap * px / (1.0 - px))))
        self.cycles = self.units(int(tr["block_steps"]))
        C = int(tr["chains"])
        state = self.app.init(box=float(cfg["box"]), n_init=int(tr["n_init"]),
                              n_chains=C)
        melt = int(cfg.get("melt_sweeps", 0))
        if melt:
            fixed_n = MolGCMC(system, params, activity=float(cfg["activity"]),
                              p_exchange=0.0, dtype=torch.float32,
                              chunk=int(cfg["chunk"]), mega=True,
                              device=self.device, generator=gen)
            state, _ = fixed_n.run_block(state, melt * self.cap)
        for _ in range(int(tr.get("warm_blocks", 0))):
            state, _ = self.app.run_block(state, int(tr["block_steps"]))
            self.n_means.append(float(state.active.sum(1).double().mean()))
        self.state = state
        self.sample = sample_chains(C, int(tr["check_chains"]), self.seed,
                                    self.device)

    def units(self, n_steps, *_):
        """Cycles in one run_steps(state, n_steps) call: the port's
        rounding to whole cycles of capacity + x_per steps."""
        return max(1, int(round(int(n_steps) / (self.cap + self.x_per))))

    # ---------------- the window ----------------

    def install(self, spans):
        """Wrap the two calls run_block makes through the instance:
        run_steps (a span) and full_energy (a span, and the capture of the
        block-end state for the check); attach the port's spans."""
        from metropolismontecarlo_tpu_torch.utils import profiling

        app = self.app
        inner_steps, inner_fe = app.run_steps, app.full_energy

        def run_steps(state, n_steps):
            with spans.span("run_steps", self.units(n_steps)):
                return inner_steps(state, n_steps)

        def full_energy(state):
            self._capture_carried(state)
            with spans.span("full_energy", 1):
                return inner_fe(state)

        app.run_steps, app.full_energy = run_steps, full_energy
        profiling.attach(PortSink(spans))
        self._attached = True
        self.states.append(self._state_row(self.state))

    def _state_row(self, state):
        """The sampled chains' configurations."""
        i = self.sample
        return {"com": state.com[i], "quat": state.quat[i],
                "box": state.box[i], "active": state.active[i]}

    def _capture_carried(self, state):
        i = self.sample
        A = self.cap * self.P
        coords = state.coords[i][:, :, :A].transpose(1, 2).reshape(
            len(i), self.cap, self.P, 3)
        self.rows.append(dict(self._state_row(state), coords=coords,
                              e_carried=state.energy[i],
                              sk_carried=state.sfac[i]))

    def block(self):
        """One block; returns the attempts it made, over all chains."""
        acc0, att0 = self.state.acc, self.state.att
        n0 = self.state.active.sum(1)
        self.state, _ = self.app.run_block(self.state,
                                           int(self.traffic["block_steps"]))
        st = self.state
        self.rows[-1].update(e_resync=st.energy[self.sample],
                             sk_resync=st.sfac[self.sample])
        d_acc, d_att = st.acc - acc0, st.att - att0
        self.bad_x.append((d_att[:, 2] + d_att[:, 3]
                           != self.cycles * self.x_per).sum())
        self.bad_n.append((st.active.sum(1) - n0
                           != d_acc[:, 2] - d_acc[:, 3]).sum())
        self.acc.append(d_acc[self.sample].sum(0))
        self.att.append(d_att[self.sample].sum(0))
        self.states.append(self._state_row(st))
        n_mean, work = torch.stack([st.active.sum(1).double().mean(),
                                    d_att.sum().double()]).tolist()
        self.n_means.append(n_mean)
        return int(work)

    def exact_counts(self):
        """Per block the chains whose exchange attempts differ from the
        count the block asked for, and those whose N moved otherwise than
        by their accepted exchanges."""
        return {"exchange_attempts": [int(b) for b in self.bad_x],
                "n_balance": [int(b) for b in self.bad_n]}

    def check_rows(self):
        return self.rows

    def acceptance(self):
        """What the check holds against the acceptance reference: the
        states around the blocks (the window's start, then each block's
        end) and, per kind of move, the accepted and attempted counts of
        the sampled chains over the window (counter columns: translation,
        rotation, then insertion and deletion together as "xfer")."""
        acc = torch.stack(self.acc).sum(0).tolist()
        att = torch.stack(self.att).sum(0).tolist()
        return {"ensemble": "muvt", "states": self.states,
                "realized": {"trans": (acc[0], att[0]),
                             "rot": (acc[1], att[1]),
                             "xfer": (acc[2] + acc[3], att[2] + att[3])},
                "moves": self.traffic["moves"],
                "trials": self.traffic["accept_trials"]}

    # ---------------- yardstick inputs ----------------

    def bounds(self):
        """Least times (ms) at the window's first configuration: one cycle
        of every chain ("unit", roofline_muvt.muvt_bound) and one
        recompute of every chain's active slots ("recompute")."""
        st, p = self.state, self.config["params"]
        C = st.com.shape[0]
        A = self.cap * self.P
        sites = st.coords[:, :, :A].transpose(1, 2).reshape(
            C, self.cap, self.P, 3).double()
        frac = roofline.cutoff_fraction(sites, st.box.double(), p["r_cut"],
                                        st.active)
        near = roofline.reach_fraction(sites, st.com.double(),
                                       st.box.double(), p["r_cut"],
                                       st.active)
        K = len(kvectors(p["nk"], p["ksq_max"])[0])
        blk = roofline.block_of(self.config["model"], self.cap, p)
        n = st.active.sum(1)
        unit, _ = muvt_bound(blk, C, K, n, frac, near, self.x_per)
        rec, _ = roofline.recompute_bound(blk, [(n, frac)], K)
        return {"unit": unit, "recompute": rec}

    def free(self):
        if self._attached:
            from metropolismontecarlo_tpu_torch.utils import profiling

            profiling.detach()
            self._attached = False
        self.app = self.state = None
