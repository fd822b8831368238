"""Each cell at a size a CPU test run holds: its configuration and
traffic with the scale cut (molecules, box, cutoff, chains, block
length), every other setting as the cell's files give it.  A sound run
that the acceptance check is to pass takes more chains, trials and
melt, so that its counts and expectations are not dominated by the
noise of a few dozen attempts or by the relaxation from the lattice."""

import copy

from benchmark import spec

CELLS = ("spce750.nvt.b100", "spce750.npt.v20", "tip4p2005_750.nvt.b100",
         "gibbs_spce128.vle450")


def tiny(workload, sound=False):
    """(config, traffic) of the cell cut to a CPU test's size; sound: the
    sizes of a sound run (module docstring)."""
    w = spec.workload(spec.benchmark(), workload)
    c = copy.deepcopy(spec.config(w["config"]))
    t = copy.deepcopy(spec.traffic(w["traffic"]))
    if t["ensemble"] == "gibbs":
        c["model"]["n_mol"] = c["capacity"] = 24
        c.update(boxes=[9.0, 11.0], n_init=[16, 4])
        c["params"]["r_cut"] = 4.4
        t.update(chains=4, block_moves=150, check_chains=2, warm_blocks=1)
        t["moves"]["p_volume"] = 0.02
        if sound:
            t.update(chains=16, check_chains=16, warm_blocks=3)
            t["accept_trials"] = {"move": 64, "volume": 16,
                                  "transfer": 512}
    else:
        c["model"]["n_mol"] = 64
        c["box"] = 12.42
        c["params"]["r_cut"] = 5.5
        t.update(chains=8, block_sweeps=2, melt_sweeps=2, check_chains=4)
        if "p_volume" in t["moves"]:
            # a volume move every second sweep, in the middle of a block
            t["moves"]["p_volume"] = 0.5
            t["melt_sweeps"] = 1
        if sound:
            t.update(chains=32, check_chains=16,
                     melt_sweeps=t["melt_sweeps"] + 10)
            t["accept_trials"] = dict(t["accept_trials"], move=128,
                                      volume=8)
    return c, t
