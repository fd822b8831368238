"""Hold the plain ops of the hybrid muVT step for batch invariance: each
op on C chains against the same op on the rows [C / 2, C), which is what
a rank of a 2-way chain-sharded run computes.  A chain-sharded run
equals the unsharded one bit for bit only where every op is.

    python3 scripts/batch_invariance.py [--device cuda|cpu]

At chip_smoke.py phase 6's muVT shape (SPC/E cap 512, 25 A, 500 K, the
flagship Ewald, 256 chains, N 256) it prints, for each op, how many
elements differ: the pose S(k) (ops/ewald.py structure_factor on pose
rows, an elementwise atom sum) beside the batched einsum it replaced,
its phases, the pose pair energies, the reciprocal delta, the box edge
(ops/pbc.py cube_root) beside x ** (1/3), and 3 whole exchange-only
plain steps under utils/shard.py's shard context.  Exits 1 if an op of
the port differs; the two reference forms may.  The card's name and
power limit come first.
"""

import argparse
import dataclasses
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from metropolismontecarlo_tpu_torch.mc.gcmc_mol import (  # noqa: E402
    make_gcmc_mol,
    make_mol_slots,
)
from metropolismontecarlo_tpu_torch.models.system import (  # noqa: E402
    RunParams,
)
from metropolismontecarlo_tpu_torch.models.water import (  # noqa: E402
    spce_system,
)
from metropolismontecarlo_tpu_torch.ops import ewald  # noqa: E402
from metropolismontecarlo_tpu_torch.ops.pbc import cube_root  # noqa: E402
from metropolismontecarlo_tpu_torch.utils.shard import (  # noqa: E402
    shard_context,
)

CAP, BOX, N_INIT, CHAINS = 512, 25.0, 256, 256
PARAMS = dict(temperature=500.0, r_cut=10.0, cutoff_mode="site",
              coulomb="ewald", nk=5, ksq_max=27, p_translate=0.5,
              dr_max=0.4, dphi_max=0.4, use_lrc=False)


def differing(full, part, c0):
    """Elements of the rows [c0, C) of `full` (a tensor or a tuple of
    them) that differ from `part`."""
    if isinstance(full, (tuple, list)):
        return sum(differing(f, p, c0) for f, p in zip(full, part))
    return int((full[c0:] != part).sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("no CUDA device (pass --device cpu for the CPU)")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(f"card: {smi}")
        torch.backends.cuda.matmul.allow_tf32 = False
    f32, C = torch.float32, CHAINS
    c0 = C // 2
    params = RunParams(**PARAMS)
    system = spce_system(CAP)

    def build():
        gen = torch.Generator(device=dev).manual_seed(7)
        # the exchange-only plain sampler of the hybrid route
        return make_gcmc_mol(system, params, 2.2e-4, 1.0, f32, 16,
                             device=dev, generator=gen)[:2]

    init, _ = build()
    st = init(BOX, N_INIT, C)
    ms = make_mol_slots(system, params, dev, f32)
    ev = ms.ev
    gen = torch.Generator(device=dev).manual_seed(3)
    ra = torch.rand((C, 1, 3, 3), generator=gen, device=dev) * BOX
    com_t, box = ra[:, :, 0, :], st.box
    box_n = box[:, None].expand(C, 1)
    ph = ewald._phases(ra, ms.kv, box_n)
    q = torch.broadcast_to(ev.q_t.to(f32), ph.shape[:-1])
    a_ok = ms.atom_ok_of(st.active)
    cf = ewald.cfac_coeffs(ms.kv, ms.kw, params.kappa_L / box, box)
    s = ev.pose_sfac(ra, box_n)
    vol = box[:, None] ** 3 * (1.0 + 0.1 * torch.rand(
        (C, 2), generator=gen, device=dev))
    ops = {
        "pose S(k) (elementwise atom sum)": (
            lambda r: ev.pose_sfac(ra[r:], box_n[r:]), True),
        "pose S(k) as a batched einsum (the replaced form)": (
            lambda r: torch.einsum("...a,...ak->...k", q[r:],
                                   torch.cos(ph[r:])), False),
        "pose phases": (lambda r: ewald._phases(ra[r:], ms.kv, box_n[r:]),
                        True),
        "pose pair energies": (lambda r: ev.pair_energy(
            com_t[r:], ra[r:], st.coords[r:], st.com[r:], box[r:],
            a_ok[r:], -1), True),
        "reciprocal delta": (lambda r: ewald.recip_energy_delta(
            st.sfac[r:, None], s[r:], cf[r:, None]), True),
        "box edge cube_root": (lambda r: cube_root(vol[r:]), True),
        "box edge x ** (1/3) (the replaced form)": (
            lambda r: vol[r:] ** (1.0 / 3.0), False),
    }
    bad = 0
    for name, (fn, ported) in ops.items():
        n = differing(fn(0), fn(c0), c0)
        print(f"{name}: {n} differing elements")
        bad += n if ported else 0
    # whole exchange-only plain steps, sharded against unsharded
    init_f, run_f = build()
    full = run_f(init_f(BOX, N_INIT, C), 3)
    init_p, run_p = build()
    with shard_context(c0, C):
        part = run_p(init_p(BOX, N_INIT, C - c0), 3)
    for f in dataclasses.fields(full):
        n = differing(getattr(full, f.name), getattr(part, f.name), c0)
        print(f"3 plain exchange steps, {f.name}: {n} differing elements")
        bad += n
    if bad:
        sys.exit(f"{bad} elements of the port's ops depend on the batch")


if __name__ == "__main__":
    main()
