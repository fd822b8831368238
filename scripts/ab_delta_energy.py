"""Time the delta-energy kernel on one card, in turns: csrc/delta_energy.cu
and other builds of it (for example the parent commit's source, or a
variant made by a text edit), each at 256 and at 128 threads per chain
where its launcher takes them.

    git show HEAD~1:metropolismontecarlo_tpu_torch/csrc/delta_energy.cu \\
        > scripts/out/delta_energy_parent.cu
    python3 scripts/ab_delta_energy.py [scripts/out/delta_energy_parent.cu ...]

Another source must keep the launcher's C interface
(mmc_delta_energy_launch); each is built with ops/cuda/build.py's flags
into scripts/out/, beside a copy of csrc/mmc_common.cuh.  A source whose
name starts with "ko_" is a knock-out copy (a stage's work removed to time
the rest): its disagreement is printed, not gated.  The arguments are
those of the per-move main path (chip_smoke.py phase 5): the 600 CO2 + 150
N2 mixture in 37 A at 2048 chains, after 4 whole-sweep sweeps from the
diagonal lattice, the move of molecule 375.  Each build is timed two
ways: one launch's device time from 20 launches replayed in one CUDA
graph (chip_smoke._graph_ms), and one delta_energy wrapper call, host
time included, from 20 calls (chip_smoke._time_ms: how chip_smoke.py's
kernels line times it); the builds go in order, then in reverse.  Every
build's outputs are held against delta_energy_plain first.
"""

import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from metropolismontecarlo_tpu_torch.io.configs import (  # noqa: E402
    cubic_lattice,
)
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo  # noqa: E402
from metropolismontecarlo_tpu_torch.mc.moves import draw_uniforms  # noqa: E402
from metropolismontecarlo_tpu_torch.models.linear import (  # noqa: E402
    co2_n2_system,
)
from metropolismontecarlo_tpu_torch.ops.cuda import build  # noqa: E402
from metropolismontecarlo_tpu_torch.ops.cuda import (  # noqa: E402
    delta_energy as dop,
)


def other_library(src):
    """The other source built into scripts/out/, its C interface declared
    as ops/cuda/delta_energy.py declares csrc's."""
    out_dir = ROOT / "scripts" / "out"
    out_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(build.COMMON_HEADER, out_dir / build.COMMON_HEADER.name)
    lib_path = out_dir / f"lib{Path(src).stem}.so"
    res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                          str(out_dir), "-o", str(lib_path), str(src)],
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ab ptxas {Path(src).name}: {line.strip()}")
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("mmc_delta_energy_launch", "mmc_delta_error_string"):
        ours = getattr(dop._library(), fn)
        getattr(lib, fn).argtypes = ours.argtypes
        getattr(lib, fn).restype = ours.restype
    if hasattr(lib, "mmc_delta_init") and lib.mmc_delta_init() != 0:
        raise RuntimeError(f"{src}: mmc_delta_init failed")
    return lib


def main_path_args(dev, chains=2048):
    """delta_energy's arguments for the move of molecule 375 of the
    mixture after 4 whole-sweep sweeps."""
    system = co2_n2_system(600, 150)
    params = chip_smoke.mixture_params(r_cut=10.0)
    gen = torch.Generator(device=dev).manual_seed(2027)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    state = mc.init_state(cubic_lattice(750, 37.0),
                          quat=chip_smoke.diagonal_quats(750), box=37.0,
                          n_chains=chains)
    state = mc.run_steps(state, 4, adjust=True)
    mixed = dataclasses.replace(system, species=None)
    mc5 = MonteCarlo(mixed, params, device=dev, generator=gen)
    _, _, body = mc5.move_bodies[0]
    m = 375
    u = draw_uniforms(chains, 1, gen, dev)[:, 0]
    pr = body.propose(state.com, state.quat, state.coords, state.box, u,
                      state.dr_max, state.dphi_max, m)
    return body.delta_args(pr, state.coords, state.box, m), body.P


def launchers(lib, args, outs, threads):
    """Two calls with lib in place of csrc's build and `threads` threads
    per chain: ops/cuda/delta_energy.py _launch on delta_energy's
    arguments into outs (capturable), and one delta_energy wrapper
    call."""
    tensors = tuple(args[:7]) + tuple(args[8:16])

    def swapped(fn):
        def call():
            saved = dop._library, dop.THREADS
            dop._library, dop.THREADS = (lambda: lib), threads
            try:
                fn()
            finally:
                dop._library, dop.THREADS = saved
        return call
    return (swapped(lambda: dop._launch(tensors, args[7], args[16], outs)),
            swapped(lambda: dop.delta_energy(*args)))


def main():
    _, smi = chip_smoke.phase0()
    dev = torch.device("cuda", 0)
    args, P = main_path_args(dev)
    chip_smoke.check_delta("ab csrc kernel", args, P)
    C, R = args[3].shape
    T = args[8].shape[1]
    regs, local, blocks = dop.occupancy(args[16].coulomb, R, T)
    print(f"ab csrc kernel at {dop.THREADS} threads: {regs} registers, "
          f"{local} B local, {blocks} blocks per SM")
    libs = [("csrc", dop._library())] + [
        (Path(src).stem, other_library(src)) for src in sys.argv[1:]]
    want = dop.delta_energy_plain(*args)
    runs = []
    for tag, lib in libs:
        for threads in (256, 128):
            outs = tuple(torch.empty((C, R), device=dev) for _ in range(3))
            call, wrapped = launchers(lib, args, outs, threads)
            try:
                call()
            except RuntimeError as e:
                print(f"ab {tag} at {threads} threads: {e}")
                continue
            torch.cuda.synchronize()
            scale = want[0].abs().max() + want[1].abs().max()
            err = float(max((outs[k] - want[k]).abs().max() for k in (0, 1))
                        / scale)
            ok = err < 1e-4 and torch.equal(outs[2], want[2])
            print(f"ab {tag} at {threads} threads: largest difference to "
                  f"the plain version {err:.3e} of the largest row sum, "
                  f"overlaps equal {torch.equal(outs[2], want[2])}")
            if not ok and not tag.startswith("ko_"):
                raise AssertionError(f"{tag} disagrees with the plain "
                                     f"version")
            runs.append((f"{tag} {threads}", call, wrapped))
    order = runs + runs[::-1]
    times = [(tag, chip_smoke._graph_ms(fn, 20), chip_smoke._time_ms(w, 20))
             for tag, fn, w in order]
    shape = f"{C} chains x {args[0].shape[1]} lanes x {R} rows"
    print(f"ab delta_energy, {shape}, device us per launch in turns: "
          + ", ".join(f"{tag} {1e3 * ms:.3f}" for tag, ms, _ in times)
          + f"; card: {smi}")
    print(f"ab delta_energy, {shape}, us per wrapper call (host time "
          f"included) in turns: "
          + ", ".join(f"{tag} {1e3 * w:.3f}" for tag, _, w in times)
          + f"; card: {smi}")


if __name__ == "__main__":
    main()
