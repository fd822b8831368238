"""Full-system energy recompute op: the CUDA kernel's wrapper and its
tables (no TPU counterpart: the JAX package recomputes in plain jnp,
models/energy.py energy_breakdown).

One call recomputes C chains' total energy, molecular virial and S(k)
with the conventions of energy_breakdown's dense route: every unordered
pair of sites of different molecules in the chain's own minimum image
(box (C,): NPT chains differ), site cutoffs on d^2 (LJ below r_cut^2,
Coulomb below qq_cut^2), LJ with lj_shift "none" or "linear" and its
virial on the pair-consistent COM image r_ij = r_ab - (d_a - d_b),
real-space Ewald erfc(kappa r)/r with its exact virial, the
intramolecular correction and its kappa derivative, S(k) and the
reciprocal energy and virial; the self energy and the LJ tail are added
here, once over all C chains.

The kernel (csrc/recompute_kernel.cu) runs every chain in one launch, one
thread block each, and writes eight raw sums per chain (RAW_COLUMNS) and
S(k); `assemble` turns them into energy_breakdown's total and w.  The
per-atom, LJ and k-vector tables (`recompute_tables`) are built once per
system and stay on the device.  A chain's result depends on its own rows
only: bit-equal alone, in a shard or in the full batch.

`recompute_kernel` launches the kernel on CUDA tensors and raises on any
other device: models/energy.py energy_breakdown is its plain twin.  The
driver's route (mc/driver.py MonteCarlo._energies) takes it where
mc/moves.py recompute_kernel_supported admits the run, and
energy_breakdown everywhere else.
"""

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops import tail as tail_ops
from metropolismontecarlo_tpu_torch.ops.lj import _shift_coeffs
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

# the kernel's raw sums per chain, in its column order
RAW_COLUMNS = ("e_lj", "w_lj", "e_real", "w_real", "intra_erf",
               "intra_gauss", "recip_s2", "recip_st")
THREADS = 256
# per-atom info word (csrc/recompute_kernel.cu kInfo*): bit 0 an LJ site,
# bit 1 charged (with Ewald), the LJ type from bit 2, the molecule from 7
INFO_TYPE, INFO_MOL = 2, 7
MAX_TYPES = 32
MAX_NK = 127            # the packed k indices hold 8 bits an axis


@dataclasses.dataclass(frozen=True)
class RecomputeTables:
    """Per-system constants of the recompute (built by recompute_tables).

    A atoms (A_pad the state's storage width), M molecules, T LJ types,
    K k-vectors of largest |integer component| nk; ewald and linear (LJ
    shift) select the kernel's instantiation; squared LJ and Coulomb
    cutoffs, kappa_L; use_lrc and r_cut for the tail.  Tensors (f32
    unless noted, all on one device): info (A,) int32 (INFO_* bits), q
    (A,) site charges, ljt (4, T, T) = [eps, sigma^2, lam1, lam2] per
    type pair (lam pre-scaled: the shift is lam1 + lam2 r), kvec (K, 3)
    integers as f32 and kw (K,) their weights ((1, 3) and (1,) zeros
    without Ewald); type_counts (T,), eps_table, sig_table (T, T) for
    the tail."""

    A: int
    A_pad: int
    M: int
    T: int
    K: int
    nk: int
    ewald: bool
    linear: bool
    rc2: float
    qrc2: float
    kappa_l: float
    use_lrc: bool
    r_cut: float
    info: torch.Tensor
    q: torch.Tensor
    ljt: torch.Tensor
    kvec: torch.Tensor
    kw: torch.Tensor
    type_counts: torch.Tensor
    eps_table: torch.Tensor
    sig_table: torch.Tensor


def atom_info(system, params):
    """(A,) int32 numpy info words of the system's atoms: LJ site (any
    nonzero epsilon in its type's row), charged (a nonzero charge, with
    Ewald), LJ type and molecule."""
    et = np.asarray(system.eps_table)
    tid = np.asarray(system.flat(system.type_ids)).astype(np.int64)
    q = np.asarray(system.flat(system.charges))
    mol = system.atom_mol_slot[0].astype(np.int64)
    lj = np.any(et != 0.0, axis=1)[tid]
    charged = (q != 0.0) & (params.coulomb == "ewald")
    info = (mol << INFO_MOL) | (tid << INFO_TYPE) \
        | (charged.astype(np.int64) << 1) | lj.astype(np.int64)
    return info.astype(np.int32)


def pair_tables(system, params):
    """(4, T, T) float64 numpy [eps, sigma^2, lam1, lam2] of every type
    pair; lam1 = eps l1 and lam2 = eps l2 / sigma with the linear shift's
    coefficients (ops/lj.py _shift_coeffs), zero without it and for pairs
    without LJ."""
    eps = np.asarray(system.eps_table, np.float64)
    sig = np.asarray(system.sig_table, np.float64)
    lam1 = np.zeros_like(eps)
    lam2 = np.zeros_like(eps)
    if params.lj_shift == "linear":
        on = (eps != 0.0) & (sig > 0.0)
        l1, l2 = _shift_coeffs(params.r_cut / np.where(on, sig, 1.0))
        lam1 = np.where(on, eps * l1, 0.0)
        lam2 = np.where(on, eps * l2 / np.where(on, sig, 1.0), 0.0)
    return np.stack([eps, sig * sig, lam1, lam2])


def recompute_tables(system, params, kvecs, kweights, device):
    """RecomputeTables of the system on `device`; kvecs/kweights numpy
    (ewald.make_kvectors) with Ewald, else None."""
    ewald = params.coulomb == "ewald"
    if ewald:
        kvec, kw = np.asarray(kvecs), np.asarray(kweights)
    else:
        kvec, kw = np.zeros((1, 3)), np.zeros(1)

    def tab(x):
        return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32,
                            device=device)

    return RecomputeTables(
        A=system.n_atoms, A_pad=system.n_atoms_padded, M=system.n_mol,
        T=int(system.eps_table.shape[0]), K=len(kvec) if ewald else 0,
        nk=int(np.rint(np.abs(kvec)).max()) if ewald else 0, ewald=ewald,
        linear=params.lj_shift == "linear", rc2=float(params.r_cut ** 2),
        qrc2=float(params.qq_cut ** 2), kappa_l=float(params.kappa_L),
        use_lrc=bool(params.use_lrc and params.lj_shift == "none"),
        r_cut=float(params.r_cut),
        info=torch.tensor(atom_info(system, params), device=device),
        q=tab(system.flat(system.charges)), ljt=tab(pair_tables(system,
                                                                params)),
        kvec=tab(kvec), kw=tab(kw), type_counts=tab(system.type_counts),
        eps_table=tab(system.eps_table), sig_table=tab(system.sig_table))


def _check_inputs(t, coords, com, box):
    C = coords.shape[0]
    shapes = {"coords": ((C, 3, t.A_pad), coords), "com": ((C, t.M, 3), com),
              "box": ((C,), box)}
    for name, (shape, x) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {x.dtype}, the kernel runs "
                             f"float32")
        if x.device != t.info.device:
            raise ValueError(f"{name} on {x.device}, the tables on "
                             f"{t.info.device}")
    if C < 1:
        raise ValueError("no chains to recompute")


def recompute_kernel(t, coords, com, box):
    """Energy, virial and S(k) of every chain.

    t RecomputeTables; coords (C, 3, A_pad), com (C, M, 3), box (C,) f32
    on the tables' device.  Returns (total (C,), w (C,), sfac (C, K, 2),
    or (C, 1, 2) zeros without Ewald) as energy_breakdown's "total", "w"
    and "sfac".  CUDA tensors only: one kernel launch, counted in
    recompute_kernel.launches; any other device raises (energy_breakdown
    is the plain twin)."""
    _check_inputs(t, coords, com, box)
    if coords.device.type != "cuda":
        raise ValueError(f"the recompute kernel runs on CUDA tensors, not "
                         f"{coords.device}; energy_breakdown is its plain "
                         f"twin")
    coords, com, box = (x.contiguous() for x in (coords, com, box))
    raw, sfac = _launch(t, coords, com, box)
    total, w = assemble(t, raw, box)
    if not t.ewald:
        sfac = torch.zeros((coords.shape[0], 1, 2), dtype=coords.dtype,
                           device=coords.device)
    return total, w, sfac


recompute_kernel.launches = 0


def assemble(t, raw, box):
    """(total, w) of the raw sums (C, 8) at boxes (C,): the intra and
    reciprocal sums scaled, the Ewald self energy and the LJ tail added,
    in energy_breakdown's order of terms."""
    e_lj, w_lj, e_real, w_real, s_erf, s_gauss, s2, st = raw.unbind(-1)
    total, w = e_lj, w_lj
    if t.use_lrc:
        e_lrc = tail_ops.lrc_energy(t.type_counts, t.eps_table, t.sig_table,
                                    t.r_cut, box ** 3)
        total, w = total + e_lrc, w + 3.0 * e_lrc
    if t.ewald:
        kappa = t.kappa_l / box
        e_four = COULOMB_FACTOR * s2
        e_self = ewald_ops.ewald_self(t.q, kappa)
        e_intra = -s_erf
        w_intra = -(ewald_ops._TWO_OVER_RTPI * kappa) * s_gauss
        total = total + e_real + e_four + e_self + e_intra
        w = w + (w_real + (e_four - 2.0 * COULOMB_FACTOR * st) + e_self
                 + w_intra)
    return total, w


def _launch(t, coords, com, box):
    """One launch of the kernel over all C chains, counted in
    recompute_kernel.launches once the launch succeeded: (raw (C, 8),
    sfac (C, max(K, 1), 2))."""
    lib = _library()
    C = coords.shape[0]
    raw = torch.empty((C, len(RAW_COLUMNS)), dtype=torch.float32,
                      device=coords.device)
    sfac = torch.empty((C, max(t.K, 1), 2), dtype=torch.float32,
                       device=coords.device)
    err = lib.mmc_recompute_launch(
        coords.data_ptr(), com.data_ptr(), box.data_ptr(), t.info.data_ptr(),
        t.q.data_ptr(), t.ljt.data_ptr(), t.kvec.data_ptr(),
        t.kw.data_ptr(), raw.data_ptr(), sfac.data_ptr(), C, t.A, t.A_pad,
        t.M, t.T, t.K, t.nk, int(t.ewald), int(t.linear), THREADS, t.rc2,
        t.qrc2, t.kappa_l, COULOMB_FACTOR,
        torch.cuda.current_stream(coords.device).cuda_stream)
    if err != 0:
        msg = lib.mmc_cuda_error_string(err).decode()
        raise RuntimeError(f"recompute kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    recompute_kernel.launches += 1
    return raw, sfac


@functools.lru_cache(maxsize=None)
def _library():
    """csrc/recompute_kernel.cu, built on first use, with its C interface
    declared (one load per process)."""
    from metropolismontecarlo_tpu_torch.ops.cuda.build import load_library

    lib = load_library("recompute_kernel")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mmc_recompute_launch.argtypes = [vp] * 10 + [ci] * 10 + [cf] * 4 \
        + [vp]
    lib.mmc_recompute_launch.restype = ci
    lib.mmc_recompute_smem_bytes.argtypes = [ci] * 3
    lib.mmc_recompute_smem_bytes.restype = ctypes.c_size_t
    lib.mmc_recompute_tile.argtypes = [ci]
    lib.mmc_recompute_tile.restype = ci
    lib.mmc_recompute_occupancy.argtypes = [ci] * 5 + [ctypes.POINTER(ci)]
    lib.mmc_recompute_occupancy.restype = ci
    lib.mmc_cuda_error_string.argtypes = [ci]
    lib.mmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def occupancy(t):
    """(registers, local memory bytes, blocks per SM, dynamic shared bytes
    of a block, sites per eik tile or 0 without Ewald) of the tables'
    instantiation at their shape, as the CUDA runtime and
    csrc/recompute_kernel.cu report them."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    err = lib.mmc_recompute_occupancy(t.A, t.M, t.T, int(t.ewald),
                                      int(t.linear), out)
    if err != 0:
        raise RuntimeError(f"recompute occupancy query failed: CUDA error "
                           f"{err}")
    return (*out, int(lib.mmc_recompute_smem_bytes(t.A, t.M, t.T)),
            lib.mmc_recompute_tile(t.nk) if t.ewald else 0)
