"""Per-move delta-energy op: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of metropolismontecarlo_tpu/ops/pallas/
delta_energy.py delta_energy_pallas).

For every chain and every moved row ([P old sites; P new sites; pad] of
the molecule m being moved), the row's LJ and real-space Coulomb energy
against all atom lanes, and the count of attractive overlaps; the caller
forms new - old.  Coulomb styles: ewald / wolf_ref (erfc(kappa r)/r),
wolf (minus erfc(kappa r_c)/r_c), bare (1/r), none.  e_coul excludes the
Coulomb unit factor.

`delta_energy` launches the kernel (csrc/delta_energy.cu) for CUDA
tensors and runs `delta_energy_plain` for CPU tensors; there is no
fallback between them.
"""

import ctypes
import dataclasses
import functools

import torch

from metropolismontecarlo_tpu_torch.ops.cuda.sweep_kernel import COULOMB_CODES

ROW_GROUP = 8       # rows are padded to a multiple of this
MAX_ROWS = 32
MAX_TYPES = 64
THREADS = 128       # threads per chain (one block per chain)


@dataclasses.dataclass(frozen=True)
class DeltaParams:
    """Scalars of the delta-energy op: coulomb style (a COULOMB_CODES
    key), squared LJ and Coulomb cutoffs, kappa_L, the overlap distance^2
    and the Wolf cutoff radius."""

    coulomb: str
    rc2: float
    qrc2: float
    kappa_l: float
    d2_overlap: float
    wolf_rc: float


def _check_inputs(x, y, z, mx, my, mz, box, eps, sig2, q8, has_lj, has_q,
                  tid_row, molid_row, q_row):
    C, A_pad = x.shape
    R, T = eps.shape
    if R % ROW_GROUP or not ROW_GROUP <= R <= MAX_ROWS or T > MAX_TYPES:
        raise ValueError(f"rows R={R} must be a multiple of {ROW_GROUP} up "
                         f"to {MAX_ROWS}, types T={T} at most {MAX_TYPES}")
    for name, p in (("x", x), ("y", y), ("z", z)):
        if tuple(p.shape) != (C, A_pad) or p.stride() != x.stride() \
                or p.stride(1) != 1:
            raise ValueError(f"{name}: planes must share shape (C, A_pad) "
                             f"and a row stride with unit lane stride")
    shapes = dict(mx=(C, R), my=(C, R), mz=(C, R), box=(C,), eps=(R, T),
                  sig2=(R, T), q8=(R,), has_lj=(R,), has_q=(R,),
                  tid_row=(A_pad,), molid_row=(A_pad,), q_row=(A_pad,))
    tensors = dict(x=x, y=y, z=z, mx=mx, my=my, mz=mz, box=box, eps=eps,
                   sig2=sig2, q8=q8, has_lj=has_lj, has_q=has_q,
                   tid_row=tid_row, molid_row=molid_row, q_row=q_row)
    for name, t in tensors.items():
        if name in shapes:
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{shapes[name]}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        int_field = name in ("has_lj", "has_q", "tid_row", "molid_row")
        if t.dtype != (torch.int32 if int_field else torch.float32):
            raise ValueError(f"{name}: dtype {t.dtype}")
    # the kernel reads the planes and the molecule ids as 16-byte vectors
    if A_pad % 4 or x.stride(0) % 4:
        raise ValueError(f"planes: A_pad {A_pad} and the row stride "
                         f"{x.stride(0)} must be multiples of 4 floats (the "
                         f"kernel reads 16-byte vectors)")
    for name, t in (("x", x), ("y", y), ("z", z), ("molid_row", molid_row)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             f"kernel reads 16-byte vectors); it starts at "
                             f"{t.data_ptr() % 16} bytes past one")


def delta_energy(x, y, z, mx, my, mz, box, m, eps, sig2, q8, has_lj, has_q,
                 tid_row, molid_row, q_row, params):
    """Batched per-row delta energies of the move of molecule m (an int,
    the global index).

    x/y/z (C, A_pad) coordinate planes (views of one (C, 3, A_pad) tensor
    do: a shared row stride, unit lane stride; the bases and molid_row
    16-byte aligned, A_pad and the row stride multiples of 4, else it
    raises on every device); mx/my/mz (C, R) moved
    rows; box (C,); eps/sig2 (R, T) per-row LJ parameters by neighbour
    type; q8 (R,) row charges; has_lj/has_q (R,) int32 row flags;
    tid_row/molid_row (A_pad,) int32 (pads -1), q_row (A_pad,); f32
    unless noted; params a DeltaParams.  Returns (e_lj, e_coul, ovr),
    each (C, R) f32.  CUDA tensors launch the kernel (and count it in
    delta_energy.launches); CPU tensors run delta_energy_plain; any other
    device raises."""
    args = (x, y, z, mx, my, mz, box, eps, sig2, q8, has_lj, has_q, tid_row,
            molid_row, q_row)
    _check_inputs(*args)
    if x.device.type == "cpu":
        return delta_energy_plain(x, y, z, mx, my, mz, box, m, eps, sig2, q8,
                                  has_lj, has_q, tid_row, molid_row, q_row,
                                  params)
    if x.device.type != "cuda":
        raise ValueError(f"no delta_energy for device {x.device}")
    C, R = mx.shape
    outs = tuple(torch.empty((C, R), dtype=torch.float32, device=x.device)
                 for _ in range(3))
    _launch(args, m, params, outs)
    delta_energy.launches += 1
    return outs


delta_energy.launches = 0


def _launch(args, m, params, outs):
    """One kernel launch on the current CUDA stream, on checked arguments
    (delta_energy's tensors in its order, without m and params) into
    outs; raises on a refused launch.  Counts nothing: delta_energy counts
    its launches."""
    lib = _library()
    x, eps = args[0], args[7]
    C, A_pad = x.shape
    R, T = eps.shape
    ptrs = [t.data_ptr() for t in tuple(args) + tuple(outs)]
    err = lib.mmc_delta_energy_launch(
        *ptrs[:3], x.stride(0), *ptrs[3:], C, A_pad, R, T, int(m),
        COULOMB_CODES[params.coulomb], THREADS, params.rc2, params.qrc2,
        params.kappa_l, params.d2_overlap, params.wolf_rc,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.mmc_delta_error_string(err).decode()
        raise RuntimeError(f"delta_energy launch failed: CUDA error {err} "
                           f"({msg})")


@functools.lru_cache(maxsize=None)
def _library():
    """csrc/delta_energy.cu, built on first use, with its C interface
    declared (one load per process)."""
    from metropolismontecarlo_tpu_torch.ops.cuda.build import load_library

    lib = load_library("delta_energy")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mmc_delta_energy_launch.argtypes = (
        [vp] * 3 + [ctypes.c_longlong] + [vp] * 15 + [ci] * 7 + [cf] * 5
        + [vp])
    lib.mmc_delta_energy_launch.restype = ci
    lib.mmc_delta_error_string.argtypes = [ci]
    lib.mmc_delta_error_string.restype = ctypes.c_char_p
    for fn in (lib.mmc_delta_max_rows, lib.mmc_delta_max_types,
               lib.mmc_delta_init):
        fn.argtypes = []
        fn.restype = ci
    lib.mmc_delta_smem_bytes.argtypes = [ci, ci, ci]
    lib.mmc_delta_smem_bytes.restype = ctypes.c_size_t
    lib.mmc_delta_occupancy.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
    lib.mmc_delta_occupancy.restype = ci
    if (lib.mmc_delta_max_rows(), lib.mmc_delta_max_types()) != \
            (MAX_ROWS, MAX_TYPES):
        raise RuntimeError("csrc/delta_energy.cu and ops/cuda/delta_energy"
                           ".py disagree on the row and type limits")
    err = lib.mmc_delta_init()
    if err != 0:
        raise RuntimeError(f"delta_energy: setting the shared-memory limit "
                           f"failed: CUDA error {err} "
                           f"({lib.mmc_delta_error_string(err).decode()})")
    return lib


def occupancy(coulomb, R, T):
    """(registers, local memory bytes, blocks per SM) of the kernel's
    instantiation for `coulomb` (a COULOMB_CODES key) at R rows and T
    types, as the CUDA runtime reports them."""
    out = (ctypes.c_int * 3)()
    err = _library().mmc_delta_occupancy(COULOMB_CODES[coulomb], R, T,
                                         THREADS, out)
    if err != 0:
        raise RuntimeError(f"delta_energy occupancy query failed: CUDA "
                           f"error {err}")
    return tuple(out)


def delta_energy_plain(x, y, z, mx, my, mz, box, m, eps, sig2, q8, has_lj,
                       has_q, tid_row, molid_row, q_row, params):
    """Plain PyTorch version of the kernel over (C, R, A_pad) grids, in
    the dtype of the inputs.  Same arguments and results as
    `delta_energy`."""
    b = box[:, None, None]
    inv_b = 1.0 / b
    d2 = None
    for plane, rows in ((x, mx), (y, my), (z, mz)):
        dd = plane[:, None, :] - rows[:, :, None]                 # (C, R, A)
        dd = dd - b * torch.round(dd * inv_b)
        d2 = dd * dd if d2 is None else d2 + dd * dd
    d2 = torch.clamp_min(d2, 1e-4)
    other = (molid_row != m) & (molid_row >= 0)                   # (A,)
    tid = tid_row.clamp(min=0).long()
    inv_r = torch.rsqrt(d2)
    s2 = sig2[:, tid] * (inv_r * inv_r)
    s6 = s2 * s2 * s2
    pot = (4.0 * eps[:, tid]) * (s6 * s6 - s6)
    mask_lj = other & (d2 < params.rc2) & (has_lj[:, None] != 0)
    e_lj = torch.where(mask_lj, pot, 0.0).sum(-1)
    if params.coulomb == "none":
        zero = torch.zeros_like(e_lj)
        return e_lj, zero, zero
    qq = q8[:, None] * q_row[None, :]                             # (R, A)
    kr = (params.kappa_l / b) * (d2 * inv_r)
    if params.coulomb == "bare":
        cp = qq * inv_r
    elif params.coulomb == "wolf":
        kc = params.kappa_l / box[:, None, None] * params.wolf_rc
        cp = qq * (torch.special.erfc(kr) * inv_r
                   - torch.special.erfc(kc) / params.wolf_rc)
    else:                                          # ewald, wolf_ref
        cp = qq * (torch.special.erfc(kr) * inv_r)
    mask_qq = other & (d2 < params.qrc2) & (has_q[:, None] != 0)
    e_coul = torch.where(mask_qq, cp, 0.0).sum(-1)
    bad = mask_qq & (d2 < params.d2_overlap) & (qq < 0.0)
    return e_lj, e_coul, bad.sum(-1).to(e_lj.dtype)
