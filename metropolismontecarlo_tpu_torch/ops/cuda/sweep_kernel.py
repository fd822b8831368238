"""Whole-sweep Metropolis op: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of metropolismontecarlo_tpu/ops/pallas/
sweep_kernel.py sweep_pallas, base and species-block variants: no
activity mask, exchanges, TMMC, Widom or sorted slabs).

One call runs the M sequential moves of one species block (global
molecules [m_start, m_start + M), atoms from column a_start, P each) on
every chain; a mixture makes one call per block, threading the state.  Each move: a
translate or rotate proposal, old and new site sums of LJ plus real-space
Coulomb (ewald / wolf / wolf_ref / bare / none) over all atoms, the
incremental S(k) and reciprocal energy delta (ewald), the overlap veto,
the Metropolis test, and the write-back of the accepted move.

Random numbers come from outside: u (C, M_total, 10) uniforms in [0, 1),
one row per molecule of the whole system, whose columns are [selector, dx, dy, dz, accept, e1, e2, e3, e4, angle] (the
TPU kernel's u[:, 0:10]).  The kernel and sweep_plain read the same u,
so the two can be compared trajectory by trajectory.

`sweep` launches the kernel (csrc/sweep_kernel.cu) for CUDA tensors and
runs `sweep_plain` for CPU tensors; there is no fallback between them.
"""

import ctypes
import dataclasses
import functools
import math

import torch

from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

N_UNIFORMS = 10
# stats columns: [energy delta, acc_trans, acc_rot, att_trans, att_rot,
# decision fingerprint = sum of (global m + 1) over accepted moves]
N_STATS = 6
MAX_SITES = 16
MAX_SMEM_BYTES = 232448   # 227 KB, a Hopper block's dynamic shared memory
THREADS = 256
COULOMB_CODES = {"none": 0, "ewald": 1, "wolf": 2, "wolf_ref": 3, "bare": 4}

_TWO_PI = 2.0 * math.pi
_INV_TWO_PI = 1.0 / _TWO_PI


@dataclasses.dataclass(frozen=True)
class SweepTables:
    """Per-system constants of the sweep (built by mc.moves.sweep_tables).

    Scalars: M molecules swept, from global index m_start, whose atoms
    start at column a_start, P sites per molecule, coulomb style (a
    COULOMB_CODES key), lj_shift ("none" | "linear"), use_rot, squared
    LJ and Coulomb cutoffs, kappa_L, the overlap distance^2 and
    p_translate.  Tensors (f32 unless noted, all on one device):
    body (P, 3); qp (P,) site charges; eps/sig2/lam1/lam2 (P, T) per-site
    LJ rows by neighbour type (lam pre-scaled: the shift is
    lam1 + lam2 * r); has_lj/has_q (P,) int32 site flags; tid_row/
    molid_row (A_pad,) int32 (pads -1); q_row (A_pad,); kvec (K, 3);
    kw (K,)."""

    M: int
    m_start: int
    a_start: int
    P: int
    coulomb: str
    lj_shift: str
    use_rot: bool
    rc2: float
    qrc2: float
    kappa_l: float
    d2_overlap: float
    p_translate: float
    body: torch.Tensor
    qp: torch.Tensor
    eps: torch.Tensor
    sig2: torch.Tensor
    lam1: torch.Tensor
    lam2: torch.Tensor
    has_lj: torch.Tensor
    has_q: torch.Tensor
    tid_row: torch.Tensor
    molid_row: torch.Tensor
    q_row: torch.Tensor
    kvec: torch.Tensor
    kw: torch.Tensor

    def tensors(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}


def smem_bytes(M, P, A_pad, K, T):
    """Dynamic shared memory of one block, M the COM/quaternion rows held
    (all molecules of the system); must match sweep_smem_floats in
    csrc/sweep_kernel.cu."""
    return 4 * (6 * A_pad + 7 * M + 8 * K + 4 * P * T + 11 * P + 80)


def _check_inputs(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u,
                  t):
    C, three, A_pad = coords.shape
    M_total = com.shape[1]
    K = sfac.shape[1]
    T = t.eps.shape[1]
    if three != 3:
        raise ValueError(f"coords must be (C, 3, A_pad), got {coords.shape}")
    if t.P > MAX_SITES or t.a_start + t.M * t.P > A_pad or t.m_start < 0 \
            or t.a_start < 0 or t.m_start + t.M > M_total:
        raise ValueError(
            f"sweep supports P <= {MAX_SITES} sites, a block within the "
            f"A_pad atoms and M_total molecules (P={t.P}, M={t.M}, "
            f"m_start={t.m_start}, a_start={t.a_start}, A_pad={A_pad}, "
            f"M_total={M_total})")
    tensors = dict(t.tensors(), coords=coords, com=com, quat=quat, sfac=sfac,
                   box=box, temp=temp, dr_max=dr_max, dphi_max=dphi_max, u=u)
    shapes = dict(
        coords=(C, 3, A_pad), com=(C, M_total, 3), quat=(C, M_total, 4),
        sfac=(C, K, 2), box=(C,), temp=(C,), dr_max=(C,), dphi_max=(C,),
        u=(C, M_total, N_UNIFORMS), body=(t.P, 3), qp=(t.P,), eps=(t.P, T),
        sig2=(t.P, T), lam1=(t.P, T), lam2=(t.P, T), has_lj=(t.P,),
        has_q=(t.P,), tid_row=(A_pad,), molid_row=(A_pad,), q_row=(A_pad,),
        kvec=(K, 3), kw=(K,))
    for name, x in tensors.items():
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != "
                             f"{shapes[name]}")
        if x.device != coords.device:
            raise ValueError(f"{name} on {x.device}, coords on "
                             f"{coords.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        int_field = name in ("tid_row", "molid_row", "has_lj", "has_q")
        if x.dtype != (torch.int32 if int_field else torch.float32):
            raise ValueError(f"{name}: dtype {x.dtype}")


def sweep(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u, tables):
    """One sweep of the species block's tables.M moves per chain.

    coords (C, 3, A_pad), com (C, M_total, 3), quat (C, M_total, 4), sfac
    (C, K, 2), box/temp/dr_max/dphi_max (C,), u (C, M_total, 10); all f32,
    contiguous, on one device.  Returns new (coords, com, quat, sfac, stats (C, 6)).
    CUDA tensors launch the kernel (and count it in sweep.launches); CPU
    tensors run sweep_plain; any other device raises."""
    _check_inputs(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u,
                  tables)
    if coords.device.type == "cpu":
        return sweep_plain(coords, com, quat, sfac, box, temp, dr_max,
                           dphi_max, u, tables)
    if coords.device.type != "cuda":
        raise ValueError(f"no sweep for device {coords.device}")
    return _launch(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u,
                   tables)


sweep.launches = 0


def _launch(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u, t):
    lib = _library()
    C, _, A_pad = coords.shape
    M_total, K, T = com.shape[1], sfac.shape[1], t.eps.shape[1]
    nbytes = smem_bytes(M_total, t.P, A_pad, K, T)
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"chain state needs {nbytes} B of shared memory, "
                         f"over the {MAX_SMEM_BYTES} B a block may use")
    if lib.mmc_sweep_smem_bytes(M_total, t.P, A_pad, K, T) != nbytes:
        raise RuntimeError("csrc/sweep_kernel.cu and smem_bytes disagree "
                           "on the shared-memory layout")
    outs = (torch.empty_like(coords), torch.empty_like(com),
            torch.empty_like(quat), torch.empty_like(sfac),
            torch.empty((C, N_STATS), dtype=torch.float32,
                        device=coords.device))
    ptrs = [x.data_ptr() for x in (
        coords, com, quat, sfac, box, temp, dr_max, dphi_max, u, t.body,
        t.qp, t.eps, t.sig2, t.lam1, t.lam2, t.has_lj, t.has_q, t.tid_row,
        t.molid_row, t.q_row, t.kvec, t.kw) + outs]
    err = lib.mmc_sweep_launch(
        *ptrs, C, t.M, M_total, t.m_start, t.a_start, t.P, A_pad, K, T,
        COULOMB_CODES[t.coulomb],
        int(t.lj_shift == "linear"), int(t.use_rot), THREADS,
        t.rc2, t.qrc2, t.kappa_l, t.d2_overlap, t.p_translate,
        COULOMB_FACTOR, torch.cuda.current_stream(coords.device).cuda_stream)
    if err != 0:
        msg = lib.mmc_cuda_error_string(err).decode()
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err} "
                           f"({msg})")
    sweep.launches += 1
    return outs


@functools.lru_cache(maxsize=None)
def _library():
    """csrc/sweep_kernel.cu, built on first use, with its C interface
    declared (one load per process)."""
    from metropolismontecarlo_tpu_torch.ops.cuda.build import load_library

    lib = load_library("sweep_kernel")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mmc_sweep_launch.argtypes = [vp] * 27 + [ci] * 13 + [cf] * 6 + [vp]
    lib.mmc_sweep_launch.restype = ci
    lib.mmc_sweep_smem_bytes.argtypes = [ci] * 5
    lib.mmc_sweep_smem_bytes.restype = ctypes.c_size_t
    lib.mmc_cuda_error_string.argtypes = [ci]
    lib.mmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def rot_apply(w, x, y, z, bx, by, bz):
    """R(q) b for quaternion columns (C, 1) and body rows (P,): the
    kernel's expansion, term for term."""
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    ox = (ww + xx - yy - zz) * bx + 2.0 * ((xy - wz) * by + (xz + wy) * bz)
    oy = (ww - xx + yy - zz) * by + 2.0 * ((xy + wz) * bx + (yz - wx) * bz)
    oz = (ww - xx - yy + zz) * bz + 2.0 * ((xz - wy) * bx + (yz + wx) * by)
    return ox, oy, oz


def propose_rotation(w0, x0, y0, z0, um, dphi_max):
    """The kernel's rotation proposal for quaternion columns (C, 1),
    uniforms um (C, 10) (columns 5-9) and dphi_max (C,): the normalised
    product of a rotation by (2 u9 - 1) dphi_max about a Box-Muller axis
    with q0, as four (C, 1) columns."""
    e1 = torch.clamp_min(um[:, 5:6], 1e-12)
    e3 = torch.clamp_min(um[:, 7:8], 1e-12)
    e2, e4 = um[:, 6:7], um[:, 8:9]
    r1 = torch.sqrt(-2.0 * torch.log(e1))
    r2 = torch.sqrt(-2.0 * torch.log(e3))
    a2 = _TWO_PI * (e2 - torch.round(e2))
    a4 = _TWO_PI * (e4 - torch.round(e4))
    g1, g2, g3 = r1 * torch.cos(a2), r1 * torch.sin(a2), r2 * torch.cos(a4)
    gn = torch.rsqrt(g1 * g1 + g2 * g2 + g3 * g3 + 1e-20)
    half = 0.5 * ((2.0 * um[:, 9:10] - 1.0) * dphi_max[:, None])
    sh, rw = torch.sin(half) * gn, torch.cos(half)
    rx, ry, rz = sh * g1, sh * g2, sh * g3
    nw = rw * w0 - rx * x0 - ry * y0 - rz * z0
    nx = rw * x0 + rx * w0 + ry * z0 - rz * y0
    ny = rw * y0 - rx * z0 + ry * w0 + rz * x0
    nz = rw * z0 + rx * y0 - ry * x0 + rz * w0
    qn = torch.rsqrt(nw * nw + nx * nx + ny * ny + nz * nz)
    return nw * qn, nx * qn, ny * qn, nz * qn


def sweep_plain(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u, t,
                magnitude=False):
    """Plain PyTorch version of the kernel: a Python loop over the M
    molecules, vectorised over chains, f32 throughout.  Same arguments
    and results as `sweep`.  With magnitude, stats gains a seventh column:
    the sum over accepted moves of the magnitudes of the terms their
    energy deltas add up (each old and new row's r^-12 and r^-6 LJ terms,
    linear shift and Coulomb pair terms, each k-vector's reciprocal
    term), the scale of the energy delta's f32 rounding, for holding
    another route's energy delta against this one's."""
    coords, com, quat = coords.clone(), com.clone(), quat.clone()
    sre, sim = sfac[..., 0].clone(), sfac[..., 1].clone()
    C, _, A_pad = coords.shape
    P = t.P
    box_c, temp_c = box[:, None], temp[:, None]
    inv_box = 1.0 / box_c
    kappa = t.kappa_l * inv_box                                   # (C, 1)
    ewald = t.coulomb == "ewald"
    use_q = t.coulomb != "none"
    if ewald:
        k2 = (t.kvec * t.kvec).sum(-1)                           # (K,)
        kt2 = (_TWO_PI * inv_box) ** 2 * k2
        vol = box_c * box_c * box_c
        cfac = t.kw * (_TWO_PI / vol) * torch.exp(
            -kt2 / (4.0 * kappa * kappa)) / kt2                   # (C, K)
    if t.coulomb == "wolf":
        qrc = math.sqrt(t.qrc2)
        sh_w = torch.special.erfc(kappa * qrc) / qrc              # (C, 1)
    tid = t.tid_row.clamp(min=0).long()
    eps4 = (4.0 * t.eps[:, tid]).repeat(2, 1)                     # (2P, A)
    sig2 = t.sig2[:, tid].repeat(2, 1)
    lam1 = t.lam1[:, tid].repeat(2, 1)
    lam2 = t.lam2[:, tid].repeat(2, 1)
    qq = ((COULOMB_FACTOR * t.qp)[:, None] * t.q_row[None, :]).repeat(2, 1)
    new_row = (torch.arange(2 * P, device=coords.device) >= P)[:, None]
    sign = torch.cat([-torch.ones(P), torch.ones(P)]).to(coords)  # (2P,)
    valid = t.molid_row >= 0
    bx, by, bz = t.body[:, 0], t.body[:, 1], t.body[:, 2]
    stats = torch.zeros((C, N_STATS + int(magnitude)), dtype=torch.float32,
                        device=coords.device)

    for m in range(t.M):
        mg = t.m_start + m                                        # global
        um = u[:, mg]
        w0, x0, y0, z0 = quat[:, mg, 0:1], quat[:, mg, 1:2], \
            quat[:, mg, 2:3], quat[:, mg, 3:4]
        if t.use_rot:
            tsel = (um[:, 0:1] < t.p_translate).to(coords.dtype)
            trans = tsel > 0.0
            rot_q = propose_rotation(w0, x0, y0, z0, um, dphi_max)
            w1, x1, y1, z1 = (torch.where(trans, a, b) for a, b in
                              zip((w0, x0, y0, z0), rot_q))
        else:
            tsel = torch.ones_like(um[:, 0:1])
            w1, x1, y1, z1 = w0, x0, y0, z0
        ncom = com[:, mg] + tsel * (um[:, 1:4] - 0.5) * dr_max[:, None]
        ncom = ncom - box_c * torch.floor(ncom * inv_box)        # (C, 3)

        a0 = t.a_start + m * P
        old = coords[:, :, a0:a0 + P].clone()                    # (C, 3, P)
        if P > 1:
            rot = rot_apply(w1, x1, y1, z1, bx, by, bz)
            new = torch.stack([ncom[:, d:d + 1] + rot[d] for d in range(3)],
                              dim=1)
        else:
            new = ncom[:, :, None].clone()
        pos = torch.cat([old, new], dim=2)                       # (C, 3, 2P)

        d2 = None
        for d in range(3):
            dd = coords[:, d, None, :] - pos[:, d, :, None]      # (C, 2P, A)
            dd = dd - box_c[:, :, None] * torch.round(
                dd * inv_box[:, :, None])
            d2 = dd * dd if d2 is None else d2 + dd * dd
        d2 = torch.clamp_min(d2, 1e-4)
        other = valid & (t.molid_row != mg)
        mask_lj = other & (d2 < t.rc2)
        mask_qq = other & (d2 < t.qrc2) if t.qrc2 != t.rc2 else mask_lj
        inv_r = torch.rsqrt(d2)
        inv_d2 = inv_r * inv_r
        s2 = sig2 * inv_d2
        s6 = s2 * s2 * s2
        pot = eps4 * (s6 * s6 - s6)
        if magnitude:
            lj_mag = eps4.abs() * (s6 * s6 + s6)
        if t.lj_shift == "linear":
            shift = lam1 + lam2 * torch.sqrt(d2)
            pot = pot + shift
            if magnitude:
                lj_mag = lj_mag + shift.abs()
        contrib = torch.where(mask_lj, pot, 0.0)
        if magnitude:
            mag = torch.where(mask_lj, lj_mag, 0.0).sum((1, 2))
        if use_q:
            r = d2 * inv_r
            kr = kappa[:, :, None] * r
            if t.coulomb in ("ewald", "wolf_ref"):
                cp = qq * (torch.special.erfc(kr) * inv_r)
            elif t.coulomb == "wolf":
                cp = qq * (torch.special.erfc(kr) * inv_r - sh_w[:, :, None])
            else:
                cp = qq * inv_r
            veto = new_row & (d2 < t.d2_overlap) & (qq < 0.0)
            cp = torch.where(veto, 1e30, cp)
            contrib = contrib + torch.where(mask_qq, cp, 0.0)
            if magnitude:
                mag = mag + torch.where(mask_qq, cp.abs(), 0.0).sum((1, 2))
        d_e = (contrib.sum(-1) * sign).sum(-1)                   # (C,)

        if ewald:
            tpl = (_TWO_PI * inv_box)[:, :, None]                # (C, 1, 1)
            ph = tpl * (t.kvec[:, 0] * pos[:, 0, :, None]
                        + t.kvec[:, 1] * pos[:, 1, :, None]
                        + t.kvec[:, 2] * pos[:, 2, :, None])     # (C, 2P, K)
            ph = ph - _TWO_PI * torch.round(ph * _INV_TWO_PI)
            qs = (sign * t.qp.repeat(2))[None, :, None]
            ds_re = (qs * torch.cos(ph)).sum(1)                  # (C, K)
            ds_im = (qs * torch.sin(ph)).sum(1)
            cross = 2.0 * (sre * ds_re + sim * ds_im) \
                + ds_re * ds_re + ds_im * ds_im
            d_e = d_e + COULOMB_FACTOR * (cfac * cross).sum(-1)
            if magnitude:
                mag = mag + COULOMB_FACTOR * (cfac * cross.abs()).sum(-1)

        beta_de = d_e / temp_c[:, 0]
        accept = (beta_de < 0.0) | (um[:, 4] < torch.exp(-beta_de))
        acc = accept[:, None]
        com[:, mg] = torch.where(acc, ncom, com[:, mg])
        if t.use_rot:
            quat[:, mg] = torch.where(acc, torch.cat([w1, x1, y1, z1], 1),
                                      quat[:, mg])
        coords[:, :, a0:a0 + P] = torch.where(acc[:, :, None], new, old)
        if ewald:
            sre = torch.where(acc, sre + ds_re, sre)
            sim = torch.where(acc, sim + ds_im, sim)
        ts = tsel[:, 0]
        af = accept.to(coords.dtype)
        cols = [torch.where(accept, d_e, 0.0), af * ts, af * (1.0 - ts), ts,
                1.0 - ts, af * float(mg + 1)]
        if magnitude:
            cols.append(torch.where(accept, mag, 0.0))
        stats += torch.stack(cols, dim=1)
    return coords, com, quat, torch.stack([sre, sim], dim=-1), stats
