"""Two-box Gibbs cycle op: the CUDA kernel's wrapper and its plain PyTorch
version (counterpart of metropolismontecarlo_tpu/ops/pallas/gibbs_kernel.py
sweep_gibbs_pallas).

Both boxes of a chain live in one call.  The state keeps the two-box
layout of mc/gibbs_mol.MolGibbsState: atom planes (C, 2, 3, A_off), slot
rows (C, 2, m_off, 3|4), activity (C, 2, A_off) per atom and (C, 2,
m_off) per slot, S(k) (C, 2, K, 2), box lengths, exchange constants
(C, 2).  Slots are plane-indexed: box b's slot j has id b * m_off + j,
and its atoms are box b's columns.

One call runs the moves of one species block (slots [m_start, m_start +
M) of each box, atoms from column a_start, P each): the M moves of box 0,
then the M moves of box 1, each a translate or rotate proposal of an
active slot summed against the active atoms of its own box only, with
that box's length, kappa = kappa_L / L, Wolf shift and reciprocal
coefficients, the Metropolis test and the write-back (an inactive slot's
move is a null move, not an attempt).  Then n_exch transfer attempts:
the direction (uniform column 0 < 0.5: box 0 -> 1), the deletion
candidate (the source box's active slot with the largest score), the
first free slot of the destination box and a fresh pose uniform in the
destination volume; the candidate's pair sum against its source box
(veto off) and the pose's against the destination box (+1e30 overlap
veto on), two S(k) rows, and the log-space rule

    ln acc = ln N_s - ln(N_d + 1) + 3 (ln L_d - ln L_s) - beta (dU_s + dU_d)
    dU_s = -u_del - si_s + wc_s (1 - 2 N_s) + dU_recip,s
    dU_d = u_ins + si_d + wc_d (2 N_d + 1) + dU_recip,d

with each box's own si (self + intra) and wc (reference Wolf c Q^2 plus
the LJ tail) constants.  An attempt from an empty box or into a full one
is refused and writes nothing.  Volume moves are not part of the op.

Random numbers come from outside: u (C, 2 M, 10) the moves' uniforms
(box 0's M rows, then box 1's; sweep_kernel's columns), ux (C, n_exch,
8) the attempts' [direction, x, y, z, u1, theta2, theta3, accept] (the
trial pose as sweep_kernel.trial_pose builds it).  The deletion scores
are the sweep kernel's Philox4x32-10 words (key (seed, chain0 + chain),
chain0 the global index of the call's first chain; counter (plane slot
id, attempt)), so the kernel and sweep_gibbs_plain pick the
same slot; ties go to the lower slot.

stats (C, 8): [d_e box 0, d_e box 1, acc_trans, acc_rot, att_trans,
att_rot, acc_transfer, decision fingerprint]; the attempts of transfers
are n_exch; the fingerprint adds slot + 1 per accepted move and the
deleted slot + 1 + 2 m_off per accepted transfer.

The kernel keeps a chain's two-box state in one thread block's shared
memory when it fits (layout "shared"); otherwise the atom, activity,
score and molecule rows stay in global memory (layout "global"), and
where even the 11 k rows do not fit, those too (layout "global_k";
`choose_layout`, which layout= can force).  Every layout takes the same
decisions bit for bit.

`sweep_gibbs` launches the kernel (csrc/gibbs_kernel.cu) for CUDA tensors
and runs `sweep_gibbs_plain` for CPU tensors; any other device raises.
"""

import ctypes
import functools

import torch

from metropolismontecarlo_tpu_torch.ops.cuda.sweep_kernel import (
    COULOMB_CODES,
    LAYOUT_CODES,
    LAYOUTS,
    MAX_SITES,
    NEAR_WORDS,
    N_EXCH_UNIFORMS,
    N_UNIFORMS,
    QUEUE_WORDS,
    THREADS,
    SweepTables,
    box_constants,
    chain0_arg,
    pair_terms,
    philox_scores,
    pick_layout,
    propose_rotation,
    recip_delta,
    rot_apply,
    site_sfac,
    trial_pose,
)
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

N_STATS = 8


# A Gibbs call's tables are one species block's SweepTables
# (mc.moves.sweep_tables of a system holding one box's contents): M slots
# per box from slot m_start, atoms from column a_start of each box, P
# sites; one box's per-atom rows (molecule ids of box 0; the other box's
# are m_off higher).  Their slab fields stay unset.
GibbsTables = SweepTables


def gibbs_smem_bytes(m_off, P, A_off, K, T, nk, layout="shared"):
    """Dynamic shared memory of one block; must match gibbs_smem_floats
    in csrc/gibbs_kernel.cu.  Every layout: the warp queues of live pair
    terms (QUEUE_WORDS) and of (atom, pose) pairs within reach
    (NEAR_WORDS); two proposal buffers, each an old and a new pose of P
    16-byte site rows (16 P) and their eik tables (per pose and site three
    rows of 2 nk + 1 complex: 24 P (2 nk + 1)); 4 (P, T) LJ tables; 7
    P-wide site rows (body 3, charge, two flags, live cutoff^2) and 88
    words of scratch (two proposals' scalars, two rows of warp partials,
    the statistics, the box constants).  The shared layout adds 8 two-box
    atom rows (x, y, z, activity: 2 A_off each), one box's molecule row,
    the two-box slot activity (2 m_off) and two rows of Philox scores (2
    x 2 m_off); the shared and global layouts add 11 k rows (S re/im and
    cfac per box, the move's or insertion's and the deletion's dS re/im,
    the packed k indices).  The COM and quaternion rows and the per-atom
    charge and type rows stay in global memory in every layout."""
    n = (QUEUE_WORDS + NEAR_WORDS + 16 * P + 24 * P * (2 * nk + 1)
         + 4 * P * T + 7 * P + 88)
    if layout == "shared":
        n += 9 * A_off + 6 * m_off
    if layout != "global_k":
        n += 11 * K
    return 4 * n


def ws_floats(m_off, A_off, K, layout):
    """Words of one chain's workspace row (csrc/gibbs_kernel.cu
    gibbs_ws_floats): none in the shared layout; x/y/z over both boxes
    and two rows of Philox scores in the global ones, and in global_k the
    11 k rows too."""
    if layout == "shared":
        return 0
    return 6 * A_off + 4 * m_off + (11 * K if layout == "global_k" else 0)


def choose_layout(m_off, P, A_off, K, T, nk, layout="auto"):
    """The kernel layout of a launch: the first of "shared", "global" and
    "global_k" that fits a block's shared memory, or the one `layout`
    forces.  Raises, with the byte count, when the forced layout does not
    fit, or when even global_k's (the parts that do not grow with the
    state) does not."""
    sizes = {lay: gibbs_smem_bytes(m_off, P, A_off, K, T, nk, lay)
             for lay in LAYOUTS}
    return pick_layout(sizes, layout, f"the two-box chain state (m_off="
                       f"{m_off}, A_off={A_off}, K={K}, P={P}, nk={nk})")


def occupancy(t, m_off, A_off, K, layout="shared"):
    """(registers per thread, local memory per thread in bytes -- stack
    frame and spills --, blocks per SM) of the kernel instantiation that
    tables t launch, at this shape and layout, from the CUDA runtime;
    needs the card."""
    out = (ctypes.c_int * 3)()
    err = _library().mmc_gibbs_occupancy(
        COULOMB_CODES[t.coulomb], int(t.lj_shift == "linear"), m_off, t.P,
        A_off, K, t.eps.shape[1], t.nk, LAYOUT_CODES[layout], out)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return tuple(out)


def _check_inputs(coords, com, quat, sfac, box2, temp, dr_max, dphi_max, u,
                  t, act, actm, n_exch, ux, si2, wc2):
    C, two, three, A_off = coords.shape
    m_off = com.shape[2]
    K = sfac.shape[2]
    T = t.eps.shape[1]
    if two != 2 or three != 3:
        raise ValueError(f"coords must be (C, 2, 3, A_off), got "
                         f"{tuple(coords.shape)}")
    if t.W:
        raise ValueError("the Gibbs op scans dense boxes: tables with "
                         "sorted-slab windows (W > 0) are refused")
    if t.P > MAX_SITES or t.M < 1 or t.m_start < 0 or t.a_start < 0 \
            or t.m_start + t.M > m_off or t.a_start + t.M * t.P > A_off:
        raise ValueError(
            f"sweep_gibbs supports P <= {MAX_SITES} sites and a block within "
            f"a box's A_off atoms and m_off slots (P={t.P}, M={t.M}, "
            f"m_start={t.m_start}, a_start={t.a_start}, A_off={A_off}, "
            f"m_off={m_off})")
    if n_exch < 0:
        raise ValueError("n_exch must be >= 0")
    tensors = dict(t.tensors(), coords=coords, com=com, quat=quat, sfac=sfac,
                   box2=box2, temp=temp, dr_max=dr_max, dphi_max=dphi_max,
                   u=u, act=act, actm=actm)
    if n_exch:
        tensors.update(ux=ux, si2=si2, wc2=wc2)
    shapes = dict(
        coords=(C, 2, 3, A_off), com=(C, 2, m_off, 3), quat=(C, 2, m_off, 4),
        sfac=(C, 2, K, 2), box2=(C, 2), temp=(C,), dr_max=(C,),
        dphi_max=(C,), u=(C, 2 * t.M, N_UNIFORMS), act=(C, 2, A_off),
        actm=(C, 2, m_off), ux=(C, n_exch, N_EXCH_UNIFORMS), si2=(C, 2),
        wc2=(C, 2), body=(t.P, 3), qp=(t.P,), eps=(t.P, T), sig2=(t.P, T),
        lam1=(t.P, T), lam2=(t.P, T), has_lj=(t.P,), has_q=(t.P,),
        tid_row=(A_off,), molid_row=(A_off,), q_row=(A_off,), kvec=(K, 3),
        kw=(K,))
    for name, x in tensors.items():
        if x is None:
            raise ValueError(f"{name} is required")
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


def sweep_gibbs(coords, com, quat, sfac, box2, temp, dr_max, dphi_max, u,
                tables, act, actm, n_exch=0, ux=None, si2=None, wc2=None,
                seed=0, layout="auto", chain0=0):
    """One Gibbs call of the species block `tables`: 2 M moves, then n_exch
    transfer attempts (module docstring).

    coords (C, 2, 3, A_off), com (C, 2, m_off, 3), quat (C, 2, m_off, 4),
    sfac (C, 2, K, 2), box2 (C, 2), temp/dr_max/dphi_max (C,), u (C, 2 M,
    10), act (C, 2, A_off), actm (C, 2, m_off); with n_exch > 0 also ux
    (C, n_exch, 8), si2/wc2 (C, 2) and the integer seed of the deletion
    scores; chain0 the global index of chain 0 of this call, which keys
    its scores.  All f32, contiguous, on one device.  Returns (coords, com,
    quat, sfac, stats (C, 8), act, actm).  layout: "auto"
    (choose_layout) or one of LAYOUTS.  CUDA tensors launch the kernel
    (and count it in sweep_gibbs.launches); CPU tensors run
    sweep_gibbs_plain; any other device raises."""
    _check_inputs(coords, com, quat, sfac, box2, temp, dr_max, dphi_max, u,
                  tables, act, actm, n_exch, ux, si2, wc2)
    layout = choose_layout(com.shape[2], tables.P, coords.shape[3],
                           sfac.shape[2], tables.eps.shape[1], tables.nk,
                           layout)
    if coords.device.type == "cpu":
        return sweep_gibbs_plain(coords, com, quat, sfac, box2, temp, dr_max,
                                 dphi_max, u, tables, act, actm, n_exch, ux,
                                 si2, wc2, seed, chain0=chain0)
    if coords.device.type != "cuda":
        raise ValueError(f"no sweep_gibbs for device {coords.device}")
    return _launch(coords, com, quat, sfac, box2, temp, dr_max, dphi_max, u,
                   tables, act, actm, n_exch, ux, si2, wc2, seed, layout,
                   chain0)


sweep_gibbs.launches = 0


def _launch(coords, com, quat, sfac, box2, temp, dr_max, dphi_max, u, t, act,
            actm, n_exch, ux, si2, wc2, seed, layout, chain0):
    lib = _library()
    C, _, _, A_off = coords.shape
    m_off, K, T = com.shape[2], sfac.shape[2], t.eps.shape[1]
    code = LAYOUT_CODES[layout]
    n_ws = ws_floats(m_off, A_off, K, layout)
    if lib.mmc_gibbs_smem_bytes(m_off, t.P, A_off, K, T, t.nk, code) \
            != gibbs_smem_bytes(m_off, t.P, A_off, K, T, t.nk, layout) \
            or lib.mmc_gibbs_ws_floats(m_off, A_off, K, code) != n_ws:
        raise RuntimeError("csrc/gibbs_kernel.cu and gibbs_smem_bytes or "
                           "ws_floats disagree on the layout")
    outs = (torch.empty_like(coords), torch.empty_like(com),
            torch.empty_like(quat), torch.empty_like(sfac),
            torch.empty((C, N_STATS), dtype=torch.float32,
                        device=coords.device),
            torch.empty_like(act), torch.empty_like(actm))
    ws = torch.empty((C, n_ws), dtype=torch.float32,
                     device=coords.device) if n_ws else None

    def ptr(x):
        return None if x is None else x.data_ptr()

    ins = (coords, com, quat, sfac, act, actm, box2, temp, dr_max, dphi_max,
           si2, wc2, u, ux, t.body, t.qp, t.eps, t.sig2, t.lam1, t.lam2,
           t.has_lj, t.has_q, t.tid_row, t.molid_row, t.q_row, t.kvec, t.kw)
    err = lib.mmc_gibbs_launch(
        *(ptr(x) for x in ins + outs + (ws,)), C, t.M, m_off, t.m_start,
        t.a_start, t.P, A_off, K, T, t.nk, COULOMB_CODES[t.coulomb],
        int(t.lj_shift == "linear"), int(t.use_rot), int(n_exch), code,
        int(seed) & 0xFFFFFFFF, chain0_arg(chain0), THREADS, t.rc2, t.qrc2,
        t.kappa_l,
        t.d2_overlap, t.p_translate, COULOMB_FACTOR,
        torch.cuda.current_stream(coords.device).cuda_stream)
    if err != 0:
        msg = lib.mmc_gibbs_error_string(err).decode()
        raise RuntimeError(f"gibbs kernel launch failed: CUDA error {err} "
                           f"({msg})")
    sweep_gibbs.launches += 1
    return outs


@functools.lru_cache(maxsize=None)
def _library():
    """csrc/gibbs_kernel.cu, built on first use, with its C interface
    declared (one load per process)."""
    from metropolismontecarlo_tpu_torch.ops.cuda.build import load_library

    lib = load_library("gibbs_kernel")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mmc_gibbs_launch.argtypes = [vp] * 35 + [ci] * 15 \
        + [ctypes.c_uint] * 2 + [ci] + [cf] * 6 + [vp]
    lib.mmc_gibbs_launch.restype = ci
    lib.mmc_gibbs_smem_bytes.argtypes = [ci] * 7
    lib.mmc_gibbs_smem_bytes.restype = ctypes.c_size_t
    lib.mmc_gibbs_ws_floats.argtypes = [ci] * 4
    lib.mmc_gibbs_ws_floats.restype = ctypes.c_size_t
    lib.mmc_gibbs_occupancy.argtypes = [ci] * 9 + [vp]
    lib.mmc_gibbs_occupancy.restype = ci
    lib.mmc_gibbs_error_string.argtypes = [ci]
    lib.mmc_gibbs_error_string.restype = ctypes.c_char_p
    return lib


def sweep_gibbs_plain(coords, com, quat, sfac, box2, temp, dr_max, dphi_max,
                      u, t, act, actm, n_exch=0, ux=None, si2=None, wc2=None,
                      seed=0, magnitude=False, scores=None, chain0=0):
    """Plain PyTorch version of the kernel: Python loops over the 2 M moves
    and the attempts, vectorised over chains, f32 throughout.  Same
    arguments and results as `sweep_gibbs`.  scores (C, n_exch, 2 m_off),
    when given, replace the Philox deletion scores by plane slot id (a
    test forces a deletion slot with them).  With magnitude, stats gains
    a ninth column: the summed magnitudes of the terms the accepted moves'
    and transfers' energy deltas add up (each row's LJ r^-12 and r^-6
    terms, shift and Coulomb pair terms, each k-vector's reciprocal term,
    the exchange constants), the scale of the deltas' f32 rounding."""
    coords, com, quat = coords.clone(), com.clone(), quat.clone()
    act, actm = act.clone(), actm.clone()
    sre, sim = sfac[..., 0].clone(), sfac[..., 1].clone()      # (C, 2, K)
    C, _, _, A_off = coords.shape
    m_off = com.shape[2]
    P, M, m0, a0s = t.P, t.M, t.m_start, t.a_start
    dev = coords.device
    ar = torch.arange(C, device=dev)
    ewald = t.coulomb == "ewald"
    csts, cfac = zip(*(box_constants(t, box2[:, b:b + 1])
                       for b in range(2)))
    if ewald:
        cfac = torch.stack(cfac, 1)                               # (C, 2, K)
    tid = t.tid_row.clamp(min=0).long()
    eps4_p, sig2_p = 4.0 * t.eps[:, tid], t.sig2[:, tid]          # (P, A_off)
    lam1_p, lam2_p = t.lam1[:, tid], t.lam2[:, tid]
    qq_p = (COULOMB_FACTOR * t.qp)[:, None] * t.q_row[None, :]
    valid = t.molid_row >= 0
    bx, by, bz = t.body[:, 0], t.body[:, 1], t.body[:, 2]
    stats = torch.zeros((C, N_STATS + int(magnitude)), dtype=torch.float32,
                        device=dev)

    tabs = (eps4_p, sig2_p, lam1_p, lam2_p, qq_p)
    rep2 = tuple(x.repeat(2, 1) for x in tabs)
    new_row = (torch.arange(2 * P, device=dev) >= P)[None, :, None]
    sign = torch.cat([-torch.ones(P), torch.ones(P)]).to(coords)  # (2P,)
    zero = torch.zeros((C,), dtype=torch.float32, device=dev)

    for b in range(2):
        cst = csts[b]
        box_c, inv_c = cst[0], cst[1]
        for i in range(M):
            j = m0 + i                                   # slot in box b
            slot = b * m_off + j                         # plane id
            um = u[:, b * M + i]
            w0, x0, y0, z0 = (quat[:, b, j, q:q + 1] for q in range(4))
            if t.use_rot:
                tsel = (um[:, 0:1] < t.p_translate).to(coords.dtype)
                trans = tsel > 0.0
                rot_q = propose_rotation(w0, x0, y0, z0, um, dphi_max)
                w1, x1, y1, z1 = (torch.where(trans, a, r) for a, r in
                                  zip((w0, x0, y0, z0), rot_q))
            else:
                tsel = torch.ones_like(um[:, 0:1])
                w1, x1, y1, z1 = w0, x0, y0, z0
            ncom = com[:, b, j] + tsel * (um[:, 1:4] - 0.5) * dr_max[:, None]
            ncom = ncom - box_c * torch.floor(ncom * inv_c)
            a0 = a0s + i * P
            old = coords[:, b, :, a0:a0 + P].clone()            # (C, 3, P)
            if P > 1:
                rot = rot_apply(w1, x1, y1, z1, bx, by, bz)
                new = torch.stack([ncom[:, d:d + 1] + rot[d]
                                   for d in range(3)], dim=1)
            else:
                new = ncom[:, :, None].clone()
            pos = torch.cat([old, new], dim=2)                   # (C, 3, 2P)
            other = (valid & (t.molid_row != j)).to(coords.dtype)
            weight = (other[None, :] * act[:, b])[:, None, :]
            e_rows, mag = pair_terms(t, coords[:, b], pos, weight, new_row,
                                     cst, rep2, magnitude)
            d_e = (e_rows * sign).sum(-1)
            if ewald:
                ds_re, ds_im = site_sfac(t, pos, sign * t.qp.repeat(2),
                                         inv_c)
                dr_e, dr_mag = recip_delta(ds_re, ds_im, 1.0, sre[:, b],
                                           sim[:, b], cfac[:, b])
                d_e = d_e + dr_e
                if magnitude:
                    mag = mag + dr_mag
            beta_de = d_e / temp
            accept = (beta_de < 0.0) | (um[:, 4] < torch.exp(-beta_de))
            gate = act[:, b, a0]          # an inactive slot: a null move
            accept = accept & (gate > 0.0)
            ts = tsel[:, 0]
            acc = accept[:, None]
            com[:, b, j] = torch.where(acc, ncom, com[:, b, j])
            if t.use_rot:
                quat[:, b, j] = torch.where(
                    acc, torch.cat([w1, x1, y1, z1], 1), quat[:, b, j])
            coords[:, b, :, a0:a0 + P] = torch.where(acc[:, :, None], new,
                                                     old)
            if ewald:
                sre[:, b] = torch.where(acc, sre[:, b] + ds_re, sre[:, b])
                sim[:, b] = torch.where(acc, sim[:, b] + ds_im, sim[:, b])
            af = accept.to(coords.dtype)
            d_acc = torch.where(accept, d_e, 0.0)
            cols = [d_acc if b == 0 else zero, zero if b == 0 else d_acc,
                    af * ts, af * (1.0 - ts), gate * ts, gate * (1.0 - ts),
                    zero, af * float(slot + 1)]
            if magnitude:
                cols.append(torch.where(accept, mag, 0.0))
            stats += torch.stack(cols, dim=1)

    if n_exch:
        beta = 1.0 / temp
        iota = torch.arange(M, device=dev)[None, :]
        prange = torch.arange(P, device=dev)[None, :]
        ln_box = torch.log(box2)                                  # (C, 2)
        none = torch.zeros((C, 1, 1), dtype=torch.bool, device=dev)
    for xi in range(n_exch):
        ux_i = ux[:, xi]
        dir01 = ux_i[:, 0] < 0.5                  # box 0 -> box 1
        src = torch.where(dir01, 0, 1)
        dst = 1 - src
        on = actm[:, :, m0:m0 + M] > 0.5                          # (C, 2, M)
        n = on.sum(2).to(coords.dtype)
        n_src, n_dst = n[ar, src], n[ar, dst]
        if scores is None:
            sc = torch.where(
                dir01[:, None],
                philox_scores(seed, C, xi, m0, M, dev, chain0),
                philox_scores(seed, C, xi, m_off + m0, M, dev, chain0))
        else:
            sc = scores[:, xi].reshape(C, 2, m_off)[ar, src, m0:m0 + M]
        # deletion: the largest score on the source box's active slots,
        # the lower slot on a tie; insertion: the destination box's first
        # free slot; no candidate: slot 0 of the block, the attempt is
        # refused (can)
        score = torch.where(on[ar, src], sc, -torch.ones_like(sc))
        smax = score.max(dim=1, keepdim=True).values
        del_i = torch.where(score == smax, iota, M).min(dim=1).values
        ins_i = torch.where(~on[ar, dst], iota, M).min(dim=1).values
        ins_i = torch.where(ins_i >= M, 0, ins_i)
        can = (n_src > 0.5) & (n_dst < M - 0.5)
        cst_s = tuple(None if x is None else torch.where(
            dir01[:, None], x, y) for x, y in zip(*csts))
        cst_d = tuple(None if x is None else torch.where(
            dir01[:, None], y, x) for x, y in zip(*csts))
        cols_d = (a0s + del_i * P)[:, None] + prange              # (C, P)
        cols_i = (a0s + ins_i * P)[:, None] + prange
        lanes_s, lanes_d = coords[ar, src], coords[ar, dst]      # (C, 3, A)
        cur = lanes_s.gather(2, cols_d[:, None, :].expand(C, 3, P))
        ct, q_ins, ins_atoms = trial_pose(ux_i, cst_d[0][:, 0], t.body)
        w_s = torch.where(valid[None, :] & (t.molid_row[None, :]
                                            != (m0 + del_i)[:, None]),
                          act[ar, src], 0.0)[:, None, :]
        w_d = torch.where(valid[None, :], act[ar, dst], 0.0)[:, None, :]
        u_del, mag_d = pair_terms(t, lanes_s, cur, w_s, none, cst_s, tabs,
                                  magnitude)
        u_ins, mag_i = pair_terms(t, lanes_d, ins_atoms, w_d, ~none, cst_d,
                                  tabs, magnitude)
        si_s, si_d = si2[ar, src], si2[ar, dst]
        wc_s, wc_d = wc2[ar, src], wc2[ar, dst]
        du_d = -u_del.sum(-1) - si_s + wc_s * (-2.0 * n_src + 1.0)
        du_i = u_ins.sum(-1) + si_d + wc_d * (2.0 * n_dst + 1.0)
        mag = None
        if magnitude:
            mag = mag_d + mag_i + si_s.abs() + si_d.abs() \
                + (wc_s * (-2.0 * n_src + 1.0)).abs() \
                + (wc_d * (2.0 * n_dst + 1.0)).abs()
        if ewald:
            dsd = site_sfac(t, cur, t.qp, cst_s[1])
            dsi = site_sfac(t, ins_atoms, t.qp, cst_d[1])
            re_s, im_s = sre[ar, src], sim[ar, src]
            re_d, im_d = sre[ar, dst], sim[ar, dst]
            rd, rd_mag = recip_delta(*dsd, -1.0, re_s, im_s, cfac[ar, src])
            ri, ri_mag = recip_delta(*dsi, 1.0, re_d, im_d, cfac[ar, dst])
            du_d, du_i = du_d + rd, du_i + ri
            if magnitude:
                mag = mag + rd_mag + ri_mag
        du = du_d + du_i
        ln_acc = torch.log(torch.clamp_min(n_src, 1.0)) \
            - torch.log(n_dst + 1.0) \
            + 3.0 * (ln_box[ar, dst] - ln_box[ar, src]) - beta * du
        ln_u = torch.log(torch.clamp_min(ux_i[:, 7], 1e-30))
        ok = can & (ln_u < ln_acc)
        okf = ok.to(coords.dtype)
        # the writes: nothing when refused (and never through the slot
        # indices of a refused attempt)
        ok_c = ar[ok]
        s_ok, d_ok = src[ok], dst[ok]
        actm[ok_c, s_ok, m0 + del_i[ok]] = 0.0
        actm[ok_c, d_ok, m0 + ins_i[ok]] = 1.0
        for p in range(P):
            act[ok_c, s_ok, cols_d[ok, p]] = 0.0
            act[ok_c, d_ok, cols_i[ok, p]] = 1.0
            for d in range(3):
                coords[ok_c, d_ok, d, cols_i[ok, p]] = ins_atoms[ok, d, p]
        com[ok_c, d_ok, m0 + ins_i[ok]] = ct[ok]
        if P > 1:
            quat[ok_c, d_ok, m0 + ins_i[ok]] = q_ins[ok]
        if ewald:
            sre[ok_c, s_ok] -= dsd[0][ok]
            sim[ok_c, s_ok] -= dsd[1][ok]
            sre[ok_c, d_ok] += dsi[0][ok]
            sim[ok_c, d_ok] += dsi[1][ok]
        de0 = torch.where(ok, torch.where(dir01, du_d, du_i), 0.0)
        de1 = torch.where(ok, torch.where(dir01, du_i, du_d), 0.0)
        fp = okf * (src * m_off + m0 + del_i + 1 + 2 * m_off).to(
            coords.dtype)
        cols_x = [de0, de1, zero, zero, zero, zero, okf, fp]
        if magnitude:
            cols_x.append(torch.where(ok, mag, 0.0))
        stats += torch.stack(cols_x, dim=1)
    return (coords, com, quat, torch.stack([sre, sim], dim=-1), stats, act,
            actm)
