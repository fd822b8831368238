"""Semigrand identity-flip op: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of metropolismontecarlo_tpu/ops/pallas/
flip_kernel.py flip_pallas).

The state keeps the two-block slot layout of mc/semigrand.SemigrandState:
one box, slots [0, cap_a) species A (P0 sites, atoms from column 0) and
[cap_a, cap_a + cap_b) species B (P1 sites, atoms from column a0_b); a
slot's atoms sit at slot * P0, or at a0_b + (slot - cap_a) * P1.  Planes:
coords (C, 3, A_pad), com (C, M, 3), quat (C, M, 4), sfac (C, K, 2), act
(C, A_pad) per atom and actm (C, M) per slot, box and temperature (C,),
si2 (C, 2) each species' self + intra constant, lrc3 (C, 3) the LJ tail's
[g c00, g c01, g c11] or None.

Each of the n_flip attempts of a chain, in order:
  the pick: the active slot of either block with the largest score, the
      sweep kernel's Philox4x32-10 word (key (seed, chain0 + chain),
      chain0 the global index of the call's first chain, counter (slot,
      attempt, 0, 0); ties to the lower slot); with no active slot the
      attempt counts as an A -> B attempt, as the TPU kernel's degenerate
      pick (slot 0) does, and changes nothing;
  the target: the first free slot of the other block; with none the
      attempt is refused and writes nothing;
  dU = U_new - U_old + si[new] - si[old] (+ the LJ tail's delta in the
      live counts, + under Ewald the reciprocal term of dS = s_new(new
      pose) - s_old(old pose)): the old identity's stored atoms against
      the other active atoms (veto off), the other species' template at the
      same COM in the Shoemake orientation of ux[4..6] (veto on);
  accept when ln max(u7, 1e-30) < +-ln xi - beta dU (+ for A -> B): the old
      slot and its atoms go inactive, the target and its atoms active with
      the new pose, the COM and the quaternion; dS goes into S(k).

stats (C, 8): [d_e, acc A->B, acc B->A, att A->B, att B->A, decision
fingerprint (slot + 1 per accepted flip), 0, 0].

The kernel keeps a chain's state in one thread block's shared memory
when it fits (layout "shared"); otherwise the atom planes, the
active-atom list, the slot activity, the scores and the molecule row stay
in global memory (layout "global"), and where even the 6 k rows do not
fit, those too (layout "global_k"; `choose_layout`, which layout= can
force).  Every layout takes the same decisions bit for bit.

`flip` launches the kernel (csrc/flip_kernel.cu) for CUDA tensors and runs
`flip_plain` for CPU tensors; any other device raises.
"""

import ctypes
import dataclasses
import functools

import torch

from metropolismontecarlo_tpu_torch.ops.cuda.sweep_kernel import (
    COULOMB_CODES,
    LAYOUT_CODES,
    LAYOUTS,
    MAX_SITES,
    N_EXCH_UNIFORMS,
    QUEUE_WORDS,
    THREADS,
    SweepTables,
    box_constants,
    chain0_arg,
    pair_terms,
    philox_scores,
    pick_layout,
    recip_delta,
    rot_apply,
    shoemake,
    site_sfac,
)
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

N_STATS = 8


@dataclasses.dataclass(frozen=True)
class FlipTables:
    """Both species' tables of a flip launch: `a` and `b` are the two
    species blocks' SweepTables (mc.moves.sweep_tables), which carry each
    species' body, charge and per-site LJ rows and share the per-atom rows
    and the k-vectors; ln_xi = ln(f_B / f_A)."""

    a: SweepTables
    b: SweepTables
    ln_xi: float

    def __post_init__(self):
        a, b = self.a, self.b
        if a.m_start != 0 or a.a_start != 0 or b.m_start != a.M \
                or b.a_start < a.M * a.P:
            raise ValueError("flip tables need species A at slots [0, cap_a) "
                             "from column 0 and species B after it")
        if a.lj_shift != "none" or b.lj_shift != "none" or a.W or b.W:
            raise ValueError("the flip op runs unshifted LJ on dense planes")


def flip_smem_bytes(M, P0, P1, A_pad, K, T, nk, layout="shared"):
    """Dynamic shared memory of one block; must match flip_smem_floats in
    csrc/flip_kernel.cu.  Every layout: the warp queues of live pair terms
    (QUEUE_WORDS); the old and new poses' 16-byte site rows (2 x 4 max(P0,
    P1)) and eik tables (per pose and site three rows of 2 nk + 1
    complex: 12 max(P0, P1) (2 nk + 1)); two proposal buffers of both
    species' rotated templates and the attempt's quaternion and accept
    uniform (2 x (3 (P0 + P1) + 8)); both species' (P, T) eps and sigma^2
    tables; both species' 7 P-wide site rows (body 3, charge, two flags,
    live cutoff^2) and 33 words of warp partials, statistics and the
    list's length.  The shared layout adds 6 atom rows (x, y, z, the list
    of active atom columns, each column's place in it, molecule), the
    slot activity (M) and two rows of Philox scores (2 M); the shared and
    global layouts add 6 k rows (S re/im, cfac, dS re/im, the packed k
    indices).  The COM and quaternion rows and the per-atom charge and
    type rows stay in global memory in every layout."""
    pmax = max(P0, P1)
    n = (QUEUE_WORDS + 8 * pmax + 12 * pmax * (2 * nk + 1)
         + 2 * (3 * (P0 + P1) + 8) + 2 * (P0 + P1) * T + 7 * (P0 + P1) + 33)
    if layout == "shared":
        n += 6 * A_pad + 3 * M
    if layout != "global_k":
        n += 6 * K
    return 4 * n


def ws_floats(M, A_pad, K, layout):
    """Words of one chain's workspace row (csrc/flip_kernel.cu
    flip_ws_floats): none in the shared layout; the active-atom list, each
    column's place in it and two rows of Philox scores in the global ones,
    and in global_k the 6 k rows too."""
    if layout == "shared":
        return 0
    return 2 * A_pad + 2 * M + (6 * K if layout == "global_k" else 0)


def choose_layout(M, P0, P1, A_pad, K, T, nk, layout="auto"):
    """The kernel layout of a launch: the first of "shared", "global" and
    "global_k" that fits a block's shared memory, or the one `layout`
    forces.  Raises, with the byte count, when the forced layout does not
    fit, or when even global_k's (the parts that do not grow with the
    state) does not."""
    sizes = {lay: flip_smem_bytes(M, P0, P1, A_pad, K, T, nk, lay)
             for lay in LAYOUTS}
    return pick_layout(sizes, layout, f"the semigrand chain state (M={M}, "
                       f"A_pad={A_pad}, K={K}, P0={P0}, P1={P1}, nk={nk})")


def occupancy(t, M, A_pad, K, layout="shared"):
    """(registers per thread, local memory per thread in bytes -- stack
    frame and spills --, blocks per SM) of the kernel instantiation that
    FlipTables t launch, at this shape and layout, from the CUDA runtime;
    needs the card."""
    out = (ctypes.c_int * 3)()
    err = _library().mmc_flip_occupancy(
        COULOMB_CODES[t.a.coulomb], M, t.a.P, t.b.P, A_pad, K,
        t.a.eps.shape[1], t.a.nk, LAYOUT_CODES[layout], out)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return tuple(out)


def _check_inputs(coords, com, quat, sfac, box, temp, act, actm, ux, t,
                  si2, lrc3):
    C, three, A_pad = coords.shape
    M = com.shape[1]
    K = sfac.shape[1]
    T = t.a.eps.shape[1]
    if three != 3:
        raise ValueError(f"coords must be (C, 3, A_pad), got "
                         f"{tuple(coords.shape)}")
    if max(t.a.P, t.b.P) > MAX_SITES or t.a.M + t.b.M != M \
            or t.b.a_start + t.b.M * t.b.P > A_pad:
        raise ValueError(
            f"flip supports P <= {MAX_SITES} sites and two blocks that fill "
            f"the M slots within A_pad atoms (caps {t.a.M}, {t.b.M}, P "
            f"{t.a.P}, {t.b.P}, a0_b {t.b.a_start}, M={M}, A_pad={A_pad})")
    tensors = dict(coords=coords, com=com, quat=quat, sfac=sfac, box=box,
                   temp=temp, act=act, actm=actm, ux=ux, si2=si2)
    if lrc3 is not None:
        tensors["lrc3"] = lrc3
    shapes = dict(
        coords=(C, 3, A_pad), com=(C, M, 3), quat=(C, M, 4), sfac=(C, K, 2),
        box=(C,), temp=(C,), act=(C, A_pad), actm=(C, M),
        ux=(C, ux.shape[1], N_EXCH_UNIFORMS), si2=(C, 2), lrc3=(C, 3),
        tid_row=(A_pad,), molid_row=(A_pad,), q_row=(A_pad,), kvec=(K, 3),
        kw=(K,))
    for s, ts in (("a", t.a), ("b", t.b)):
        for name, x in ts.tensors().items():
            if name in ("body", "qp", "eps", "sig2", "has_lj", "has_q"):
                tensors[f"{name}_{s}"] = x
                shapes[f"{name}_{s}"] = dict(
                    body=(ts.P, 3), qp=(ts.P,), eps=(ts.P, T), sig2=(ts.P, T),
                    has_lj=(ts.P,), has_q=(ts.P,))[name]
            elif name in shapes:
                tensors[name] = x
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
        int_field = name.split("_")[0] in ("tid", "molid") \
            or name.startswith("has_")
        if x.dtype != (torch.int32 if int_field else torch.float32):
            raise ValueError(f"{name}: dtype {x.dtype}")


def flip(coords, com, quat, sfac, box, temp, act, actm, ux, tables, si2,
         lrc3=None, seed=0, layout="auto", chain0=0):
    """ux.shape[1] flip attempts per chain (module docstring).

    coords (C, 3, A_pad), com (C, M, 3), quat (C, M, 4), sfac (C, K, 2),
    box/temp (C,), act (C, A_pad), actm (C, M), ux (C, n_flip, 8), si2
    (C, 2), lrc3 (C, 3) or None; tables a FlipTables; the integer seed of
    the pick scores and chain0, the global index of chain 0 of this call,
    which keys them.  All f32, contiguous, on one device.  Returns (coords,
    com, quat, sfac, stats (C, 8), act, actm).  layout: "auto"
    (choose_layout) or one of LAYOUTS.  CUDA tensors launch the kernel
    (and count it in flip.launches); CPU tensors run flip_plain; any
    other device raises."""
    _check_inputs(coords, com, quat, sfac, box, temp, act, actm, ux, tables,
                  si2, lrc3)
    layout = choose_layout(com.shape[1], tables.a.P, tables.b.P,
                           coords.shape[2], sfac.shape[1],
                           tables.a.eps.shape[1], tables.a.nk, layout)
    if coords.device.type == "cpu":
        return flip_plain(coords, com, quat, sfac, box, temp, act, actm, ux,
                          tables, si2, lrc3, seed, chain0=chain0)
    if coords.device.type != "cuda":
        raise ValueError(f"no flip for device {coords.device}")
    return _launch(coords, com, quat, sfac, box, temp, act, actm, ux, tables,
                   si2, lrc3, seed, layout, chain0)


flip.launches = 0


def _launch(coords, com, quat, sfac, box, temp, act, actm, ux, t, si2, lrc3,
            seed, layout, chain0):
    lib = _library()
    C, _, A_pad = coords.shape
    M, K, T = com.shape[1], sfac.shape[1], t.a.eps.shape[1]
    code = LAYOUT_CODES[layout]
    n_ws = ws_floats(M, A_pad, K, layout)
    if lib.mmc_flip_smem_bytes(M, t.a.P, t.b.P, A_pad, K, T, t.a.nk, code) \
            != flip_smem_bytes(M, t.a.P, t.b.P, A_pad, K, T, t.a.nk, layout) \
            or lib.mmc_flip_ws_floats(M, A_pad, K, code) != n_ws:
        raise RuntimeError("csrc/flip_kernel.cu and flip_smem_bytes or "
                           "ws_floats disagree on the layout")
    ws = torch.empty((C, n_ws), dtype=torch.float32,
                     device=coords.device) if n_ws else None
    outs = (torch.empty_like(coords), torch.empty_like(com),
            torch.empty_like(quat), torch.empty_like(sfac),
            torch.empty_like(act), torch.empty_like(actm),
            torch.empty((C, N_STATS), dtype=torch.float32,
                        device=coords.device))

    def ptr(x):
        return None if x is None else x.data_ptr()

    a, b = t.a, t.b
    ins = (coords, com, quat, sfac, act, actm, box, temp, si2, lrc3, ux,
           a.body, a.qp, a.eps, a.sig2, a.has_lj, a.has_q, b.body, b.qp,
           b.eps, b.sig2, b.has_lj, b.has_q, a.tid_row, a.molid_row, a.q_row,
           a.kvec, a.kw)
    err = lib.mmc_flip_launch(
        *(ptr(x) for x in ins + outs + (ws,)), C, a.M, b.M, a.P, b.P,
        b.a_start, A_pad, K, T, a.nk, COULOMB_CODES[a.coulomb], ux.shape[1],
        code, int(seed) & 0xFFFFFFFF, chain0_arg(chain0), THREADS, a.rc2,
        a.qrc2, a.kappa_l,
        a.d2_overlap, float(t.ln_xi), COULOMB_FACTOR,
        torch.cuda.current_stream(coords.device).cuda_stream)
    if err != 0:
        msg = lib.mmc_flip_error_string(err).decode()
        raise RuntimeError(f"flip kernel launch failed: CUDA error {err} "
                           f"({msg})")
    flip.launches += 1
    coords_o, com_o, quat_o, sfac_o, act_o, actm_o, stats = outs
    return coords_o, com_o, quat_o, sfac_o, stats, act_o, actm_o


@functools.lru_cache(maxsize=None)
def _library():
    """csrc/flip_kernel.cu, built on first use, with its C interface
    declared (one load per process)."""
    from metropolismontecarlo_tpu_torch.ops.cuda.build import load_library

    lib = load_library("flip_kernel")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mmc_flip_launch.argtypes = [vp] * 36 + [ci] * 13 \
        + [ctypes.c_uint] * 2 + [ci] + [cf] * 6 + [vp]
    lib.mmc_flip_launch.restype = ci
    lib.mmc_flip_smem_bytes.argtypes = [ci] * 8
    lib.mmc_flip_smem_bytes.restype = ctypes.c_size_t
    lib.mmc_flip_ws_floats.argtypes = [ci] * 4
    lib.mmc_flip_ws_floats.restype = ctypes.c_size_t
    lib.mmc_flip_occupancy.argtypes = [ci] * 9 + [ctypes.c_void_p]
    lib.mmc_flip_occupancy.restype = ci
    lib.mmc_flip_error_string.argtypes = [ci]
    lib.mmc_flip_error_string.restype = ctypes.c_char_p
    return lib


def flip_plain(coords, com, quat, sfac, box, temp, act, actm, ux, t, si2,
               lrc3=None, seed=0, scores=None, magnitude=False, chain0=0):
    """Plain PyTorch version of the kernel: a Python loop over the
    attempts, vectorised over chains, each direction's energies computed
    for every chain and selected by the pick's species; f32 throughout.
    Same arguments and results as `flip`.  scores (C, n_flip, M), when
    given, replace the Philox pick scores (equal scores pick the lowest
    active slot, as the TPU interpreter's zero stream does).  With
    magnitude, stats gains a ninth column: the summed magnitudes of the
    terms the accepted flips' energy deltas add up (each pose row's LJ and
    Coulomb pair terms, each k-vector's reciprocal term, the constants),
    the scale of the deltas' f32 rounding."""
    coords, com, quat = coords.clone(), com.clone(), quat.clone()
    act, actm = act.clone(), actm.clone()
    sre, sim = sfac[..., 0].clone(), sfac[..., 1].clone()
    C, _, A_pad = coords.shape
    M = com.shape[1]
    dev = coords.device
    ar = torch.arange(C, device=dev)
    a = t.a
    ewald = a.coulomb == "ewald"
    cst, cfac = box_constants(a, box[:, None])
    inv_c = cst[1]
    tid = a.tid_row.clamp(min=0).long()
    valid = a.molid_row >= 0
    beta = 1.0 / temp
    iota = torch.arange(M, device=dev)[None, :]
    stats = torch.zeros((C, N_STATS + int(magnitude)), dtype=torch.float32,
                        device=dev)

    def tabs(ts):
        zero = torch.zeros_like(ts.eps[:, tid])
        return (4.0 * ts.eps[:, tid], ts.sig2[:, tid], zero, zero,
                (COULOMB_FACTOR * ts.qp)[:, None] * ts.q_row[None, :])

    # each direction: (old species' tables, new species' tables, the new
    # species' index, sign of ln xi), with the pair rows [old P_o, new P_n]
    dirs = []
    for so, sn, s_new, sgn in ((t.a, t.b, 1, 1.0), (t.b, t.a, 0, -1.0)):
        rows = tuple(torch.cat([x, y]) for x, y in zip(tabs(so), tabs(sn)))
        veto = (torch.arange(so.P + sn.P, device=dev) >= so.P)[None, :, None]
        sign = torch.cat([-torch.ones(so.P), torch.ones(sn.P)]).to(coords)
        dirs.append((so, sn, s_new, sgn, rows, veto, sign))

    def block_cols(ts, slot):
        """(C, P) atom columns of slot (C,) in block ts, clamped in range
        for the chains whose slot lies in the other block."""
        cols = ts.a_start + (slot - ts.m_start)[:, None] * ts.P \
            + torch.arange(ts.P, device=dev)[None, :]
        return cols.clamp(0, A_pad - 1)

    for fi in range(ux.shape[1]):
        ux_i = ux[:, fi]
        on = actm > 0.5
        n_a = on[:, :a.M].sum(1).to(coords.dtype)
        n_b = on[:, a.M:].sum(1).to(coords.dtype)
        sc = philox_scores(seed, C, fi, 0, M, dev, chain0) \
            if scores is None \
            else scores[:, fi]
        score = torch.where(on, sc, -torch.ones_like(sc))
        smax = score.max(dim=1, keepdim=True).values
        slot = torch.where(score == smax, iota, M).min(dim=1).values
        empty = smax[:, 0] < 0
        slot = torch.where(empty, 0, slot)     # the degenerate pick
        is_a = slot < a.M
        com_i = com[ar, slot]                                     # (C, 3)
        q = shoemake(ux_i)
        weight = torch.where(valid[None, :] & (a.molid_row[None, :]
                                               != slot[:, None]),
                             act, 0.0)[:, None, :]
        res = []
        for so, sn, s_new, sgn, rows, veto, sign in dirs:
            cols_o = block_cols(so, slot)
            old = coords.gather(2, cols_o[:, None, :].expand(C, 3, so.P))
            if sn.P > 1:
                rot = rot_apply(*q, sn.body[:, 0], sn.body[:, 1],
                                sn.body[:, 2])
                new = torch.stack([com_i[:, d:d + 1] + rot[d]
                                   for d in range(3)], 1)
            else:
                new = com_i[:, :, None].clone()
            pos = torch.cat([old, new], dim=2)
            e_rows, mag = pair_terms(a, coords, pos, weight, veto, cst, rows,
                                     magnitude)
            du = (e_rows * sign).sum(-1)
            const = si2[:, s_new] - si2[:, 1 - s_new]
            if lrc3 is not None:
                g00, g01, g11 = lrc3[:, 0], lrc3[:, 1], lrc3[:, 2]
                if s_new == 1:
                    const = const - (2.0 * n_a - 1.0) * g00 \
                        + (2.0 * n_b + 1.0) * g11 \
                        + 2.0 * (n_a - n_b - 1.0) * g01
                else:
                    const = const + (2.0 * n_a + 1.0) * g00 \
                        - (2.0 * n_b - 1.0) * g11 \
                        + 2.0 * (n_b - n_a - 1.0) * g01
            du = du + const
            if magnitude:
                mag = mag + const.abs()
            ds = None
            if ewald:
                ds = site_sfac(a, pos, torch.cat([-so.qp, sn.qp]), inv_c)
                dr, dr_mag = recip_delta(ds[0], ds[1], 1.0, sre, sim, cfac)
                du = du + dr
                if magnitude:
                    mag = mag + dr_mag
            free = torch.where(~on[:, sn.m_start:sn.m_start + sn.M],
                               iota[:, :sn.M], sn.M).min(dim=1).values
            ln_acc = sgn * t.ln_xi - beta * du
            res.append((cols_o, old, new, du, mag, ds, free, ln_acc, sn))

        def pick(x, y):
            return torch.where(is_a.reshape((C,) + (1,) * (x.dim() - 1)),
                               x, y)

        du = pick(res[0][3], res[1][3])
        free = pick(res[0][6], res[1][6])
        room = free < torch.where(is_a, t.b.M, t.a.M)
        ln_acc = pick(res[0][7], res[1][7])
        ln_u = torch.log(torch.clamp_min(ux_i[:, 7], 1e-30))
        ok = ~empty & room & (ln_u < ln_acc)
        okf = ok.to(coords.dtype)
        isaf = is_a.to(coords.dtype)
        # the writes: nothing when refused
        for d, (cols_o, old, new, _, _, ds, free_d, _, sn) in enumerate(res):
            w = ok & (is_a if d == 0 else ~is_a)
            if not bool(w.any()):
                continue
            wc = ar[w]
            tgt = sn.m_start + free_d[w]
            cols_n = block_cols(sn, sn.m_start + free_d)[w]
            actm[wc, slot[w]] = 0.0
            actm[wc, tgt] = 1.0
            act[wc[:, None], cols_o[w]] = 0.0
            act[wc[:, None], cols_n] = 1.0
            for k in range(3):
                coords[wc[:, None], k, cols_n] = new[w, k]
            com[wc, tgt] = com_i[w]
            quat[wc, tgt] = torch.cat(q, 1)[w]
            if ewald:
                sre[wc] += ds[0][w]
                sim[wc] += ds[1][w]
        zero = torch.zeros_like(okf)
        cols_s = [torch.where(ok, du, 0.0), okf * isaf, okf * (1.0 - isaf),
                  isaf, 1.0 - isaf, okf * (slot + 1).to(coords.dtype), zero,
                  zero]
        if magnitude:
            cols_s.append(torch.where(ok, pick(res[0][4], res[1][4]), 0.0))
        stats += torch.stack(cols_s, dim=1)
    return (coords, com, quat, torch.stack([sre, sim], dim=-1), stats, act,
            actm)
