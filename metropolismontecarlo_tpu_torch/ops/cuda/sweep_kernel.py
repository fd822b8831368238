"""Whole-sweep Metropolis op: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of metropolismontecarlo_tpu/ops/pallas/
sweep_kernel.py sweep_pallas: the base and species-block variants, the
sorted-slab windows, the activity mask, the in-kernel exchange attempts,
the transition-matrix deposits and the Widom ghosts).

One call runs the M sequential moves of one species block (global
molecules [m_start, m_start + M), atoms from column a_start, P each) on
every chain; a mixture makes one call per block, threading the state.  Each move: a
translate or rotate proposal, old and new site sums of LJ plus real-space
Coulomb (ewald / wolf / wolf_ref / bare / none) over all atoms, the
incremental S(k) and reciprocal energy delta (ewald), the overlap veto,
the Metropolis test, and the write-back of the accepted move.

With an activity mask (act (C, A_pad) per atom, actm (C, M_total) per
molecule slot, f32 1/0) an inactive slot's move is a null move that
counts as no attempt and inactive atoms add exactly 0 to every pair sum.
After the moves the same call can run n_exch grand-canonical exchange
attempts of this block's species (50/50 insertion into the first free
slot at a uniform pose / deletion of a uniform active slot, the muVT
acceptance in log space; the state's activity planes change) and then
n_widom ghost insertions that touch no state and deposit sum w and
sum w^2 of w = exp(-dU_ins / T).  With tmmc every attempt evaluates both
branches (the first free slot's insertion and the highest-scoring active
slot's deletion) and deposits their unbiased acceptances into the
collection matrix cmat (C, M + 1, 3) = [stay, up, down] of row n, and [1,
e, e^2] into uhist (C, M + 1, 3), e = e_in plus the call's running energy
delta; the bias eta (M + 1,) enters the acceptance thresholds only, so
eta = 0 samples what the plain exchange attempts sample.

With sorted slabs (tables.W > 0; mc/moves.py builds them) the last
species block is z-sorted and the planes (C, 3, A_store) carry a ghost
halo [A, A + W) replicating its first W columns: a move's pair scan reads
the other blocks as column segments and one W-wide window of the sorted
block at tables.wst[m], and an accepted head molecule also updates its
ghost twin (see csrc/sweep_kernel.cu).

The kernel keeps a chain's state in one thread block's shared memory
when it fits (layout "shared").  Otherwise, and always with slabs, the
atom planes, the activity planes and the molecule row stay in global
memory (layout "global"), and where even the k rows (S(k), cfac, the
moves' dS, the k-vectors) do not fit, those too (layout "global_k").  The
COM and quaternion rows and the per-atom charge and type rows stay in
global memory in every layout.  `sweep` picks the layout before the
launch (`choose_layout`); layout= forces one.  Only where the words live
differs: every layout takes the same decisions bit for bit.

Random numbers come from outside: u (C, M_total, 10) uniforms in [0, 1),
one row per molecule of the whole system, whose columns are [selector, dx, dy, dz, accept, e1, e2, e3, e4, angle] (the
TPU kernel's u[:, 0:10]), and ux (C, n_exch + n_widom, 8), one row per
attempt, [type, x, y, z, u1, theta2, theta3, accept].  The kernel and
sweep_plain read the same u and ux, so the two can be compared
trajectory by trajectory.  The one exception is the deletion pick, which
needs a score per slot and attempt: both generate it from the caller's
seed with Philox4x32-10 (`philox_scores`; key (seed, chain0 + chain),
counter (slot, attempt, 0, 0), the top 24 bits of the first output
word), the same integers in the kernel and here.  chain0 (default 0) is
the global index of the call's first chain: a rank holding rows
[c0, c0 + L) of a chain-sharded run passes c0, so its chains draw the
scores those chains draw in the unsharded run.

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
N_EXCH_UNIFORMS = 8
# stats columns: [energy delta (moves and exchanges), acc_trans, acc_rot,
# att_trans, att_rot (active slots only), acc_insert, acc_delete,
# att_insert (att_delete = n_exch - att_insert), decision fingerprint = sum
# of (global m + 1) over accepted moves, of (slot + 1) over accepted
# insertions and of (slot + 1 + M_total) over accepted deletions]
N_STATS = 9
MAX_SITES = 16
P_DEPOSIT = 0.5           # the exchange type's probability in a deposit
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
    kw (K,); nk the largest |integer component| of kvec (the extent of
    the Gibbs and flip kernels' per-site eik tables).  Sorted slabs (W >
    0): the sorted block's first column a0_w and width A_blk, the window
    width W, wst (M_total,) int32 each
    molecule's window start, segs (n_seg, 2) int32 the other blocks'
    [first column, width]; the rows are then A_store wide (ghost halo
    type and charge copied, molecule -1)."""

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
    nk: int = 0
    a0_w: int = 0
    A_blk: int = 0
    W: int = 0
    wst: torch.Tensor = None
    segs: torch.Tensor = None

    def tensors(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}


# Where a chain's state lives, in the order the choosers try them
# (csrc/mmc_common.cuh Layout): all of it in shared memory; the rows that
# grow with atoms and slots in global memory; those and the k rows too.
LAYOUTS = ("shared", "global", "global_k")
LAYOUT_CODES = {lay: i for i, lay in enumerate(LAYOUTS)}


QUEUE_WORDS = 2 * (THREADS // 32) * 128  # the warp queues: 128 entries
NEAR_WORDS = (THREADS // 32) * 64        # the warps' near rings: 64 keys


def smem_bytes(M, P, A_pad, K, T, use_act=False, tmmc=False,
               layout="shared"):
    """Dynamic shared memory of one block, M the molecules of the system;
    must match sweep_smem_floats in csrc/sweep_kernel.cu.  Every layout:
    the slot-pick row (64 words), the warp queues of live pair terms
    (QUEUE_WORDS) and of (atom, pose) pairs within reach (NEAR_WORDS), 4
    (P, T) LJ tables, 23 P-wide site rows (two proposal buffers of an old
    and a new pose, each site a 16-byte row of x, y, z and its live
    cutoff^2: 16; the body 3, charge, two flags and the live cutoff^2)
    and 96 words of scratch (two proposals' scalars, exchange uniforms,
    warp partials, the chain's statistics).  The shared layout adds 4 atom
    rows (x, y, z, molecule) and, with use_act, the two activity planes
    (A_pad + M); the shared and global layouts add 8 k-vector rows (S(k)
    re/im, cfac, dS re/im, the k-vectors); tmmc adds a second slot-pick
    row (64), a second set of warp queues, the deletion pose (4 P) and
    its warp partials (32), and outside global_k the deletion's S(k) row
    (2 K).  The COM and quaternion rows and the per-atom charge and type
    rows stay in global memory in every layout."""
    n = 64 + QUEUE_WORDS + NEAR_WORDS + 4 * P * T + 23 * P + 96
    if layout == "shared":
        n += 4 * A_pad + (A_pad + M if use_act else 0)
    if layout != "global_k":
        n += 8 * K + (2 * K if tmmc else 0)
    if tmmc:
        n += 64 + QUEUE_WORDS + 4 * P + 32
    return 4 * n


def kws_floats(K, tmmc=False):
    """Words of one chain's row of the global_k layout's k-row workspace
    (csrc/sweep_kernel.cu sweep_kws_floats): S(k) re/im, cfac and the
    move's dS re/im, and with tmmc the deletion's dS re/im."""
    return (7 if tmmc else 5) * K


def occupancy(M, P, A_pad, K, T, use_act=False, tmmc=False,
              layout="shared"):
    """(registers per thread, local memory per thread in bytes -- stack
    frame and spills --, blocks per SM) of the instantiation that this
    launch shape takes, from the CUDA runtime (the occupancy calculator:
    shared memory and registers); needs the card."""
    out = (ctypes.c_int * 3)()
    err = _library().mmc_sweep_occupancy(
        M, P, A_pad, K, T, int(use_act), int(tmmc), LAYOUT_CODES[layout], out)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return tuple(out)


def blocks_per_sm(M, P, A_pad, K, T, use_act=False, tmmc=False,
                  layout="shared"):
    """Blocks of this shape one SM holds at once (`occupancy`)."""
    return occupancy(M, P, A_pad, K, T, use_act, tmmc, layout)[2]


def pick_layout(sizes, layout, what):
    """The first of LAYOUTS whose shared-memory bytes (sizes: layout ->
    bytes) fit a block, or the one `layout` forces; the Gibbs and flip
    ops choose the same way.  Raises, with the byte count, when the
    forced layout or the last one (only the parts that do not grow with
    the state) does not fit."""
    if layout not in ("auto",) + LAYOUTS:
        raise ValueError(f"layout must be auto or one of {LAYOUTS}, got "
                         f"{layout!r}")
    want = layout
    if want == "auto":
        want = next((lay for lay in sizes if sizes[lay] <= MAX_SMEM_BYTES),
                    LAYOUTS[-1])
    if sizes[want] > MAX_SMEM_BYTES:
        raise ValueError(f"{what} needs {sizes[want]} B of shared memory "
                         f"in the {want} layout, over the {MAX_SMEM_BYTES} "
                         f"B a block may use")
    return want


def choose_layout(M, P, A_pad, K, T, use_act=False, tmmc=False,
                  slab=False, layout="auto"):
    """The kernel layout of a launch: the first of "shared", "global" and
    "global_k" that fits a block's shared memory ("global" or "global_k"
    with slabs), or the one `layout` forces.  Raises, with the byte
    count, when the forced layout does not fit, or when even global_k's
    (the parts that do not grow with the state) does not."""
    if slab and layout == "shared":
        raise ValueError("sorted slabs run on a global layout only")
    sizes = {lay: smem_bytes(M, P, A_pad, K, T, use_act, tmmc, lay)
             for lay in LAYOUTS if not (slab and lay == "shared")}
    return pick_layout(sizes, layout, "the chain state")


def _check_inputs(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u,
                  t, act, actm, n_exch, n_widom, ux, z, si, wc, tmmc, eta,
                  e_in):
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
    if (act is None) != (actm is None):
        raise ValueError("act and actm go together")
    n_seg = 0
    if t.W:
        if t.wst is None or t.segs is None or act is not None:
            raise ValueError("sorted slabs need wst and segs, and run "
                             "without activity planes")
        n_seg = t.segs.shape[0]
        if not (0 < t.W <= t.A_blk and t.a0_w + t.A_blk + t.W <= A_pad):
            raise ValueError(f"slab window W={t.W} of a block of "
                             f"{t.A_blk} atoms from column {t.a0_w} does "
                             f"not fit A_store={A_pad}")
    if n_exch < 0 or n_widom < 0:
        raise ValueError("n_exch and n_widom must be >= 0")
    if act is not None:
        tensors.update(act=act, actm=actm)
    if n_exch or n_widom:
        if act is None:
            raise ValueError("exchange attempts and Widom ghosts need the "
                             "activity planes act and actm")
        tensors.update(ux=ux, z=z, si=si, wc=wc)
    if tmmc:
        if not n_exch:
            raise ValueError("tmmc deposits need exchange attempts "
                             "(n_exch > 0)")
        tensors.update(eta=eta, e_in=e_in)
    shapes = dict(
        coords=(C, 3, A_pad), com=(C, M_total, 3), quat=(C, M_total, 4),
        sfac=(C, K, 2), box=(C,), temp=(C,), dr_max=(C,), dphi_max=(C,),
        u=(C, M_total, N_UNIFORMS), body=(t.P, 3), qp=(t.P,), eps=(t.P, T),
        sig2=(t.P, T), lam1=(t.P, T), lam2=(t.P, T), has_lj=(t.P,),
        has_q=(t.P,), tid_row=(A_pad,), molid_row=(A_pad,), q_row=(A_pad,),
        kvec=(K, 3), kw=(K,), wst=(M_total,), segs=(n_seg, 2),
        act=(C, A_pad), actm=(C, M_total),
        ux=(C, n_exch + n_widom, N_EXCH_UNIFORMS), z=(C,), si=(C,), wc=(C,),
        eta=(t.M + 1,), e_in=(C,))
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
        int_field = name in ("tid_row", "molid_row", "has_lj", "has_q",
                             "wst", "segs")
        if x.dtype != (torch.int32 if int_field else torch.float32):
            raise ValueError(f"{name}: dtype {x.dtype}")


def sweep(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u, tables,
          act=None, actm=None, n_exch=0, n_widom=0, ux=None, z=None, si=None,
          wc=None, seed=0, tmmc=False, eta=None, e_in=None, layout="auto",
          chain0=0):
    """One sweep of the species block's tables.M moves per chain, then
    n_exch exchange attempts and n_widom ghost insertions.

    coords (C, 3, A_pad), com (C, M_total, 3), quat (C, M_total, 4), sfac
    (C, K, 2), box/temp/dr_max/dphi_max (C,), u (C, M_total, 10); all f32,
    contiguous, on one device.  Optional: act (C, A_pad) and actm
    (C, M_total) f32 activity planes; with n_exch + n_widom > 0 also ux
    (C, n_exch + n_widom, 8), the per-chain activity z, the exchange
    constants si and wc (C,) (du = +-u_pair +- si + wc (2 n sgn + 1) +
    dU_recip) and the integer seed of the deletion scores; chain0 the
    global index of chain 0 of this call, which keys its scores.
    With tmmc (needs n_exch) also the bias eta (M + 1,) and the chains'
    carried energies e_in (C,).
    Returns new (coords, com, quat, sfac, stats (C, 9)); with activity
    planes also (act, actm, wid (C, 2) = [sum w, sum w^2] of the ghosts);
    with tmmc also (cmat, uhist), each (C, M + 1, 3), this call's deposits.
    layout: "auto" (choose_layout) or one of LAYOUTS.
    CUDA tensors launch the kernel (and count it in sweep.launches); CPU
    tensors run sweep_plain; any other device raises."""
    _check_inputs(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u,
                  tables, act, actm, n_exch, n_widom, ux, z, si, wc, tmmc,
                  eta, e_in)
    layout = choose_layout(com.shape[1], tables.P, coords.shape[2],
                           sfac.shape[1], tables.eps.shape[1],
                           act is not None, tmmc, tables.W > 0, layout)
    if coords.device.type == "cpu":
        return sweep_plain(coords, com, quat, sfac, box, temp, dr_max,
                           dphi_max, u, tables, act, actm, n_exch, n_widom,
                           ux, z, si, wc, seed, tmmc=tmmc, eta=eta,
                           e_in=e_in, chain0=chain0)
    if coords.device.type != "cuda":
        raise ValueError(f"no sweep for device {coords.device}")
    return _launch(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u,
                   tables, act, actm, n_exch, n_widom, ux, z, si, wc, seed,
                   tmmc, eta, e_in, layout, chain0)


sweep.launches = 0


def _launch(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u, t, act,
            actm, n_exch, n_widom, ux, z, si, wc, seed, tmmc, eta, e_in,
            layout, chain0):
    lib = _library()
    C, _, A_pad = coords.shape
    M_total, K, T = com.shape[1], sfac.shape[1], t.eps.shape[1]
    use_act = act is not None
    code = LAYOUT_CODES[layout]
    nbytes = smem_bytes(M_total, t.P, A_pad, K, T, use_act, tmmc, layout)
    if lib.mmc_sweep_smem_bytes(M_total, t.P, A_pad, K, T, int(use_act),
                                int(tmmc), code) != nbytes \
            or lib.mmc_sweep_kws_floats(K, int(tmmc)) != kws_floats(K, tmmc):
        raise RuntimeError("csrc/sweep_kernel.cu and smem_bytes or "
                           "kws_floats disagree on the layout")
    kws = None
    if layout == "global_k":
        kws = torch.empty((C, kws_floats(K, tmmc)), dtype=torch.float32,
                          device=coords.device)
    outs = (torch.empty_like(coords), torch.empty_like(com),
            torch.empty_like(quat), torch.empty_like(sfac),
            torch.empty((C, N_STATS), dtype=torch.float32,
                        device=coords.device))
    if use_act:
        outs += (torch.empty_like(act), torch.empty_like(actm),
                 torch.empty((C, 2), dtype=torch.float32,
                             device=coords.device))
    if tmmc:
        # the kernel zeroes each chain's rows before it deposits
        outs += tuple(torch.empty((C, t.M + 1, 3), dtype=torch.float32,
                                  device=coords.device) for _ in range(2))

    def ptr(x):
        return None if x is None else x.data_ptr()

    ins = (coords, com, quat, sfac, box, temp, dr_max, dphi_max, u, t.body,
           t.qp, t.eps, t.sig2, t.lam1, t.lam2, t.has_lj, t.has_q, t.tid_row,
           t.molid_row, t.q_row, t.kvec, t.kw, act, actm, ux, z, si, wc, eta,
           e_in, t.wst if t.W else None, t.segs if t.W else None)
    ptrs = [ptr(x) for x in ins + outs + (None,) * (10 - len(outs))
            + (kws,)]
    n_seg = t.segs.shape[0] if t.W else 0
    err = lib.mmc_sweep_launch(
        *ptrs, C, t.M, M_total, t.m_start, t.a_start, t.P, A_pad, K, T,
        COULOMB_CODES[t.coulomb],
        int(t.lj_shift == "linear"), int(t.use_rot), int(use_act),
        int(n_exch), int(n_widom), int(tmmc), code, n_seg, t.a0_w,
        t.A_blk, t.W, int(seed) & 0xFFFFFFFF, chain0_arg(chain0), THREADS,
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
    lib.mmc_sweep_launch.argtypes = [vp] * 43 + [ci] * 21 \
        + [ctypes.c_uint] * 2 + [ci] + [cf] * 6 + [vp]
    lib.mmc_sweep_launch.restype = ci
    lib.mmc_sweep_smem_bytes.argtypes = [ci] * 8
    lib.mmc_sweep_smem_bytes.restype = ctypes.c_size_t
    lib.mmc_sweep_kws_floats.argtypes = [ci] * 2
    lib.mmc_sweep_kws_floats.restype = ctypes.c_size_t
    lib.mmc_sweep_occupancy.argtypes = [ci] * 8 + [vp]
    lib.mmc_sweep_occupancy.restype = ci
    lib.mmc_cuda_error_string.argtypes = [ci]
    lib.mmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo32(m, x):
    """(high, low) 32-bit words of the product of the constant m < 2^32
    and x (int64 tensor, values < 2^32), through 16-bit halves of x so
    that no int64 intermediate overflows."""
    a, b = m * (x >> 16), m * (x & 0xFFFF)          # each < 2^48
    mid = a + (b >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (b & 0xFFFF)


def philox4x32(counter, key):
    """Philox4x32-10 (Salmon et al., SC 2011): counter 4 and key 2 int64
    tensors (broadcastable, values < 2^32) -> the 4 output words, int64
    tensors.  Integer arithmetic only, so the CUDA kernel's words and
    these are the same bits."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def chain0_arg(chain0):
    """chain0 as the kernels' unsigned argument; refuses a value that
    does not fit it."""
    chain0 = int(chain0)
    if not 0 <= chain0 <= _MASK32:
        raise ValueError(f"chain0 {chain0} is not a 32-bit chain index")
    return chain0


def philox_scores(seed, n_chains, attempt, m_start, M, device, chain0=0):
    """The kernel's deletion scores of one attempt: (C, M) int64 in
    [0, 2^24), the top 24 bits of the first Philox word for counter
    (slot, attempt, 0, 0) and key (seed, chain0 + chain), the chain index
    wrapped to 32 bits as the kernel's unsigned sum wraps it."""
    i64 = dict(dtype=torch.int64, device=device)
    slot = torch.arange(m_start, m_start + M, **i64)[None, :]
    chain = (torch.arange(n_chains, **i64)[:, None] + chain0_arg(chain0)) \
        & _MASK32
    zero = torch.zeros((), **i64)
    w0 = philox4x32((slot, zero + int(attempt), zero, zero),
                    (zero + (int(seed) & _MASK32), chain))[0]
    return w0 >> 8


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


def shoemake(ux_i):
    """The Shoemake quaternion of one attempt's uniforms ux_i (C, 8),
    columns 4-6, as four (C, 1) columns."""
    u1 = ux_i[:, 4:5]
    th2 = _TWO_PI * (ux_i[:, 5:6] - torch.round(ux_i[:, 5:6]))
    th3 = _TWO_PI * (ux_i[:, 6:7] - torch.round(ux_i[:, 6:7]))
    r1, r2 = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0)), torch.sqrt(u1)
    return (r1 * torch.sin(th2), r1 * torch.cos(th2), r2 * torch.sin(th3),
            r2 * torch.cos(th3))


def trial_pose(ux_i, box, body):
    """The insertion measure shared by exchange attempts and Widom
    ghosts, from one attempt's uniforms ux_i (C, 8): a uniform position
    (columns 1-3) and a Shoemake quaternion (columns 4-6; the identity
    for a one-site body).  Returns (com (C, 3), quat (C, 4), atoms
    (C, 3, P))."""
    ct = ux_i[:, 1:4] * box[:, None]
    P = body.shape[0]
    if P > 1:
        q = shoemake(ux_i)
        rot = rot_apply(*q, body[:, 0], body[:, 1], body[:, 2])
        atoms = torch.stack([ct[:, d:d + 1] + rot[d] for d in range(3)], 1)
        return ct, torch.cat(q, dim=1), atoms
    quat = torch.zeros((ct.shape[0], 4), dtype=ct.dtype, device=ct.device)
    quat[:, 0] = 1.0
    return ct, quat, ct[:, :, None].clone()


def box_constants(t, box_c):
    """The plain twins' constants of boxes of length box_c (C, 1): ((L,
    1 / L, kappa, Wolf shift), cfac (C, K)); the shift is None unless
    t.coulomb is "wolf", cfac None unless it is "ewald"."""
    inv_c = 1.0 / box_c
    kappa = t.kappa_l * inv_c
    sh_w = cfac = None
    if t.coulomb == "ewald":
        k2 = (t.kvec * t.kvec).sum(-1)                           # (K,)
        kt2 = (_TWO_PI * inv_c) ** 2 * k2
        vol = box_c * box_c * box_c
        cfac = t.kw * (_TWO_PI / vol) * torch.exp(
            -kt2 / (4.0 * kappa * kappa)) / kt2                   # (C, K)
    if t.coulomb == "wolf":
        qrc = math.sqrt(t.qrc2)
        sh_w = torch.special.erfc(kappa * qrc) / qrc              # (C, 1)
    return (box_c, inv_c, kappa, sh_w), cfac


def pair_terms(t, lanes, pos, weight, veto, cst, tabs, magnitude=False):
    """Site sums of pos (C, 3, R) against the atom lanes (C, 3, A) of one
    box per chain, with its constants cst (`box_constants`): the pair
    energies times weight (C, 1 | R, A) summed over lanes (C, R), and
    (magnitude) their magnitudes (C,); veto (C, R, 1) bool marks the rows
    that carry the +1e30 overlap penalty; tabs = (eps4, sig2, lam1, lam2,
    qq), the rows' (R, A) parameter tables."""
    box_c, inv_c, kappa, sh_w = cst
    eps4, sig2, lam1, lam2, qq = tabs
    d2 = None
    for d in range(3):
        dd = lanes[:, d, None, :] - pos[:, d, :, None]           # (C, R, A)
        dd = dd - box_c[:, :, None] * torch.round(dd * inv_c[:, :, None])
        d2 = dd * dd if d2 is None else d2 + dd * dd
    d2 = torch.clamp_min(d2, 1e-4)
    mask_lj = d2 < t.rc2
    mask_qq = d2 < t.qrc2 if t.qrc2 != t.rc2 else mask_lj
    inv_r = torch.rsqrt(d2)
    inv_d2 = inv_r * inv_r
    s2 = sig2 * inv_d2
    s6 = s2 * s2 * s2
    pot = eps4 * (s6 * s6 - s6)
    lj_mag = eps4.abs() * (s6 * s6 + s6) if magnitude else None
    if t.lj_shift == "linear":
        shift = lam1 + lam2 * torch.sqrt(d2)
        pot = pot + shift
        if magnitude:
            lj_mag = lj_mag + shift.abs()
    contrib = torch.where(mask_lj, pot, 0.0)
    mag = torch.where(mask_lj, lj_mag, 0.0) if magnitude else None
    if t.coulomb != "none":
        r = d2 * inv_r
        kr = kappa[:, :, None] * r
        if t.coulomb in ("ewald", "wolf_ref"):
            cp = qq * (torch.special.erfc(kr) * inv_r)
        elif t.coulomb == "wolf":
            cp = qq * (torch.special.erfc(kr) * inv_r - sh_w[:, :, None])
        else:
            cp = qq * inv_r
        cp = torch.where(veto & (d2 < t.d2_overlap) & (qq < 0.0), 1e30, cp)
        contrib = contrib + torch.where(mask_qq, cp, 0.0)
        if magnitude:
            mag = mag + torch.where(mask_qq, cp.abs(), 0.0)
    e = (contrib * weight).sum(-1)                                # (C, R)
    return e, ((mag * weight).sum((1, 2)) if magnitude else None)


def site_sfac(t, pos, qs, inv_c):
    """sum_r qs_r exp(i k~ . pos_r) in boxes of 1 / L inv_c (C, 1): pos
    (C, 3, R), qs (R,) -> ((C, K), (C, K))."""
    tpl = (_TWO_PI * inv_c)[:, :, None]                           # (C, 1, 1)
    ph = tpl * (t.kvec[:, 0] * pos[:, 0, :, None]
                + t.kvec[:, 1] * pos[:, 1, :, None]
                + t.kvec[:, 2] * pos[:, 2, :, None])             # (C, R, K)
    ph = ph - _TWO_PI * torch.round(ph * _INV_TWO_PI)
    qs = qs[None, :, None]
    return (qs * torch.cos(ph)).sum(1), (qs * torch.sin(ph)).sum(1)


def recip_delta(ds_re, ds_im, sgn, s_re, s_im, cfac):
    """(dU_recip (C,), its magnitude) of S = s_re + i s_im -> S + sgn dS,
    cfac (C, K) the box's k-space coefficients."""
    cross = 2.0 * sgn * (s_re * ds_re + s_im * ds_im) \
        + ds_re * ds_re + ds_im * ds_im
    return COULOMB_FACTOR * (cfac * cross).sum(-1), \
        COULOMB_FACTOR * (cfac * cross.abs()).sum(-1)


def sweep_plain(coords, com, quat, sfac, box, temp, dr_max, dphi_max, u, t,
                act=None, actm=None, n_exch=0, n_widom=0, ux=None, z=None,
                si=None, wc=None, seed=0, magnitude=False, scores=None,
                tmmc=False, eta=None, e_in=None, chain0=0):
    """Plain PyTorch version of the kernel: a Python loop over the M
    molecules, the exchange attempts and the ghosts, vectorised over
    chains, f32 throughout.  Same arguments and results as `sweep`.
    scores (C, n_exch, M_total) f32, when given, replace the Philox
    deletion scores (a test forces a deletion slot with them).  With
    magnitude, stats gains a tenth column:
    the sum over accepted moves and exchanges of the magnitudes of the
    terms their energy deltas add up (each old and new row's r^-12 and
    r^-6 LJ terms, linear shift and Coulomb pair terms, each k-vector's
    reciprocal term, the exchange constants), the scale of the energy
    delta's f32 rounding, for holding another route's energy delta
    against this one's; with tmmc the results also gain umag (C, M + 1,
    3), each row's scales: of uhist's sum E and sum E^2, the sums over its
    deposits of s = |e_in| + the magnitude column so far and of
    (|e| + s)^2; of its cmat entries, the sum over its deposits of
    beta (up m_ins + dn m_del), m a branch's term magnitudes, which is
    how far a relative error of the energy terms moves the deposits."""
    coords, com, quat = coords.clone(), com.clone(), quat.clone()
    sre, sim = sfac[..., 0].clone(), sfac[..., 1].clone()
    C, _, A_pad = coords.shape
    M_total = com.shape[1]
    P = t.P
    dev = coords.device
    use_act = act is not None
    if use_act:
        act, actm = act.clone(), actm.clone()
    temp_c = temp[:, None]
    cst, cfac = box_constants(t, box[:, None])
    box_c, inv_box = cst[0], cst[1]
    ewald = t.coulomb == "ewald"
    tid = t.tid_row.clamp(min=0).long()
    eps4_p, sig2_p = 4.0 * t.eps[:, tid], t.sig2[:, tid]          # (P, A)
    lam1_p, lam2_p = t.lam1[:, tid], t.lam2[:, tid]
    qq_p = (COULOMB_FACTOR * t.qp)[:, None] * t.q_row[None, :]
    valid = t.molid_row >= 0
    bx, by, bz = t.body[:, 0], t.body[:, 1], t.body[:, 2]
    stats = torch.zeros((C, N_STATS + int(magnitude)), dtype=torch.float32,
                        device=dev)

    rep2 = [x.repeat(2, 1) for x in (eps4_p, sig2_p, lam1_p, lam2_p, qq_p)]
    new_row = (torch.arange(2 * P, device=dev) >= P)[None, :, None]
    sign = torch.cat([-torch.ones(P), torch.ones(P)]).to(coords)  # (2P,)
    if t.W:
        # sorted slabs: lanes by column range (the ghost columns carry
        # molecule -1): the other blocks' segments and the move's window
        wst = t.wst.tolist()
        seg_lanes = torch.zeros(A_pad, dtype=torch.bool, device=dev)
        for b0, width in t.segs.tolist():
            seg_lanes[b0:b0 + width] = True

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

        if t.W:
            lanes = seg_lanes.clone()
            lanes[a0:a0 + P] = False
            lanes[max(wst[mg], t.a0_w):wst[mg] + t.W] = True
            in_w = a0 >= t.a0_w          # the mover is in the sorted block
            if in_w:
                lanes[a0:a0 + P] = False
                lanes[a0 + t.A_blk:a0 + t.A_blk + P] = False
            other = lanes.to(coords.dtype)[None, None, :]
        else:
            other = (valid & (t.molid_row != mg)).to(coords.dtype)[
                None, None, :]
        if use_act:
            other = other * act[:, None, :]
        e_rows, mag = pair_terms(t, coords, pos, other, new_row, cst, rep2,
                                 magnitude)
        d_e = (e_rows * sign).sum(-1)                            # (C,)

        if ewald:
            ds_re, ds_im = site_sfac(t, pos, sign * t.qp.repeat(2), inv_box)
            dr_e, dr_mag = recip_delta(ds_re, ds_im, 1.0, sre, sim, cfac)
            d_e = d_e + dr_e
            if magnitude:
                mag = mag + dr_mag

        beta_de = d_e / temp_c[:, 0]
        accept = (beta_de < 0.0) | (um[:, 4] < torch.exp(-beta_de))
        ts = tsel[:, 0]
        if use_act:
            gate = act[:, a0]        # an inactive slot: a null move
            accept = accept & (gate > 0.0)
            att_t, att_r = gate * ts, gate * (1.0 - ts)
        else:
            att_t, att_r = ts, 1.0 - ts
        acc = accept[:, None]
        com[:, mg] = torch.where(acc, ncom, com[:, mg])
        if t.use_rot:
            quat[:, mg] = torch.where(acc, torch.cat([w1, x1, y1, z1], 1),
                                      quat[:, mg])
        coords[:, :, a0:a0 + P] = torch.where(acc[:, :, None], new, old)
        if t.W and in_w and a0 - t.a0_w < t.W:
            # a head molecule's ghost twin (the halo may end inside it)
            n_g = min(P, t.a0_w + t.W - a0)
            g = slice(a0 + t.A_blk, a0 + t.A_blk + n_g)
            coords[:, :, g] = torch.where(acc[:, :, None], new[:, :, :n_g],
                                          coords[:, :, g])
        if ewald:
            sre = torch.where(acc, sre + ds_re, sre)
            sim = torch.where(acc, sim + ds_im, sim)
        af = accept.to(coords.dtype)
        zero = torch.zeros_like(af)
        cols = [torch.where(accept, d_e, 0.0), af * ts, af * (1.0 - ts),
                att_t, att_r, zero, zero, zero, af * float(mg + 1)]
        if magnitude:
            cols.append(torch.where(accept, mag, 0.0))
        stats += torch.stack(cols, dim=1)

    if not use_act:
        return coords, com, quat, torch.stack([sre, sim], dim=-1), stats

    wid = torch.zeros((C, 2), dtype=torch.float32, device=dev)
    if n_exch or n_widom:
        beta = 1.0 / temp
        ar = torch.arange(C, device=dev)
        iota = torch.arange(t.M, device=dev)[None, :]
        prange = torch.arange(P, device=dev)[None, :]
        m0, m1 = t.m_start, t.m_start + t.M
        tabs = (eps4_p, sig2_p, lam1_p, lam2_p, qq_p)

        def pose_energy(pos, excl, veto, sgn):
            """(sgn * pair + reciprocal delta (C,), magnitude, dS) of the
            pose pos (C, 3, P) against the active atoms of molecules other
            than excl (C,)."""
            weight = torch.where(
                valid[None, :] & (t.molid_row[None, :] != excl[:, None]),
                act, 0.0)[:, None, :]
            e_rows, mag = pair_terms(t, coords, pos, weight,
                                     veto[:, None, None], cst, tabs,
                                     magnitude)
            part = sgn * e_rows.sum(-1)
            ds = None
            if ewald:
                ds = site_sfac(t, pos, t.qp, inv_box)
                dr_e, dr_mag = recip_delta(
                    ds[0], ds[1],
                    sgn[:, None] if torch.is_tensor(sgn) else sgn, sre, sim,
                    cfac)
                part = part + dr_e
                if magnitude:
                    mag = mag + dr_mag
            return part, mag, ds

    if n_exch:
        lnzv = torch.log(z * box * box * box)
    if tmmc:
        f32 = dict(dtype=torch.float32, device=dev)
        cmat = torch.zeros((C, t.M + 1, 3), **f32)
        uhist = torch.zeros((C, t.M + 1, 3), **f32)
        umag = torch.zeros((C, t.M + 1, 3), **f32)
        ones = torch.ones((C,), **f32)
        veto_on = torch.ones((C,), dtype=torch.bool, device=dev)
    for xi in range(n_exch):
        ux_i = ux[:, xi]
        is_ins = ux_i[:, 0] < 0.5
        insf = is_ins.to(coords.dtype)
        sgn = 2.0 * insf - 1.0
        on = actm[:, m0:m1] > 0.5
        n = on.sum(1).to(coords.dtype)
        if scores is None:
            sc = philox_scores(seed, C, xi, m0, t.M, dev, chain0)
        else:
            sc = scores[:, xi, m0:m1]
        # deletion: the largest score on the active set, the lower index
        # on a tie; insertion: the first free slot; no candidate: slot 0
        # of the block, the branch is refused
        score = torch.where(on, sc, -torch.ones_like(sc))
        smax = score.max(dim=1, keepdim=True).values
        del_i = torch.where(score == smax, iota, t.M).min(dim=1).values
        ins_i = torch.where(~on, iota, t.M).min(dim=1).values
        idx_i = torch.where(ins_i >= t.M, 0, ins_i)
        idx_d = torch.where(del_i >= t.M, 0, del_i)
        idx = torch.where(is_ins, idx_i, idx_d)
        slot = m0 + idx
        cols = (t.a_start + idx * P)[:, None] + prange            # (C, P)
        gidx = cols[:, None, :].expand(C, 3, P)
        cur = coords.gather(2, gidx)                              # (C, 3, P)
        ct, q_ins, ins_atoms = trial_pose(ux_i, box, t.body)
        if tmmc:
            # both branches, each as the selected branch is summed below
            cols_d = (t.a_start + idx_d * P)[:, None] + prange
            cur_d = coords.gather(2, cols_d[:, None, :].expand(C, 3, P))
            du_i, mag_i, ds_i = pose_energy(ins_atoms, m0 + idx_i, veto_on,
                                            ones)
            du_d, mag_d, ds_d = pose_energy(cur_d, m0 + idx_d, ~veto_on,
                                            -ones)
            const_i = si * ones + wc * (2.0 * n * ones + 1.0)
            const_d = si * -ones + wc * (2.0 * n * -ones + 1.0)
            du_i, du_d = du_i + const_i, du_d + const_d
            la_i = (lnzv - torch.log(n + 1.0)) - beta * du_i
            la_d = (torch.log(torch.clamp_min(n, 1.0)) - lnzv) - beta * du_d
            can_i, can_d = n < t.M - 0.5, n > 0.5
            up = torch.where(can_i, P_DEPOSIT * torch.exp(
                torch.clamp_max(la_i, 0.0)), 0.0)
            dn = torch.where(can_d, P_DEPOSIT * torch.exp(
                torch.clamp_max(la_d, 0.0)), 0.0)
            row = n.long()
            cmat[ar, row] += torch.stack([1.0 - up - dn, up, dn], 1)
            e = e_in + stats[:, 0]
            uhist[ar, row] += torch.stack([ones, e, e * e], 1)
            if magnitude:
                s_e = e_in.abs() + stats[:, N_STATS]
                s_dep = beta * (up * (mag_i + const_i.abs())
                                + dn * (mag_d + const_d.abs()))
                umag[ar, row] += torch.stack(
                    [s_e, (e.abs() + s_e) ** 2, s_dep], 1)
            # the bias, in the thresholds only
            eta_n = eta[row]
            la_i = (la_i + eta[torch.clamp_max(row + 1, t.M)]) - eta_n
            la_d = (la_d + eta[torch.clamp_min(row - 1, 0)]) - eta_n
            du = torch.where(is_ins, du_i, du_d)
            const = torch.where(is_ins, const_i, const_d)
            ln_acc = torch.where(is_ins, la_i, la_d)
            can = torch.where(is_ins, can_i, can_d)
            mag = torch.where(is_ins, mag_i, mag_d) if magnitude else None
            if ewald:
                ds = tuple(torch.where(is_ins[:, None], a, b)
                           for a, b in zip(ds_i, ds_d))
        else:
            sel = torch.where(is_ins[:, None, None], ins_atoms, cur)
            # excl = slot serves both branches: the insertion slot is
            # inactive
            du, mag, ds = pose_energy(sel, slot, is_ins, sgn)
            const = si * sgn + wc * (2.0 * n * sgn + 1.0)
            du = du + const
            ln_acc = torch.where(is_ins, lnzv - torch.log(n + 1.0),
                                 torch.log(torch.clamp_min(n, 1.0)) - lnzv) \
                - beta * du
            can = torch.where(is_ins, n < t.M - 0.5, n > 0.5)
        ln_u = torch.log(torch.clamp_min(ux_i[:, 7], 1e-30))
        ok = can & (ln_u < ln_acc)
        wr = ok & is_ins
        actm[ar, slot] = torch.where(ok, insf, actm[ar, slot])
        act.scatter_(1, cols, torch.where(ok[:, None], insf[:, None],
                                          act.gather(1, cols)))
        coords.scatter_(2, gidx, torch.where(wr[:, None, None], ins_atoms,
                                             cur))
        com[ar, slot] = torch.where(wr[:, None], ct, com[ar, slot])
        if P > 1:
            quat[ar, slot] = torch.where(wr[:, None], q_ins, quat[ar, slot])
        if ewald:
            okf = (ok.to(coords.dtype) * sgn)[:, None]
            sre = sre + okf * ds[0]
            sim = sim + okf * ds[1]
        okf = ok.to(coords.dtype)
        zero = torch.zeros_like(okf)
        fp = okf * (slot + 1 + (~is_ins) * M_total).to(coords.dtype)
        cols_s = [torch.where(ok, du, 0.0), zero, zero, zero, zero,
                  okf * insf, okf * (1.0 - insf), insf, fp]
        if magnitude:
            cols_s.append(torch.where(ok, mag + const.abs(), 0.0))
        stats += torch.stack(cols_s, dim=1)

    for wi in range(n_widom):
        _, _, ins_atoms = trial_pose(ux[:, n_exch + wi], box, t.body)
        n = (actm[:, m0:m1] > 0.5).sum(1).to(coords.dtype)
        none = torch.full((C,), -2, dtype=torch.long, device=dev)
        veto = torch.ones((C,), dtype=torch.bool, device=dev)
        du, _, _ = pose_energy(ins_atoms, none, veto, 1.0)
        du = du + (si + wc * (2.0 * n + 1.0))
        # a vetoed ghost carries +1e30: w = 0
        w = torch.exp(-beta * du)
        wid += torch.stack([w, w * w], dim=1)
    out = (coords, com, quat, torch.stack([sre, sim], dim=-1), stats, act,
           actm, wid)
    if tmmc:
        out += (cmat, uhist) + ((umag,) if magnitude else ())
    return out
