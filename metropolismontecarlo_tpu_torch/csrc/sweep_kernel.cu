// Whole-sweep Metropolis kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel metropolismontecarlo_tpu/ops/pallas/sweep_kernel.py
// sweep_pallas / _make_kernel: the base and species-block variants, the
// sorted-slab windows (slab), the activity mask (use_act), the in-kernel
// grand-canonical exchange attempts (n_exch), the transition-matrix
// deposits (tmmc) and the Widom ghost insertions (n_widom), with lj_shift
// "none" and "linear".  Plain PyTorch twin: ops/cuda/sweep_kernel.py
// sweep_plain.
//
// What it computes: for one chain per thread block, M sequential moves of
// the species block whose molecules are [m_start, m_start + M) (global
// indices) and whose atoms start at column a_start, P atoms each.  A
// uniform system is one block (m_start = a_start = 0); a mixture runs one
// launch per block, each over the full atom planes.  Each move makes a translate or rotate proposal, sums the old and
// new site energies (LJ from per-site tables plus real-space Coulomb:
// ewald / wolf / wolf_ref / bare / none) over every atom, adds the
// incremental S(k) and reciprocal energy delta (ewald), vetoes attractive
// overlaps with a +1e30 penalty, takes the Metropolis decision and writes
// the accepted move back.  Uniforms come from the caller, u (C, M, 10).
//
// What bounds it on this card: instruction issue and latency inside each
// block, not bytes.  The moves of a chain form a dependent chain of 750
// steps (at the 750-water flagship), each a pass over ~2300 atoms x 3
// sites x 2 poses followed by a block-wide sum and a scalar decision;
// device memory is touched only to load and store the chain state and to
// read 40 B of uniforms per move.  Only a fifth of the flagship's site
// pairs lie inside the cutoff, and a pair's LJ + erfc body costs several
// times its distance.  The design:
// - Residency: the atom planes and molecule row, S(k), the k-vectors and
//   the LJ tables live in shared memory for the whole sweep; the COM and
//   quaternion rows, which only the moved molecule touches, stay in the
//   chain's own rows of the outputs (copied in at entry, updated in
//   place), and the per-atom charge and type rows, the same for every
//   chain, in their global tables (L1).  A 750-water block needs ~58 KB,
//   and __launch_bounds__ caps the registers so that three blocks share
//   an SM.
// - Compacted pair sums in three stages per warp, each on full warps:
//   (0) 32 consecutive atom columns at a time, the distance to each
//   pose's centre; the (atom, pose) pairs within the pose's reach (the
//   largest cutoff plus the pose's radius: exact, the minimum-image
//   distance obeys the triangle inequality) go to the warp's near ring;
//   (1) 32 near pairs at a time, the pose's site distances, 3 sites per
//   step (a ballot per site; a lane's slot follows the live lanes below
//   it), the triples inside their site's cutoff to the warp's queue of
//   live terms; (2) 32 live terms at a time, LJ and erfc Coulomb.  A
//   partial flush of each ends the pass.  A pose's sites are 16-byte rows
//   (x, y, z, the site's live cutoff^2), one load each.  The exchange,
//   ghost and tmmc passes run stages 1-2 over every active atom, one
//   queue per branch.
// - Proposals off the critical path: move m + 1 does not depend on move
//   m's outcome (each molecule moves once per launch, and move m touches
//   none of molecule m + 1's rows), so the last warp builds the next
//   move's proposal (with activity, for the next active slot) into the
//   other half of a double buffer while the block sums move m.
// - Two barriers per move: after the warp partials every thread sums them
//   in the same order and takes the same decision; P threads write an
//   accepted move's atoms, seven its COM and quaternion, each thread the
//   S(k) deltas of its own k-vectors; the second barrier orders those
//   writes before the next pass.
// The pair arithmetic (minimum image, d^2 floor, erfc, the order inside a
// term) is the same for every term; only the order in which terms are
// summed follows the queues.
//
// Semantics kept from the TPU kernel: the molecule-id mask and the COM,
// quaternion and uniform rows use the global index m_start + m, the atom
// columns a_start + m * P; old atoms are read from the stored
// coordinates, never rebuilt from COM + quaternion; new atoms are the
// floor-wrapped new COM plus R(q_new) body (not wrapped per atom); pair
// distances use the minimum image rounded to nearest, ties to even
// (rintf's values, computed on the FMA pipe: round_near) with d^2 floored
// at 1e-4; pads
// (molid < 0) and the molecule's own atoms are excluded; S(k) changes only
// on accept; the energy statistic adds d_e by select, so a rejected move's
// overflowed delta never enters.
//
// Activity (use_act): act (C, A_pad) is 1 on the atoms of active molecule
// slots and 0 on inactive slots and pads, actm (C, M_total) the same per
// molecule.  An inactive slot's move is a null move (the proposal warp
// skips to the next active slot: one chain per block makes the skip
// block-uniform) and is not counted as an attempt; inactive neighbour
// lanes add exactly 0.
//
// Exchanges (n_exch > 0, needs use_act): after the moves, n_exch attempts on
// uniforms ux (C, n_exch + n_widom, 8) = [type, x, y, z, u1, th2, th3,
// accept].  type < 0.5 inserts into the first free slot of this block at a
// uniform position with a Shoemake quaternion, else deletes the active slot
// of this block with the largest score (ties to the lower index); the
// scores are Philox4x32-10 words keyed by (seed, chain0 + chain), chain0
// the global index of the launch's first chain (a rank's shard of a
// chain-sharded run keys on global chain ids), with counter (slot,
// attempt, 0, 0), which sweep_plain reproduces bit for bit.  The TPU
// kernel picks slots by full-row one-hot reductions; here a block max
// reduction over 64-bit keys finds the slot and its columns are read
// directly.  du = +-u_pair +- si + wc (2 n sgn + 1) + dU_recip against the
// live S(k), accepted in log space with the muVT rule; the +1e30 overlap
// veto applies to insertions only; n counts this block's active slots;
// insertion at n = M and deletion at n = 0 are refused.
//
// Transition matrix (tmmc, needs n_exch; its own instantiation): every
// attempt evaluates both branches -- the insertion pose into the first
// free slot (veto on) and the deletion of the highest-scoring active slot
// (veto off), each with its own pair sum, S(k) row and reciprocal delta,
// in one pass over the atom lanes -- and deposits both unbiased
// acceptances: row n of cmat (C, M + 1, 3) receives [1 - up - dn, up, dn],
// up = 0.5 pa_ins and dn = 0.5 pa_del with pa = exp(min(ln_acc, 0)) (0 at
// n = M resp. n = 0), and row n of uhist (C, M + 1, 3) receives [1, e,
// e^2] with e = e_in (C,) plus this launch's running energy delta.  The
// block zeroes its chain's rows at entry (one chain per block: no races).
// Only then does the bias eta (M + 1,) enter the thresholds: ln_acc_ins +=
// eta[min(n + 1, M)] - eta[n], ln_acc_del += eta[max(n - 1, 0)] - eta[n].
// Each branch's arithmetic is the n_exch instantiation's (same lane
// stride, skip test, queue of its own, term order, signs and roundings),
// so eta = 0 takes the same decisions bit for bit.
//
// Widom (n_widom > 0, needs use_act): after moves and exchanges, n_widom
// ghost insertions with the same pose and energy code and no writes; wid
// (C, 2) receives sum w and sum w^2, w = exp(-du_ins / T).
//
// Global layouts (kLayout, one instantiation each): for chain states that
// do not fit a block's shared memory, the rows that grow with the atoms
// and slots move to global memory (kGlobal: 6859 SPC/E waters with K =
// 2874 would need ~435 KB, a capacity-4096 muVT chain ~369 KB).  The x/y/z
// planes live in the chain's own rows of the output, copied in at entry
// and updated in place by accepted moves and insertions; with activity
// the act and actm planes likewise live in the chain's rows of act_out
// and actm_out; the molecule row is read from its global table (shared by
// all chains, so L2 keeps it).  Where even the k rows overflow (kGlobalK:
// 6859 waters at tol 1e-5, K = 22,994, would need ~736 KB of them), S(k),
// cfac and the move's dS rows (and tmmc's deletion row) live in the
// chain's rows of the workspace kws, and the k-vectors are read from
// their global table (L1/L2).  Every thread touches only the k-vectors it
// owns (k = tid, tid + 256, ...), in every pass.  Shared memory keeps the
// LJ tables, the site rows, the queues and the scratch.  The writes of an
// accepted move or exchange are ordered before every other thread's reads
// by the barrier that ends it (__syncthreads orders a block's global
// writes too).  The arithmetic, lane order, skip tests, queues and
// reduction order are the shared layout's; only where the words live
// differs.
//
// Sorted slabs (W > 0, global layout): the last species block (atoms
// [a0_w, a0_w + A_blk)) is kept z-sorted by the caller, and the planes
// carry a ghost halo [A, A + W) replicating its first W columns.  A
// move's pair scan reads each other species block as a column segment
// (segs: (n_seg, 2) = [first column, width]; the mover's own columns
// excluded) and one W-wide window of the sorted block starting at column
// wst[m]: lanes below a0_w are skipped, and a mover of the sorted block
// (a0 >= a0_w) excludes its own columns and their ghost twin at +A_blk.  Lane validity comes from these column ranges,
// not from molid (ghost columns carry molid -1).  An accepted move of a
// head molecule (column offset < W in its block) also writes its twin's
// columns inside the halo.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mmc_common.cuh"

namespace {

constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr int kStats = 9;
constexpr int kUniforms = 10;
constexpr int kExchUniforms = 8;
constexpr float kPDep = 0.5f;  // the exchange type's probability, folded in
// A live pair term's queue key (mmc_common.cuh Queue): the atom column
// (kKeySite bits), the site (4 bits), the pose's sign (1: new or exchange
// pose, 0: old pose) and the overlap veto.
constexpr int kKeySign = 24, kKeyVeto = 25;
// A warp's ring of (atom, pose) pairs within the pose's reach, kNear keys
// (the atom column with the pose's sign and veto bits): the move pass
// computes site distances only for these.  One pose of 32 lanes is
// appended at a time, so 31 left over plus 32 fit the ring.
constexpr int kNear = 64;
constexpr int kNearWords = kWarps * kNear;
// One proposal's scalars: the new COM and the new pose's squared reach
// [0, 4), the old COM and the old pose's squared reach [4, 8) (a reach is
// the largest cutoff plus the pose's radius, with a rounding margin), the
// new quaternion [8, 12), tsel, the accept uniform and the local move
// index (M: the sweep is over).
constexpr int kDec = 16;

// Shared-memory words of one block; ops/cuda/sweep_kernel.py smem_bytes
// computes the same number.  Every layout holds the slot-pick row (64
// words: 32 x 8 B), the warp queues and near rings, the 4 LJ tables (P T),
// 23 P-wide site rows (two proposal buffers of an old and a new pose, each
// site a 16-byte row of x, y, z and its live cutoff^2: 16; the body 3,
// charge, two flags and the live cutoff^2) and 96 words of scratch (2 x 16
// proposal scalars, 16 exchange uniforms, 32 warp partials, 16 for the
// chain's statistics).  The shared layout adds the 4 atom rows x, y, z and
// molecule (A_pad; charges and types are read from their global tables,
// the same for every chain) and, with use_act, the two activity planes;
// the shared and global layouts add the 8 k-vector rows (K); tmmc adds a
// second slot-pick row (64), a second set of warp queues, the deletion
// pose (4 P) and its warp partials (32), and outside kGlobalK the
// deletion's S(k) row (2 K).
__host__ __device__ inline size_t sweep_smem_floats(int M, int P, int A_pad,
                                                    int K, int T, int use_act,
                                                    int tmmc, int layout) {
  size_t n = 64 + kQueueWords + kNearWords + 4 * (size_t)P * T +
             23 * (size_t)P + 96;
  if (layout == kShared) n += 4 * (size_t)A_pad;
  if (layout != kGlobalK) n += 8 * (size_t)K;
  if (use_act && layout == kShared) n += (size_t)A_pad + (size_t)M;
  if (tmmc) n += 64 + kQueueWords + 4 * (size_t)P + 32;
  if (tmmc && layout != kGlobalK) n += 2 * (size_t)K;
  return n;
}

// Words of one chain's row of the k-row workspace (kGlobalK): S(k) re/im,
// cfac and the move's dS re/im, and with tmmc the deletion's dS re/im.
__host__ __device__ inline size_t sweep_kws_floats(int K, int tmmc) {
  return (size_t)(tmmc ? 7 : 5) * K;
}

// kAct: the activity-mask instantiation (use_act), which alone carries the
// exchange attempts and the ghosts; the other keeps the fixed-N sweep's
// inner loop and register count free of them.  kTmmc (with kAct): the
// transition-matrix instantiation, whose attempts evaluate both branches
// and deposit cmat/uhist; the fixed-N and muVT instantiations carry none
// of it.  kLayout: where the chain state lives (Layout); the global
// layouts alone carry the slab windows.  The fixed-N kGlobal instantiation
// keeps the three-block register cap of the shared ones (two blocks of
// the 6859-water state share an SM); the other global ones take
// kMinBlocksGlobal.
template <bool kAct, bool kTmmc, int kLayout>
__global__ void __launch_bounds__(
    kThreads, kLayout == kShared || (!kAct && kLayout == kGlobal)
                  ? kMinBlocks
                  : kMinBlocksGlobal) sweep_kernel(
    const float* __restrict__ coords_in, const float* __restrict__ com_in,
    const float* __restrict__ quat_in, const float* __restrict__ sfac_in,
    const float* __restrict__ box_in, const float* __restrict__ temp_in,
    const float* __restrict__ drmax_in, const float* __restrict__ dphi_in,
    const float* __restrict__ u_in, const float* __restrict__ body,
    const float* __restrict__ qp, const float* __restrict__ eps_pt,
    const float* __restrict__ sig2_pt, const float* __restrict__ lam1_pt,
    const float* __restrict__ lam2_pt, const int* __restrict__ has_lj,
    const int* __restrict__ has_q, const int* __restrict__ tid_row,
    const int* __restrict__ molid_row, const float* __restrict__ q_row,
    const float* __restrict__ kvec, const float* __restrict__ kw,
    const float* __restrict__ act_in, const float* __restrict__ actm_in,
    const float* __restrict__ ux_in, const float* __restrict__ z_in,
    const float* __restrict__ si_in, const float* __restrict__ wc_in,
    const float* __restrict__ eta_in, const float* __restrict__ e_in,
    const int* __restrict__ wst, const int* __restrict__ segs,
    float* __restrict__ coords_out, float* __restrict__ com_out,
    float* __restrict__ quat_out, float* __restrict__ sfac_out,
    float* __restrict__ stats_out, float* __restrict__ act_out,
    float* __restrict__ actm_out, float* __restrict__ wid_out,
    float* __restrict__ cmat_out, float* __restrict__ uhist_out,
    float* __restrict__ kws, int M,
    int M_total, int m_start, int a_start, int P, int A_pad, int K, int T,
    int coulomb, int lj_linear, int use_rot, int n_exch, int n_widom,
    int n_seg, int a0_w, int A_blk, int W, unsigned int seed,
    unsigned int chain0, float rc2,
    float qrc2, float kappa_l, float d2_overlap, float p_translate,
    float factor) {
  extern __shared__ float smem[];
  // 32 x 8-byte slots of the slot-pick reduction first: 8-byte aligned;
  // tmmc's deletion pick has a second row
  unsigned long long* sred64 = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* sred64d = sred64 + 32;
  // the warp queues (tmmc: a second set for the deletion branch)
  float* squeue = smem + (kTmmc ? 128 : 64);
  int* qkey = reinterpret_cast<int*>(squeue);
  float* qd2 = squeue + kWarps * kQueue;
  int* qkey2 = reinterpret_cast<int*>(squeue + kQueueWords);
  float* qd22 = squeue + kQueueWords + kWarps * kQueue;
  int* qnear = reinterpret_cast<int*>(squeue + (kTmmc ? 2 : 1) * kQueueWords);
  constexpr bool kGlob = kLayout != kShared;  // atom rows in global memory
  constexpr bool kGk = kLayout == kGlobalK;     // k rows too
  // the shared layout's atom rows; the global layouts point these at
  // global memory below and start the k rows (kGlobal) or the LJ tables
  // (kGlobalK) at their place
  float* sx = reinterpret_cast<float*>(qnear + kNearWords);
  float* sy = sx + A_pad;
  float* sz = sy + A_pad;
  int* smol = reinterpret_cast<int*>(sz + A_pad);
  float* ssre = kGlob ? sx : reinterpret_cast<float*>(smol + A_pad);
  float* ssim = ssre + K;
  float* scfac = ssim + K;
  float* sdre = scfac + K;
  float* sdim = sdre + K;
  float* skx = sdim + K;
  float* sky = skx + K;
  float* skz = sky + K;
  float* seps = kGk ? sx : skz + K;  // (P, T)
  float* ssig2 = seps + P * T;
  float* slam1 = ssig2 + P * T;
  float* slam2 = slam1 + P * T;
  // 16-byte rows from here (every region above is a multiple of 4
  // words): two proposal buffers of the old then the new pose, each site
  // (x, y, z, its live cutoff^2)
  float* spose = slam2 + P * T;   // 2 x 2 x (P, 4)
  float* sdel = spose + 16 * P;   // (P, 4) tmmc: the deletion pose
  float* sdec = sdel + (kTmmc ? 4 * P : 0);  // 2 x kDec: proposal scalars
  float* sux = sdec + 2 * kDec;   // an exchange attempt's 8 uniforms
  float* sred = sux + 16;         // one partial sum per warp
  // thread 0's statistics: energy delta, acc/att [trans, rot], acc
  // [insert, delete], att insert, a decision fingerprint (the sum of the
  // global index + 1 over accepted moves, which tells a chain whose accept
  // sequence diverged from one that only matches in its counts; accepted
  // exchanges add slot + 1, deletions M_total more), sum w, sum w^2
  float* sstat = sred + 32;
  float* sbody = sstat + 16;      // (P, 3)
  float* sqp = sbody + 3 * P;
  int* slj = reinterpret_cast<int*>(sqp + P);
  int* sqf = slj + P;
  float* scut = reinterpret_cast<float*>(sqf + P);  // (P) live cutoff^2
  float* sact = scut + P;         // (A_pad) atom activity, with use_act
  float* sactm = sact + A_pad;    // (M_total) slot activity, with use_act
  // (K) tmmc: the deletion's S(k) row
  float* sdre2 = kGlob ? scut + P : sactm + M_total;
  float* sdim2 = sdre2 + K;
  float* sred2 = kGk ? scut + P : sdim2 + K;  // tmmc: its warp partials

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  constexpr int nt = kThreads;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  constexpr int kProposer = kWarps - 1;  // the warp that builds proposals

  // the chain's COM and quaternion rows: its own rows of the outputs,
  // updated in place
  float* const scom = com_out + (size_t)c * 3 * M_total;
  float* const squat = quat_out + (size_t)c * 4 * M_total;
  const float* cin = coords_in + (size_t)c * 3 * A_pad;
  if constexpr (kGlob) {
    // the chain's own rows of the outputs, updated in place; the per-atom
    // rows are read (never written) from their global tables
    sx = coords_out + (size_t)c * 3 * A_pad;
    sy = sx + A_pad;
    sz = sy + A_pad;
    smol = const_cast<int*>(molid_row);
    for (int j = tid; j < 3 * A_pad; j += nt) sx[j] = cin[j];
    if constexpr (kAct) {
      sact = act_out + (size_t)c * A_pad;
      sactm = actm_out + (size_t)c * M_total;
      for (int j = tid; j < A_pad; j += nt)
        sact[j] = act_in[(size_t)c * A_pad + j];
    }
  } else {
    for (int j = tid; j < A_pad; j += nt) {
      sx[j] = cin[j];
      sy[j] = cin[A_pad + j];
      sz[j] = cin[2 * A_pad + j];
      smol[j] = molid_row[j];
      if (kAct) sact[j] = act_in[(size_t)c * A_pad + j];
    }
  }
  if constexpr (kGk) {
    // the chain's row of the k-row workspace (sweep_kws_floats)
    float* const kb = kws + (size_t)c * sweep_kws_floats(K, kTmmc);
    ssre = kb;
    ssim = kb + K;
    scfac = kb + 2 * K;
    sdre = kb + 3 * K;
    sdim = kb + 4 * K;
    sdre2 = kb + 5 * K;
    sdim2 = kb + 6 * K;
  }
  if (kAct)
    for (int i = tid; i < M_total; i += nt)
      sactm[i] = actm_in[(size_t)c * M_total + i];
  for (int i = tid; i < 3 * M_total; i += nt)
    scom[i] = com_in[(size_t)c * 3 * M_total + i];
  for (int i = tid; i < 4 * M_total; i += nt)
    squat[i] = quat_in[(size_t)c * 4 * M_total + i];
  if (tid < 16) sstat[tid] = 0.0f;
  if (kTmmc)
    for (int i = tid; i < 3 * (M + 1); i += nt) {
      cmat_out[(size_t)c * 3 * (M + 1) + i] = 0.0f;
      uhist_out[(size_t)c * 3 * (M + 1) + i] = 0.0f;
    }

  const float box = box_in[c];
  const float inv_box = 1.0f / box;
  const float kappa = kappa_l * inv_box;
  const float temp = temp_in[c];
  const float dr_max = drmax_in[c];
  const float dphi_max = dphi_in[c];
  const bool ewald = coulomb == kEwald;
  for (int k = tid; k < K; k += nt) {
    ssre[k] = sfac_in[((size_t)c * K + k) * 2];
    ssim[k] = sfac_in[((size_t)c * K + k) * 2 + 1];
    const float kx = kvec[3 * k], ky = kvec[3 * k + 1], kz = kvec[3 * k + 2];
    if constexpr (!kGk) {
      skx[k] = kx;
      sky[k] = ky;
      skz[k] = kz;
    }
    if (ewald) {
      const float tpl = kTwoPi * inv_box;
      const float kt2 = tpl * tpl * (kx * kx + ky * ky + kz * kz);
      const float vol = box * box * box;
      scfac[k] = kw[k] * (kTwoPi / vol) * expf(-kt2 / (4.0f * kappa * kappa)) / kt2;
    }
  }
  for (int i = tid; i < P * T; i += nt) {
    seps[i] = 4.0f * eps_pt[i];
    ssig2[i] = sig2_pt[i];
    slam1[i] = lam1_pt[i];
    slam2[i] = lam2_pt[i];
  }
  const bool split_cut = qrc2 != rc2;
  const float qcut2 = split_cut ? qrc2 : rc2;
  for (int i = tid; i < 3 * P; i += nt) sbody[i] = body[i];
  for (int i = tid; i < P; i += nt) {
    const bool lj = has_lj[i] != 0, uq = has_q[i] && coulomb != kNone;
    sqp[i] = qp[i];
    slj[i] = lj;
    sqf[i] = uq;
    // site i adds a term at d^2 iff d^2 < its live cutoff^2: LJ below
    // rc2, Coulomb below qcut2 (-1: neither)
    scut[i] = lj ? (uq ? fmaxf(rc2, qcut2) : rc2) : (uq ? qcut2 : -1.0f);
  }
  float sh_w = 0.0f;
  if (coulomb == kWolf) {
    const float qrc = sqrtf(qrc2);
    sh_w = erfcf(kappa * qrc) / qrc;
  }
  // the largest cutoff: a pose's reach is this plus the pose's radius
  const float rc_max = sqrtf(fmaxf(rc2, qcut2));
  const float* u_chain = u_in + ((size_t)c * M_total + m_start) * kUniforms;

  // k-vector k's integer components: its shared rows or (kGlobalK) its
  // global table
  auto k_vec = [&](int k, float& kx, float& ky, float& kz) {
    if constexpr (kGk) {
      kx = __ldg(kvec + 3 * k);
      ky = __ldg(kvec + 3 * k + 1);
      kz = __ldg(kvec + 3 * k + 2);
    } else {
      kx = skx[k];
      ky = sky[k];
      kz = skz[k];
    }
  };

  // ---- pair terms: distances on every lane, live terms through queues ----
  auto dist2 = [&](float xj, float yj, float zj, float ax, float ay,
                   float az) -> float {
    float dx = xj - ax, dy = yj - ay, dz = zj - az;
    dx -= box * round_near(dx * inv_box);
    dy -= box * round_near(dy * inv_box);
    dz -= box * round_near(dz * inv_box);
    return fmaxf(dx * dx + dy * dy + dz * dz, 1e-4f);
  };
  // One live term: LJ (with the linear shift) plus real-space Coulomb, the
  // +1e30 veto on an attractive overlap when the key asks for it, negated
  // for the old pose.
  auto live_term = [&](int key, float d2) -> float {
    const int j = key & (kMaxColumns - 1);
    const int p = (key >> kKeySite) & 15;
    const int tj = __ldg(tid_row + j);
    const float qj = __ldg(q_row + j);
    const bool m_lj = d2 < rc2;
    const bool m_qq = split_cut ? d2 < qrc2 : m_lj;
    const float inv_r = rsqrtf(d2);
    const float inv_d2 = inv_r * inv_r;
    float contrib = 0.0f;
    if (slj[p] != 0 && m_lj) {
      const float s2 = ssig2[p * T + tj] * inv_d2;
      const float s6 = s2 * s2 * s2;
      float pot = seps[p * T + tj] * (s6 * s6 - s6);
      if (lj_linear) pot += slam1[p * T + tj] + slam2[p * T + tj] * sqrtf(d2);
      contrib = pot;
    }
    if (sqf[p] != 0 && m_qq) {
      const float qq = (factor * sqp[p]) * qj;
      const float r = d2 * inv_r;
      float cp;
      if (coulomb == kBare)
        cp = qq * inv_r;
      else if (coulomb == kWolf)
        cp = qq * (erfcf(kappa * r) * inv_r - sh_w);
      else
        cp = qq * (erfcf(kappa * r) * inv_r);
      if (((key >> kKeyVeto) & 1) && d2 < d2_overlap && qq < 0.0f) cp = 1e30f;
      contrib += cp;
    }
    return ((key >> kKeySign) & 1) ? contrib : -contrib;
  };
  // a warp queue's live terms into acc (mmc_common.cuh Queue)
  auto push = [&](Queue& q, float& acc, int n, const bool* live,
                  const float* d2, int key0) {
    q.push(n, live, d2, key0, lane,
           [&](int key, float dd) { acc += live_term(key, dd); });
  };
  auto drain = [&](Queue& q, float& acc) {
    q.drain(lane, [&](int key, float dd) { acc += live_term(key, dd); });
  };

  // ---- the proposal warp's work ----
  // the next move after local move m: m + 1, or with activity the next
  // active slot; M ends the sweep
  auto next_move = [&](int m) -> int {
    if (!kAct) return m + 1;
    for (int base = m + 1; base < M; base += 32) {
      const int i = base + lane;
      const unsigned bal =
          __ballot_sync(kFull, i < M && sact[a_start + i * P] != 0.0f);
      if (bal) return base + __ffs(bal) - 1;
    }
    return M;
  };
  // lane i < 10 loads uniform i of move m, lane i < 7 COM/quaternion
  // word i: issued a pass ahead of their use
  auto prefetch = [&](int m, float& u_pre, float& c_pre) {
    if (m >= M) return;
    const int mg = m_start + m;
    if (lane < kUniforms) u_pre = u_chain[(size_t)m * kUniforms + lane];
    if (lane < 3)
      c_pre = scom[3 * mg + lane];
    else if (lane < 7)
      c_pre = squat[4 * mg + lane - 3];
  };
  // the proposal of local move m into buffer b: every lane computes the
  // molecule's scalars, lane p < P places site p
  auto propose = [&](int m, int b, float u_pre, float c_pre) {
    float* dec = sdec + kDec * b;
    if (m >= M) {
      if (lane == 0) dec[14] = (float)M;
      return;
    }
    float um[kUniforms], cm[3], q0[4];
    for (int i = 0; i < kUniforms; ++i) um[i] = __shfl_sync(kFull, u_pre, i);
    for (int d = 0; d < 3; ++d) cm[d] = __shfl_sync(kFull, c_pre, d);
    for (int i = 0; i < 4; ++i) q0[i] = __shfl_sync(kFull, c_pre, 3 + i);
    float tsel = 1.0f;
    float q1[4] = {q0[0], q0[1], q0[2], q0[3]};
    if (use_rot) {
      tsel = um[0] < p_translate ? 1.0f : 0.0f;
      const float e1 = fmaxf(um[5], 1e-12f), e2 = um[6];
      const float e3 = fmaxf(um[7], 1e-12f), e4 = um[8];
      const float r1 = sqrtf(-2.0f * logf(e1));
      const float r2 = sqrtf(-2.0f * logf(e3));
      float s2, c2, s4, c4;
      sincosf(kTwoPi * (e2 - rintf(e2)), &s2, &c2);
      sincosf(kTwoPi * (e4 - rintf(e4)), &s4, &c4);
      const float g1 = r1 * c2, g2 = r1 * s2, g3 = r2 * c4;
      const float gn = rsqrtf(g1 * g1 + g2 * g2 + g3 * g3 + 1e-20f);
      const float half = 0.5f * ((2.0f * um[9] - 1.0f) * dphi_max);
      float sh, rw;
      sincosf(half, &sh, &rw);
      sh = sh * gn;
      const float rx = sh * g1, ry = sh * g2, rz = sh * g3;
      const float w0 = q0[0], x0 = q0[1], y0 = q0[2], z0 = q0[3];
      const float nw = rw * w0 - rx * x0 - ry * y0 - rz * z0;
      const float nx = rw * x0 + rx * w0 + ry * z0 - rz * y0;
      const float ny = rw * y0 - rx * z0 + ry * w0 + rz * x0;
      const float nz = rw * z0 + rx * y0 - ry * x0 + rz * w0;
      const float qn = rsqrtf(nw * nw + nx * nx + ny * ny + nz * nz);
      if (tsel == 0.0f) {
        q1[0] = nw * qn;
        q1[1] = nx * qn;
        q1[2] = ny * qn;
        q1[3] = nz * qn;
      }
    }
    float nc[3];
    for (int d = 0; d < 3; ++d) {
      const float v = cm[d] + tsel * (um[1 + d] - 0.5f) * dr_max;
      nc[d] = v - box * floorf(v * inv_box);
    }
    float* so = spose + 8 * P * b;
    float* sn = so + 4 * P;
    const int a0 = a_start + m * P;
    float r_old = 0.0f, r_new = 0.0f;
    if (lane < P) {
      const int p = lane;
      const float xo[3] = {sx[a0 + p], sy[a0 + p], sz[a0 + p]};
      float o[3] = {0.0f, 0.0f, 0.0f};
      if (P > 1)
        rot_apply(q1[0], q1[1], q1[2], q1[3], sbody[3 * p], sbody[3 * p + 1],
                  sbody[3 * p + 2], o);
      float xn[3];
      for (int d = 0; d < 3; ++d) {
        so[4 * p + d] = xo[d];
        xn[d] = nc[d] + o[d];
        sn[4 * p + d] = xn[d];
      }
      so[4 * p + 3] = scut[p];
      sn[4 * p + 3] = scut[p];
      r_old = sqrtf(dist2(xo[0], xo[1], xo[2], cm[0], cm[1], cm[2]));
      r_new = sqrtf(dist2(xn[0], xn[1], xn[2], nc[0], nc[1], nc[2]));
    }
    r_old = warp_max_all(r_old);
    r_new = warp_max_all(r_new);
    if (lane == 0) {
      const float reach_n = (rc_max + r_new) * 1.0001f + 1e-3f;
      const float reach_o = (rc_max + r_old) * 1.0001f + 1e-3f;
      for (int d = 0; d < 3; ++d) {
        dec[d] = nc[d];
        dec[4 + d] = cm[d];
      }
      dec[3] = reach_n * reach_n;
      dec[7] = reach_o * reach_o;
      for (int i = 0; i < 4; ++i) dec[8 + i] = q1[i];
      dec[12] = tsel;
      dec[13] = um[4];
      dec[14] = (float)m;
    }
  };

  // The n (<= 32, warp-uniform) oldest (atom, pose) pairs of the near
  // ring qn, one per lane: the site distances of the pose the key's sign
  // bit names (pose_old or pose_new), the live triples into the queue q.
  auto near_flush = [&](Queue& qn, Queue& q, float& acc, int n,
                        const float* pose_old, const float* pose_new) {
    __syncwarp();
    const bool ok = lane < n;
    const int key = ok ? qn.key[(qn.head + lane) & (kNear - 1)] : 0;
    qn.head += n;
    __syncwarp();
    const int j = key & (kMaxColumns - 1);
    const int s = (key >> kKeySign) & 1;
    float xj = 0.0f, yj = 0.0f, zj = 0.0f;
    if (ok) {
      xj = sx[j];
      yj = sy[j];
      zj = sz[j];
    }
    const float4* a = reinterpret_cast<const float4*>(s ? pose_new : pose_old);
    for (int p0 = 0; p0 < P; p0 += kChunk) {
      bool live[kChunk];
      float d2[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        live[k] = false;
        d2[k] = 0.0f;
        if (ok && p0 + k < P) {
          const float4 site = a[p0 + k];
          d2[k] = dist2(xj, yj, zj, site.x, site.y, site.z);
          live[k] = d2[k] < site.w;
        }
      }
      push(q, acc, P - p0, live, d2, key | p0 << kKeySite);
    }
  };
  // the lanes' (atom, pose) pairs within reach (key: atom column, sign and
  // veto bits) appended in lane order; 32 queued go through stage 1
  auto near_push = [&](Queue& qn, Queue& q, float& acc, bool near, int key,
                       const float* pose_old, const float* pose_new) {
    const unsigned bal = __ballot_sync(kFull, near);
    if (!bal) return;
    if (near) qn.key[(qn.tail + __popc(bal & lanes_below)) & (kNear - 1)] = key;
    qn.tail += __popc(bal);
    if (qn.tail - qn.head >= 32)
      near_flush(qn, q, acc, 32, pose_old, pose_new);
  };
  // One warp's 32 atom lanes j (ok: the lane is a neighbour of the mover)
  // against the old and the new pose of the proposal (pose, dec): the
  // (atom, pose) pairs within the pose's reach go to the near ring.
  auto move_lanes = [&](Queue& qn, Queue& q, float& acc, int j, bool ok,
                        const float* pose, const float* dec) {
    float xj = 0.0f, yj = 0.0f, zj = 0.0f;
    if (ok) {
      xj = sx[j];
      yj = sy[j];
      zj = sz[j];
    }
    for (int s = 0; s < 2; ++s) {
      const float4 c = reinterpret_cast<const float4*>(dec)[s ? 0 : 1];
      const bool near = ok && dist2(xj, yj, zj, c.x, c.y, c.z) < c.w;
      near_push(qn, q, acc, near, j | s << kKeySign | s << kKeyVeto, pose,
                pose + 4 * P);
    }
  };

  __syncthreads();
  {
    // the first move's proposal
    if (warp == kProposer) {
      float u_pre = 0.0f, c_pre = 0.0f;
      const int m0 = next_move(-1);
      prefetch(m0, u_pre, c_pre);
      propose(m0, 0, u_pre, c_pre);
    }
    __syncthreads();
  }

  for (int it = 0;; ++it) {
    const int b = it & 1;
    const float* dec = sdec + kDec * b;
    const int m = (int)dec[14];
    if (m >= M) break;  // block-uniform: every thread reads one word
    const int mg = m_start + m;  // global molecule index
    const int a0 = a_start + m * P;
    const float* pose = spose + 8 * P * b;
    // the proposal warp starts the next proposal's loads
    int m_next = M;
    float u_pre = 0.0f, c_pre = 0.0f;
    if (warp == kProposer) {
      m_next = next_move(m);
      prefetch(m_next, u_pre, c_pre);
    }

    // ---- old and new site sums over the atom lanes ----
    float part = 0.0f;
    Queue q{qkey + warp * kQueue, qd2 + warp * kQueue, 0, 0};
    Queue qn{qnear + warp * kNear, nullptr, 0, 0};
    bool dense = true;
    if constexpr (kGlob) {
      if (W > 0) {
        // sorted slabs: the other blocks' column segments, then the window
        dense = false;
        for (int sg = 0; sg < n_seg; ++sg) {
          const int b0 = segs[2 * sg], b1 = b0 + segs[2 * sg + 1];
          for (int jb = b0 + warp * 32; jb < b1; jb += nt) {
            const int j = jb + lane;
            move_lanes(qn, q, part, j, j < b1 && (j < a0 || j >= a0 + P),
                       pose, dec);
          }
        }
        const int wb = wst[mg];
        const bool in_w = a0 >= a0_w;  // the mover is in the sorted block
        for (int jb = wb + warp * 32; jb < wb + W; jb += nt) {
          const int j = jb + lane;
          // the window's alignment overhang and the mover's own columns
          const bool own = in_w && ((j >= a0 && j < a0 + P) ||
                                    (j >= a0 + A_blk && j < a0 + A_blk + P));
          move_lanes(qn, q, part, j, j < wb + W && j >= a0_w && !own, pose,
                     dec);
        }
      }
    }
    if (dense)
      for (int jb = warp * 32; jb < A_pad; jb += nt) {
        const int j = jb + lane;
        bool ok = j < A_pad;
        if (ok) {
          const int mj = smol[j];
          ok = mj >= 0 && mj != mg && (!kAct || sact[j] != 0.0f);
        }
        move_lanes(qn, q, part, j, ok, pose, dec);
      }
    if (qn.tail > qn.head)
      near_flush(qn, q, part, qn.tail - qn.head, pose, pose + 4 * P);
    drain(q, part);

    // ---- incremental S(k) and the reciprocal energy delta ----
    if (ewald) {
      const float tpl = kTwoPi * inv_box;
      for (int k = tid; k < K; k += nt) {
        float kx, ky, kz;
        k_vec(k, kx, ky, kz);
        float dre = 0.0f, dim = 0.0f;
        for (int s = 0; s < 2; ++s) {
          const float* a = pose + 4 * P * s;
          for (int p = 0; p < P; ++p) {
            if (!sqf[p]) continue;
            float ph = tpl * (kx * a[4 * p] + ky * a[4 * p + 1] + kz * a[4 * p + 2]);
            ph -= kTwoPi * round_near(ph * kInvTwoPi);
            float sn, cs;
            sincosf(ph, &sn, &cs);
            const float qps = s ? sqp[p] : -sqp[p];
            dre += qps * cs;
            dim += qps * sn;
          }
        }
        sdre[k] = dre;
        sdim[k] = dim;
        const float cross = 2.0f * (ssre[k] * dre + ssim[k] * dim) + dre * dre + dim * dim;
        part += factor * (scfac[k] * cross);
      }
    }

    part = warp_sum(part);
    if (warp == kProposer) propose(m_next, b ^ 1, u_pre, c_pre);
    if (lane == 0) sred[warp] = part;
    __syncthreads();

    // every thread: the same sum in the same order, the same decision
    float d_e = 0.0f;
    for (int w = 0; w < kWarps; ++w) d_e += sred[w];
    const float beta_de = d_e / temp;
    // the overlap penalty makes beta_de huge: exp(-beta_de) == 0 rejects
    const bool accept = (beta_de < 0.0f) || (dec[13] < expf(-beta_de));
    if (tid == 0) {
      const float tsel = dec[12];
      sstat[3] += tsel;
      sstat[4] += 1.0f - tsel;
      if (accept) {
        sstat[0] += d_e;
        sstat[1] += tsel;
        sstat[2] += 1.0f - tsel;
        sstat[8] += (float)(mg + 1);
      }
    }
    if (accept) {
      const float* sn = pose + 4 * P;
      if (tid < P) {
        sx[a0 + tid] = sn[4 * tid];
        sy[a0 + tid] = sn[4 * tid + 1];
        sz[a0 + tid] = sn[4 * tid + 2];
        if constexpr (kGlob)
          if (W > 0 && a0 >= a0_w && a0 + tid - a0_w < W) {
            // a head molecule's ghost twin (the halo may end inside it)
            sx[a0 + A_blk + tid] = sn[4 * tid];
            sy[a0 + A_blk + tid] = sn[4 * tid + 1];
            sz[a0 + A_blk + tid] = sn[4 * tid + 2];
          }
      } else if (tid >= 32 && tid < 32 + 3) {
        scom[3 * mg + tid - 32] = dec[tid - 32];
      } else if (tid >= 35 && tid < 35 + 4) {
        squat[4 * mg + tid - 35] = dec[8 + tid - 35];
      }
      if (ewald)
        // each thread adds the deltas of the k-vectors it computed
        for (int k = tid; k < K; k += nt) {
          ssre[k] += sdre[k];
          ssim[k] += sdim[k];
        }
    }
    __syncthreads();
  }

  if (kAct && (n_exch > 0 || n_widom > 0)) {
    const float beta = 1.0f / temp;
    const float si_c = si_in[c], wc_c = wc_in[c];
    const float lnzv = n_exch > 0 ? logf(z_in[c] * box * box * box) : 0.0f;
    const float* ux_chain = ux_in + (size_t)c * (n_exch + n_widom) * kExchUniforms;
    float* ux = sux;         // this attempt's 8 uniforms
    float* snew = spose + 4 * P;  // the attempt's pose (buffer 0's new rows)
    float* sxd = sdec;       // its scalars: COM, quaternion, decision [8]

    // n: this block's active slots, counted once and then tracked
    float cnt = 0.0f;
    for (int i = tid; i < M; i += nt) cnt += sactm[m_start + i] > 0.5f ? 1.0f : 0.0f;
    cnt = warp_sum(cnt);
    if (lane == 0) sred[warp] = cnt;
    __syncthreads();
    float n_act = 0.0f;
    for (int w = 0; w < kWarps; ++w) n_act += sred[w];
    __syncthreads();

    // One or two poses against every active atom of other molecules than
    // their own: pose 0 (snew, excluding molecule excl0, veto0) into acc0
    // and, with two, pose 1 (sdel, excl1, veto1) into acc1, each through a
    // queue of its own, so that each branch sums in a one-pose pass's order.
    auto exch_lanes = [&](bool two, int excl0, int excl1, bool veto0,
                          bool veto1, float& acc0, float& acc1) {
      Queue q0{qkey + warp * kQueue, qd2 + warp * kQueue, 0, 0};
      Queue q1{qkey2 + warp * kQueue, qd22 + warp * kQueue, 0, 0};
      const int k0 = 1 << kKeySign | (veto0 ? 1 : 0) << kKeyVeto;
      const int k1 = 1 << kKeySign | (veto1 ? 1 : 0) << kKeyVeto;
      for (int jb = warp * 32; jb < A_pad; jb += nt) {
        const int j = jb + lane;
        int mj = -1;
        bool on = false;
        if (j < A_pad) {
          mj = smol[j];
          on = mj >= 0 && sact[j] != 0.0f;
        }
        if (!__any_sync(kFull, on)) continue;
        float xj = 0.0f, yj = 0.0f, zj = 0.0f;
        if (on) {
          xj = sx[j];
          yj = sy[j];
          zj = sz[j];
        }
        const bool ok0 = on && mj != excl0, ok1 = on && mj != excl1;
        for (int p0 = 0; p0 < P; p0 += kChunk) {
          bool live[kChunk];
          float d2[kChunk];
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            live[k] = false;
            d2[k] = 0.0f;
            if (p0 + k < P) {
              const float4 site = reinterpret_cast<const float4*>(snew)[p0 + k];
              d2[k] = dist2(xj, yj, zj, site.x, site.y, site.z);
              live[k] = ok0 && d2[k] < site.w;
            }
          }
          push(q0, acc0, P - p0, live, d2, j | p0 << kKeySite | k0);
          if (two) {
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
              live[k] = false;
              d2[k] = 0.0f;
              if (p0 + k < P) {
                const float4 site = reinterpret_cast<const float4*>(sdel)[p0 + k];
                d2[k] = dist2(xj, yj, zj, site.x, site.y, site.z);
                live[k] = ok1 && d2[k] < site.w;
              }
            }
            push(q1, acc1, P - p0, live, d2, j | p0 << kKeySite | k1);
          }
        }
      }
      drain(q0, acc0);
      if (two) drain(q1, acc1);
    };

    // The structure-factor row of pose a at k-vector k, and the reciprocal
    // energy delta of adding (sgn = +1) or removing (-1) it against the
    // live S(k).
    const float tpl = kTwoPi * inv_box;
    auto k_row = [&](const float* a, int k, float& dre, float& dim) {
      float kx, ky, kz;
      k_vec(k, kx, ky, kz);
      dre = 0.0f;
      dim = 0.0f;
      for (int p = 0; p < P; ++p) {
        if (!sqf[p]) continue;
        float ph = tpl * (kx * a[4 * p] + ky * a[4 * p + 1] + kz * a[4 * p + 2]);
        ph -= kTwoPi * round_near(ph * kInvTwoPi);
        float sn, cs;
        sincosf(ph, &sn, &cs);
        dre += sqp[p] * cs;
        dim += sqp[p] * sn;
      }
    };
    auto k_term = [&](int k, float dre, float dim, float sgn) -> float {
      const float cross = 2.0f * sgn * (ssre[k] * dre + ssim[k] * dim) + dre * dre + dim * dim;
      return factor * (scfac[k] * cross);
    };

    // The pose in snew against every active atom of other molecules than
    // `excl` (sgn * pair sum), plus the reciprocal delta of adding or
    // removing it; leaves the pose's structure-factor row in sdre/sdim.
    // One thread's partial sum.
    auto pose_part = [&](int excl, bool veto, float sgn) -> float {
      float pair = 0.0f, unused = 0.0f;
      exch_lanes(false, excl, -1, veto, false, pair, unused);
      float part = sgn * pair;
      if (ewald)
        for (int k = tid; k < K; k += nt) {
          float dre, dim;
          k_row(snew, k, dre, dim);
          sdre[k] = dre;
          sdim[k] = dim;
          part += k_term(k, dre, dim, sgn);
        }
      return part;
    };

    // Both branches of a tmmc attempt in one pass: each atom lane is loaded
    // once and feeds the insertion pose's (snew, excl_i) and the deletion
    // pose's (sdel, excl_d) queues, each summed in pose_part's order with
    // its arithmetic; the S(k) rows go to sdre/sdim and sdre2/sdim2.
    auto pose_part2 = [&](int excl_i, int excl_d, bool veto_i, bool veto_d,
                          float sgn_i, float sgn_d, float& part_i, float& part_d) {
      float pair_i = 0.0f, pair_d = 0.0f;
      exch_lanes(true, excl_i, excl_d, veto_i, veto_d, pair_i, pair_d);
      part_i = sgn_i * pair_i;
      part_d = sgn_d * pair_d;
      if (ewald)
        for (int k = tid; k < K; k += nt) {
          float dre, dim;
          k_row(snew, k, dre, dim);
          sdre[k] = dre;
          sdim[k] = dim;
          part_i += k_term(k, dre, dim, sgn_i);
          k_row(sdel, k, dre, dim);
          sdre2[k] = dre;
          sdim2[k] = dim;
          part_d += k_term(k, dre, dim, sgn_d);
        }
    };

    // du's position-independent part, si sgn + wc (2 n sgn + 1), rounded
    // as sweep_plain rounds it (no contraction)
    auto exch_const = [&](float sgn) -> float {
      return __fadd_rn(si_c * sgn, __fmul_rn(wc_c, 2.0f * n_act * sgn + 1.0f));
    };

    // Thread 0: the trial pose of uniforms ux[1..6] (uniform position,
    // Shoemake quaternion; identity for P = 1) into snew and sxd[0..6].
    auto trial_pose = [&]() {
      float q[4] = {1.0f, 0.0f, 0.0f, 0.0f};
      if (P > 1) {
        const float u1 = ux[4];
        float s2, c2, s3, c3;
        sincosf(kTwoPi * (ux[5] - rintf(ux[5])), &s2, &c2);
        sincosf(kTwoPi * (ux[6] - rintf(ux[6])), &s3, &c3);
        const float r1 = sqrtf(fmaxf(1.0f - u1, 0.0f)), r2 = sqrtf(u1);
        q[0] = r1 * s2;
        q[1] = r1 * c2;
        q[2] = r2 * s3;
        q[3] = r2 * c3;
      }
      for (int d = 0; d < 3; ++d) sxd[d] = ux[1 + d] * box;
      for (int i = 0; i < 4; ++i) sxd[3 + i] = q[i];
      for (int p = 0; p < P; ++p) {
        float o[3] = {0.0f, 0.0f, 0.0f};
        if (P > 1)
          rot_apply(q[0], q[1], q[2], q[3], sbody[3 * p], sbody[3 * p + 1],
                    sbody[3 * p + 2], o);
        for (int d = 0; d < 3; ++d) snew[4 * p + d] = sxd[d] + o[d];
        snew[4 * p + 3] = scut[p];
      }
    };

    // tmmc's branch signs and vetoes as values the compiler cannot fold:
    // folded constants would let it drop the deletion branch's veto select
    // and contract that branch's terms otherwise than the n_exch
    // instantiation does, and eta = 0 must decide as that one does
    volatile float one_v = 1.0f;
    const float sgn_i = one_v, sgn_d = -sgn_i;
    const bool veto_i = sgn_i > 0.0f, veto_d = sgn_d > 0.0f;
    const float e_c = kTmmc ? e_in[c] : 0.0f;
    auto block_max = [&](const unsigned long long* row) {
      unsigned long long b = 0ull;
      for (int w = 0; w < kWarps; ++w) b = row[w] > b ? row[w] : b;
      return b;
    };
    // no candidate (a full or an empty block): any slot of the block, the
    // branch is refused below
    auto slot_of = [&](unsigned long long b) {
      return b ? (int)(0xFFFFFFFFu - (uint32_t)(b & 0xFFFFFFFFull)) : m_start;
    };

    for (int xi = 0; xi < n_exch; ++xi) {
      if (tid < kExchUniforms) ux[tid] = ux_chain[(size_t)xi * kExchUniforms + tid];
      __syncthreads();
      const bool is_ins = ux[0] < 0.5f;
      const float sgn = is_ins ? 1.0f : -1.0f;

      // slot pick: the first free slot (insertion) or the active slot with
      // the largest score, the lower index on a tie (deletion), as the
      // maximum of 64-bit keys (score, ~slot); 0 marks no candidate.  tmmc
      // picks both in one pass.
      unsigned long long best_i = 0ull, best_d = 0ull;
      for (int i = tid; i < M; i += nt) {
        const int slot = m_start + i;
        if (!(sactm[slot] > 0.5f)) {
          if (kTmmc || is_ins) {
            const unsigned long long key = (1ull << 32) | (0xFFFFFFFFu - (uint32_t)slot);
            best_i = key > best_i ? key : best_i;
          }
        } else if (kTmmc || !is_ins) {
          const uint32_t bits = philox_word((uint32_t)slot, (uint32_t)xi, seed, chain0 + (uint32_t)c) >> 8;
          const unsigned long long key =
              ((unsigned long long)(bits + 1u) << 32) | (0xFFFFFFFFu - (uint32_t)slot);
          best_d = key > best_d ? key : best_d;
        }
      }
      if (kTmmc) {
        best_i = warp_max_u64(best_i);
        best_d = warp_max_u64(best_d);
        if (lane == 0) {
          sred64[warp] = best_i;
          sred64d[warp] = best_d;
        }
      } else {
        const unsigned long long b = warp_max_u64(is_ins ? best_i : best_d);
        if (lane == 0) sred64[warp] = b;
      }
      __syncthreads();
      const int slot_i = slot_of(block_max(sred64));
      const int slot_d = kTmmc ? slot_of(block_max(sred64d)) : slot_i;
      const int slot = is_ins ? slot_i : slot_d;
      const int a0 = a_start + (slot - m_start) * P;
      const int a0_d = a_start + (slot_d - m_start) * P;

      if (tid == 0) {
        if (kTmmc || is_ins) trial_pose();
        if (kTmmc || !is_ins) {
          float* pd = kTmmc ? sdel : snew;
          for (int p = 0; p < P; ++p) {
            pd[4 * p] = sx[a0_d + p];
            pd[4 * p + 1] = sy[a0_d + p];
            pd[4 * p + 2] = sz[a0_d + p];
            pd[4 * p + 3] = scut[p];
          }
        }
      }
      __syncthreads();

      // excl = slot serves the insertion: its slot is inactive
      float part, part_d = 0.0f;
      if (kTmmc)
        pose_part2(slot_i, slot_d, veto_i, veto_d, sgn_i, sgn_d, part, part_d);
      else
        part = pose_part(slot, is_ins, sgn);
      part = warp_sum(part);
      if (kTmmc) part_d = warp_sum(part_d);
      if (lane == 0) {
        sred[warp] = part;
        if (kTmmc) sred2[warp] = part_d;
      }
      __syncthreads();

      if (tid == 0) {
        float du = 0.0f, ln_acc;
        bool can;
        for (int w = 0; w < kWarps; ++w) du += sred[w];
        if (kTmmc) {
          float du_d = 0.0f;
          for (int w = 0; w < kWarps; ++w) du_d += sred2[w];
          const float du_i = __fadd_rn(du, exch_const(sgn_i));
          du_d = __fadd_rn(du_d, exch_const(sgn_d));
          float la_i = __fsub_rn(lnzv - logf(n_act + 1.0f), __fmul_rn(beta, du_i));
          float la_d = __fsub_rn(logf(fmaxf(n_act, 1.0f)) - lnzv, __fmul_rn(beta, du_d));
          const bool can_i = n_act < (float)M - 0.5f, can_d = n_act > 0.5f;
          // the deposits: unbiased acceptances, the type probability folded in
          const float up = can_i ? kPDep * expf(fminf(la_i, 0.0f)) : 0.0f;
          const float dn = can_d ? kPDep * expf(fminf(la_d, 0.0f)) : 0.0f;
          const int row = (int)n_act;
          float* cm = cmat_out + ((size_t)c * (M + 1) + row) * 3;
          cm[0] += (1.0f - up) - dn;
          cm[1] += up;
          cm[2] += dn;
          const float e = e_c + sstat[0];
          float* uh = uhist_out + ((size_t)c * (M + 1) + row) * 3;
          uh[0] += 1.0f;
          uh[1] += e;
          uh[2] += __fmul_rn(e, e);
          // the bias, in the thresholds only
          const float eta_n = eta_in[row];
          la_i = (la_i + eta_in[min(row + 1, M)]) - eta_n;
          la_d = (la_d + eta_in[max(row - 1, 0)]) - eta_n;
          du = is_ins ? du_i : du_d;
          ln_acc = is_ins ? la_i : la_d;
          can = is_ins ? can_i : can_d;
        } else {
          du = __fadd_rn(du, exch_const(sgn));
          ln_acc = __fsub_rn(is_ins ? lnzv - logf(n_act + 1.0f) : logf(fmaxf(n_act, 1.0f)) - lnzv,
                             __fmul_rn(beta, du));
          can = is_ins ? n_act < (float)M - 0.5f : n_act > 0.5f;
        }
        const float ln_u = logf(fmaxf(ux[7], 1e-30f));
        const bool ok = can && ln_u < ln_acc;
        sstat[7] += is_ins ? 1.0f : 0.0f;
        if (ok) {
          sstat[0] += du;
          sstat[8] += (float)(slot + 1 + (is_ins ? 0 : M_total));
          const float on = is_ins ? 1.0f : 0.0f;
          sactm[slot] = on;
          for (int p = 0; p < P; ++p) sact[a0 + p] = on;
          if (is_ins) {
            sstat[5] += 1.0f;
            for (int p = 0; p < P; ++p) {
              sx[a0 + p] = snew[4 * p];
              sy[a0 + p] = snew[4 * p + 1];
              sz[a0 + p] = snew[4 * p + 2];
            }
            for (int d = 0; d < 3; ++d) scom[3 * slot + d] = sxd[d];
            if (P > 1)
              for (int i = 0; i < 4; ++i) squat[4 * slot + i] = sxd[3 + i];
          } else {
            sstat[6] += 1.0f;
          }
        }
        sxd[8] = ok ? 1.0f : 0.0f;
      }
      __syncthreads();
      if (sxd[8] != 0.0f) {
        n_act += sgn;
        if (ewald) {
          const float* dre = kTmmc && !is_ins ? sdre2 : sdre;
          const float* dim = kTmmc && !is_ins ? sdim2 : sdim;
          for (int k = tid; k < K; k += nt) {
            ssre[k] += sgn * dre[k];
            ssim[k] += sgn * dim[k];
          }
        }
      }
    }

    for (int wi = 0; wi < n_widom; ++wi) {
      __syncthreads();  // the last reader of ux and sred is done
      if (tid < kExchUniforms) ux[tid] = ux_chain[(size_t)(n_exch + wi) * kExchUniforms + tid];
      __syncthreads();
      if (tid == 0) trial_pose();
      __syncthreads();
      float part = pose_part(-2, true, 1.0f);
      part = warp_sum(part);
      if (lane == 0) sred[warp] = part;
      __syncthreads();
      if (tid == 0) {
        float du = 0.0f;
        for (int w = 0; w < kWarps; ++w) du += sred[w];
        du += si_c + wc_c * (2.0f * n_act + 1.0f);
        // a vetoed ghost carries +1e30: w = 0
        const float w = expf(-beta * du);
        sstat[9] += w;
        sstat[10] += w * w;
      }
    }
    __syncthreads();
  }

  if constexpr (!kGlob) {
    float* cout = coords_out + (size_t)c * 3 * A_pad;
    for (int j = tid; j < A_pad; j += nt) {
      cout[j] = sx[j];
      cout[A_pad + j] = sy[j];
      cout[2 * A_pad + j] = sz[j];
      if (kAct) act_out[(size_t)c * A_pad + j] = sact[j];
    }
    if (kAct)
      for (int i = tid; i < M_total; i += nt)
        actm_out[(size_t)c * M_total + i] = sactm[i];
  }
  for (int k = tid; k < K; k += nt) {
    sfac_out[((size_t)c * K + k) * 2] = ssre[k];
    sfac_out[((size_t)c * K + k) * 2 + 1] = ssim[k];
  }
  if (tid == 0) {
    float* st = stats_out + (size_t)c * kStats;
    for (int i = 0; i < kStats; ++i) st[i] = sstat[i];
    if (kAct) {
      wid_out[(size_t)c * 2] = sstat[9];
      wid_out[(size_t)c * 2 + 1] = sstat[10];
    }
  }
}

using SweepKernel = decltype(&sweep_kernel<false, false, kShared>);

template <bool kAct, bool kTmmc>
SweepKernel pick_layout(int layout) {
  return layout == kGlobalK  ? sweep_kernel<kAct, kTmmc, kGlobalK>
         : layout == kGlobal ? sweep_kernel<kAct, kTmmc, kGlobal>
                             : sweep_kernel<kAct, kTmmc, kShared>;
}

SweepKernel pick_kernel(int use_act, int tmmc, int layout) {
  return tmmc      ? pick_layout<true, true>(layout)
         : use_act ? pick_layout<true, false>(layout)
                   : pick_layout<false, false>(layout);
}

// Lets the instantiation take `smem` bytes of dynamic shared memory.
cudaError_t allow_smem(SweepKernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" size_t mmc_sweep_smem_bytes(int M, int P, int A_pad, int K, int T,
                                       int use_act, int tmmc, int layout) {
  return sizeof(float) *
         sweep_smem_floats(M, P, A_pad, K, T, use_act, tmmc, layout);
}

extern "C" size_t mmc_sweep_kws_floats(int K, int tmmc) {
  return sweep_kws_floats(K, tmmc);
}

// The instantiation's registers per thread, local memory per thread (stack
// frame and spills, bytes) and the blocks of this shape one SM holds at
// once (the CUDA occupancy calculator: shared memory and registers) into
// out[0..2]; returns the CUDA error code (0 on success).
extern "C" int mmc_sweep_occupancy(int M, int P, int A_pad, int K, int T,
                                   int use_act, int tmmc, int layout,
                                   int* out) {
  const SweepKernel kernel = pick_kernel(use_act, tmmc, layout);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = 0;
  const size_t smem =
      mmc_sweep_smem_bytes(M, P, A_pad, K, T, use_act, tmmc, layout);
  if (smem > (size_t)kMaxSmemBytes) return 0;
  e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      kThreads, smem);
  return static_cast<int>(e);
}

extern "C" const char* mmc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one sweep of one species block (grid = C chains of 256
// threads) on `stream`; returns the CUDA error code of the launch (0 on
// success).  com/quat/u/actm hold all M_total molecules' rows.  All
// pointers are device pointers to contiguous f32 (int32 for the flag and
// row tables) tensors; act, actm, act_out, actm_out and wid_out are read
// and written only with use_act, ux, z, si and wc only with n_exch +
// n_widom > 0 (which needs use_act), eta (M + 1), e_in (C), cmat_out and
// uhist_out (C, M + 1, 3) only with tmmc (which needs n_exch > 0).  layout
// selects where the chain state lives (Layout); kGlobalK needs the k-row
// workspace kws, C rows of mmc_sweep_kws_floats(K, tmmc) f32.  With W > 0
// (a global layout without activity) wst (M_total,) and segs (n_seg, 2)
// int32 give the slab windows and segments.
extern "C" int mmc_sweep_launch(
    const void* coords, const void* com, const void* quat, const void* sfac,
    const void* box, const void* temp, const void* drmax, const void* dphi,
    const void* u, const void* body, const void* qp, const void* eps_pt,
    const void* sig2_pt, const void* lam1_pt, const void* lam2_pt,
    const void* has_lj, const void* has_q, const void* tid_row,
    const void* molid_row, const void* q_row, const void* kvec, const void* kw,
    const void* act, const void* actm, const void* ux, const void* z,
    const void* si, const void* wc, const void* eta, const void* e_in,
    const void* wst, const void* segs, void* coords_out, void* com_out,
    void* quat_out, void* sfac_out, void* stats_out, void* act_out,
    void* actm_out, void* wid_out, void* cmat_out, void* uhist_out, void* kws,
    int C, int M, int M_total, int m_start, int a_start, int P, int A_pad,
    int K, int T, int coulomb, int lj_linear, int use_rot, int use_act,
    int n_exch, int n_widom, int tmmc, int layout, int n_seg, int a0_w,
    int A_blk, int W, unsigned int seed, unsigned int chain0, int threads,
    float rc2, float qrc2,
    float kappa_l, float d2_overlap, float p_translate, float factor,
    void* stream) {
  const size_t smem = mmc_sweep_smem_bytes(M_total, P, A_pad, K, T, use_act,
                                           tmmc, layout);
  if (layout < kShared || layout > kGlobalK || smem > (size_t)kMaxSmemBytes ||
      threads != kThreads || C < 1 || M < 1 ||
      P < 1 || P > 16 || A_pad > kMaxColumns ||
      (layout == kShared && A_pad % 4) || (layout == kGlobalK && !kws) ||
      m_start < 0 || a_start < 0 ||
      m_start + M > M_total || a_start + M * P > A_pad || n_exch < 0 ||
      n_widom < 0 || ((n_exch > 0 || n_widom > 0) && !use_act) ||
      (tmmc && n_exch < 1) || W < 0 ||
      (W > 0 && (layout == kShared || use_act || !wst ||
                 (n_seg > 0 && !segs) || n_seg < 0 ||
                 W > A_blk || a0_w < 0 || a0_w + A_blk + W > A_pad)))
    return static_cast<int>(cudaErrorInvalidValue);
  const SweepKernel kernel = pick_kernel(use_act, tmmc, layout);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const float*>(com),
      static_cast<const float*>(quat), static_cast<const float*>(sfac),
      static_cast<const float*>(box), static_cast<const float*>(temp),
      static_cast<const float*>(drmax), static_cast<const float*>(dphi),
      static_cast<const float*>(u), static_cast<const float*>(body),
      static_cast<const float*>(qp), static_cast<const float*>(eps_pt),
      static_cast<const float*>(sig2_pt), static_cast<const float*>(lam1_pt),
      static_cast<const float*>(lam2_pt), static_cast<const int*>(has_lj),
      static_cast<const int*>(has_q), static_cast<const int*>(tid_row),
      static_cast<const int*>(molid_row), static_cast<const float*>(q_row),
      static_cast<const float*>(kvec), static_cast<const float*>(kw),
      static_cast<const float*>(act), static_cast<const float*>(actm),
      static_cast<const float*>(ux), static_cast<const float*>(z),
      static_cast<const float*>(si), static_cast<const float*>(wc),
      static_cast<const float*>(eta), static_cast<const float*>(e_in),
      static_cast<const int*>(wst), static_cast<const int*>(segs),
      static_cast<float*>(coords_out), static_cast<float*>(com_out),
      static_cast<float*>(quat_out), static_cast<float*>(sfac_out),
      static_cast<float*>(stats_out), static_cast<float*>(act_out),
      static_cast<float*>(actm_out), static_cast<float*>(wid_out),
      static_cast<float*>(cmat_out), static_cast<float*>(uhist_out),
      static_cast<float*>(kws), M, M_total, m_start, a_start, P, A_pad, K, T,
      coulomb, lj_linear, use_rot, n_exch, n_widom, n_seg, a0_w, A_blk, W, seed, chain0, rc2, qrc2, kappa_l,
      d2_overlap, p_translate, factor);
  return static_cast<int>(cudaGetLastError());
}
