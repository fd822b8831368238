// Two-box Gibbs-ensemble cycle kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel metropolismontecarlo_tpu/ops/pallas/gibbs_kernel.py
// sweep_gibbs_pallas / _make_gibbs_kernel (with _rot_apply).  Plain
// PyTorch twin: ops/cuda/gibbs_kernel.py sweep_gibbs_plain.
//
// What it computes: for one chain per thread block, both Gibbs boxes of
// the chain, one species block of each (slots [m_start, m_start + M) of
// each box, atoms from column a_start, P each).  First the M moves of box 0
// and then the M moves of box 1: a translate or rotate proposal of an
// active slot, its old and new site sums against the active atoms of its
// own box (LJ from per-site tables plus real-space Coulomb: ewald / wolf /
// wolf_ref / bare / none), the incremental S(k) of that box and its
// reciprocal energy delta, the +1e30 overlap veto on the new pose, the
// Metropolis test and the write-back.  Then n_exch transfer attempts: the
// direction (ux[0] < 0.5: box 0 -> 1), the source box's active slot with the
// largest Philox4x32-10 score (key (seed, chain0 + chain), chain0 the
// global index of the launch's first chain, counter (plane slot id,
// attempt, 0, 0); ties to the lower slot), the destination box's first free
// slot and a fresh pose uniform in the destination volume (ux[1..6]); one
// pass over the source box's lanes with the candidate's stored pose (veto
// off, its own molecule excluded) and one over the destination box's lanes
// with the fresh pose (veto on), two S(k) rows, and the log-space rule
//   ln acc = ln N_s - ln(N_d + 1) + 3 (ln L_d - ln L_s) - beta (dU_s + dU_d),
//   dU_s = -u_del - si_s + wc_s (1 - 2 N_s) + dU_recip,s,
//   dU_d =  u_ins + si_d + wc_d (2 N_d + 1) + dU_recip,d.
// An attempt from an empty box or into a full one is refused and reads and
// writes nothing through its slot indices.
//
// Per-box constants: each box has its own length L_b (box2), kappa =
// kappa_L / L_b, Wolf shift erfc(kappa qrc) / qrc and reciprocal
// coefficients cfac_b(k); a move or a pose sum of box b uses only box b's.
// These do not cancel between boxes of different sizes: a kernel that used
// box 0's for box 1 would still conserve N.
//
// Layout: the state arrives in the two-box layout of mc/gibbs_mol.py --
// coords (C, 2, 3, A_off), com (C, 2 m_off, 3), quat (C, 2 m_off, 4), act
// (C, 2 A_off), actm (C, 2 m_off), sfac (C, 2, K, 2), box2/si2/wc2 (C, 2);
// slots are plane-indexed (box b's slot j has id b m_off + j).  The per-atom
// type, charge and molecule rows are one box's (A_off): both boxes hold the
// same slots.
//
// What bounds it on this card: latency and instruction issue inside each
// block (three blocks of 8 warps share an SM's 4 schedulers), not bytes.
// One cycle of the flagship (cap 128 x 2 SPC/E, K = 783) is ~106 dependent
// moves and 110 dependent transfers, each a pass over a box's 512 lanes
// and 783 k-vectors, a block reduction and a decision; device memory is
// touched only to load and store the chain state (~60 KB) and the
// uniforms.  Only a third to a half of the active atoms lie within a
// pose's reach, and a pair's LJ + erfc body costs several times its
// distance.  The design (the move body of csrc/sweep_kernel.cu, carried
// over; each step measured in turns with the previous build on one card,
// PERF.md):
// - Residency and occupancy: both boxes' atom planes, the molecule row,
//   both S(k) and cfac rows and the k-vector indices live in shared memory
//   for the whole cycle; the COM and quaternion rows, which only the moved
//   or inserted molecule touches, stay in the chain's own rows of the
//   outputs (copied in at entry, updated in place), and the per-atom
//   charge and type rows, the same for every chain, in their global
//   tables.  The real-space Coulomb form and the linear LJ shift are
//   template parameters, and __launch_bounds__(256, 3) caps the registers:
//   ~71 KB and three blocks per SM at the flagship.
// - Compacted pair sums in three warp stages (sweep_kernel.cu): centre
//   distances of 32 atoms at a time to each pose of a move, the (atom,
//   pose) pairs within the pose's reach (largest cutoff plus the pose's
//   radius, widened by 1e-4 relative plus 1e-3 A: exact by the triangle
//   inequality) into a near ring; their site distances against 16-byte
//   site rows (x, y, z, the site's live cutoff^2), a ballot per site, the
//   live triples into a queue; LJ + erfc on full warps of live terms.  A
//   transfer's two poses run stages 1-2 over every active atom of their
//   boxes (no reach ring), in one queue whose key's sign bit sends each
//   term to its pose's sum.
// - k-space from per-site eik tables: for each charged site of a pose, the
//   rows q e^{i 2 pi n x / L}, e^{i 2 pi n y / L}, e^{i 2 pi n z / L} for
//   |n| <= nk (the charge and the pose's sign folded into the x row; the
//   negative n are the conjugates), in the box of the sum, each row from
//   one sincospif by the recurrence e^{i n t} = e^{i (n - 1) t} e^{i t}.  A
//   k-vector's phase factor is then two complex products instead of a
//   sincosf: a pose costs 3 P sincospif instead of P K sincosf, and each
//   thread keeps two k-vectors' chains of loads in flight.
//   sincospif's argument reduction is exact, so no slow path or stack
//   frame is built.
// - Proposals one step ahead on one warp: move i + 1 does not depend on
//   move i's outcome (each slot moves once per launch and move i touches
//   none of slot i + 1's rows), so the last warp builds the next active
//   slot's proposal -- pose rows and eik tables -- into the other half of a
//   double buffer while the block sums move i.  It skips inactive slots, so
//   an inactive slot costs no barrier.  A transfer's direction, fresh pose
//   and its tables depend only on ux and the attempt index, so the same
//   warp builds them an attempt ahead; every thread computes the next
//   attempt's Philox scores (one per slot) during the current pass.  The
//   pick depends on activity: after a decision every warp redoes it on its
//   own (the source's largest key, the destination's first free slot: a few
//   keys per lane and one warp max), so no barrier orders it.
// - Every thread takes the same decision: after the warp partials every
//   thread sums them in the same order.  A move takes two barriers (the
//   partials; the write-back), a transfer two when it is rejected and three
//   when accepted (the deletion pose's rows and tables, built by the block
//   after the pick; the partials; the write-back).  P threads write an
//   accepted pose, seven its COM and quaternion, each thread the S(k)
//   deltas of its own k-vectors.
// The pair arithmetic (minimum image, d^2 floor, erfc, the order inside a
// term) is the same for every term; only the order in which terms are
// summed follows the queues.
//
// Global layouts (kGlob, their own instantiations; Layout in
// mmc_common.cuh): for chain states that do not fit a block's shared
// memory (bench's cap-1024 Gibbs recipe at K = 4849 would need ~367 KB),
// the rows that grow with the state leave it.  Both boxes' x/y/z rows and
// the two rows of Philox scores live in the chain's row of the workspace
// ws, in the shared layout's order (x/y/z copied in at entry and out at
// the end); the activity rows live in the chain's rows of act_out and
// actm_out (copied in at entry, updated in place); the molecule row is
// read from its global table.  The shared part keeps the queues, the
// proposal buffers and eik tables, the scratch, the LJ tables and the site
// rows, then the 11 k rows -- or, with k_global (layout kGlobalK: the k
// rows do not fit either), those follow in the chain's workspace row too.
// Every thread touches only the k-vectors it owns (k = tid, tid + 256,
// ...).  Writes to global rows are ordered before other threads' reads by
// the barriers that already order the shared layout's (__syncthreads
// orders a block's global writes too).  The arithmetic, lane order, skip
// tests, queues and reduction order are the shared layout's; only where
// the words live differs.
//
// Semantics kept from the TPU kernel: old atoms are read from the stored
// coordinates; new atoms are the floor-wrapped new COM plus R(q_new) body;
// pair distances use the minimum image rounded to nearest (ties to even, on
// the FMA pipe) with d^2 floored at 1e-4; pads (molid < 0), inactive atoms
// and the molecule's own atoms are excluded; S(k) changes only on accept;
// energy statistics add deltas by select.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mmc_common.cuh"

namespace {

constexpr int kStats = 8;
constexpr int kUniforms = 10;
constexpr int kExchUniforms = 8;
// A live pair term's queue key (mmc_common.cuh Queue): the plane column
// (kKeySite bits), the site (4 bits), the pose's sign (1: new or inserted
// pose, 0: old or deleted pose) and the overlap veto.
constexpr int kKeySign = 24, kKeyVeto = 25;
// A warp's ring of (atom, pose) pairs within the pose's reach (moves).
constexpr int kNear = 64;
constexpr int kNearWords = kWarps * kNear;
// One proposal's scalars.  A move: the new COM and the new pose's squared
// reach [0, 4), the old COM and the old pose's squared reach [4, 8), the
// new quaternion [8, 12), tsel, the accept uniform and the move index (2 M:
// the moves are over).  A transfer: the fresh COM [0, 3), its quaternion
// [3, 7), the accept uniform, the source box.
constexpr int kDec = 16;
constexpr int kScratch = 2 * kDec + 32 + 16 + 8;

// Shared-memory words of one block; ops/cuda/gibbs_kernel.py
// gibbs_smem_bytes computes the same number.  The warp queues and near
// rings; two proposal buffers, each an old and a new pose of P 16-byte site
// rows (16 P) and their eik tables (2 P x 3 rows of 2 nk + 1 complex: 24 P
// (2 nk + 1)); 4 (P, T) LJ tables; 7 P-wide site rows (body 3, charge, two
// flags, live cutoff^2); 88 words of scratch (two proposals' scalars, two
// rows of warp partials, the statistics, the box constants).  The shared
// layout adds x/y/z/activity over both boxes (8 A_off) and one box's
// molecule row (A_off), slot activity over both boxes (2 m_off) and two
// rows of Philox scores (4 m_off); the shared and global layouts add 11 k
// rows (S re/im and cfac per box, the move's or insertion's and the
// deletion's dS re/im, the packed k-vector indices).
__host__ __device__ inline size_t gibbs_smem_floats(int m_off, int P,
                                                    int A_off, int K, int T,
                                                    int nk, int layout) {
  size_t n = kQueueWords + kNearWords + 16 * (size_t)P +
             24 * (size_t)P * (2 * nk + 1) + 4 * (size_t)P * T +
             7 * (size_t)P + kScratch;
  if (layout == kShared) n += 9 * (size_t)A_off + 6 * (size_t)m_off;
  if (layout != kGlobalK) n += 11 * (size_t)K;
  return n;
}

// Words of one chain's workspace row in a global layout: x/y/z over both
// boxes (6 A_off), two rows of Philox scores (4 m_off) and, in kGlobalK,
// the 11 k rows.
__host__ __device__ inline size_t gibbs_ws_floats(int m_off, int A_off, int K,
                                                  int layout) {
  if (layout == kShared) return 0;
  return 6 * (size_t)A_off + 4 * (size_t)m_off +
         (layout == kGlobalK ? 11 * (size_t)K : 0);
}

template <int kQ, bool kLinear, bool kGlob>
__global__ void __launch_bounds__(kThreads,
                                  kGlob ? kMinBlocksGlobal : kMinBlocks)
    gibbs_kernel(
    const float* __restrict__ coords_in, const float* __restrict__ com_in,
    const float* __restrict__ quat_in, const float* __restrict__ sfac_in,
    const float* __restrict__ act_in, const float* __restrict__ actm_in,
    const float* __restrict__ box2_in, const float* __restrict__ temp_in,
    const float* __restrict__ drmax_in, const float* __restrict__ dphi_in,
    const float* __restrict__ si2_in, const float* __restrict__ wc2_in,
    const float* __restrict__ u_in, const float* __restrict__ ux_in,
    const float* __restrict__ body, const float* __restrict__ qp,
    const float* __restrict__ eps_pt, const float* __restrict__ sig2_pt,
    const float* __restrict__ lam1_pt, const float* __restrict__ lam2_pt,
    const int* __restrict__ has_lj, const int* __restrict__ has_q,
    const int* __restrict__ tid_row, const int* __restrict__ molid_row,
    const float* __restrict__ q_row, const float* __restrict__ kvec,
    const float* __restrict__ kw, float* __restrict__ coords_out,
    float* __restrict__ com_out, float* __restrict__ quat_out,
    float* __restrict__ sfac_out, float* __restrict__ stats_out,
    float* __restrict__ act_out, float* __restrict__ actm_out,
    float* __restrict__ ws, int M,
    int m_off, int m_start, int a_start, int P, int A_off, int K, int T,
    int nk, int ewald, int use_rot, int n_exch, int k_global,
    unsigned int seed, unsigned int chain0, float rc2,
    float qrc2, float kappa_l, float d2_overlap, float p_translate,
    float factor) {
  extern __shared__ float smem[];
  const int W = 2 * nk + 1;   // an eik row's entries
  const int TW = 6 * W;       // words of one site's three rows
  int* qkey = reinterpret_cast<int*>(smem);
  float* qd2 = smem + kWarps * kQueue;
  int* qnear = reinterpret_cast<int*>(smem + kQueueWords);
  // 16-byte rows from here: two proposal buffers of an old then a new pose
  // (a transfer: the deletion pose, then the inserted one)
  float* spose = smem + kQueueWords + kNearWords;  // 2 x 2 x (P, 4)
  float* stab = spose + 16 * P;                     // 2 x 2 x P x TW
  float* sdec = stab + 4 * P * TW;  // 2 x kDec: proposal scalars (16-byte)
  float* sred = sdec + 2 * kDec;    // 16 partials (a second row at +16)
  // thread 0's statistics: per-box energy deltas, acc/att [trans, rot],
  // accepted transfers, a decision fingerprint; [15] a k-vector out of range
  float* sstat = sred + 32;
  float* sbox = sstat + 16;       // per box: L, 1 / L, kappa, Wolf shift
  const int A2 = 2 * A_off, M2 = 2 * m_off;
  float* sx = sbox + 8;           // (2 A_off) both boxes
  float* sy = sx + A2;
  float* sz = sy + A2;
  float* sact = sz + A2;
  int* smol = reinterpret_cast<int*>(sact + A2);     // (A_off) one box's
  float* sactm = reinterpret_cast<float*>(smol + A_off);  // (2 m_off)
  float* ssre = sactm + M2;      // (2, K) per box
  float* ssim = ssre + 2 * K;
  float* scfac = ssim + 2 * K;
  float* sdre = scfac + 2 * K;   // (K) a move's or an insertion's dS
  float* sdim = sdre + K;
  float* sdre2 = sdim + K;       // (K) a deletion's dS
  float* sdim2 = sdre2 + K;
  int* skidx = reinterpret_cast<int*>(sdim2 + K);  // (K) packed k indices
  float* seps = reinterpret_cast<float*>(skidx + K);  // (P, T)
  float* ssig2 = seps + P * T;
  float* slam1 = ssig2 + P * T;
  float* slam2 = slam1 + P * T;
  float* sbody = slam2 + P * T;   // (P, 3)
  float* sqp = sbody + 3 * P;
  int* slj = reinterpret_cast<int*>(sqp + P);
  int* sqf = slj + P;
  float* scut = reinterpret_cast<float*>(sqf + P);   // (P) live cutoff^2
  unsigned* sscore = reinterpret_cast<unsigned*>(scut + P);  // 2 x (2 m_off)
  if constexpr (kGlob) {
    // the fixed part follows the box constants; the chain's workspace row
    // holds x/y/z and the scores (gibbs_ws_floats), the outputs' rows the
    // activity, the global table the molecule row; the k rows follow the
    // fixed part or, with k_global, the workspace row's scores
    seps = sbox + 8;
    ssig2 = seps + P * T;
    slam1 = ssig2 + P * T;
    slam2 = slam1 + P * T;
    sbody = slam2 + P * T;
    sqp = sbody + 3 * P;
    slj = reinterpret_cast<int*>(sqp + P);
    sqf = slj + P;
    scut = reinterpret_cast<float*>(sqf + P);
    float* const wrow =
        ws + (size_t)blockIdx.x *
                 gibbs_ws_floats(m_off, A_off, K, k_global ? kGlobalK : kGlobal);
    sx = wrow;
    sy = sx + A2;
    sz = sy + A2;
    sscore = reinterpret_cast<unsigned*>(sz + A2);
    sact = act_out + (size_t)blockIdx.x * A2;
    sactm = actm_out + (size_t)blockIdx.x * M2;
    smol = const_cast<int*>(molid_row);
    ssre = k_global ? reinterpret_cast<float*>(sscore + 2 * M2) : scut + P;
    ssim = ssre + 2 * K;
    scfac = ssim + 2 * K;
    sdre = scfac + 2 * K;
    sdim = sdre + K;
    sdre2 = sdim + K;
    sdim2 = sdre2 + K;
    skidx = reinterpret_cast<int*>(sdim2 + K);
  }

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  constexpr int nt = kThreads;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  constexpr int kProposer = kWarps - 1;  // the warp that builds proposals

  // the chain's COM and quaternion rows: its own rows of the outputs,
  // updated in place
  float* const scom = com_out + (size_t)c * 3 * M2;
  float* const squat = quat_out + (size_t)c * 4 * M2;
  const float* cin = coords_in + (size_t)c * 6 * A_off;
  for (int j = tid; j < A_off; j += nt) {
    for (int b = 0; b < 2; ++b) {
      sx[b * A_off + j] = cin[(3 * b) * A_off + j];
      sy[b * A_off + j] = cin[(3 * b + 1) * A_off + j];
      sz[b * A_off + j] = cin[(3 * b + 2) * A_off + j];
    }
    if (!kGlob) smol[j] = molid_row[j];
  }
  for (int j = tid; j < A2; j += nt) sact[j] = act_in[(size_t)c * A2 + j];
  for (int i = tid; i < M2; i += nt) sactm[i] = actm_in[(size_t)c * M2 + i];
  for (int i = tid; i < 3 * M2; i += nt) scom[i] = com_in[(size_t)c * 3 * M2 + i];
  for (int i = tid; i < 4 * M2; i += nt) squat[i] = quat_in[(size_t)c * 4 * M2 + i];
  if (tid < 16) sstat[tid] = 0.0f;
  if (tid < 2) {
    const float L = box2_in[2 * c + tid];
    const float inv = 1.0f / L;
    const float kap = kappa_l * inv;
    sbox[4 * tid] = L;
    sbox[4 * tid + 1] = inv;
    sbox[4 * tid + 2] = kap;
    float shw = 0.0f;
    if (kQ == kQWolf) {
      const float qrc = sqrtf(qrc2);
      shw = erfcf(kap * qrc) / qrc;
    }
    sbox[4 * tid + 3] = shw;
  }
  const float temp = temp_in[c];
  const float dr_max = drmax_in[c];
  const float dphi_max = dphi_in[c];
  const float L0 = box2_in[2 * c], L1 = box2_in[2 * c + 1];
  bool k_bad = false;
  for (int k = tid; k < K; k += nt) {
    const float kx = kvec[3 * k], ky = kvec[3 * k + 1], kz = kvec[3 * k + 2];
    const int nx = (int)rintf(kx), ny = (int)rintf(ky), nz = (int)rintf(kz);
    if (ewald && (abs(nx) > nk || abs(ny) > nk || abs(nz) > nk)) k_bad = true;
    skidx[k] = (nx + nk) | (ny + nk) << 8 | (nz + nk) << 16;
    for (int b = 0; b < 2; ++b) {
      ssre[b * K + k] = sfac_in[(((size_t)c * 2 + b) * K + k) * 2];
      ssim[b * K + k] = sfac_in[(((size_t)c * 2 + b) * K + k) * 2 + 1];
      if (ewald) {
        const float L = b ? L1 : L0;
        const float inv = 1.0f / L, kap = kappa_l * inv;
        const float tpl = kTwoPi * inv;
        const float kt2 = tpl * tpl * (kx * kx + ky * ky + kz * kz);
        const float vol = L * L * L;
        scfac[b * K + k] =
            kw[k] * (kTwoPi / vol) * expf(-kt2 / (4.0f * kap * kap)) / kt2;
      }
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
    const bool lj = has_lj[i] != 0, uq = kQ != kQNone && has_q[i] != 0;
    sqp[i] = qp[i];
    slj[i] = lj;
    sqf[i] = uq;
    scut[i] = lj ? (uq ? fmaxf(rc2, qcut2) : rc2) : (uq ? qcut2 : -1.0f);
  }
  // the largest cutoff: a pose's reach is this plus the pose's radius
  const float rc_max = sqrtf(fmaxf(rc2, qcut2));
  __syncthreads();
  if (k_bad) sstat[15] = 1.0f;

  // ---- pair terms: distances on every lane, live terms through queues ----
  auto dist2 = [&](float xj, float yj, float zj, float ax, float ay, float az,
                   float L, float inv) -> float {
    float dx = xj - ax, dy = yj - ay, dz = zj - az;
    dx -= L * round_near(dx * inv);
    dy -= L * round_near(dy * inv);
    dz -= L * round_near(dz * inv);
    return fmaxf(dx * dx + dy * dy + dz * dz, 1e-4f);
  };
  // One live term: LJ (with the linear shift) plus real-space Coulomb with
  // the constants of the column's box, the +1e30 veto on an attractive
  // overlap when the key asks for it, negated for the old or deleted pose.
  auto live_term = [&](int key, float d2) -> float {
    const int j = key & (kMaxColumns - 1);
    const int p = (key >> kKeySite) & 15;
    const int bx = j >= A_off ? 1 : 0;
    const int jl = j - bx * A_off;
    const int tj = __ldg(tid_row + jl);
    const bool m_lj = d2 < rc2;
    const bool m_qq = split_cut ? d2 < qrc2 : m_lj;
    const float inv_r = rsqrtf(d2);
    const float inv_d2 = inv_r * inv_r;
    // r from the reciprocal root, for the linear shift as for erfc: no
    // IEEE square root and its slow path in the term
    const float r = d2 * inv_r;
    float contrib = 0.0f;
    if (slj[p] != 0 && m_lj) {
      const float s2 = ssig2[p * T + tj] * inv_d2;
      const float s6 = s2 * s2 * s2;
      float pot = seps[p * T + tj] * (s6 * s6 - s6);
      if (kLinear) pot += slam1[p * T + tj] + slam2[p * T + tj] * r;
      contrib = pot;
    }
    if (kQ != kQNone && sqf[p] != 0 && m_qq) {
      const float qq = (factor * sqp[p]) * __ldg(q_row + jl);
      float cp;
      if (kQ == kQBare) {
        cp = qq * inv_r;
      } else {
        const float kap = sbox[4 * bx + 2];
        if (kQ == kQWolf)
          cp = qq * (erfcf(kap * r) * inv_r - sbox[4 * bx + 3]);
        else
          cp = qq * (erfcf(kap * r) * inv_r);
      }
      if (((key >> kKeyVeto) & 1) && d2 < d2_overlap && qq < 0.0f) cp = 1e30f;
      contrib += cp;
    }
    return ((key >> kKeySign) & 1) ? contrib : -contrib;
  };
  // a warp queue's live terms (mmc_common.cuh Queue): the old or deleted
  // pose's into acc0, the others into acc1
  auto push = [&](Queue& q, float& acc0, float& acc1, int n, const bool* live,
                  const float* d2, int key0) {
    q.push(n, live, d2, key0, lane, [&](int key, float dd) {
      const float t = live_term(key, dd);
      if ((key >> kKeySign) & 1)
        acc1 += t;
      else
        acc0 += t;
    });
  };
  auto drain = [&](Queue& q, float& acc0, float& acc1) {
    q.drain(lane, [&](int key, float dd) {
      const float t = live_term(key, dd);
      if ((key >> kKeySign) & 1)
        acc1 += t;
      else
        acc0 += t;
    });
  };
  // stage 1 of one lane: the site distances of the pose rows `pose` (veto
  // and sign in key) to the atom (xj, yj, zj) when ok, live triples queued
  auto site_stage = [&](Queue& q, float& acc0, float& acc1, bool ok, float xj,
                        float yj, float zj, const float* pose, float L,
                        float inv, int key) {
    const float4* a = reinterpret_cast<const float4*>(pose);
    for (int p0 = 0; p0 < P; p0 += kChunk) {
      bool live[kChunk];
      float d2[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        live[k] = false;
        d2[k] = 0.0f;
        if (ok && p0 + k < P) {
          const float4 site = a[p0 + k];
          d2[k] = dist2(xj, yj, zj, site.x, site.y, site.z, L, inv);
          live[k] = d2[k] < site.w;
        }
      }
      push(q, acc0, acc1, P - p0, live, d2, key | p0 << kKeySite);
    }
  };
  // The n (<= 32, warp-uniform) oldest (atom, pose) pairs of the near ring,
  // one per lane, through stage 1 against the pose the key's sign names.
  auto near_flush = [&](Queue& qn, Queue& q, float& acc0, float& acc1, int n,
                        const float* pose, float L, float inv) {
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
    site_stage(q, acc0, acc1, ok, xj, yj, zj, pose + 4 * P * s, L, inv, key);
  };

  // ---- eik tables and the k-space rows ----
  // The rows of the n_pose poses' sites (pose s, site p: table (s P + p)
  // TW) of tab, sign sgn(s) * q_p folded into the x row, from coordinates
  // pos(s, p, axis), in a box of inverse length inv: one row (s, p, axis)
  // per thread of first, first + stride, ...
  auto build_tables = [&](float* tab, int n_pose, auto pos, auto sgn,
                          float inv, int first, int stride) {
    for (int r = first; r < 3 * P * n_pose; r += stride) {
      const int sp = r / 3, axis = r - 3 * sp;
      const int s = sp / P, p = sp - s * P;
      if (!sqf[p]) continue;
      eik_row(reinterpret_cast<float2*>(tab + sp * TW) + axis * W, nk,
              pos(s, p, axis), inv, axis == 0 ? sgn(s) * sqp[p] : 1.0f);
    }
  };
  // The structure-factor rows of the poses of `n_pose` consecutive site
  // tables at the k-vectors k0 and k0 + nt (the second when below K): the
  // sum over charged sites of x y z, two independent chains of loads and
  // products per site.
  auto k_sum2 = [&](const float* tab, int n_pose, int k0, float* dre,
                    float* dim) {
    const bool two = k0 + nt < K;
    const int idx0 = skidx[k0], idx1 = two ? skidx[k0 + nt] : idx0;
    for (int j = 0; j < 2; ++j) {
      dre[j] = 0.0f;
      dim[j] = 0.0f;
    }
    for (int s = 0; s < n_pose; ++s)
      for (int p = 0; p < P; ++p) {
        if (!sqf[p]) continue;
        eik_add2(reinterpret_cast<const float2*>(tab + (s * P + p) * TW), W,
                 idx0, idx1, dre, dim);
      }
  };

  // ---- moves: the proposal warp's work ----
  const int M2m = 2 * M;  // move indices: box 0's M, then box 1's
  // the next move after move i: the next active slot; 2 M ends the moves
  auto next_move = [&](int i) -> int {
    for (int base = i + 1; base < M2m; base += 32) {
      const int n = base + lane;
      bool on = false;
      if (n < M2m) {
        const int b = n >= M ? 1 : 0;
        on = sact[b * A_off + a_start + (n - b * M) * P] != 0.0f;
      }
      const unsigned bal = __ballot_sync(kFull, on);
      if (bal) return base + __ffs(bal) - 1;
    }
    return M2m;
  };
  auto slot_of_move = [&](int i) {
    const int b = i >= M ? 1 : 0;
    return b * m_off + m_start + i - b * M;
  };
  // lane i < 10 loads uniform i of move i, lane i < 7 COM/quaternion word
  // i: issued a pass ahead of their use
  auto prefetch = [&](int i, float& u_pre, float& c_pre) {
    if (i >= M2m) return;
    const int slot = slot_of_move(i);
    if (lane < kUniforms)
      u_pre = u_in[((size_t)c * M2m + i) * kUniforms + lane];
    if (lane < 3)
      c_pre = scom[3 * slot + lane];
    else if (lane < 7)
      c_pre = squat[4 * slot + lane - 3];
  };
  // the proposal of move i into buffer b: every lane computes the
  // molecule's scalars, lane p < P places site p, then the warp builds the
  // two poses' eik tables
  auto propose = [&](int i, int b, float u_pre, float c_pre) {
    float* dec = sdec + kDec * b;
    if (i >= M2m) {
      if (lane == 0) dec[14] = (float)M2m;
      return;
    }
    const int bx = i >= M ? 1 : 0;
    const float box = sbox[4 * bx], inv_box = sbox[4 * bx + 1];
    float um[kUniforms], cm[3], q0[4];
    for (int k = 0; k < kUniforms; ++k) um[k] = __shfl_sync(kFull, u_pre, k);
    for (int d = 0; d < 3; ++d) cm[d] = __shfl_sync(kFull, c_pre, d);
    for (int k = 0; k < 4; ++k) q0[k] = __shfl_sync(kFull, c_pre, 3 + k);
    float tsel = 1.0f;
    float q1[4] = {q0[0], q0[1], q0[2], q0[3]};
    if (use_rot) {
      tsel = um[0] < p_translate ? 1.0f : 0.0f;
      const float e1 = fmaxf(um[5], 1e-12f), e2 = um[6];
      const float e3 = fmaxf(um[7], 1e-12f), e4 = um[8];
      const float r1 = sqrtf(-2.0f * logf(e1));
      const float r2 = sqrtf(-2.0f * logf(e3));
      float s2, c2, s4, c4;
      sincos_turns(e2, &s2, &c2);
      sincos_turns(e4, &s4, &c4);
      const float g1 = r1 * c2, g2 = r1 * s2, g3 = r2 * c4;
      const float gn = rsqrtf(g1 * g1 + g2 * g2 + g3 * g3 + 1e-20f);
      const float half = 0.5f * ((2.0f * um[9] - 1.0f) * dphi_max);
      float sh, rw;
      sincospif(half * 0.3183098861837907f, &sh, &rw);
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
    const int a0 = bx * A_off + a_start + (i - bx * M) * P;
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
      r_old = sqrtf(dist2(xo[0], xo[1], xo[2], cm[0], cm[1], cm[2], box, inv_box));
      r_new = sqrtf(dist2(xn[0], xn[1], xn[2], nc[0], nc[1], nc[2], box, inv_box));
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
      for (int k = 0; k < 4; ++k) dec[8 + k] = q1[k];
      dec[12] = tsel;
      dec[13] = um[4];
      dec[14] = (float)i;
    }
    if (ewald) {
      __syncwarp();
      build_tables(stab + 2 * P * TW * b, 2,
                   [&](int s, int p, int axis) { return so[4 * P * s + 4 * p + axis]; },
                   [](int s) { return s ? 1.0f : -1.0f; }, inv_box, lane, 32);
    }
  };

  // One warp's 32 atom lanes j (ok: a neighbour of the mover) against the
  // old and the new pose of a move (pose, dec): the (atom, pose) pairs
  // within the pose's reach go to the near ring, 32 at a time on through
  // stage 1.
  auto move_lanes = [&](Queue& qn, Queue& q, float& acc0, float& acc1, int j,
                        bool ok, const float* pose, const float* dec, float L,
                        float inv) {
    float xj = 0.0f, yj = 0.0f, zj = 0.0f;
    if (ok) {
      xj = sx[j];
      yj = sy[j];
      zj = sz[j];
    }
    for (int s = 0; s < 2; ++s) {
      const float4 cc = reinterpret_cast<const float4*>(dec)[s ? 0 : 1];
      const bool near = ok && dist2(xj, yj, zj, cc.x, cc.y, cc.z, L, inv) < cc.w;
      const unsigned bal = __ballot_sync(kFull, near);
      if (!bal) continue;
      if (near)
        qn.key[(qn.tail + __popc(bal & lanes_below)) & (kNear - 1)] =
            j | s << kKeySign | s << kKeyVeto;
      qn.tail += __popc(bal);
      if (qn.tail - qn.head >= 32) near_flush(qn, q, acc0, acc1, 32, pose, L, inv);
    }
  };

  __syncthreads();
  if (warp == kProposer) {
    // the first move's proposal
    float u_pre = 0.0f, c_pre = 0.0f;
    const int i0 = next_move(-1);
    prefetch(i0, u_pre, c_pre);
    propose(i0, 0, u_pre, c_pre);
  }
  __syncthreads();

  for (int it = 0;; ++it) {
    const int b = it & 1;
    const float* dec = sdec + kDec * b;
    const int i = (int)dec[14];
    if (i >= M2m) break;  // block-uniform: every thread reads one word
    const int bx = i >= M ? 1 : 0;
    const int mloc = m_start + i - bx * M;  // the slot within its box
    const int slot = bx * m_off + mloc;
    const int col0 = bx * A_off;
    const int a0 = col0 + a_start + (i - bx * M) * P;
    const float box = sbox[4 * bx], inv_box = sbox[4 * bx + 1];
    const float* pose = spose + 8 * P * b;
    // the proposal warp starts the next proposal's loads
    int i_next = M2m;
    float u_pre = 0.0f, c_pre = 0.0f;
    if (warp == kProposer) {
      i_next = next_move(i);
      prefetch(i_next, u_pre, c_pre);
    }

    // ---- old and new site sums over this box's atom lanes ----
    float acc0 = 0.0f, acc1 = 0.0f;
    Queue q{qkey + warp * kQueue, qd2 + warp * kQueue, 0, 0};
    Queue qn{qnear + warp * kNear, nullptr, 0, 0};
    for (int jb = warp * 32; jb < A_off; jb += nt) {
      const int jl = jb + lane;
      bool ok = jl < A_off;
      if (ok) {
        const int mj = smol[jl];
        ok = mj >= 0 && mj != mloc && sact[col0 + jl] != 0.0f;
      }
      move_lanes(qn, q, acc0, acc1, col0 + jl, ok, pose, dec, box, inv_box);
    }
    if (qn.tail > qn.head)
      near_flush(qn, q, acc0, acc1, qn.tail - qn.head, pose, box, inv_box);
    drain(q, acc0, acc1);
    float part = acc0 + acc1;

    // ---- incremental S(k) of this box and the reciprocal delta ----
    if (ewald) {
      const float* tab = stab + 2 * P * TW * b;
      const float* sre_b = ssre + bx * K;
      const float* sim_b = ssim + bx * K;
      const float* cf_b = scfac + bx * K;
      for (int k0 = tid; k0 < K; k0 += 2 * nt) {
        float dre[2], dim[2];
        k_sum2(tab, 2, k0, dre, dim);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = k0 + j * nt;
          if (k >= K) break;
          sdre[k] = dre[j];
          sdim[k] = dim[j];
          const float cross = 2.0f * (sre_b[k] * dre[j] + sim_b[k] * dim[j]) +
                              dre[j] * dre[j] + dim[j] * dim[j];
          part += factor * (cf_b[k] * cross);
        }
      }
    }

    part = warp_sum(part);
    if (warp == kProposer) propose(i_next, b ^ 1, u_pre, c_pre);
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
      sstat[4] += tsel;
      sstat[5] += 1.0f - tsel;
      if (accept) {
        sstat[bx] += d_e;
        sstat[2] += tsel;
        sstat[3] += 1.0f - tsel;
        sstat[7] += (float)(slot + 1);
      }
    }
    if (accept) {
      const float* sn = pose + 4 * P;
      if (tid < P) {
        sx[a0 + tid] = sn[4 * tid];
        sy[a0 + tid] = sn[4 * tid + 1];
        sz[a0 + tid] = sn[4 * tid + 2];
      } else if (tid >= 32 && tid < 32 + 3) {
        scom[3 * slot + tid - 32] = dec[tid - 32];
      } else if (tid >= 35 && tid < 35 + 4) {
        squat[4 * slot + tid - 35] = dec[8 + tid - 35];
      }
      if (ewald)
        // each thread adds the deltas of the k-vectors it computed
        for (int k = tid; k < K; k += nt) {
          ssre[bx * K + k] += sdre[k];
          ssim[bx * K + k] += sdim[k];
        }
    }
    __syncthreads();
  }

  if (n_exch > 0) {
    const float beta = 1.0f / temp;
    const float* ux_chain = ux_in + (size_t)c * n_exch * kExchUniforms;
    const float ln_l0 = logf(L0), ln_l1 = logf(L1);

    // N of this block in each box, counted once and then tracked by every
    // thread
    float cnt0 = 0.0f, cnt1 = 0.0f;
    for (int i = tid; i < M; i += nt) {
      cnt0 += sactm[m_start + i] > 0.5f ? 1.0f : 0.0f;
      cnt1 += sactm[m_off + m_start + i] > 0.5f ? 1.0f : 0.0f;
    }
    cnt0 = warp_sum(cnt0);
    cnt1 = warp_sum(cnt1);
    if (lane == 0) {
      sred[warp] = cnt0;
      sred[16 + warp] = cnt1;
    }
    __syncthreads();
    float n_b0 = 0.0f, n_b1 = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      n_b0 += sred[w];
      n_b1 += sred[16 + w];
    }

    // every thread: the Philox scores of attempt x for the block's slots of
    // both boxes (score + 1; 0 is never a score) into row x & 1
    auto scores = [&](int x) {
      unsigned* row = sscore + (x & 1) * M2;
      for (int i = tid; i < 2 * M; i += nt) {
        const int bx = i >= M ? 1 : 0;
        const int id = bx * m_off + m_start + i - bx * M;
        row[i] = (philox_word((uint32_t)id, (uint32_t)x, seed, chain0 + (uint32_t)c) >> 8) + 1u;
      }
    };
    // the proposal warp: attempt x's direction, fresh pose (uniform in the
    // destination volume, Shoemake quaternion; the identity for P = 1) and
    // its eik tables into buffer b's second half
    auto xpropose = [&](int x, int b) {
      float* dec = sdec + kDec * b;
      float* sn = spose + 8 * P * b + 4 * P;
      float v = 0.0f;
      if (lane < kExchUniforms) v = ux_chain[(size_t)x * kExchUniforms + lane];
      float ux[kExchUniforms];
      for (int k = 0; k < kExchUniforms; ++k) ux[k] = __shfl_sync(kFull, v, k);
      const int dst = ux[0] < 0.5f ? 1 : 0;
      const float L_d = sbox[4 * dst], inv_d = sbox[4 * dst + 1];
      float q[4] = {1.0f, 0.0f, 0.0f, 0.0f};
      if (P > 1) {
        const float u1 = ux[4];
        float s2, c2, s3, c3;
        sincos_turns(ux[5], &s2, &c2);
        sincos_turns(ux[6], &s3, &c3);
        const float r1 = sqrtf(fmaxf(1.0f - u1, 0.0f)), r2 = sqrtf(u1);
        q[0] = r1 * s2;
        q[1] = r1 * c2;
        q[2] = r2 * s3;
        q[3] = r2 * c3;
      }
      float ct[3];
      for (int d = 0; d < 3; ++d) ct[d] = ux[1 + d] * L_d;
      if (lane < P) {
        const int p = lane;
        float o[3] = {0.0f, 0.0f, 0.0f};
        if (P > 1)
          rot_apply(q[0], q[1], q[2], q[3], sbody[3 * p], sbody[3 * p + 1],
                    sbody[3 * p + 2], o);
        for (int d = 0; d < 3; ++d) sn[4 * p + d] = ct[d] + o[d];
        sn[4 * p + 3] = scut[p];
      }
      if (lane == 0) {
        for (int d = 0; d < 3; ++d) dec[d] = ct[d];
        for (int k = 0; k < 4; ++k) dec[3 + k] = q[k];
        dec[7] = ux[7];
        dec[8] = (float)(1 - dst);
      }
      if (ewald) {
        __syncwarp();
        build_tables(stab + 2 * P * TW * b + P * TW, 1,
                     [&](int, int p, int axis) { return sn[4 * p + axis]; },
                     [](int) { return 1.0f; }, inv_d, lane, 32);
      }
    };

    scores(0);
    if (warp == kProposer) xpropose(0, 0);
    __syncthreads();

    for (int xi = 0; xi < n_exch; ++xi) {
      const int b = xi & 1;
      const float* dec = sdec + kDec * b;
      const bool more = xi + 1 < n_exch;
      const int src = dec[8] > 0.5f ? 1 : 0;
      const int dst = 1 - src;
      const float n_src = src ? n_b1 : n_b0, n_dst = src ? n_b0 : n_b1;
      // an empty source or a full destination: refused, nothing read or
      // written through the slot indices (block-uniform)
      if (!(n_src > 0.5f && n_dst < (float)M - 0.5f)) {
        __syncthreads();  // the last readers of buffer b ^ 1 are done
        if (more) {
          scores(xi + 1);
          if (warp == kProposer) xpropose(xi + 1, b ^ 1);
        }
        __syncthreads();
        continue;
      }

      // the pick, in every warp alike: the source's active slot with the
      // largest key (score, ~slot) and the destination's first free slot
      const unsigned* row = sscore + b * M2;
      unsigned long long best = 0ull;
      for (int i = lane; i < M; i += 32) {
        const int id = src * m_off + m_start + i;
        if (sactm[id] > 0.5f) {
          const unsigned long long key =
              ((unsigned long long)row[src * M + i] << 32) | (0xFFFFFFFFu - (uint32_t)id);
          best = key > best ? key : best;
        }
      }
      best = warp_max_u64(best);
      const int del_slot = (int)(0xFFFFFFFFu - (uint32_t)(best & 0xFFFFFFFFull));
      int ins_loc = m_start;
      for (int base = 0; base < M; base += 32) {
        const int i = base + lane;
        const unsigned bal = __ballot_sync(
            kFull, i < M && !(sactm[dst * m_off + m_start + i] > 0.5f));
        if (bal) {
          ins_loc = m_start + base + __ffs(bal) - 1;
          break;
        }
      }
      const int ins_slot = dst * m_off + ins_loc;
      const int del_loc = del_slot - src * m_off;   // within the source box
      const int a0_d = src * A_off + a_start + (del_loc - m_start) * P;
      const int a0_i = dst * A_off + a_start + (ins_loc - m_start) * P;
      const float L_s = sbox[4 * src], inv_s = sbox[4 * src + 1];
      const float L_d = sbox[4 * dst], inv_d = sbox[4 * dst + 1];
      float* sdel = spose + 8 * P * b;   // the candidate's rows
      const float* sins = sdel + 4 * P;  // the fresh pose's rows
      float* tab = stab + 2 * P * TW * b;

      // the block: the candidate's stored pose as site rows and eik tables
      if (tid < P) {
        sdel[4 * tid] = sx[a0_d + tid];
        sdel[4 * tid + 1] = sy[a0_d + tid];
        sdel[4 * tid + 2] = sz[a0_d + tid];
        sdel[4 * tid + 3] = scut[tid];
      }
      if (ewald)
        build_tables(tab, 1,
                     [&](int, int p, int axis) {
                       return (axis == 0 ? sx : axis == 1 ? sy : sz)[a0_d + p];
                     },
                     [](int) { return 1.0f; }, inv_s, tid, nt);
      __syncthreads();

      // the candidate against its source box (its own atoms excluded, veto
      // off: acc0, negated) and the fresh pose against the destination box
      // (veto on: acc1), one queue
      float acc0 = 0.0f, acc1 = 0.0f;
      {
        Queue q{qkey + warp * kQueue, qd2 + warp * kQueue, 0, 0};
        for (int jb = warp * 32; jb < A_off; jb += nt) {
          const int jl = jb + lane;
          int mj = -1;
          if (jl < A_off) mj = smol[jl];
          const bool on_s = mj >= 0 && mj != del_loc && sact[src * A_off + jl] != 0.0f;
          const bool on_d = mj >= 0 && sact[dst * A_off + jl] != 0.0f;
          for (int s = 0; s < 2; ++s) {
            const bool on = s ? on_d : on_s;
            if (!__any_sync(kFull, on)) continue;
            const int j = (s ? dst : src) * A_off + jl;
            float xj = 0.0f, yj = 0.0f, zj = 0.0f;
            if (on) {
              xj = sx[j];
              yj = sy[j];
              zj = sz[j];
            }
            site_stage(q, acc0, acc1, on, xj, yj, zj, s ? sins : sdel,
                       s ? L_d : L_s, s ? inv_d : inv_s,
                       j | s << kKeySign | s << kKeyVeto);
          }
        }
        drain(q, acc0, acc1);
      }
      if (more) scores(xi + 1);
      float part_d = acc0, part_i = acc1;
      if (ewald) {
        const float* re_s = ssre + src * K;
        const float* im_s = ssim + src * K;
        const float* cf_s = scfac + src * K;
        const float* re_d = ssre + dst * K;
        const float* im_d = ssim + dst * K;
        const float* cf_d = scfac + dst * K;
        for (int k0 = tid; k0 < K; k0 += 2 * nt) {
          float dre[2], dim[2];
          k_sum2(tab, 1, k0, dre, dim);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = k0 + j * nt;
            if (k >= K) break;
            sdre2[k] = dre[j];
            sdim2[k] = dim[j];
            const float cross = -2.0f * (re_s[k] * dre[j] + im_s[k] * dim[j]) +
                                dre[j] * dre[j] + dim[j] * dim[j];
            part_d += factor * (cf_s[k] * cross);
          }
          k_sum2(tab + P * TW, 1, k0, dre, dim);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = k0 + j * nt;
            if (k >= K) break;
            sdre[k] = dre[j];
            sdim[k] = dim[j];
            const float cross = 2.0f * (re_d[k] * dre[j] + im_d[k] * dim[j]) +
                                dre[j] * dre[j] + dim[j] * dim[j];
            part_i += factor * (cf_d[k] * cross);
          }
        }
      }
      part_d = warp_sum(part_d);
      part_i = warp_sum(part_i);
      if (warp == kProposer && more) xpropose(xi + 1, b ^ 1);
      if (lane == 0) {
        sred[warp] = part_d;
        sred[16 + warp] = part_i;
      }
      __syncthreads();

      // every thread: the same sums, the same decision
      float du_d = 0.0f, du_i = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        du_d += sred[w];
        du_i += sred[16 + w];
      }
      du_d += -si2_in[2 * c + src] + wc2_in[2 * c + src] * (-2.0f * n_src + 1.0f);
      du_i += si2_in[2 * c + dst] + wc2_in[2 * c + dst] * (2.0f * n_dst + 1.0f);
      const float du = du_d + du_i;
      const float ln_acc = logf(fmaxf(n_src, 1.0f)) - logf(n_dst + 1.0f) +
                           3.0f * ((dst ? ln_l1 : ln_l0) - (src ? ln_l1 : ln_l0)) -
                           beta * du;
      const float ln_u = logf(fmaxf(dec[7], 1e-30f));
      if (!(ln_u < ln_acc)) continue;
      if (tid == 0) {
        sstat[0] += src ? du_i : du_d;
        sstat[1] += src ? du_d : du_i;
        sstat[6] += 1.0f;
        sstat[7] += (float)(del_slot + 1 + 2 * m_off);
        sactm[del_slot] = 0.0f;
        sactm[ins_slot] = 1.0f;
      }
      if (tid < P) {
        sact[a0_d + tid] = 0.0f;
        sact[a0_i + tid] = 1.0f;
        sx[a0_i + tid] = sins[4 * tid];
        sy[a0_i + tid] = sins[4 * tid + 1];
        sz[a0_i + tid] = sins[4 * tid + 2];
      } else if (tid >= 32 && tid < 32 + 3) {
        scom[3 * ins_slot + tid - 32] = dec[tid - 32];
      } else if (tid >= 35 && tid < 35 + 4 && P > 1) {
        squat[4 * ins_slot + tid - 35] = dec[3 + tid - 35];
      }
      n_b0 += src ? 1.0f : -1.0f;
      n_b1 += src ? -1.0f : 1.0f;
      if (ewald)
        for (int k = tid; k < K; k += nt) {
          ssre[src * K + k] -= sdre2[k];
          ssim[src * K + k] -= sdim2[k];
          ssre[dst * K + k] += sdre[k];
          ssim[dst * K + k] += sdim[k];
        }
      __syncthreads();
    }
  }
  __syncthreads();

  float* cout = coords_out + (size_t)c * 6 * A_off;
  for (int j = tid; j < A_off; j += nt)
    for (int b = 0; b < 2; ++b) {
      cout[(3 * b) * A_off + j] = sx[b * A_off + j];
      cout[(3 * b + 1) * A_off + j] = sy[b * A_off + j];
      cout[(3 * b + 2) * A_off + j] = sz[b * A_off + j];
    }
  if (!kGlob) {
    for (int j = tid; j < A2; j += nt) act_out[(size_t)c * A2 + j] = sact[j];
    for (int i = tid; i < M2; i += nt) actm_out[(size_t)c * M2 + i] = sactm[i];
  }
  for (int k = tid; k < K; k += nt)
    for (int b = 0; b < 2; ++b) {
      sfac_out[(((size_t)c * 2 + b) * K + k) * 2] = ssre[b * K + k];
      sfac_out[(((size_t)c * 2 + b) * K + k) * 2 + 1] = ssim[b * K + k];
    }
  if (tid == 0) {
    float* st = stats_out + (size_t)c * kStats;
    for (int i = 0; i < kStats; ++i) st[i] = sstat[i];
    if (sstat[15] != 0.0f) st[0] = st[1] = nanf("");  // a k-vector beyond nk
  }
}

using GibbsKernel = decltype(&gibbs_kernel<kQNone, false, false>);

template <bool kGlob>
GibbsKernel pick_form(int q, int lj_linear) {
  switch (2 * q + (lj_linear ? 1 : 0)) {
    case 0: return gibbs_kernel<kQNone, false, kGlob>;
    case 1: return gibbs_kernel<kQNone, true, kGlob>;
    case 2: return gibbs_kernel<kQErfc, false, kGlob>;
    case 3: return gibbs_kernel<kQErfc, true, kGlob>;
    case 4: return gibbs_kernel<kQWolf, false, kGlob>;
    case 5: return gibbs_kernel<kQWolf, true, kGlob>;
    case 6: return gibbs_kernel<kQBare, false, kGlob>;
    default: return gibbs_kernel<kQBare, true, kGlob>;
  }
}

// The instantiation of a Coulomb style, LJ shift and layout (kGlobal and
// kGlobalK share theirs).
GibbsKernel pick_kernel(int coulomb, int lj_linear, int layout) {
  const int q = coulomb == kNone   ? kQNone
                : coulomb == kWolf ? kQWolf
                : coulomb == kBare ? kQBare
                                   : kQErfc;
  return layout == kShared ? pick_form<false>(q, lj_linear)
                           : pick_form<true>(q, lj_linear);
}

// Lets the instantiation take `smem` bytes of dynamic shared memory.
cudaError_t allow_smem(GibbsKernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" size_t mmc_gibbs_smem_bytes(int m_off, int P, int A_off, int K,
                                       int T, int nk, int layout) {
  return sizeof(float) * gibbs_smem_floats(m_off, P, A_off, K, T, nk, layout);
}

extern "C" size_t mmc_gibbs_ws_floats(int m_off, int A_off, int K,
                                      int layout) {
  return gibbs_ws_floats(m_off, A_off, K, layout);
}

// The instantiation's registers per thread, local memory per thread (stack
// frame and spills, bytes) and the blocks of this shape one SM holds at
// once (the CUDA occupancy calculator) into out[0..2]; returns the CUDA
// error code (0 on success).
extern "C" int mmc_gibbs_occupancy(int coulomb, int lj_linear, int m_off,
                                   int P, int A_off, int K, int T, int nk,
                                   int layout, int* out) {
  const GibbsKernel kernel = pick_kernel(coulomb, lj_linear, layout);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = 0;
  const size_t smem = mmc_gibbs_smem_bytes(m_off, P, A_off, K, T, nk, layout);
  if (smem > (size_t)kMaxSmemBytes) return 0;
  e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      kThreads, smem);
  return static_cast<int>(e);
}

extern "C" const char* mmc_gibbs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one Gibbs call of one species block (grid = C chains of 256
// threads) on `stream`; returns the CUDA error code of the launch (0 on
// success).  All pointers are device pointers to contiguous f32 (int32 for
// the flag and row tables) tensors in the layout described at the top; ux,
// si2 and wc2 are read only with n_exch > 0.  nk bounds the k-vectors'
// integer components (|n| <= nk; a launch whose k-vectors exceed it returns
// NaN energy statistics).  layout selects where the chain state lives
// (Layout); the global layouts need the workspace ws, C rows of
// mmc_gibbs_ws_floats(m_off, A_off, K, layout) f32.
extern "C" int mmc_gibbs_launch(
    const void* coords, const void* com, const void* quat, const void* sfac,
    const void* act, const void* actm, const void* box2, const void* temp,
    const void* drmax, const void* dphi, const void* si2, const void* wc2,
    const void* u, const void* ux, const void* body, const void* qp,
    const void* eps_pt, const void* sig2_pt, const void* lam1_pt,
    const void* lam2_pt, const void* has_lj, const void* has_q,
    const void* tid_row, const void* molid_row, const void* q_row,
    const void* kvec, const void* kw, void* coords_out, void* com_out,
    void* quat_out, void* sfac_out, void* stats_out, void* act_out,
    void* actm_out, void* ws, int C, int M, int m_off, int m_start,
    int a_start, int P, int A_off, int K, int T, int nk, int coulomb,
    int lj_linear, int use_rot, int n_exch, int layout, unsigned int seed,
    unsigned int chain0, int threads, float rc2, float qrc2, float kappa_l,
    float d2_overlap, float p_translate, float factor, void* stream) {
  const size_t smem = mmc_gibbs_smem_bytes(m_off, P, A_off, K, T, nk, layout);
  if (layout < kShared || layout > kGlobalK || (layout != kShared && !ws) ||
      smem > (size_t)kMaxSmemBytes || threads != kThreads || C < 1 || M < 1 ||
      P < 1 || P > 16 || nk < 0 || nk > 127 || 2 * A_off > kMaxColumns ||
      m_start < 0 || a_start < 0 || m_start + M > m_off ||
      a_start + M * P > A_off || n_exch < 0 ||
      (n_exch > 0 && (!ux || !si2 || !wc2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const GibbsKernel kernel = pick_kernel(coulomb, lj_linear, layout);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const float*>(com),
      static_cast<const float*>(quat), static_cast<const float*>(sfac),
      static_cast<const float*>(act), static_cast<const float*>(actm),
      static_cast<const float*>(box2), static_cast<const float*>(temp),
      static_cast<const float*>(drmax), static_cast<const float*>(dphi),
      static_cast<const float*>(si2), static_cast<const float*>(wc2),
      static_cast<const float*>(u), static_cast<const float*>(ux),
      static_cast<const float*>(body), static_cast<const float*>(qp),
      static_cast<const float*>(eps_pt), static_cast<const float*>(sig2_pt),
      static_cast<const float*>(lam1_pt), static_cast<const float*>(lam2_pt),
      static_cast<const int*>(has_lj), static_cast<const int*>(has_q),
      static_cast<const int*>(tid_row), static_cast<const int*>(molid_row),
      static_cast<const float*>(q_row), static_cast<const float*>(kvec),
      static_cast<const float*>(kw), static_cast<float*>(coords_out),
      static_cast<float*>(com_out), static_cast<float*>(quat_out),
      static_cast<float*>(sfac_out), static_cast<float*>(stats_out),
      static_cast<float*>(act_out), static_cast<float*>(actm_out),
      static_cast<float*>(ws), M, m_off, m_start, a_start, P, A_off, K, T,
      nk, coulomb == kEwald, use_rot, n_exch, layout == kGlobalK ? 1 : 0,
      seed, chain0, rc2, qrc2, kappa_l, d2_overlap, p_translate, factor);
  return static_cast<int>(cudaGetLastError());
}
