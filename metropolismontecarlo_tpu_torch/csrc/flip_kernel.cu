// Semigrand identity-flip kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel metropolismontecarlo_tpu/ops/pallas/flip_kernel.py
// flip_pallas / _make_flip_kernel.  Plain PyTorch twin:
// ops/cuda/flip_kernel.py flip_plain.
//
// What it computes: for one chain per thread block, n_flip identity flips on
// the two-block slot layout of mc/semigrand.py (slots [0, cap_a) species A
// with P0 sites from column 0, slots [cap_a, cap_a + cap_b) species B with P1
// sites from column a0_b; a slot's atoms sit at slot * P0, or at a0_b +
// (slot - cap_a) * P1).  Each attempt, in order:
//   1. the pick: the active slot of either block with the largest
//      Philox4x32-10 score (key (seed, chain0 + chain), chain0 the global
//      index of the launch's first chain, counter (slot, attempt, 0, 0);
//      ties to the lower slot); with no active slot the attempt counts as an
//      A -> B attempt (the TPU kernel's degenerate pick lands on slot 0) and
//      nothing else happens;
//   2. the target: the first free slot of the other block; with none the
//      attempt is refused and writes nothing;
//   3. the old identity's energy: its stored atom columns with its own
//      species' per-site LJ rows and charges against every active atom of
//      other molecules (veto off); the new identity's: the other species'
//      template at the same COM in a fresh Shoemake orientation (ux[4..6])
//      against the same atoms, the +1e30 overlap veto on;
//   4. dU = U_new - U_old + si[new] - si[old], plus the LJ tail's flip delta
//      in the live counts n_a, n_b (lrc3 = g [c00, c01, c11]), plus under
//      Ewald the reciprocal term of dS = s_new(new pose) - s_old(old pose);
//   5. accept when ln max(u7, 1e-30) < +-ln xi - beta dU (+ for A -> B);
//   6. on acceptance: the old slot and its atoms go inactive, the target
//      and its atoms active, the new pose goes into the target block's
//      columns, its COM and quaternion into the target slot, dS into S(k).
// The old slot's atoms, COM and quaternion stay in place, masked.
//
// stats (C, 8): [d_e, acc A->B, acc B->A, att A->B, att B->A, decision
// fingerprint (slot + 1 per accepted flip), 0, 0].
//
// What bounds it on this card: latency and instruction issue inside each
// block (three blocks of 8 warps share an SM's 4 schedulers), not bytes.
// An attempt is one pass
// over the chain's atom lanes (both poses' site sums) and its k-vectors, a
// block reduction and a scalar decision, all dependent on the previous
// attempt; device memory is touched only to load and store the chain state.
// The design (the move body of csrc/sweep_kernel.cu, carried over; each
// step measured in turns with the previous build on one card, PERF.md):
// - Residency and occupancy: the atom planes, the molecule row, S(k),
//   cfac, the packed k-vector indices and both species' LJ rows and
//   templates live in shared memory for the launch; the COM and quaternion
//   rows stay in the chain's own rows of the outputs (copied in at entry,
//   updated in place), the per-atom charge and type rows in their global
//   tables; the real-space Coulomb form is a template parameter and
//   __launch_bounds__(256, 3) caps the registers (three blocks per SM).
// - A list of the active atoms' columns (and each column's place in it),
//   kept current by the accepted flips: the old identity's columns leave
//   it, each swapped with the last entry, the new one's join at its end.
//   An attempt scans only the listed atoms, an equal share per warp; half
//   the slots of a semigrand chain are inactive.
// - Compacted pair sums: both poses' site distances against 16-byte site
//   rows (x, y, z, the site's live cutoff^2), a ballot per site, the live
//   triples into a warp queue, LJ + erfc on full warps of live terms
//   (stages 1-2 of sweep_kernel.cu; a reach ring around the slot's centre,
//   which both identities share, did not pay).
// - k-space from per-site eik tables: for each charged site of both poses
//   the rows q e^{i 2 pi n x / L}, e^{i 2 pi n y / L}, e^{i 2 pi n z / L},
//   |n| <= nk (charge and sign folded into the x row), each built from one
//   sincospif by the recurrence e^{i n t} = e^{i (n - 1) t} e^{i t}, so a
//   k-vector's dS costs two complex products per site instead of a
//   sincosf; each thread keeps two k-vectors' chains of loads in flight.
// - Proposals one step ahead: the next attempt's Shoemake orientation, both
//   species' rotated templates and accept uniform (one warp, its uniforms
//   loaded at the start of the pass) and its Philox scores (every thread,
//   one slot each) are built during the current pass; they depend only on
//   ux and the attempt index.  The pick depends on activity: after a
//   decision every warp redoes it on its own (a few keys per lane and one
//   warp max; the other block's first free slot by a ballot), so no
//   barrier orders it.
// - Every thread takes the same decision from the warp partials summed in
//   the same order: an attempt takes two barriers when rejected (the two
//   poses' rows and tables, built by the block after the pick; the
//   partials) and three when accepted (the write-back).
// The pair arithmetic (minimum image, d^2 floor, erfc, the order inside a
// term) is the same for every term; only the order in which terms are
// summed follows the queues.
//
// Global layouts (kGlob, their own instantiations; Layout in
// mmc_common.cuh): for chain states that do not fit a block's shared
// memory (bench's semigrand recipe at 16x the volume, 1024 + 1024 slots at
// K = 6062, would need ~331 KB), the rows that grow with the state leave
// it.  The x/y/z planes live in the chain's rows of coords_out and the
// slot activity in its row of actm_out (copied in at entry, updated in
// place); the active-atom list, each column's place in it and the two rows
// of Philox scores in the chain's row of the workspace ws; the molecule
// row is read from its global table.  The shared part keeps the queues,
// the poses' rows and eik tables, the proposal buffers, the LJ tables, the
// site rows and the scratch, then the 6 k rows -- or, with k_global
// (layout kGlobalK), those follow in the workspace row too.  Every thread
// touches only the k-vectors it owns; writes to global rows are ordered
// before other threads' reads by the barriers that already order the
// shared layout's.  The list keeps its order and contents: only where its
// words live differs, as for every other row.
//
// Semantics kept from the TPU kernel: pair distances use the minimum image
// rounded to nearest (ties to even, on the FMA pipe) with d^2 floored at
// 1e-4; pads (molid < 0), inactive atoms and the flipped molecule's own
// atoms are excluded; the quaternion written is the Shoemake one for either
// species (a one-site species ignores it).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mmc_common.cuh"

namespace {

constexpr int kStats = 8;
constexpr int kFlipUniforms = 8;
// A live pair term's queue key (mmc_common.cuh Queue): the atom column
// (kKeySite bits), the site's row in the two species' site table (5 bits:
// A's P0 sites, then B's P1), the pose's sign (1: the new identity, veto
// on; 0: the old one).
constexpr int kKeySign = 25;
constexpr int kDec = 8;  // an attempt's quaternion [0, 4) and accept uniform

// Shared-memory words of one block; ops/cuda/flip_kernel.py flip_smem_bytes
// computes the same number: the warp queues; the old and new poses' site
// rows (2 x 4 pmax) and eik tables (2 pmax x 3 rows of 2 nk + 1 complex:
// 12 pmax (2 nk + 1)); two proposal buffers of both species' rotated
// templates and the attempt's scalars (2 x (3 (P0 + P1) + 8)); both
// species' (P, T) eps and sigma^2 tables; both species' 7 P-wide site rows
// (body 3, charge, two flags, live cutoff^2); 33 words of warp partials,
// statistics and the list's length.  The shared layout adds x/y/z, the
// active-atom list, each column's place in it and the molecule row (6
// A_pad), slot activity (M) and two rows of Philox scores (2 M); the shared
// and global layouts add 6 k rows (S re/im, cfac, dS re/im, the packed k
// indices).
__host__ __device__ inline size_t flip_smem_floats(int M, int P0, int P1,
                                                   int A_pad, int K, int T,
                                                   int nk, int layout) {
  const int pmax = P0 > P1 ? P0 : P1;
  size_t n = kQueueWords + 8 * (size_t)pmax +
             12 * (size_t)pmax * (2 * nk + 1) +
             2 * (3 * (size_t)(P0 + P1) + kDec) + 2 * (size_t)(P0 + P1) * T +
             7 * (size_t)(P0 + P1) + 33;
  if (layout == kShared) n += 6 * (size_t)A_pad + 3 * (size_t)M;
  if (layout != kGlobalK) n += 6 * (size_t)K;
  return n;
}

// Words of one chain's workspace row in a global layout: the active-atom
// list and each column's place in it (2 A_pad), two rows of Philox scores
// (2 M) and, in kGlobalK, the 6 k rows.
__host__ __device__ inline size_t flip_ws_floats(int M, int A_pad, int K,
                                                 int layout) {
  if (layout == kShared) return 0;
  return 2 * (size_t)A_pad + 2 * (size_t)M +
         (layout == kGlobalK ? 6 * (size_t)K : 0);
}

template <int kQ, bool kGlob>
__global__ void __launch_bounds__(kThreads,
                                  kGlob ? kMinBlocksGlobal : kMinBlocks)
    flip_kernel(
    const float* __restrict__ coords_in, const float* __restrict__ com_in,
    const float* __restrict__ quat_in, const float* __restrict__ sfac_in,
    const float* __restrict__ act_in, const float* __restrict__ actm_in,
    const float* __restrict__ box_in, const float* __restrict__ temp_in,
    const float* __restrict__ si2_in, const float* __restrict__ lrc3_in,
    const float* __restrict__ ux_in, const float* __restrict__ body0,
    const float* __restrict__ qp0, const float* __restrict__ eps0,
    const float* __restrict__ sig20, const int* __restrict__ has_lj0,
    const int* __restrict__ has_q0, const float* __restrict__ body1,
    const float* __restrict__ qp1, const float* __restrict__ eps1,
    const float* __restrict__ sig21, const int* __restrict__ has_lj1,
    const int* __restrict__ has_q1, const int* __restrict__ tid_row,
    const int* __restrict__ molid_row, const float* __restrict__ q_row,
    const float* __restrict__ kvec, const float* __restrict__ kw,
    float* __restrict__ coords_out, float* __restrict__ com_out,
    float* __restrict__ quat_out, float* __restrict__ sfac_out,
    float* __restrict__ act_out, float* __restrict__ actm_out,
    float* __restrict__ stats_out, float* __restrict__ ws, int cap_a,
    int cap_b, int P0, int P1, int a0_b, int A_pad, int K, int T, int nk,
    int ewald, int n_flip, int k_global, unsigned int seed,
    unsigned int chain0, float rc2, float qrc2, float kappa_l,
    float d2_overlap, float ln_xi, float factor) {
  extern __shared__ float smem[];
  const int M = cap_a + cap_b;
  const int pmax = P0 > P1 ? P0 : P1;
  const int W = 2 * nk + 1;  // an eik row's entries
  const int TW = 6 * W;      // words of one site's three rows
  int* qkey = reinterpret_cast<int*>(smem);
  float* qd2 = smem + kWarps * kQueue;
  // 16-byte rows from here: the old pose's site rows, then the new one's
  float* sold = smem + kQueueWords;  // (pmax, 4)
  float* snew = sold + 4 * pmax;     // (pmax, 4)
  float* stab = snew + 4 * pmax;     // old then new: 2 pmax x TW
  // two proposal buffers: both species' rotated templates (P0 + P1, 3) and
  // the attempt's scalars
  float* soff = stab + 2 * pmax * TW;
  const int prop_words = 3 * (P0 + P1) + kDec;
  float* sx = soff + 2 * prop_words;
  float* sy = sx + A_pad;
  float* sz = sy + A_pad;
  // the active atoms' columns, listed in slist[i], i < n_l, and each
  // column's place in that list (-1: inactive)
  int* spos = reinterpret_cast<int*>(sz + A_pad);
  int* slist = spos + A_pad;
  int* smol = slist + A_pad;
  float* sactm = reinterpret_cast<float*>(smol + A_pad);  // (M)
  float* ssre = sactm + M;
  float* ssim = ssre + K;
  float* scfac = ssim + K;
  float* sdre = scfac + K;
  float* sdim = sdre + K;
  int* skidx = reinterpret_cast<int*>(sdim + K);  // (K) packed k indices
  // the two species' site table: A's P0 sites, then B's P1 (PS rows)
  const int PS = P0 + P1;
  float* seps = reinterpret_cast<float*>(skidx + K);  // (PS, T) 4 eps
  float* ssig2 = seps + PS * T;
  float* sbody = ssig2 + PS * T;   // (PS, 3)
  float* sqp = sbody + 3 * PS;
  int* slj = reinterpret_cast<int*>(sqp + PS);
  int* sqf = slj + PS;             // has_q and a Coulomb style
  float* scut = reinterpret_cast<float*>(sqf + PS);  // live cutoff^2
  unsigned* sscore = reinterpret_cast<unsigned*>(scut + PS);  // 2 x M
  float* sred = reinterpret_cast<float*>(sscore + 2 * M);  // 16 partials
  // thread 0's statistics ([15]: a k-vector out of range)
  float* sstat = sred + 16;
  int* snl = reinterpret_cast<int*>(sstat + 16);  // the list's length
  if constexpr (kGlob) {
    // the fixed part follows the proposal buffers; the outputs' rows hold
    // x/y/z and the slot activity, the chain's workspace row the list, its
    // inverse and the scores (flip_ws_floats), the global table the
    // molecule row; the k rows follow the fixed part or, with k_global,
    // the workspace row's scores
    seps = sx;
    ssig2 = seps + PS * T;
    sbody = ssig2 + PS * T;
    sqp = sbody + 3 * PS;
    slj = reinterpret_cast<int*>(sqp + PS);
    sqf = slj + PS;
    scut = reinterpret_cast<float*>(sqf + PS);
    sred = scut + PS;
    sstat = sred + 16;
    snl = reinterpret_cast<int*>(sstat + 16);
    int* const wrow = reinterpret_cast<int*>(ws) +
                      (size_t)blockIdx.x *
                          flip_ws_floats(M, A_pad, K,
                                         k_global ? kGlobalK : kGlobal);
    spos = wrow;
    slist = spos + A_pad;
    sscore = reinterpret_cast<unsigned*>(slist + A_pad);
    sx = coords_out + (size_t)blockIdx.x * 3 * A_pad;
    sy = sx + A_pad;
    sz = sy + A_pad;
    smol = const_cast<int*>(molid_row);
    sactm = actm_out + (size_t)blockIdx.x * M;
    ssre = k_global ? reinterpret_cast<float*>(sscore + 2 * M)
                    : reinterpret_cast<float*>(snl + 1);
    ssim = ssre + K;
    scfac = ssim + K;
    sdre = scfac + K;
    sdim = sdre + K;
    skidx = reinterpret_cast<int*>(sdim + K);
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
  float* const scom = com_out + (size_t)c * 3 * M;
  float* const squat = quat_out + (size_t)c * 4 * M;
  const float* cin = coords_in + (size_t)c * 3 * A_pad;
  for (int j = tid; j < A_pad; j += nt) {
    sx[j] = cin[j];
    sy[j] = cin[A_pad + j];
    sz[j] = cin[2 * A_pad + j];
    if (!kGlob) smol[j] = molid_row[j];
  }
  if (warp == 0) {
    // the active-atom list, in column order
    int n = 0;
    for (int base = 0; base < A_pad; base += 32) {
      const int j = base + lane;
      const bool on = j < A_pad && act_in[(size_t)c * A_pad + j] != 0.0f;
      const unsigned bal = __ballot_sync(kFull, on);
      if (j < A_pad) spos[j] = on ? n + __popc(bal & lanes_below) : -1;
      if (on) slist[n + __popc(bal & lanes_below)] = j;
      n += __popc(bal);
    }
    if (lane == 0) *snl = n;
  }
  for (int i = tid; i < M; i += nt) sactm[i] = actm_in[(size_t)c * M + i];
  for (int i = tid; i < 3 * M; i += nt) scom[i] = com_in[(size_t)c * 3 * M + i];
  for (int i = tid; i < 4 * M; i += nt) squat[i] = quat_in[(size_t)c * 4 * M + i];
  if (tid < 16) sstat[tid] = 0.0f;

  const float box = box_in[c];
  const float inv_box = 1.0f / box;
  const float kappa = kappa_l * inv_box;
  float sh_w = 0.0f;
  if (kQ == kQWolf) {
    const float qrc = sqrtf(qrc2);
    sh_w = erfcf(kappa * qrc) / qrc;
  }
  const float beta = 1.0f / temp_in[c];
  bool k_bad = false;
  for (int k = tid; k < K; k += nt) {
    const float kx = kvec[3 * k], ky = kvec[3 * k + 1], kz = kvec[3 * k + 2];
    const int nx = (int)rintf(kx), ny = (int)rintf(ky), nz = (int)rintf(kz);
    if (ewald && (abs(nx) > nk || abs(ny) > nk || abs(nz) > nk)) k_bad = true;
    skidx[k] = (nx + nk) | (ny + nk) << 8 | (nz + nk) << 16;
    ssre[k] = sfac_in[((size_t)c * K + k) * 2];
    ssim[k] = sfac_in[((size_t)c * K + k) * 2 + 1];
    if (ewald) {
      const float tpl = kTwoPi * inv_box;
      const float kt2 = tpl * tpl * (kx * kx + ky * ky + kz * kz);
      const float vol = box * box * box;
      scfac[k] = kw[k] * (kTwoPi / vol) * expf(-kt2 / (4.0f * kappa * kappa)) / kt2;
    }
  }
  for (int i = tid; i < PS * T; i += nt) {
    const bool first = i < P0 * T;
    seps[i] = 4.0f * (first ? eps0[i] : eps1[i - P0 * T]);
    ssig2[i] = first ? sig20[i] : sig21[i - P0 * T];
  }
  const bool split_cut = qrc2 != rc2;
  const float qcut2 = split_cut ? qrc2 : rc2;
  for (int i = tid; i < 3 * PS; i += nt)
    sbody[i] = i < 3 * P0 ? body0[i] : body1[i - 3 * P0];
  for (int i = tid; i < PS; i += nt) {
    const bool first = i < P0;
    const int p = first ? i : i - P0;
    const bool lj = (first ? has_lj0 : has_lj1)[p] != 0;
    const bool uq = kQ != kQNone && (first ? has_q0 : has_q1)[p] != 0;
    sqp[i] = (first ? qp0 : qp1)[p];
    slj[i] = lj;
    sqf[i] = uq;
    scut[i] = lj ? (uq ? fmaxf(rc2, qcut2) : rc2) : (uq ? qcut2 : -1.0f);
  }
  const float si_a = si2_in[2 * c], si_b = si2_in[2 * c + 1];
  const bool use_lrc = lrc3_in != nullptr;

  // live per-species counts, counted once and then tracked by every thread
  float cnt_a = 0.0f, cnt_b = 0.0f;
  for (int i = tid; i < M; i += nt) {
    const float on = sactm[i] > 0.5f ? 1.0f : 0.0f;
    if (i < cap_a) cnt_a += on; else cnt_b += on;
  }
  cnt_a = warp_sum(cnt_a);
  cnt_b = warp_sum(cnt_b);
  if (lane == 0) {
    sred[warp] = cnt_a;
    sred[8 + warp] = cnt_b;
  }
  __syncthreads();
  if (k_bad) sstat[15] = 1.0f;
  int n_l = *snl;  // every thread tracks the list's length
  float n_a = 0.0f, n_b = 0.0f;
  for (int w = 0; w < kWarps; ++w) {
    n_a += sred[w];
    n_b += sred[8 + w];
  }

  // ---- pair terms: distances on every lane, live terms through queues ----
  auto dist2 = [&](float xj, float yj, float zj, float ax, float ay,
                   float az) -> float {
    float dx = xj - ax, dy = yj - ay, dz = zj - az;
    dx -= box * round_near(dx * inv_box);
    dy -= box * round_near(dy * inv_box);
    dz -= box * round_near(dz * inv_box);
    return fmaxf(dx * dx + dy * dy + dz * dz, 1e-4f);
  };
  // One live term of site-table row p of the old (negated) or the new (the
  // +1e30 veto on an attractive overlap) identity: LJ plus real-space
  // Coulomb.
  auto live_term = [&](int key, float d2) -> float {
    const int j = key & (kMaxColumns - 1);
    const int p = (key >> kKeySite) & 31;
    const bool is_new = (key >> kKeySign) & 1;
    const int tj = __ldg(tid_row + j);
    const bool m_lj = d2 < rc2;
    const bool m_qq = split_cut ? d2 < qrc2 : m_lj;
    const float inv_r = rsqrtf(d2);
    const float inv_d2 = inv_r * inv_r;
    float contrib = 0.0f;
    if (slj[p] && m_lj) {
      const float s2 = ssig2[p * T + tj] * inv_d2;
      const float s6 = s2 * s2 * s2;
      contrib = seps[p * T + tj] * (s6 * s6 - s6);
    }
    if (kQ != kQNone && sqf[p] && m_qq) {
      const float qq = (factor * sqp[p]) * __ldg(q_row + j);
      float cp;
      if (kQ == kQBare) {
        cp = qq * inv_r;
      } else {
        const float r = d2 * inv_r;
        if (kQ == kQWolf)
          cp = qq * (erfcf(kappa * r) * inv_r - sh_w);
        else
          cp = qq * (erfcf(kappa * r) * inv_r);
      }
      if (is_new && d2 < d2_overlap && qq < 0.0f) cp = 1e30f;
      contrib += cp;
    }
    return is_new ? contrib : -contrib;
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

  // ---- eik tables: the P sites of a pose (site-table rows g0 + p) into
  // tab (P x TW words), sign * q folded into the x row, from coordinates
  // pos(p, axis); one row (p, axis) per thread of first, first + stride,
  // ... ----
  auto build_tables = [&](float* tab, int g0, int P, auto pos, float sgn,
                          int first, int stride) {
    for (int r = first; r < 3 * P; r += stride) {
      const int p = r / 3, axis = r - 3 * p;
      if (!sqf[g0 + p]) continue;
      eik_row(reinterpret_cast<float2*>(tab + p * TW) + axis * W, nk,
              pos(p, axis), inv_box, axis == 0 ? sgn * sqp[g0 + p] : 1.0f);
    }
  };
  // dS at the k-vectors k0 and k0 + nt (the second when below K), added
  // into dre/dim: the sum over the charged sites of a pose's tables of x y
  // z, two independent chains of loads and products per site
  auto k_sum2 = [&](const float* tab, int g0, int P, int k0, float* dre,
                    float* dim) {
    const bool two = k0 + nt < K;
    const int idx0 = skidx[k0], idx1 = two ? skidx[k0 + nt] : idx0;
    for (int p = 0; p < P; ++p) {
      if (!sqf[g0 + p]) continue;
      eik_add2(reinterpret_cast<const float2*>(tab + p * TW), W, idx0, idx1,
               dre, dim);
    }
  };

  // ---- proposals: every thread the Philox scores (score + 1) of attempt
  // x, one slot each, into row x & 1; the proposal warp its Shoemake
  // orientation, both species' rotated templates and its accept uniform
  // into buffer x & 1 ----
  const float* ux_chain = ux_in + (size_t)c * n_flip * kFlipUniforms;
  auto scores = [&](int x) {
    unsigned* row = sscore + (x & 1) * M;
    for (int i = tid; i < M; i += nt)
      row[i] = (philox_word((uint32_t)i, (uint32_t)x, seed, chain0 + (uint32_t)c) >> 8) + 1u;
  };
  // lane i < 8 loads uniform i of attempt x (a pass ahead of its use)
  auto prefetch = [&](int x) -> float {
    return lane < kFlipUniforms ? ux_chain[(size_t)x * kFlipUniforms + lane] : 0.0f;
  };
  auto propose = [&](int x, float v) {
    float* off = soff + (x & 1) * prop_words;
    float* dec = off + 3 * (P0 + P1);
    const float u1 = __shfl_sync(kFull, v, 4);
    const float u5 = __shfl_sync(kFull, v, 5);
    const float u6 = __shfl_sync(kFull, v, 6);
    float s2, c2, s3, c3;
    sincos_turns(u5, &s2, &c2);
    sincos_turns(u6, &s3, &c3);
    const float r1 = sqrtf(fmaxf(1.0f - u1, 0.0f)), r2 = sqrtf(u1);
    const float q[4] = {r1 * s2, r1 * c2, r2 * s3, r2 * c3};
    for (int i = lane; i < PS; i += 32) {
      float o[3] = {0.0f, 0.0f, 0.0f};
      if ((i < P0 ? P0 : P1) > 1)
        rot_apply(q[0], q[1], q[2], q[3], sbody[3 * i], sbody[3 * i + 1],
                  sbody[3 * i + 2], o);
      for (int d = 0; d < 3; ++d) off[3 * i + d] = o[d];
    }
    if (lane < 4) dec[lane] = q[lane];
    if (lane == 7) dec[4] = v;
  };

  if (n_flip > 0) {
    scores(0);
    if (warp == kProposer) propose(0, prefetch(0));
  }
  __syncthreads();

  for (int fi = 0; fi < n_flip; ++fi) {
    const int b = fi & 1;
    const bool more = fi + 1 < n_flip;
    const float* off_b = soff + b * prop_words;
    const float* dec = off_b + 3 * (P0 + P1);
    // the pick, in every warp alike: key (score, ~slot) over the active
    // slots
    const unsigned* row = sscore + b * M;
    unsigned long long best = 0ull;
    for (int i = lane; i < M; i += 32)
      if (sactm[i] > 0.5f) {
        const unsigned long long key =
            ((unsigned long long)row[i] << 32) | (0xFFFFFFFFu - (uint32_t)i);
        best = key > best ? key : best;
      }
    best = warp_max_u64(best);
    const int slot = (int)(0xFFFFFFFFu - (uint32_t)(best & 0xFFFFFFFFull));
    const bool is_a = best == 0ull || slot < cap_a;
    // the target: the other block's first free slot (M: none)
    int tgt = M;
    if (best != 0ull) {
      const int t0 = is_a ? cap_a : 0, t1 = is_a ? M : cap_a;
      for (int base = t0; base < t1; base += 32) {
        const int i = base + lane;
        const unsigned bal = __ballot_sync(kFull, i < t1 && !(sactm[i] > 0.5f));
        if (bal) {
          tgt = base + __ffs(bal) - 1;
          break;
        }
      }
    }
    if (tid == 0) sstat[is_a ? 3 : 4] += 1.0f;
    if (tgt == M) {
      // no active slot (the TPU kernel's degenerate pick is slot 0, an
      // A -> B attempt that can never be accepted) or no free target:
      // refused, nothing written (block-uniform)
      __syncthreads();  // the last readers of buffer b ^ 1 are done
      if (more) {
        scores(fi + 1);
        if (warp == kProposer) propose(fi + 1, prefetch(fi + 1));
      }
      __syncthreads();
      continue;
    }
    // the old and the new identity: site-table rows from g_o / g_n
    const int g_o = is_a ? 0 : P0, g_n = is_a ? P0 : 0;
    const int P_o = is_a ? P0 : P1, P_n = is_a ? P1 : P0;
    const int col_old = is_a ? slot * P0 : a0_b + (slot - cap_a) * P1;
    const int col_new = is_a ? a0_b + (tgt - cap_a) * P1 : tgt * P0;
    const float* off_n = off_b + 3 * g_n;  // the new rotated template

    // the block: both poses' site rows and eik tables
    if (tid < P_o) {
      sold[4 * tid] = sx[col_old + tid];
      sold[4 * tid + 1] = sy[col_old + tid];
      sold[4 * tid + 2] = sz[col_old + tid];
      sold[4 * tid + 3] = scut[g_o + tid];
    } else if (tid >= 32 && tid < 32 + P_n) {
      const int p = tid - 32;
      for (int d = 0; d < 3; ++d) snew[4 * p + d] = scom[3 * slot + d] + off_n[3 * p + d];
      snew[4 * p + 3] = scut[g_n + p];
    }
    if (ewald) {
      build_tables(stab, g_o, P_o,
                   [&](int p, int axis) {
                     return (axis == 0 ? sx : axis == 1 ? sy : sz)[col_old + p];
                   },
                   -1.0f, tid, nt);
      build_tables(stab + pmax * TW, g_n, P_n,
                   [&](int p, int axis) {
                     return scom[3 * slot + axis] + off_n[3 * p + axis];
                   },
                   1.0f, (tid + 128) & (nt - 1), nt);
    }
    __syncthreads();
    // the proposal warp starts the next attempt's loads
    float ux_pre = 0.0f;
    if (warp == kProposer && more) ux_pre = prefetch(fi + 1);

    // both identities' site sums over the atom lanes
    float part = 0.0f;
    {
      Queue q{qkey + warp * kQueue, qd2 + warp * kQueue, 0, 0};
      // the active atoms, an equal share of the list per warp
      const int per = (n_l + kWarps - 1) / kWarps;
      const int hi = min((warp + 1) * per, n_l);
      for (int ib = warp * per; ib < hi; ib += 32) {
        const int i = ib + lane;
        bool on = i < hi;
        int j = 0;
        float xj = 0.0f, yj = 0.0f, zj = 0.0f;
        if (on) {
          j = slist[i];
          on = smol[j] != slot;
          xj = sx[j];
          yj = sy[j];
          zj = sz[j];
        }
        for (int s = 0; s < 2; ++s) {
          const float4* a = reinterpret_cast<const float4*>(s ? snew : sold);
          const int P = s ? P_n : P_o;
          const int key = j | (s ? g_n : g_o) << kKeySite | s << kKeySign;
          for (int p0 = 0; p0 < P; p0 += kChunk) {
            bool live[kChunk];
            float d2[kChunk];
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
              live[k] = false;
              d2[k] = 0.0f;
              if (on && p0 + k < P) {
                const float4 site = a[p0 + k];
                d2[k] = dist2(xj, yj, zj, site.x, site.y, site.z);
                live[k] = d2[k] < site.w;
              }
            }
            push(q, part, P - p0, live, d2, key + (p0 << kKeySite));
          }
        }
      }
      drain(q, part);
    }
    if (more) scores(fi + 1);
    if (ewald) {
      for (int k0 = tid; k0 < K; k0 += 2 * nt) {
        float dre[2] = {0.0f, 0.0f}, dim[2] = {0.0f, 0.0f};
        k_sum2(stab, g_o, P_o, k0, dre, dim);
        k_sum2(stab + pmax * TW, g_n, P_n, k0, dre, dim);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = k0 + j * nt;
          if (k >= K) break;
          sdre[k] = dre[j];
          sdim[k] = dim[j];
          const float cross = 2.0f * (ssre[k] * dre[j] + ssim[k] * dim[j]) +
                              dre[j] * dre[j] + dim[j] * dim[j];
          part += factor * (scfac[k] * cross);
        }
      }
    }
    part = warp_sum(part);
    if (warp == kProposer && more) propose(fi + 1, ux_pre);
    if (lane == 0) sred[warp] = part;
    __syncthreads();

    // every thread: the same sum in the same order, the same decision
    float du = 0.0f;
    for (int w = 0; w < kWarps; ++w) du += sred[w];
    du += is_a ? si_b - si_a : si_a - si_b;
    if (use_lrc) {
      // the tail's flip delta, affine in the live counts
      const float g00 = lrc3_in[3 * c], g01 = lrc3_in[3 * c + 1],
                  g11 = lrc3_in[3 * c + 2];
      const float d_ab = -(2.0f * n_a - 1.0f) * g00 + (2.0f * n_b + 1.0f) * g11 +
                         2.0f * (n_a - n_b - 1.0f) * g01;
      const float d_ba = (2.0f * n_a + 1.0f) * g00 - (2.0f * n_b - 1.0f) * g11 +
                         2.0f * (n_b - n_a - 1.0f) * g01;
      du += is_a ? d_ab : d_ba;
    }
    const float ln_acc = (is_a ? ln_xi : -ln_xi) - beta * du;
    const float ln_u = logf(fmaxf(dec[4], 1e-30f));
    if (!(ln_u < ln_acc)) continue;
    if (tid == 0) {
      sstat[0] += du;
      sstat[is_a ? 1 : 2] += 1.0f;
      sstat[5] += (float)(slot + 1);
      sactm[slot] = 0.0f;
      sactm[tgt] = 1.0f;
      // the old identity's atoms leave the list (each swapped with the last
      // entry), the new one's join it
      int n = n_l;
      for (int p = 0; p < P_o; ++p) {
        const int i = spos[col_old + p];
        const int last = slist[n - 1];
        slist[i] = last;
        spos[last] = i;
        spos[col_old + p] = -1;
        --n;
      }
      for (int p = 0; p < P_n; ++p) {
        slist[n] = col_new + p;
        spos[col_new + p] = n++;
      }
    }
    if (tid >= 32 && tid < 32 + P_n) {
      const int p = tid - 32;
      sx[col_new + p] = snew[4 * p];
      sy[col_new + p] = snew[4 * p + 1];
      sz[col_new + p] = snew[4 * p + 2];
    } else if (tid >= 64 && tid < 64 + 3) {
      scom[3 * tgt + tid - 64] = scom[3 * slot + tid - 64];
    } else if (tid >= 67 && tid < 67 + 4) {
      squat[4 * tgt + tid - 67] = dec[tid - 67];
    }
    n_a += is_a ? -1.0f : 1.0f;
    n_b += is_a ? 1.0f : -1.0f;
    n_l += P_n - P_o;
    if (ewald)
      // each thread adds the deltas of the k-vectors it computed
      for (int k = tid; k < K; k += nt) {
        ssre[k] += sdre[k];
        ssim[k] += sdim[k];
      }
    __syncthreads();
  }
  __syncthreads();

  float* cout = coords_out + (size_t)c * 3 * A_pad;
  for (int j = tid; j < A_pad; j += nt) {
    if (!kGlob) {
      cout[j] = sx[j];
      cout[A_pad + j] = sy[j];
      cout[2 * A_pad + j] = sz[j];
    }
    act_out[(size_t)c * A_pad + j] = spos[j] >= 0 ? 1.0f : 0.0f;
  }
  if (!kGlob)
    for (int i = tid; i < M; i += nt) actm_out[(size_t)c * M + i] = sactm[i];
  for (int k = tid; k < K; k += nt) {
    sfac_out[((size_t)c * K + k) * 2] = ssre[k];
    sfac_out[((size_t)c * K + k) * 2 + 1] = ssim[k];
  }
  if (tid == 0) {
    float* st = stats_out + (size_t)c * kStats;
    for (int i = 0; i < 6; ++i) st[i] = sstat[i];
    st[6] = 0.0f;
    st[7] = 0.0f;
    if (sstat[15] != 0.0f) st[0] = nanf("");  // a k-vector beyond nk
  }
}

using FlipKernel = decltype(&flip_kernel<kQNone, false>);

template <bool kGlob>
FlipKernel pick_form(int coulomb) {
  switch (coulomb) {
    case kNone: return flip_kernel<kQNone, kGlob>;
    case kWolf: return flip_kernel<kQWolf, kGlob>;
    case kBare: return flip_kernel<kQBare, kGlob>;
    default: return flip_kernel<kQErfc, kGlob>;
  }
}

// The instantiation of a Coulomb style and layout (kGlobal and kGlobalK
// share theirs).
FlipKernel pick_kernel(int coulomb, int layout) {
  return layout == kShared ? pick_form<false>(coulomb)
                           : pick_form<true>(coulomb);
}

// Lets the instantiation take `smem` bytes of dynamic shared memory.
cudaError_t allow_smem(FlipKernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" size_t mmc_flip_smem_bytes(int M, int P0, int P1, int A_pad, int K,
                                      int T, int nk, int layout) {
  return sizeof(float) * flip_smem_floats(M, P0, P1, A_pad, K, T, nk, layout);
}

extern "C" size_t mmc_flip_ws_floats(int M, int A_pad, int K, int layout) {
  return flip_ws_floats(M, A_pad, K, layout);
}

// The instantiation's registers per thread, local memory per thread (stack
// frame and spills, bytes) and the blocks of this shape one SM holds at
// once (the CUDA occupancy calculator) into out[0..2]; returns the CUDA
// error code (0 on success).
extern "C" int mmc_flip_occupancy(int coulomb, int M, int P0, int P1,
                                  int A_pad, int K, int T, int nk, int layout,
                                  int* out) {
  const FlipKernel kernel = pick_kernel(coulomb, layout);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = 0;
  const size_t smem = mmc_flip_smem_bytes(M, P0, P1, A_pad, K, T, nk, layout);
  if (smem > (size_t)kMaxSmemBytes) return 0;
  e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      kThreads, smem);
  return static_cast<int>(e);
}

extern "C" const char* mmc_flip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches n_flip flip attempts of every chain (grid = C chains of 256
// threads) on `stream`; returns the CUDA error code of the launch (0 on
// success).  All pointers are device pointers to contiguous f32 (int32 for
// the flag and row tables) tensors: coords (C, 3, A_pad), com (C, M, 3),
// quat (C, M, 4), sfac (C, K, 2), act (C, A_pad), actm (C, M), box/temp
// (C), si2 (C, 2), lrc3 (C, 3) or null (no LJ tail), ux (C, n_flip, 8); per
// species s: body (P_s, 3), qp (P_s), eps/sig2 (P_s, T), has_lj/has_q
// (P_s); tid/molid/q rows (A_pad), kvec (K, 3) whose integer components
// are at most nk in magnitude (else the energy statistic is NaN), kw (K).
// layout selects where the chain state lives (Layout); the global layouts
// need the workspace ws, C rows of mmc_flip_ws_floats(M, A_pad, K, layout)
// f32.
extern "C" int mmc_flip_launch(
    const void* coords, const void* com, const void* quat, const void* sfac,
    const void* act, const void* actm, const void* box, const void* temp,
    const void* si2, const void* lrc3, const void* ux, const void* body0,
    const void* qp0, const void* eps0, const void* sig20, const void* has_lj0,
    const void* has_q0, const void* body1, const void* qp1, const void* eps1,
    const void* sig21, const void* has_lj1, const void* has_q1,
    const void* tid_row, const void* molid_row, const void* q_row,
    const void* kvec, const void* kw, void* coords_out, void* com_out,
    void* quat_out, void* sfac_out, void* act_out, void* actm_out,
    void* stats_out, void* ws, int C, int cap_a, int cap_b, int P0, int P1,
    int a0_b, int A_pad, int K, int T, int nk, int coulomb, int n_flip,
    int layout, unsigned int seed, unsigned int chain0, int threads,
    float rc2, float qrc2, float kappa_l, float d2_overlap, float ln_xi,
    float factor, void* stream) {
  const size_t smem =
      mmc_flip_smem_bytes(cap_a + cap_b, P0, P1, A_pad, K, T, nk, layout);
  if (layout < kShared || layout > kGlobalK || (layout != kShared && !ws) ||
      smem > (size_t)kMaxSmemBytes || threads != kThreads || C < 1 ||
      cap_a < 1 || cap_b < 1 || P0 < 1 || P1 < 1 || P0 > 16 || P1 > 16 ||
      nk < 0 || nk > 127 || A_pad > kMaxColumns ||
      a0_b < cap_a * P0 || a0_b + cap_b * P1 > A_pad || n_flip < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlipKernel kernel = pick_kernel(coulomb, layout);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const float*>(com),
      static_cast<const float*>(quat), static_cast<const float*>(sfac),
      static_cast<const float*>(act), static_cast<const float*>(actm),
      static_cast<const float*>(box), static_cast<const float*>(temp),
      static_cast<const float*>(si2), static_cast<const float*>(lrc3),
      static_cast<const float*>(ux), static_cast<const float*>(body0),
      static_cast<const float*>(qp0), static_cast<const float*>(eps0),
      static_cast<const float*>(sig20), static_cast<const int*>(has_lj0),
      static_cast<const int*>(has_q0), static_cast<const float*>(body1),
      static_cast<const float*>(qp1), static_cast<const float*>(eps1),
      static_cast<const float*>(sig21), static_cast<const int*>(has_lj1),
      static_cast<const int*>(has_q1), static_cast<const int*>(tid_row),
      static_cast<const int*>(molid_row), static_cast<const float*>(q_row),
      static_cast<const float*>(kvec), static_cast<const float*>(kw),
      static_cast<float*>(coords_out), static_cast<float*>(com_out),
      static_cast<float*>(quat_out), static_cast<float*>(sfac_out),
      static_cast<float*>(act_out), static_cast<float*>(actm_out),
      static_cast<float*>(stats_out), static_cast<float*>(ws), cap_a, cap_b,
      P0, P1, a0_b, A_pad, K, T, nk, coulomb == kEwald, n_flip,
      layout == kGlobalK ? 1 : 0, seed, chain0, rc2, qrc2, kappa_l,
      d2_overlap, ln_xi, factor);
  return static_cast<int>(cudaGetLastError());
}
