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
// What bounds it on this card: latency, not bytes.  The moves of a chain
// form a dependent chain of 750 steps (at the 750-water flagship), each a
// few microseconds of arithmetic over ~2300 atoms followed by a block-wide
// reduction and a scalar decision; device memory is touched only to load
// and store the chain state (~55 KB) and to read 40 B of uniforms per move.
// The design: the whole chain state (x/y/z, all M_total COM and quaternion
// rows, S(k), the per-atom type/charge/molecule rows and the k-vectors)
// lives in shared memory for the whole sweep (the global layout below
// keeps the atom, COM and quaternion rows in global memory) -- every
// block's launch loads and stores all of it, so launches chain without a
// merge step; the atom loop is strided over the block so
// neighbouring threads read neighbouring words; one warp-shuffle reduction
// plus one pass over the warp partials per move; the next move's uniforms
// are prefetched during the current move; chains run in parallel across
// blocks (2048 chains are ~8 waves at 2 blocks per SM).  Further latency
// work (fewer barriers per move, warp-specialised proposals, several
// chains per block) is left for later.
//
// Semantics kept from the TPU kernel: the molecule-id mask and the COM,
// quaternion and uniform rows use the global index m_start + m, the atom
// columns a_start + m * P; old atoms are read from the stored
// coordinates, never rebuilt from COM + quaternion; new atoms are the
// floor-wrapped new COM plus R(q_new) body (not wrapped per atom); pair
// distances use the rintf minimum image with d^2 floored at 1e-4; pads
// (molid < 0) and the molecule's own atoms are excluded; S(k) changes only
// on accept; the energy statistic adds d_e by select, so a rejected move's
// overflowed delta never enters.
//
// Activity (use_act): act (C, A_pad) is 1 on the atoms of active molecule
// slots and 0 on inactive slots and pads, actm (C, M_total) the same per
// molecule.  An inactive slot's move is a null move (the block skips it: one
// chain per block makes the gate block-uniform) and is not counted as an
// attempt; inactive neighbour lanes add exactly 0.
//
// Exchanges (n_exch > 0, needs use_act): after the moves, n_exch attempts on
// uniforms ux (C, n_exch + n_widom, 8) = [type, x, y, z, u1, th2, th3,
// accept].  type < 0.5 inserts into the first free slot of this block at a
// uniform position with a Shoemake quaternion, else deletes the active slot
// of this block with the largest score (ties to the lower index); the
// scores are Philox4x32-10 words keyed by (seed, chain) with counter (slot,
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
// stride, skip test, term order, signs and roundings), so eta = 0 takes
// the same decisions bit for bit.
//
// Widom (n_widom > 0, needs use_act): after moves and exchanges, n_widom
// ghost insertions with the same pose and energy code and no writes; wid
// (C, 2) receives sum w and sum w^2, w = exp(-du_ins / T).
//
// Global layout (kGlobal, fixed N only; its own instantiation): for chain
// states that do not fit a block's shared memory (6859 SPC/E waters with
// K = 2874 would need ~780 KB) the chain's x/y/z planes and its COM and
// quaternion rows live in global memory -- the chain's own rows of the
// output tensors, copied in at entry and updated in place by accepted
// moves -- and the type/charge/molecule rows are read from their global
// tables (shared by all chains, so L2 keeps them).  Shared memory keeps
// the k-vector rows, S(k), the LJ tables, the site rows and the scratch.
// One chain per block: thread 0's writes of an accepted move are ordered
// before every other thread's reads by the __syncthreads that follows.
// The arithmetic, lane stride, skip tests and reduction order are the
// shared layout's; only where the atom, COM and quaternion words live
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

namespace {

enum Coulomb { kNone = 0, kEwald = 1, kWolf = 2, kWolfRef = 3, kBare = 4 };

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr int kStats = 9;
constexpr int kUniforms = 10;
constexpr int kExchUniforms = 8;
constexpr int kMaxSmemBytes = 232448;
constexpr float kPDep = 0.5f;  // the exchange type's probability, folded in

// Shared-memory words of one block (M = M_total, the COM/quaternion rows
// held); ops/cuda/sweep_kernel.py smem_bytes computes the same number.
// tmmc adds a second slot-pick row (64 words), the deletion pose (3 P), its
// S(k) row (2 K) and its warp partials (32); the global layout holds no
// atom and no COM/quaternion rows.
__host__ __device__ inline size_t sweep_smem_floats(int M, int P, int A_pad,
                                                    int K, int T, int use_act,
                                                    int tmmc, int global) {
  if (global) return 8 * (size_t)K + 4 * (size_t)P * T + 12 * (size_t)P + 144;
  return 6 * (size_t)A_pad + 7 * (size_t)M + 8 * (size_t)K +
         4 * (size_t)P * T + 12 * (size_t)P + 144 +
         (use_act ? (size_t)A_pad + (size_t)M : 0) +
         (tmmc ? 2 * (size_t)K + 3 * (size_t)P + 96 : 0);
}

__device__ inline float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ inline unsigned long long warp_max_u64(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// First output word of Philox4x32-10 (Salmon et al., SC 2011) for counter
// (c0, c1, 0, 0) and key (k0, k1).
__device__ inline uint32_t philox_word(uint32_t c0, uint32_t c1, uint32_t k0,
                                       uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// R(q) b, the same expansion as the TPU kernel's rot_apply.
__device__ inline void rot_apply(float w, float x, float y, float z, float bx,
                                 float by, float bz, float* o) {
  const float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  o[0] = (ww + xx - yy - zz) * bx + 2.0f * ((xy - wz) * by + (xz + wy) * bz);
  o[1] = (ww - xx + yy - zz) * by + 2.0f * ((xy + wz) * bx + (yz - wx) * bz);
  o[2] = (ww - xx - yy + zz) * bz + 2.0f * ((xz - wy) * bx + (yz + wx) * by);
}

// kAct: the activity-mask instantiation (use_act), which alone carries the
// exchange attempts and the ghosts; the other keeps the fixed-N sweep's
// inner loop and register count free of them.  kTmmc (with kAct): the
// transition-matrix instantiation, whose attempts evaluate both branches
// and deposit cmat/uhist; the fixed-N and muVT instantiations carry none
// of it.  kGlobal (fixed N): the global-memory layout, which alone carries
// the slab windows.
template <bool kAct, bool kTmmc, bool kGlobal>
__global__ void sweep_kernel(
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
    float* __restrict__ cmat_out, float* __restrict__ uhist_out, int M,
    int M_total, int m_start, int a_start, int P, int A_pad, int K, int T,
    int coulomb, int lj_linear, int use_rot, int n_exch, int n_widom,
    int n_seg, int a0_w, int A_blk, int W, unsigned int seed, float rc2,
    float qrc2, float kappa_l, float d2_overlap, float p_translate,
    float factor) {
  extern __shared__ float smem[];
  // 32 x 8-byte slots of the slot-pick reduction first: 8-byte aligned;
  // tmmc's deletion pick has a second row
  unsigned long long* sred64 = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* sred64d = sred64 + 32;
  // the shared layout's atom, COM and quaternion rows; the global layout
  // points these at global memory below and starts S(k) at their place
  float* sx = smem + (kTmmc ? 128 : 64);
  float* sy = sx + A_pad;
  float* sz = sy + A_pad;
  float* sq = sz + A_pad;
  int* stid = reinterpret_cast<int*>(sq + A_pad);
  int* smol = stid + A_pad;
  float* scom = reinterpret_cast<float*>(smol + A_pad);  // (M_total, 3)
  float* squat = scom + 3 * M_total;                     // (M_total, 4)
  float* ssre = kGlobal ? sx : squat + 4 * M_total;
  float* ssim = ssre + K;
  float* scfac = ssim + K;
  float* sdre = scfac + K;
  float* sdim = sdre + K;
  float* skx = sdim + K;
  float* sky = skx + K;
  float* skz = sky + K;
  float* seps = skz + K;          // (P, T)
  float* ssig2 = seps + P * T;
  float* slam1 = ssig2 + P * T;
  float* slam2 = slam1 + P * T;
  float* sbody = slam2 + P * T;   // (P, 3)
  float* sqp = sbody + 3 * P;
  int* slj = reinterpret_cast<int*>(sqp + P);
  int* sqf = slj + P;
  float* sold = reinterpret_cast<float*>(sqf + P);  // (P, 3)
  float* snew = sold + 3 * P;                        // (P, 3)
  float* su = snew + 3 * P;     // 2 x 16: double-buffered uniforms
  float* sred = su + 32;        // one partial sum per warp
  float* sdec = sred + 32;      // 16 words: proposal scalars + decision
  float* sact = sdec + 16;      // (A_pad) atom activity, with use_act
  float* sactm = sact + A_pad;  // (M_total) slot activity, with use_act
  float* sdel = sactm + M_total;  // (P, 3) tmmc: the deletion pose
  float* sdre2 = sdel + 3 * P;    // (K) tmmc: its structure-factor row
  float* sdim2 = sdre2 + K;
  float* sred2 = sdim2 + K;       // tmmc: its warp partials

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  const float* cin = coords_in + (size_t)c * 3 * A_pad;
  if constexpr (kGlobal) {
    // the chain's own rows of the outputs, updated in place; the per-atom
    // rows are read (never written) from their global tables
    sx = coords_out + (size_t)c * 3 * A_pad;
    sy = sx + A_pad;
    sz = sy + A_pad;
    scom = com_out + (size_t)c * 3 * M_total;
    squat = quat_out + (size_t)c * 4 * M_total;
    sq = const_cast<float*>(q_row);
    stid = const_cast<int*>(tid_row);
    smol = const_cast<int*>(molid_row);
    for (int j = tid; j < 3 * A_pad; j += nt) sx[j] = cin[j];
  } else {
    for (int j = tid; j < A_pad; j += nt) {
      sx[j] = cin[j];
      sy[j] = cin[A_pad + j];
      sz[j] = cin[2 * A_pad + j];
      sq[j] = q_row[j];
      stid[j] = tid_row[j];
      smol[j] = molid_row[j];
      if (kAct) sact[j] = act_in[(size_t)c * A_pad + j];
    }
  }
  if (kAct)
    for (int i = tid; i < M_total; i += nt)
      sactm[i] = actm_in[(size_t)c * M_total + i];
  for (int i = tid; i < 3 * M_total; i += nt)
    scom[i] = com_in[(size_t)c * 3 * M_total + i];
  for (int i = tid; i < 4 * M_total; i += nt)
    squat[i] = quat_in[(size_t)c * 4 * M_total + i];
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
    skx[k] = kx;
    sky[k] = ky;
    skz[k] = kz;
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
  for (int i = tid; i < 3 * P; i += nt) sbody[i] = body[i];
  for (int i = tid; i < P; i += nt) {
    sqp[i] = qp[i];
    slj[i] = has_lj[i];
    sqf[i] = has_q[i] && coulomb != kNone;
  }
  float sh_w = 0.0f;
  if (coulomb == kWolf) {
    const float qrc = sqrtf(qrc2);
    sh_w = erfcf(kappa * qrc) / qrc;
  }
  const bool split_cut = qrc2 != rc2;
  const float* u_chain = u_in + ((size_t)c * M_total + m_start) * kUniforms;
  if (tid < kUniforms) su[tid] = u_chain[tid];
  __syncthreads();

  // stats: energy delta, acc/att [trans, rot], and a decision fingerprint
  // (the sum of the global index + 1 over accepted moves) that tells a chain whose accept
  // sequence diverged from one that only matches in its counts
  // (accepted exchanges add slot + 1, deletions M_total more)
  float st_e = 0.0f, st_acc_t = 0.0f, st_acc_r = 0.0f, st_att_t = 0.0f,
        st_att_r = 0.0f, st_fp = 0.0f, st_acc_i = 0.0f, st_acc_d = 0.0f,
        st_att_i = 0.0f;

  for (int m = 0; m < M; ++m) {
    const int mg = m_start + m;  // global molecule index
    const float* um = su + (m & 1) * 16;
    // prefetch the next move's uniforms into the other buffer (its last
    // reader, thread 0 at move m-1, finished before the barrier that
    // closed move m-1)
    if (tid >= 32 && tid < 32 + kUniforms && m + 1 < M)
      su[((m + 1) & 1) * 16 + tid - 32] = u_chain[(size_t)(m + 1) * kUniforms + tid - 32];
    if (kAct && sact[a_start + m * P] == 0.0f) {
      // inactive slot: a null move, not an attempt (the barrier orders the
      // prefetch above before the next move's reads)
      __syncthreads();
      continue;
    }

    if (tid == 0) {
      const float* cm = scom + 3 * mg;
      const float* q0 = squat + 4 * mg;
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
      const int a0 = a_start + m * P;
      for (int p = 0; p < P; ++p) {
        sold[3 * p] = sx[a0 + p];
        sold[3 * p + 1] = sy[a0 + p];
        sold[3 * p + 2] = sz[a0 + p];
        float o[3] = {0.0f, 0.0f, 0.0f};
        if (P > 1)
          rot_apply(q1[0], q1[1], q1[2], q1[3], sbody[3 * p], sbody[3 * p + 1],
                    sbody[3 * p + 2], o);
        for (int d = 0; d < 3; ++d) snew[3 * p + d] = nc[d] + o[d];
      }
      for (int d = 0; d < 3; ++d) sdec[d] = nc[d];
      for (int i = 0; i < 4; ++i) sdec[3 + i] = q1[i];
      sdec[7] = tsel;
    }
    __syncthreads();

    // ---- old and new site sums over the atom lanes ----
    float part = 0.0f;
    // one atom lane j: its old and new pair terms into part
    auto lane_terms = [&](int j) {
      const float xj = sx[j], yj = sy[j], zj = sz[j], qj = sq[j];
      const int tj = stid[j];
      for (int p = 0; p < P; ++p) {
        const bool lj = slj[p] != 0;
        const bool uq = sqf[p] != 0;
        const float eps4 = lj ? seps[p * T + tj] : 0.0f;
        const float sig2 = lj ? ssig2[p * T + tj] : 0.0f;
        const float l1 = lj ? slam1[p * T + tj] : 0.0f;
        const float l2 = lj ? slam2[p * T + tj] : 0.0f;
        const float qq = (factor * sqp[p]) * qj;
        for (int s = 0; s < 2; ++s) {
          const float* a = (s ? snew : sold) + 3 * p;
          float dx = xj - a[0], dy = yj - a[1], dz = zj - a[2];
          dx -= box * rintf(dx * inv_box);
          dy -= box * rintf(dy * inv_box);
          dz -= box * rintf(dz * inv_box);
          const float d2 = fmaxf(dx * dx + dy * dy + dz * dz, 1e-4f);
          const bool m_lj = d2 < rc2;
          const bool m_qq = split_cut ? d2 < qrc2 : m_lj;
          const float inv_r = rsqrtf(d2);
          const float inv_d2 = inv_r * inv_r;
          float contrib = 0.0f;
          if (lj && m_lj) {
            const float s2 = sig2 * inv_d2;
            const float s6 = s2 * s2 * s2;
            float pot = eps4 * (s6 * s6 - s6);
            if (lj_linear) pot += l1 + l2 * sqrtf(d2);
            contrib = pot;
          }
          if (uq && m_qq) {
            const float r = d2 * inv_r;
            float cp;
            if (coulomb == kBare)
              cp = qq * inv_r;
            else if (coulomb == kWolf)
              cp = qq * (erfcf(kappa * r) * inv_r - sh_w);
            else
              cp = qq * (erfcf(kappa * r) * inv_r);
            if (s == 1 && d2 < d2_overlap && qq < 0.0f) cp = 1e30f;
            contrib += cp;
          }
          part += s ? contrib : -contrib;
        }
      }
    };
    bool dense = true;
    if constexpr (kGlobal) {
      if (W > 0) {
        // sorted slabs: the other blocks' column segments, then the window
        dense = false;
        const int a0 = a_start + m * P;
        for (int sg = 0; sg < n_seg; ++sg) {
          const int b0 = segs[2 * sg], b1 = b0 + segs[2 * sg + 1];
          for (int j = b0 + tid; j < b1; j += nt)
            if (j < a0 || j >= a0 + P) lane_terms(j);
        }
        const int wb = wst[mg];
        const bool in_w = a0 >= a0_w;  // the mover is in the sorted block
        for (int j = wb + tid; j < wb + W; j += nt) {
          if (j < a0_w) continue;  // the window's alignment overhang
          if (in_w && ((j >= a0 && j < a0 + P) ||
                       (j >= a0 + A_blk && j < a0 + A_blk + P)))
            continue;
          lane_terms(j);
        }
      }
    }
    if (dense)
      for (int j = tid; j < A_pad; j += nt) {
        const int mj = smol[j];
        if (mj < 0 || mj == mg) continue;
        if (kAct && sact[j] == 0.0f) continue;
        lane_terms(j);
      }

    // ---- incremental S(k) and the reciprocal energy delta ----
    if (ewald) {
      const float tpl = kTwoPi * inv_box;
      for (int k = tid; k < K; k += nt) {
        const float kx = skx[k], ky = sky[k], kz = skz[k];
        float dre = 0.0f, dim = 0.0f;
        for (int s = 0; s < 2; ++s) {
          const float* a = s ? snew : sold;
          for (int p = 0; p < P; ++p) {
            if (!sqf[p]) continue;
            float ph = tpl * (kx * a[3 * p] + ky * a[3 * p + 1] + kz * a[3 * p + 2]);
            ph -= kTwoPi * rintf(ph * kInvTwoPi);
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
    if (lane == 0) sred[warp] = part;
    __syncthreads();

    if (tid == 0) {
      float d_e = 0.0f;
      for (int w = 0; w < nwarps; ++w) d_e += sred[w];
      const float beta_de = d_e / temp;
      // the overlap penalty makes beta_de huge: exp(-beta_de) == 0 rejects
      const bool accept = (beta_de < 0.0f) || (um[4] < expf(-beta_de));
      const float tsel = sdec[7];
      st_att_t += tsel;
      st_att_r += 1.0f - tsel;
      if (accept) {
        st_e += d_e;
        st_acc_t += tsel;
        st_acc_r += 1.0f - tsel;
        st_fp += (float)(mg + 1);
        for (int d = 0; d < 3; ++d) scom[3 * mg + d] = sdec[d];
        for (int i = 0; i < 4; ++i) squat[4 * mg + i] = sdec[3 + i];
        const int a0 = a_start + m * P;
        for (int p = 0; p < P; ++p) {
          sx[a0 + p] = snew[3 * p];
          sy[a0 + p] = snew[3 * p + 1];
          sz[a0 + p] = snew[3 * p + 2];
        }
        if constexpr (kGlobal)
          if (W > 0 && a0 >= a0_w)
            // a head molecule's ghost twin (the halo may end inside it)
            for (int p = 0; p < P && a0 + p - a0_w < W; ++p) {
              sx[a0 + A_blk + p] = snew[3 * p];
              sy[a0 + A_blk + p] = snew[3 * p + 1];
              sz[a0 + A_blk + p] = snew[3 * p + 2];
            }
      }
      sdec[8] = accept ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (ewald && sdec[8] != 0.0f) {
      // each thread adds the deltas of the k-vectors it computed
      for (int k = tid; k < K; k += nt) {
        ssre[k] += sdre[k];
        ssim[k] += sdim[k];
      }
    }
  }
  __syncthreads();

  float wsum = 0.0f, wsum2 = 0.0f;
  if (kAct && (n_exch > 0 || n_widom > 0)) {
    const float beta = 1.0f / temp;
    const float si_c = si_in[c], wc_c = wc_in[c];
    const float lnzv = n_exch > 0 ? logf(z_in[c] * box * box * box) : 0.0f;
    const float* ux_chain = ux_in + (size_t)c * (n_exch + n_widom) * kExchUniforms;
    float* ux = su;  // this attempt's 8 uniforms

    // n: this block's active slots, counted once and then tracked
    float cnt = 0.0f;
    for (int i = tid; i < M; i += nt) cnt += sactm[m_start + i] > 0.5f ? 1.0f : 0.0f;
    cnt = warp_sum(cnt);
    if (lane == 0) sred[warp] = cnt;
    __syncthreads();
    float n_act = 0.0f;
    for (int w = 0; w < nwarps; ++w) n_act += sred[w];
    __syncthreads();

    // One pair term of site p of pose a against the atom lane (xj, yj, zj,
    // qj, tj): LJ plus real-space Coulomb, the +1e30 overlap veto on
    // attractive contacts when `veto`.
    auto pair_term = [&](const float* a, int p, float xj, float yj, float zj,
                         float qj, int tj, bool veto) -> float {
      const bool lj = slj[p] != 0;
      const bool uq = sqf[p] != 0;
      const float qq = (factor * sqp[p]) * qj;
      float dx = xj - a[0], dy = yj - a[1], dz = zj - a[2];
      dx -= box * rintf(dx * inv_box);
      dy -= box * rintf(dy * inv_box);
      dz -= box * rintf(dz * inv_box);
      const float d2 = fmaxf(dx * dx + dy * dy + dz * dz, 1e-4f);
      const bool m_lj = d2 < rc2;
      const bool m_qq = split_cut ? d2 < qrc2 : m_lj;
      const float inv_r = rsqrtf(d2);
      const float inv_d2 = inv_r * inv_r;
      float contrib = 0.0f;
      if (lj && m_lj) {
        const float s2 = ssig2[p * T + tj] * inv_d2;
        const float s6 = s2 * s2 * s2;
        float pot = seps[p * T + tj] * (s6 * s6 - s6);
        if (lj_linear) pot += slam1[p * T + tj] + slam2[p * T + tj] * sqrtf(d2);
        contrib = pot;
      }
      if (uq && m_qq) {
        const float r = d2 * inv_r;
        float cp;
        if (coulomb == kBare)
          cp = qq * inv_r;
        else if (coulomb == kWolf)
          cp = qq * (erfcf(kappa * r) * inv_r - sh_w);
        else
          cp = qq * (erfcf(kappa * r) * inv_r);
        if (veto && d2 < d2_overlap && qq < 0.0f) cp = 1e30f;
        contrib += cp;
      }
      return contrib;
    };

    // The structure-factor row of pose a at k-vector k, and the reciprocal
    // energy delta of adding (sgn = +1) or removing (-1) it against the
    // live S(k).
    const float tpl = kTwoPi * inv_box;
    auto k_row = [&](const float* a, int k, float& dre, float& dim) {
      const float kx = skx[k], ky = sky[k], kz = skz[k];
      dre = 0.0f;
      dim = 0.0f;
      for (int p = 0; p < P; ++p) {
        if (!sqf[p]) continue;
        float ph = tpl * (kx * a[3 * p] + ky * a[3 * p + 1] + kz * a[3 * p + 2]);
        ph -= kTwoPi * rintf(ph * kInvTwoPi);
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
      float pair = 0.0f;
      for (int j = tid; j < A_pad; j += nt) {
        const int mj = smol[j];
        if (mj < 0 || mj == excl || sact[j] == 0.0f) continue;
        const float xj = sx[j], yj = sy[j], zj = sz[j], qj = sq[j];
        const int tj = stid[j];
        for (int p = 0; p < P; ++p) pair += pair_term(snew + 3 * p, p, xj, yj, zj, qj, tj, veto);
      }
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
    // pose's (sdel, excl_d) sums, each summed in pose_part's order with its
    // arithmetic; the S(k) rows go to sdre/sdim and sdre2/sdim2.
    auto pose_part2 = [&](int excl_i, int excl_d, bool veto_i, bool veto_d,
                          float sgn_i, float sgn_d, float& part_i, float& part_d) {
      float pair_i = 0.0f, pair_d = 0.0f;
      for (int j = tid; j < A_pad; j += nt) {
        const int mj = smol[j];
        if (mj < 0 || sact[j] == 0.0f) continue;
        const float xj = sx[j], yj = sy[j], zj = sz[j], qj = sq[j];
        const int tj = stid[j];
        const bool use_i = mj != excl_i, use_d = mj != excl_d;
        for (int p = 0; p < P; ++p) {
          if (use_i) pair_i += pair_term(snew + 3 * p, p, xj, yj, zj, qj, tj, veto_i);
          if (use_d) pair_d += pair_term(sdel + 3 * p, p, xj, yj, zj, qj, tj, veto_d);
        }
      }
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
    // Shoemake quaternion; identity for P = 1) into snew and sdec[0..6].
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
      for (int d = 0; d < 3; ++d) sdec[d] = ux[1 + d] * box;
      for (int i = 0; i < 4; ++i) sdec[3 + i] = q[i];
      for (int p = 0; p < P; ++p) {
        float o[3] = {0.0f, 0.0f, 0.0f};
        if (P > 1)
          rot_apply(q[0], q[1], q[2], q[3], sbody[3 * p], sbody[3 * p + 1],
                    sbody[3 * p + 2], o);
        for (int d = 0; d < 3; ++d) snew[3 * p + d] = sdec[d] + o[d];
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
      for (int w = 0; w < nwarps; ++w) b = row[w] > b ? row[w] : b;
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
          const uint32_t bits = philox_word((uint32_t)slot, (uint32_t)xi, seed, (uint32_t)c) >> 8;
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
            pd[3 * p] = sx[a0_d + p];
            pd[3 * p + 1] = sy[a0_d + p];
            pd[3 * p + 2] = sz[a0_d + p];
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
        for (int w = 0; w < nwarps; ++w) du += sred[w];
        if (kTmmc) {
          float du_d = 0.0f;
          for (int w = 0; w < nwarps; ++w) du_d += sred2[w];
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
          const float e = e_c + st_e;
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
        st_att_i += is_ins ? 1.0f : 0.0f;
        if (ok) {
          st_e += du;
          st_fp += (float)(slot + 1 + (is_ins ? 0 : M_total));
          const float on = is_ins ? 1.0f : 0.0f;
          sactm[slot] = on;
          for (int p = 0; p < P; ++p) sact[a0 + p] = on;
          if (is_ins) {
            st_acc_i += 1.0f;
            for (int p = 0; p < P; ++p) {
              sx[a0 + p] = snew[3 * p];
              sy[a0 + p] = snew[3 * p + 1];
              sz[a0 + p] = snew[3 * p + 2];
            }
            for (int d = 0; d < 3; ++d) scom[3 * slot + d] = sdec[d];
            if (P > 1)
              for (int i = 0; i < 4; ++i) squat[4 * slot + i] = sdec[3 + i];
          } else {
            st_acc_d += 1.0f;
          }
        }
        sdec[8] = ok ? 1.0f : 0.0f;
      }
      __syncthreads();
      if (sdec[8] != 0.0f) {
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
        for (int w = 0; w < nwarps; ++w) du += sred[w];
        du += si_c + wc_c * (2.0f * n_act + 1.0f);
        // a vetoed ghost carries +1e30: w = 0
        const float w = expf(-beta * du);
        wsum += w;
        wsum2 += w * w;
      }
    }
    __syncthreads();
  }

  if constexpr (!kGlobal) {
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
    for (int i = tid; i < 3 * M_total; i += nt)
      com_out[(size_t)c * 3 * M_total + i] = scom[i];
    for (int i = tid; i < 4 * M_total; i += nt)
      quat_out[(size_t)c * 4 * M_total + i] = squat[i];
  }
  for (int k = tid; k < K; k += nt) {
    sfac_out[((size_t)c * K + k) * 2] = ssre[k];
    sfac_out[((size_t)c * K + k) * 2 + 1] = ssim[k];
  }
  if (tid == 0) {
    float* st = stats_out + (size_t)c * kStats;
    st[0] = st_e;
    st[1] = st_acc_t;
    st[2] = st_acc_r;
    st[3] = st_att_t;
    st[4] = st_att_r;
    st[5] = st_acc_i;
    st[6] = st_acc_d;
    st[7] = st_att_i;
    st[8] = st_fp;
    if (kAct) {
      wid_out[(size_t)c * 2] = wsum;
      wid_out[(size_t)c * 2 + 1] = wsum2;
    }
  }
}

}  // namespace

extern "C" size_t mmc_sweep_smem_bytes(int M, int P, int A_pad, int K, int T,
                                       int use_act, int tmmc, int global) {
  return sizeof(float) *
         sweep_smem_floats(M, P, A_pad, K, T, use_act, tmmc, global);
}

extern "C" const char* mmc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one sweep of one species block (grid = C chains) on `stream`;
// returns the CUDA error code of the launch (0 on success).  com/quat/u/actm
// hold all M_total molecules' rows.  All pointers are device pointers to
// contiguous f32 (int32 for the flag and row tables) tensors; act, actm,
// act_out, actm_out and wid_out are read and written only with use_act, ux,
// z, si and wc only with n_exch + n_widom > 0 (which needs use_act), eta
// (M + 1), e_in (C), cmat_out and uhist_out (C, M + 1, 3) only with tmmc
// (which needs n_exch > 0).  global selects the global-memory layout (fixed
// N only); with W > 0 (which needs it) wst (M_total,) and segs (n_seg, 2)
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
    void* actm_out, void* wid_out, void* cmat_out, void* uhist_out, int C,
    int M, int M_total, int m_start, int a_start, int P, int A_pad, int K,
    int T, int coulomb, int lj_linear, int use_rot, int use_act, int n_exch,
    int n_widom, int tmmc, int global, int n_seg, int a0_w, int A_blk, int W,
    unsigned int seed, int threads, float rc2, float qrc2, float kappa_l,
    float d2_overlap, float p_translate, float factor, void* stream) {
  const size_t smem = mmc_sweep_smem_bytes(M_total, P, A_pad, K, T, use_act,
                                           tmmc, global);
  if (smem > (size_t)kMaxSmemBytes || threads < 64 || threads > 1024 ||
      threads % 32 != 0 || C < 1 || M < 1 || m_start < 0 || a_start < 0 ||
      m_start + M > M_total || a_start + M * P > A_pad || n_exch < 0 ||
      n_widom < 0 || ((n_exch > 0 || n_widom > 0) && !use_act) ||
      (tmmc && n_exch < 1) || (global && use_act) || W < 0 ||
      (W > 0 && (!global || !wst || (n_seg > 0 && !segs) || n_seg < 0 ||
                 W > A_blk || a0_w < 0 || a0_w + A_blk + W > A_pad)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tmmc ? sweep_kernel<true, true, false>
                : use_act ? sweep_kernel<true, false, false>
                : global ? sweep_kernel<false, false, true>
                         : sweep_kernel<false, false, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<C, threads, smem, static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<float*>(cmat_out), static_cast<float*>(uhist_out), M,
      M_total, m_start, a_start, P, A_pad, K, T, coulomb, lj_linear, use_rot,
      n_exch, n_widom, n_seg, a0_w, A_blk, W, seed, rc2, qrc2, kappa_l,
      d2_overlap, p_translate, factor);
  return static_cast<int>(cudaGetLastError());
}
