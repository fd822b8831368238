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
// largest Philox4x32-10 score (key (seed, chain), counter (plane slot id,
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
// What bounds it on this card: latency, not bytes.  One cycle of the
// flagship (cap 128 x 2 SPC/E, K = 783) is 256 dependent moves and 110
// dependent transfers, each a pass over <= 512 lanes and 783 k-vectors, a
// block reduction and a scalar decision; device memory is touched only to
// load and store the chain state (~60 KB) and the uniforms.  The design:
// the chain's whole two-box state (atom, slot and activity rows, both S(k)
// rows, both cfac rows, the k-vectors) lives in shared memory for the whole
// cycle, so the scans read nothing from device memory; a move scans only its
// own box's half of the lanes; a transfer reads the candidate's columns and
// writes the new slot's directly (the TPU kernel uses full-row one-hot
// reductions); slots are picked by one block max-reduction over 64-bit keys
// that finds the deletion and the insertion slot together; the next move's
// uniforms are prefetched during the current move; chains run in parallel
// across blocks (~67 KB of shared memory and ~120 registers per thread:
// two 256-thread blocks per SM).
//
// Semantics kept from the TPU kernel: old atoms are read from the stored
// coordinates; new atoms are the floor-wrapped new COM plus R(q_new) body;
// pair distances use the rintf minimum image with d^2 floored at 1e-4; pads
// (molid < 0), inactive atoms and the molecule's own atoms are excluded;
// S(k) changes only on accept; energy statistics add deltas by select.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

enum Coulomb { kNone = 0, kEwald = 1, kWolf = 2, kWolfRef = 3, kBare = 4 };

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr int kStats = 8;
constexpr int kUniforms = 10;
constexpr int kExchUniforms = 8;
constexpr int kMaxSmemBytes = 232448;

// Shared-memory words of one block; ops/cuda/gibbs_kernel.py
// gibbs_smem_bytes computes the same number: two slot-pick rows (2 x 32 x
// 8 B), x/y/z/act over both boxes (8 A_off), q/type/molecule of one box
// (3 A_off), COM/quaternion/slot activity over both boxes (16 m_off), 13 k
// rows (S re/im and cfac per box, insertion and deletion dS re/im, kx, ky,
// kz), 4 (P, T) LJ tables, 15 P-wide site rows, 112 words of scratch.
__host__ __device__ inline size_t gibbs_smem_floats(int m_off, int P,
                                                    int A_off, int K, int T) {
  return 128 + 11 * (size_t)A_off + 16 * (size_t)m_off + 13 * (size_t)K +
         4 * (size_t)P * T + 15 * (size_t)P + 112;
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
// (c0, c1, 0, 0) and key (k0, k1); the sweep kernel's deletion scores.
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

// R(q) b, the same expansion as the TPU kernel's _rot_apply.
__device__ inline void rot_apply(float w, float x, float y, float z, float bx,
                                 float by, float bz, float* o) {
  const float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  o[0] = (ww + xx - yy - zz) * bx + 2.0f * ((xy - wz) * by + (xz + wy) * bz);
  o[1] = (ww - xx + yy - zz) * by + 2.0f * ((xy + wz) * bx + (yz - wx) * bz);
  o[2] = (ww - xx - yy + zz) * bz + 2.0f * ((xz - wy) * bx + (yz + wx) * by);
}

__global__ void gibbs_kernel(
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
    float* __restrict__ act_out, float* __restrict__ actm_out, int M,
    int m_off, int m_start, int a_start, int P, int A_off, int K, int T,
    int coulomb, int lj_linear, int use_rot, int n_exch, unsigned int seed,
    float rc2, float qrc2, float kappa_l, float d2_overlap, float p_translate,
    float factor) {
  extern __shared__ float smem[];
  // the slot-pick rows first (8-byte aligned): insertion, deletion
  unsigned long long* sred64 = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* sred64d = sred64 + 32;
  const int A2 = 2 * A_off, M2 = 2 * m_off;
  float* sx = smem + 128;        // (2 A_off) both boxes
  float* sy = sx + A2;
  float* sz = sy + A2;
  float* sact = sz + A2;
  float* sq = sact + A2;         // (A_off) one box's rows
  int* stid = reinterpret_cast<int*>(sq + A_off);
  int* smol = stid + A_off;
  float* scom = reinterpret_cast<float*>(smol + A_off);  // (2 m_off, 3)
  float* squat = scom + 3 * M2;                          // (2 m_off, 4)
  float* sactm = squat + 4 * M2;                         // (2 m_off)
  float* ssre = sactm + M2;      // (2, K) per box
  float* ssim = ssre + 2 * K;
  float* scfac = ssim + 2 * K;
  float* sdre = scfac + 2 * K;   // (K) a move's or an insertion's dS
  float* sdim = sdre + K;
  float* sdre2 = sdim + K;       // (K) a deletion's dS
  float* sdim2 = sdre2 + K;
  float* skx = sdim2 + K;
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
  float* sdel = snew + 3 * P;                        // (P, 3)
  float* su = sdel + 3 * P;     // 2 x 16: double-buffered uniforms
  float* sred = su + 32;        // one partial sum per warp
  float* sred2 = sred + 32;     // a second row of them
  float* sdec = sred2 + 32;     // 16 words: proposal scalars + decision

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  const float* cin = coords_in + (size_t)c * 6 * A_off;
  for (int j = tid; j < A_off; j += nt) {
    for (int b = 0; b < 2; ++b) {
      sx[b * A_off + j] = cin[(3 * b) * A_off + j];
      sy[b * A_off + j] = cin[(3 * b + 1) * A_off + j];
      sz[b * A_off + j] = cin[(3 * b + 2) * A_off + j];
    }
    sq[j] = q_row[j];
    stid[j] = tid_row[j];
    smol[j] = molid_row[j];
  }
  for (int j = tid; j < A2; j += nt) sact[j] = act_in[(size_t)c * A2 + j];
  for (int i = tid; i < M2; i += nt) sactm[i] = actm_in[(size_t)c * M2 + i];
  for (int i = tid; i < 3 * M2; i += nt) scom[i] = com_in[(size_t)c * 3 * M2 + i];
  for (int i = tid; i < 4 * M2; i += nt) squat[i] = quat_in[(size_t)c * 4 * M2 + i];

  // per-box constants, as scalar pairs picked by selects (no local-memory
  // arrays): length, inverse length, kappa, Wolf shift
  const float L0 = box2_in[2 * c], L1 = box2_in[2 * c + 1];
  const float inv0 = 1.0f / L0, inv1 = 1.0f / L1;
  const float kap0 = kappa_l * inv0, kap1 = kappa_l * inv1;
  float shw0 = 0.0f, shw1 = 0.0f;
  if (coulomb == kWolf) {
    const float qrc = sqrtf(qrc2);
    shw0 = erfcf(kap0 * qrc) / qrc;
    shw1 = erfcf(kap1 * qrc) / qrc;
  }
  auto pick = [](int b, float v0, float v1) { return b ? v1 : v0; };
  const float temp = temp_in[c];
  const float dr_max = drmax_in[c];
  const float dphi_max = dphi_in[c];
  const bool ewald = coulomb == kEwald;
  for (int k = tid; k < K; k += nt) {
    const float kx = kvec[3 * k], ky = kvec[3 * k + 1], kz = kvec[3 * k + 2];
    skx[k] = kx;
    sky[k] = ky;
    skz[k] = kz;
    for (int b = 0; b < 2; ++b) {
      ssre[b * K + k] = sfac_in[(((size_t)c * 2 + b) * K + k) * 2];
      ssim[b * K + k] = sfac_in[(((size_t)c * 2 + b) * K + k) * 2 + 1];
      if (ewald) {
        const float L = pick(b, L0, L1), kap = pick(b, kap0, kap1);
        const float tpl = kTwoPi * pick(b, inv0, inv1);
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
  for (int i = tid; i < 3 * P; i += nt) sbody[i] = body[i];
  for (int i = tid; i < P; i += nt) {
    sqp[i] = qp[i];
    slj[i] = has_lj[i];
    sqf[i] = has_q[i] && coulomb != kNone;
  }
  const bool split_cut = qrc2 != rc2;
  __syncthreads();

  // One pair term of site p of pose a against the atom lane (xj, yj, zj,
  // qj, tj) in a box of length L (inverse inv, kappa kap, Wolf shift shw):
  // LJ plus real-space Coulomb, the +1e30 overlap veto on attractive
  // contacts when `veto`.
  auto pair_term = [&](const float* a, int p, float xj, float yj, float zj,
                       float qj, int tj, float L, float inv, float kap,
                       float shw, bool veto) -> float {
    const bool lj = slj[p] != 0;
    const bool uq = sqf[p] != 0;
    const float qq = (factor * sqp[p]) * qj;
    float dx = xj - a[0], dy = yj - a[1], dz = zj - a[2];
    dx -= L * rintf(dx * inv);
    dy -= L * rintf(dy * inv);
    dz -= L * rintf(dz * inv);
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
        cp = qq * (erfcf(kap * r) * inv_r - shw);
      else
        cp = qq * (erfcf(kap * r) * inv_r);
      if (veto && d2 < d2_overlap && qq < 0.0f) cp = 1e30f;
      contrib += cp;
    }
    return contrib;
  };

  // The structure-factor row of pose a at k-vector k in a box of inverse
  // length inv.
  auto k_row = [&](const float* a, int k, float inv, float& dre, float& dim) {
    const float tpl = kTwoPi * inv;
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

  // stats: per-box energy deltas, acc/att [trans, rot], accepted transfers
  // and a decision fingerprint
  float st_e0 = 0.0f, st_e1 = 0.0f;
  float st_acc_t = 0.0f, st_acc_r = 0.0f, st_att_t = 0.0f, st_att_r = 0.0f,
        st_acc_x = 0.0f, st_fp = 0.0f;

  for (int b = 0; b < 2; ++b) {
    const float box = pick(b, L0, L1), inv_box = pick(b, inv0, inv1);
    const float kappa = pick(b, kap0, kap1), sh_w = pick(b, shw0, shw1);
    float* sre_b = ssre + b * K;
    float* sim_b = ssim + b * K;
    const float* cf_b = scfac + b * K;
    const int col0 = b * A_off;
    const float* u_box = u_in + ((size_t)c * 2 * M + (size_t)b * M) * kUniforms;
    if (tid < kUniforms) su[tid] = u_box[tid];
    __syncthreads();

    for (int i = 0; i < M; ++i) {
      const int mloc = m_start + i;     // the slot within its box
      const int slot = b * m_off + mloc;
      const int a0 = col0 + a_start + i * P;
      const float* um = su + (i & 1) * 16;
      // prefetch the next move's uniforms into the other buffer (its last
      // reader, thread 0 at move i-1, finished before the barrier that
      // closed move i-1)
      if (tid >= 32 && tid < 32 + kUniforms && i + 1 < M)
        su[((i + 1) & 1) * 16 + tid - 32] = u_box[(size_t)(i + 1) * kUniforms + tid - 32];
      if (sact[a0] == 0.0f) {
        // an inactive slot: a null move, not an attempt
        __syncthreads();
        continue;
      }

      if (tid == 0) {
        const float* cm = scom + 3 * slot;
        const float* q0 = squat + 4 * slot;
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
        for (int q = 0; q < 4; ++q) sdec[3 + q] = q1[q];
        sdec[7] = tsel;
      }
      __syncthreads();

      // ---- old and new site sums over this box's atom lanes ----
      float part = 0.0f;
      for (int jl = tid; jl < A_off; jl += nt) {
        const int mj = smol[jl];
        if (mj < 0 || mj == mloc) continue;
        const int j = col0 + jl;
        if (sact[j] == 0.0f) continue;
        const float xj = sx[j], yj = sy[j], zj = sz[j], qj = sq[jl];
        const int tj = stid[jl];
        for (int p = 0; p < P; ++p) {
          part -= pair_term(sold + 3 * p, p, xj, yj, zj, qj, tj, box, inv_box,
                            kappa, sh_w, false);
          part += pair_term(snew + 3 * p, p, xj, yj, zj, qj, tj, box, inv_box,
                            kappa, sh_w, true);
        }
      }

      // ---- incremental S(k) of this box and the reciprocal delta ----
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
          const float cross = 2.0f * (sre_b[k] * dre + sim_b[k] * dim) + dre * dre + dim * dim;
          part += factor * (cf_b[k] * cross);
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
          if (b) st_e1 += d_e; else st_e0 += d_e;
          st_acc_t += tsel;
          st_acc_r += 1.0f - tsel;
          st_fp += (float)(slot + 1);
          for (int d = 0; d < 3; ++d) scom[3 * slot + d] = sdec[d];
          for (int q = 0; q < 4; ++q) squat[4 * slot + q] = sdec[3 + q];
          for (int p = 0; p < P; ++p) {
            sx[a0 + p] = snew[3 * p];
            sy[a0 + p] = snew[3 * p + 1];
            sz[a0 + p] = snew[3 * p + 2];
          }
        }
        sdec[8] = accept ? 1.0f : 0.0f;
      }
      __syncthreads();
      if (ewald && sdec[8] != 0.0f) {
        // each thread adds the deltas of the k-vectors it computed
        for (int k = tid; k < K; k += nt) {
          sre_b[k] += sdre[k];
          sim_b[k] += sdim[k];
        }
      }
    }
    __syncthreads();  // the last readers of su are done before it refills
  }

  if (n_exch > 0) {
    const float beta = 1.0f / temp;
    const float* ux_chain = ux_in + (size_t)c * n_exch * kExchUniforms;
    float* ux = su;  // this attempt's 8 uniforms
    const float ln_l0 = logf(L0), ln_l1 = logf(L1);

    // N of this block in each box, counted once and then tracked
    float cnt0 = 0.0f, cnt1 = 0.0f;
    for (int i = tid; i < M; i += nt) {
      cnt0 += sactm[m_start + i] > 0.5f ? 1.0f : 0.0f;
      cnt1 += sactm[m_off + m_start + i] > 0.5f ? 1.0f : 0.0f;
    }
    cnt0 = warp_sum(cnt0);
    cnt1 = warp_sum(cnt1);
    if (lane == 0) {
      sred[warp] = cnt0;
      sred2[warp] = cnt1;
    }
    __syncthreads();
    float n_b0 = 0.0f, n_b1 = 0.0f;
    for (int w = 0; w < nwarps; ++w) {
      n_b0 += sred[w];
      n_b1 += sred2[w];
    }
    auto block_max = [&](const unsigned long long* row) {
      unsigned long long v = 0ull;
      for (int w = 0; w < nwarps; ++w) v = row[w] > v ? row[w] : v;
      return v;
    };

    for (int xi = 0; xi < n_exch; ++xi) {
      __syncthreads();  // the last readers of ux, sred and sred64 are done
      if (tid < kExchUniforms) ux[tid] = ux_chain[(size_t)xi * kExchUniforms + tid];
      __syncthreads();
      const int src = ux[0] < 0.5f ? 0 : 1;
      const int dst = 1 - src;
      const float n_src = pick(src, n_b0, n_b1), n_dst = pick(dst, n_b0, n_b1);
      // an empty source or a full destination: refused, nothing read or
      // written through the slot indices (block-uniform)
      if (!(n_src > 0.5f && n_dst < (float)M - 0.5f)) continue;

      // slot pick in one pass: the source's active slot with the largest
      // score (key (score + 1, ~slot)) and the destination's first free slot
      // (key (1, ~slot))
      unsigned long long best_i = 0ull, best_d = 0ull;
      for (int i = tid; i < M; i += nt) {
        const int s_id = src * m_off + m_start + i;
        const int d_id = dst * m_off + m_start + i;
        if (sactm[s_id] > 0.5f) {
          const uint32_t bits = philox_word((uint32_t)s_id, (uint32_t)xi, seed, (uint32_t)c) >> 8;
          const unsigned long long key =
              ((unsigned long long)(bits + 1u) << 32) | (0xFFFFFFFFu - (uint32_t)s_id);
          best_d = key > best_d ? key : best_d;
        }
        if (!(sactm[d_id] > 0.5f)) {
          const unsigned long long key = (1ull << 32) | (0xFFFFFFFFu - (uint32_t)d_id);
          best_i = key > best_i ? key : best_i;
        }
      }
      best_i = warp_max_u64(best_i);
      best_d = warp_max_u64(best_d);
      if (lane == 0) {
        sred64[warp] = best_i;
        sred64d[warp] = best_d;
      }
      __syncthreads();
      const int ins_slot = (int)(0xFFFFFFFFu - (uint32_t)(block_max(sred64) & 0xFFFFFFFFull));
      const int del_slot = (int)(0xFFFFFFFFu - (uint32_t)(block_max(sred64d) & 0xFFFFFFFFull));
      const int del_loc = del_slot - src * m_off;   // within the source box
      const int ins_loc = ins_slot - dst * m_off;
      const int a0_d = src * A_off + a_start + (del_loc - m_start) * P;
      const int a0_i = dst * A_off + a_start + (ins_loc - m_start) * P;
      const float L_s = pick(src, L0, L1), inv_s = pick(src, inv0, inv1);
      const float kap_s = pick(src, kap0, kap1), shw_s = pick(src, shw0, shw1);
      const float L_d = pick(dst, L0, L1), inv_d = pick(dst, inv0, inv1);
      const float kap_d = pick(dst, kap0, kap1), shw_d = pick(dst, shw0, shw1);

      if (tid == 0) {
        // the fresh pose, uniform in the destination volume (Shoemake
        // quaternion; the identity for P = 1)
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
        for (int d = 0; d < 3; ++d) sdec[d] = ux[1 + d] * L_d;
        for (int k = 0; k < 4; ++k) sdec[3 + k] = q[k];
        for (int p = 0; p < P; ++p) {
          float o[3] = {0.0f, 0.0f, 0.0f};
          if (P > 1)
            rot_apply(q[0], q[1], q[2], q[3], sbody[3 * p], sbody[3 * p + 1],
                      sbody[3 * p + 2], o);
          for (int d = 0; d < 3; ++d) snew[3 * p + d] = sdec[d] + o[d];
          // the deletion candidate's stored pose
          sdel[3 * p] = sx[a0_d + p];
          sdel[3 * p + 1] = sy[a0_d + p];
          sdel[3 * p + 2] = sz[a0_d + p];
        }
      }
      __syncthreads();

      // the candidate against its source box (its own atoms excluded, veto
      // off) and the fresh pose against the destination box (veto on)
      float pair_d = 0.0f, pair_i = 0.0f;
      for (int jl = tid; jl < A_off; jl += nt) {
        const int mj = smol[jl];
        if (mj < 0) continue;
        const float qj = sq[jl];
        const int tj = stid[jl];
        const int js = src * A_off + jl, jd = dst * A_off + jl;
        if (mj != del_loc && sact[js] != 0.0f) {
          const float xj = sx[js], yj = sy[js], zj = sz[js];
          for (int p = 0; p < P; ++p)
            pair_d += pair_term(sdel + 3 * p, p, xj, yj, zj, qj, tj, L_s, inv_s,
                                kap_s, shw_s, false);
        }
        if (sact[jd] != 0.0f) {
          const float xj = sx[jd], yj = sy[jd], zj = sz[jd];
          for (int p = 0; p < P; ++p)
            pair_i += pair_term(snew + 3 * p, p, xj, yj, zj, qj, tj, L_d, inv_d,
                                kap_d, shw_d, true);
        }
      }
      float part_d = -pair_d, part_i = pair_i;
      if (ewald) {
        const float* re_s = ssre + src * K;
        const float* im_s = ssim + src * K;
        const float* cf_s = scfac + src * K;
        const float* re_d = ssre + dst * K;
        const float* im_d = ssim + dst * K;
        const float* cf_d = scfac + dst * K;
        for (int k = tid; k < K; k += nt) {
          float dre, dim;
          k_row(sdel, k, inv_s, dre, dim);
          sdre2[k] = dre;
          sdim2[k] = dim;
          float cross = -2.0f * (re_s[k] * dre + im_s[k] * dim) + dre * dre + dim * dim;
          part_d += factor * (cf_s[k] * cross);
          k_row(snew, k, inv_d, dre, dim);
          sdre[k] = dre;
          sdim[k] = dim;
          cross = 2.0f * (re_d[k] * dre + im_d[k] * dim) + dre * dre + dim * dim;
          part_i += factor * (cf_d[k] * cross);
        }
      }
      part_d = warp_sum(part_d);
      part_i = warp_sum(part_i);
      if (lane == 0) {
        sred[warp] = part_d;
        sred2[warp] = part_i;
      }
      __syncthreads();

      if (tid == 0) {
        float du_d = 0.0f, du_i = 0.0f;
        for (int w = 0; w < nwarps; ++w) {
          du_d += sred[w];
          du_i += sred2[w];
        }
        du_d += -si2_in[2 * c + src] + wc2_in[2 * c + src] * (-2.0f * n_src + 1.0f);
        du_i += si2_in[2 * c + dst] + wc2_in[2 * c + dst] * (2.0f * n_dst + 1.0f);
        const float du = du_d + du_i;
        const float ln_acc = logf(fmaxf(n_src, 1.0f)) - logf(n_dst + 1.0f) +
                             3.0f * (pick(dst, ln_l0, ln_l1) - pick(src, ln_l0, ln_l1)) -
                             beta * du;
        const float ln_u = logf(fmaxf(ux[7], 1e-30f));
        const bool ok = ln_u < ln_acc;
        if (ok) {
          st_e0 += src ? du_i : du_d;
          st_e1 += src ? du_d : du_i;
          st_acc_x += 1.0f;
          st_fp += (float)(del_slot + 1 + 2 * m_off);
          sactm[del_slot] = 0.0f;
          sactm[ins_slot] = 1.0f;
          for (int p = 0; p < P; ++p) {
            sact[a0_d + p] = 0.0f;
            sact[a0_i + p] = 1.0f;
            sx[a0_i + p] = snew[3 * p];
            sy[a0_i + p] = snew[3 * p + 1];
            sz[a0_i + p] = snew[3 * p + 2];
          }
          for (int d = 0; d < 3; ++d) scom[3 * ins_slot + d] = sdec[d];
          if (P > 1)
            for (int k = 0; k < 4; ++k) squat[4 * ins_slot + k] = sdec[3 + k];
        }
        sdec[8] = ok ? 1.0f : 0.0f;
      }
      __syncthreads();
      if (sdec[8] != 0.0f) {
        n_b0 += src ? 1.0f : -1.0f;
        n_b1 += src ? -1.0f : 1.0f;
        if (ewald)
          for (int k = tid; k < K; k += nt) {
            ssre[src * K + k] -= sdre2[k];
            ssim[src * K + k] -= sdim2[k];
            ssre[dst * K + k] += sdre[k];
            ssim[dst * K + k] += sdim[k];
          }
      }
    }
    __syncthreads();
  }

  float* cout = coords_out + (size_t)c * 6 * A_off;
  for (int j = tid; j < A_off; j += nt)
    for (int b = 0; b < 2; ++b) {
      cout[(3 * b) * A_off + j] = sx[b * A_off + j];
      cout[(3 * b + 1) * A_off + j] = sy[b * A_off + j];
      cout[(3 * b + 2) * A_off + j] = sz[b * A_off + j];
    }
  for (int j = tid; j < A2; j += nt) act_out[(size_t)c * A2 + j] = sact[j];
  for (int i = tid; i < M2; i += nt) actm_out[(size_t)c * M2 + i] = sactm[i];
  for (int i = tid; i < 3 * M2; i += nt) com_out[(size_t)c * 3 * M2 + i] = scom[i];
  for (int i = tid; i < 4 * M2; i += nt) quat_out[(size_t)c * 4 * M2 + i] = squat[i];
  for (int k = tid; k < K; k += nt)
    for (int b = 0; b < 2; ++b) {
      sfac_out[(((size_t)c * 2 + b) * K + k) * 2] = ssre[b * K + k];
      sfac_out[(((size_t)c * 2 + b) * K + k) * 2 + 1] = ssim[b * K + k];
    }
  if (tid == 0) {
    float* st = stats_out + (size_t)c * kStats;
    st[0] = st_e0;
    st[1] = st_e1;
    st[2] = st_acc_t;
    st[3] = st_acc_r;
    st[4] = st_att_t;
    st[5] = st_att_r;
    st[6] = st_acc_x;
    st[7] = st_fp;
  }
}

}  // namespace

extern "C" size_t mmc_gibbs_smem_bytes(int m_off, int P, int A_off, int K,
                                       int T) {
  return sizeof(float) * gibbs_smem_floats(m_off, P, A_off, K, T);
}

extern "C" const char* mmc_gibbs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one Gibbs call of one species block (grid = C chains) on
// `stream`; returns the CUDA error code of the launch (0 on success).  All
// pointers are device pointers to contiguous f32 (int32 for the flag and
// row tables) tensors in the layout described at the top; ux, si2 and wc2
// are read only with n_exch > 0.
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
    void* actm_out, int C, int M, int m_off, int m_start, int a_start, int P,
    int A_off, int K, int T, int coulomb, int lj_linear, int use_rot,
    int n_exch, unsigned int seed, int threads, float rc2, float qrc2,
    float kappa_l, float d2_overlap, float p_translate, float factor,
    void* stream) {
  const size_t smem = mmc_gibbs_smem_bytes(m_off, P, A_off, K, T);
  if (smem > (size_t)kMaxSmemBytes || threads < 64 || threads > 1024 ||
      threads % 32 != 0 || C < 1 || M < 1 || P < 1 || m_start < 0 ||
      a_start < 0 || m_start + M > m_off || a_start + M * P > A_off ||
      n_exch < 0 || (n_exch > 0 && (!ux || !si2 || !wc2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gibbs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gibbs_kernel<<<C, threads, smem, static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<float*>(act_out), static_cast<float*>(actm_out), M, m_off,
      m_start, a_start, P, A_off, K, T, coulomb, lj_linear, use_rot, n_exch,
      seed, rc2, qrc2, kappa_l, d2_overlap, p_translate, factor);
  return static_cast<int>(cudaGetLastError());
}
