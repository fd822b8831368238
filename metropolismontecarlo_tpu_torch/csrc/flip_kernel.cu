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
//      Philox4x32-10 score (key (seed, chain), counter (slot, attempt, 0, 0);
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
// What bounds it on this card: latency, not bytes.  An attempt is one pass
// over the chain's atom lanes (both poses' site sums) and its k-vectors, two
// block reductions and a scalar decision, all dependent on the previous
// attempt; device memory is touched only to load and store the chain state.
// The design: the whole chain state (atom, slot and activity rows, S(k),
// cfac, both species' LJ rows and templates) lives in shared memory for the
// launch (~31 KB at the semigrand flagship, three blocks per SM); the
// flip's direction is uniform over the block, so an attempt scans two poses
// (old and new) and builds one dS row, where the TPU kernel evaluates both
// directions and selects; the pick and both blocks' first free slots come
// from one pass of 64-bit-key max-reductions.
//
// Semantics kept from the TPU kernel: pair distances use the rintf minimum
// image with d^2 floored at 1e-4; pads (molid < 0), inactive atoms and the
// flipped molecule's own atoms are excluded; the quaternion written is the
// Shoemake one for either species (a one-site species ignores it).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

enum Coulomb { kNone = 0, kEwald = 1, kWolf = 2, kWolfRef = 3, kBare = 4 };

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr int kStats = 8;
constexpr int kFlipUniforms = 8;
constexpr int kMaxSmemBytes = 232448;
// 256 threads per block with a register cap that fits three blocks per SM:
// the launch is latency-bound, and the third block hides more of it than
// the registers the cap takes away (ptxas: 77 with the cap, 92 without)
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 3;

// Shared-memory words of one block; ops/cuda/flip_kernel.py flip_smem_bytes
// computes the same number: three slot-pick rows (3 x 32 x 8 B), x/y/z/act
// (4 A_pad), charge/type/molecule (3 A_pad), COM/quaternion/slot activity
// (8 M), 8 k rows (S re/im, cfac, dS re/im, kx, ky, kz), both species' (P,
// T) eps and sigma^2 tables, both species' 6 P-wide site rows (body 3,
// charge, two flags), the old and new poses (3 max(P0, P1) each), 64 words
// of uniforms, warp partials and decision scratch.
__host__ __device__ inline size_t flip_smem_floats(int M, int P0, int P1,
                                                   int A_pad, int K, int T) {
  const int pmax = P0 > P1 ? P0 : P1;
  return 192 + 7 * (size_t)A_pad + 8 * (size_t)M + 8 * (size_t)K +
         2 * (size_t)(P0 + P1) * T + 6 * (size_t)(P0 + P1) + 6 * (size_t)pmax +
         64;
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

__device__ inline unsigned long long block_max(const unsigned long long* row,
                                               int nwarps) {
  unsigned long long v = 0ull;
  for (int w = 0; w < nwarps; ++w) v = row[w] > v ? row[w] : v;
  return v;
}

// One species' tables in shared memory: (P, T) LJ rows by neighbour type and
// the P-wide site rows.  Attempts take plain pointer copies of the old and
// the new identity's fields (a reference picked at run time would put the
// pair in local memory).
struct Species {
  const float* eps;   // 4 eps
  const float* sig2;
  const float* body;  // (P, 3)
  const float* qp;
  const int* lj;
  const int* qf;      // has_q and a Coulomb style
  int P;
};

__device__ inline Species pick_species(bool first, const Species& s0,
                                       const Species& s1) {
  Species s;
  s.eps = first ? s0.eps : s1.eps;
  s.sig2 = first ? s0.sig2 : s1.sig2;
  s.body = first ? s0.body : s1.body;
  s.qp = first ? s0.qp : s1.qp;
  s.lj = first ? s0.lj : s1.lj;
  s.qf = first ? s0.qf : s1.qf;
  s.P = first ? s0.P : s1.P;
  return s;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) flip_kernel(
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
    float* __restrict__ stats_out, int cap_a, int cap_b, int P0, int P1,
    int a0_b, int A_pad, int K, int T, int coulomb, int n_flip,
    unsigned int seed, float rc2, float qrc2, float kappa_l, float d2_overlap,
    float ln_xi, float factor) {
  extern __shared__ float smem[];
  // the slot-pick rows first (8-byte aligned): pick, first free A, first
  // free B
  unsigned long long* sred_p = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* sred_fa = sred_p + 32;
  unsigned long long* sred_fb = sred_fa + 32;
  const int M = cap_a + cap_b;
  const int pmax = P0 > P1 ? P0 : P1;
  float* sx = smem + 192;
  float* sy = sx + A_pad;
  float* sz = sy + A_pad;
  float* sact = sz + A_pad;
  float* sq = sact + A_pad;
  int* stid = reinterpret_cast<int*>(sq + A_pad);
  int* smol = stid + A_pad;
  float* scom = reinterpret_cast<float*>(smol + A_pad);  // (M, 3)
  float* squat = scom + 3 * M;                           // (M, 4)
  float* sactm = squat + 4 * M;                          // (M)
  float* ssre = sactm + M;
  float* ssim = ssre + K;
  float* scfac = ssim + K;
  float* sdre = scfac + K;
  float* sdim = sdre + K;
  float* skx = sdim + K;
  float* sky = skx + K;
  float* skz = sky + K;
  float* seps0 = skz + K;          // (P0, T)
  float* ssig0 = seps0 + P0 * T;
  float* seps1 = ssig0 + P0 * T;   // (P1, T)
  float* ssig1 = seps1 + P1 * T;
  float* sbody0 = ssig1 + P1 * T;  // (P0, 3)
  float* sqp0 = sbody0 + 3 * P0;
  int* slj0 = reinterpret_cast<int*>(sqp0 + P0);
  int* sqf0 = slj0 + P0;
  float* sbody1 = reinterpret_cast<float*>(sqf0 + P0);  // (P1, 3)
  float* sqp1 = sbody1 + 3 * P1;
  int* slj1 = reinterpret_cast<int*>(sqp1 + P1);
  int* sqf1 = slj1 + P1;
  float* sold = reinterpret_cast<float*>(sqf1 + P1);  // (pmax, 3)
  float* snew = sold + 3 * pmax;                        // (pmax, 3)
  float* su = snew + 3 * pmax;  // 16: this attempt's uniforms
  float* sred = su + 16;        // one partial sum per warp
  float* sdec = sred + 32;      // 16 words: proposal scalars + decision

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  const float* cin = coords_in + (size_t)c * 3 * A_pad;
  for (int j = tid; j < A_pad; j += nt) {
    sx[j] = cin[j];
    sy[j] = cin[A_pad + j];
    sz[j] = cin[2 * A_pad + j];
    sact[j] = act_in[(size_t)c * A_pad + j];
    sq[j] = q_row[j];
    stid[j] = tid_row[j];
    smol[j] = molid_row[j];
  }
  for (int i = tid; i < M; i += nt) sactm[i] = actm_in[(size_t)c * M + i];
  for (int i = tid; i < 3 * M; i += nt) scom[i] = com_in[(size_t)c * 3 * M + i];
  for (int i = tid; i < 4 * M; i += nt) squat[i] = quat_in[(size_t)c * 4 * M + i];

  const float box = box_in[c];
  const float inv_box = 1.0f / box;
  const float kappa = kappa_l * inv_box;
  float sh_w = 0.0f;
  if (coulomb == kWolf) {
    const float qrc = sqrtf(qrc2);
    sh_w = erfcf(kappa * qrc) / qrc;
  }
  const float beta = 1.0f / temp_in[c];
  const bool ewald = coulomb == kEwald;
  for (int k = tid; k < K; k += nt) {
    const float kx = kvec[3 * k], ky = kvec[3 * k + 1], kz = kvec[3 * k + 2];
    skx[k] = kx;
    sky[k] = ky;
    skz[k] = kz;
    ssre[k] = sfac_in[((size_t)c * K + k) * 2];
    ssim[k] = sfac_in[((size_t)c * K + k) * 2 + 1];
    if (ewald) {
      const float tpl = kTwoPi * inv_box;
      const float kt2 = tpl * tpl * (kx * kx + ky * ky + kz * kz);
      const float vol = box * box * box;
      scfac[k] = kw[k] * (kTwoPi / vol) * expf(-kt2 / (4.0f * kappa * kappa)) / kt2;
    }
  }
  for (int i = tid; i < P0 * T; i += nt) {
    seps0[i] = 4.0f * eps0[i];
    ssig0[i] = sig20[i];
  }
  for (int i = tid; i < P1 * T; i += nt) {
    seps1[i] = 4.0f * eps1[i];
    ssig1[i] = sig21[i];
  }
  for (int i = tid; i < 3 * P0; i += nt) sbody0[i] = body0[i];
  for (int i = tid; i < 3 * P1; i += nt) sbody1[i] = body1[i];
  for (int i = tid; i < P0; i += nt) {
    sqp0[i] = qp0[i];
    slj0[i] = has_lj0[i];
    sqf0[i] = has_q0[i] && coulomb != kNone;
  }
  for (int i = tid; i < P1; i += nt) {
    sqp1[i] = qp1[i];
    slj1[i] = has_lj1[i];
    sqf1[i] = has_q1[i] && coulomb != kNone;
  }
  const Species spA = {seps0, ssig0, sbody0, sqp0, slj0, sqf0, P0};
  const Species spB = {seps1, ssig1, sbody1, sqp1, slj1, sqf1, P1};
  const bool split_cut = qrc2 != rc2;
  const float si_a = si2_in[2 * c], si_b = si2_in[2 * c + 1];
  const bool use_lrc = lrc3_in != nullptr;
  float g00 = 0.0f, g01 = 0.0f, g11 = 0.0f;
  if (use_lrc) {
    g00 = lrc3_in[3 * c];
    g01 = lrc3_in[3 * c + 1];
    g11 = lrc3_in[3 * c + 2];
  }

  // live per-species counts, counted once and then tracked by thread 0
  float cnt_a = 0.0f, cnt_b = 0.0f;
  for (int i = tid; i < M; i += nt) {
    const float on = sactm[i] > 0.5f ? 1.0f : 0.0f;
    if (i < cap_a) cnt_a += on; else cnt_b += on;
  }
  cnt_a = warp_sum(cnt_a);
  cnt_b = warp_sum(cnt_b);
  if (lane == 0) {
    sred[warp] = cnt_a;
    sdec[warp] = cnt_b;   // nwarps <= 8
  }
  __syncthreads();
  float n_a = 0.0f, n_b = 0.0f;
  for (int w = 0; w < nwarps; ++w) {
    n_a += sred[w];
    n_b += sdec[w];
  }

  // One pair term of site p (species s) of pose a against the atom lane
  // (xj, yj, zj, qj, tj): LJ plus real-space Coulomb, the +1e30 overlap
  // veto on attractive contacts when `veto`.
  auto pair_term = [&](const Species& s, const float* a, int p, float xj,
                       float yj, float zj, float qj, int tj, bool veto) -> float {
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
    if (s.lj[p] && m_lj) {
      const float s2 = s.sig2[p * T + tj] * inv_d2;
      const float s6 = s2 * s2 * s2;
      contrib = s.eps[p * T + tj] * (s6 * s6 - s6);
    }
    if (s.qf[p] && m_qq) {
      const float qq = (factor * s.qp[p]) * qj;
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

  // The structure-factor row of species-s pose a at k-vector k.
  auto k_row = [&](const Species& s, const float* a, int k, float& dre, float& dim) {
    const float tpl = kTwoPi * inv_box;
    const float kx = skx[k], ky = sky[k], kz = skz[k];
    dre = 0.0f;
    dim = 0.0f;
    for (int p = 0; p < s.P; ++p) {
      if (!s.qf[p]) continue;
      float ph = tpl * (kx * a[3 * p] + ky * a[3 * p + 1] + kz * a[3 * p + 2]);
      ph -= kTwoPi * rintf(ph * kInvTwoPi);
      float sn, cs;
      sincosf(ph, &sn, &cs);
      dre += s.qp[p] * cs;
      dim += s.qp[p] * sn;
    }
  };

  float st_e = 0.0f, st_acc_ab = 0.0f, st_acc_ba = 0.0f, st_att_ab = 0.0f,
        st_att_ba = 0.0f, st_fp = 0.0f;
  const float* ux_chain = ux_in + (size_t)c * n_flip * kFlipUniforms;

  for (int fi = 0; fi < n_flip; ++fi) {
    __syncthreads();  // the last readers of su, sred and the pick rows are done
    if (tid < kFlipUniforms) su[tid] = ux_chain[(size_t)fi * kFlipUniforms + tid];

    // the pick (key (score + 1, ~slot)) and each block's first free slot
    // (key (1, ~slot)) in one pass
    unsigned long long best_p = 0ull, best_fa = 0ull, best_fb = 0ull;
    for (int i = tid; i < M; i += nt) {
      const uint32_t low = 0xFFFFFFFFu - (uint32_t)i;
      if (sactm[i] > 0.5f) {
        const uint32_t bits = philox_word((uint32_t)i, (uint32_t)fi, seed, (uint32_t)c) >> 8;
        const unsigned long long key = ((unsigned long long)(bits + 1u) << 32) | low;
        best_p = key > best_p ? key : best_p;
      } else {
        const unsigned long long key = (1ull << 32) | low;
        if (i < cap_a)
          best_fa = key > best_fa ? key : best_fa;
        else
          best_fb = key > best_fb ? key : best_fb;
      }
    }
    best_p = warp_max_u64(best_p);
    best_fa = warp_max_u64(best_fa);
    best_fb = warp_max_u64(best_fb);
    if (lane == 0) {
      sred_p[warp] = best_p;
      sred_fa[warp] = best_fa;
      sred_fb[warp] = best_fb;
    }
    __syncthreads();
    const unsigned long long kp = block_max(sred_p, nwarps);
    if (kp == 0ull) {
      // no active slot: the TPU kernel's degenerate pick is slot 0, an
      // A -> B attempt that can never be accepted (block-uniform)
      if (tid == 0) st_att_ab += 1.0f;
      continue;
    }
    const int slot = (int)(0xFFFFFFFFu - (uint32_t)(kp & 0xFFFFFFFFull));
    const bool is_a = slot < cap_a;
    if (tid == 0) {
      if (is_a) st_att_ab += 1.0f; else st_att_ba += 1.0f;
    }
    const unsigned long long kt = block_max(is_a ? sred_fb : sred_fa, nwarps);
    // no free slot in the target block: refused, nothing written
    if (kt == 0ull) continue;
    const int tgt = (int)(0xFFFFFFFFu - (uint32_t)(kt & 0xFFFFFFFFull));
    const Species so = pick_species(is_a, spA, spB);   // the old identity
    const Species sn = pick_species(is_a, spB, spA);   // the new one
    const int col_old = is_a ? slot * P0 : a0_b + (slot - cap_a) * P1;
    const int col_new = is_a ? a0_b + (tgt - cap_a) * P1 : tgt * P0;

    if (tid == 0) {
      // the fresh Shoemake orientation of the new identity at the old COM
      const float u1 = su[4];
      float s2, c2, s3, c3;
      sincosf(kTwoPi * (su[5] - rintf(su[5])), &s2, &c2);
      sincosf(kTwoPi * (su[6] - rintf(su[6])), &s3, &c3);
      const float r1 = sqrtf(fmaxf(1.0f - u1, 0.0f)), r2 = sqrtf(u1);
      const float q[4] = {r1 * s2, r1 * c2, r2 * s3, r2 * c3};
      const float* cm = scom + 3 * slot;
      for (int d = 0; d < 3; ++d) sdec[d] = cm[d];
      for (int k = 0; k < 4; ++k) sdec[3 + k] = q[k];
      for (int p = 0; p < sn.P; ++p) {
        float o[3] = {0.0f, 0.0f, 0.0f};
        if (sn.P > 1)
          rot_apply(q[0], q[1], q[2], q[3], sn.body[3 * p], sn.body[3 * p + 1],
                    sn.body[3 * p + 2], o);
        for (int d = 0; d < 3; ++d) snew[3 * p + d] = cm[d] + o[d];
      }
      for (int p = 0; p < so.P; ++p) {
        sold[3 * p] = sx[col_old + p];
        sold[3 * p + 1] = sy[col_old + p];
        sold[3 * p + 2] = sz[col_old + p];
      }
    }
    __syncthreads();

    // both identities' site sums over the atom lanes
    float part = 0.0f;
    for (int j = tid; j < A_pad; j += nt) {
      const int mj = smol[j];
      if (mj < 0 || mj == slot || sact[j] == 0.0f) continue;
      const float xj = sx[j], yj = sy[j], zj = sz[j], qj = sq[j];
      const int tj = stid[j];
      for (int p = 0; p < so.P; ++p)
        part -= pair_term(so, sold + 3 * p, p, xj, yj, zj, qj, tj, false);
      for (int p = 0; p < sn.P; ++p)
        part += pair_term(sn, snew + 3 * p, p, xj, yj, zj, qj, tj, true);
    }
    if (ewald) {
      for (int k = tid; k < K; k += nt) {
        float re_n, im_n, re_o, im_o;
        k_row(sn, snew, k, re_n, im_n);
        k_row(so, sold, k, re_o, im_o);
        const float dre = re_n - re_o, dim = im_n - im_o;
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
      float du = 0.0f;
      for (int w = 0; w < nwarps; ++w) du += sred[w];
      du += is_a ? si_b - si_a : si_a - si_b;
      if (use_lrc) {
        // the tail's flip delta, affine in the live counts
        const float d_ab = -(2.0f * n_a - 1.0f) * g00 + (2.0f * n_b + 1.0f) * g11 +
                           2.0f * (n_a - n_b - 1.0f) * g01;
        const float d_ba = (2.0f * n_a + 1.0f) * g00 - (2.0f * n_b - 1.0f) * g11 +
                           2.0f * (n_b - n_a - 1.0f) * g01;
        du += is_a ? d_ab : d_ba;
      }
      const float ln_acc = (is_a ? ln_xi : -ln_xi) - beta * du;
      const float ln_u = logf(fmaxf(su[7], 1e-30f));
      const bool ok = ln_u < ln_acc;
      if (ok) {
        st_e += du;
        if (is_a) st_acc_ab += 1.0f; else st_acc_ba += 1.0f;
        st_fp += (float)(slot + 1);
        n_a += is_a ? -1.0f : 1.0f;
        n_b += is_a ? 1.0f : -1.0f;
        sactm[slot] = 0.0f;
        sactm[tgt] = 1.0f;
        for (int p = 0; p < so.P; ++p) sact[col_old + p] = 0.0f;
        for (int p = 0; p < sn.P; ++p) {
          sact[col_new + p] = 1.0f;
          sx[col_new + p] = snew[3 * p];
          sy[col_new + p] = snew[3 * p + 1];
          sz[col_new + p] = snew[3 * p + 2];
        }
        for (int d = 0; d < 3; ++d) scom[3 * tgt + d] = sdec[d];
        for (int k = 0; k < 4; ++k) squat[4 * tgt + k] = sdec[3 + k];
      }
      sdec[8] = ok ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (ewald && sdec[8] != 0.0f)
      // each thread adds the deltas of the k-vectors it computed
      for (int k = tid; k < K; k += nt) {
        ssre[k] += sdre[k];
        ssim[k] += sdim[k];
      }
  }
  __syncthreads();

  float* cout = coords_out + (size_t)c * 3 * A_pad;
  for (int j = tid; j < A_pad; j += nt) {
    cout[j] = sx[j];
    cout[A_pad + j] = sy[j];
    cout[2 * A_pad + j] = sz[j];
    act_out[(size_t)c * A_pad + j] = sact[j];
  }
  for (int i = tid; i < M; i += nt) actm_out[(size_t)c * M + i] = sactm[i];
  for (int i = tid; i < 3 * M; i += nt) com_out[(size_t)c * 3 * M + i] = scom[i];
  for (int i = tid; i < 4 * M; i += nt) quat_out[(size_t)c * 4 * M + i] = squat[i];
  for (int k = tid; k < K; k += nt) {
    sfac_out[((size_t)c * K + k) * 2] = ssre[k];
    sfac_out[((size_t)c * K + k) * 2 + 1] = ssim[k];
  }
  if (tid == 0) {
    float* st = stats_out + (size_t)c * kStats;
    st[0] = st_e;
    st[1] = st_acc_ab;
    st[2] = st_acc_ba;
    st[3] = st_att_ab;
    st[4] = st_att_ba;
    st[5] = st_fp;
    st[6] = 0.0f;
    st[7] = 0.0f;
  }
}

}  // namespace

extern "C" size_t mmc_flip_smem_bytes(int M, int P0, int P1, int A_pad, int K,
                                      int T) {
  return sizeof(float) * flip_smem_floats(M, P0, P1, A_pad, K, T);
}

extern "C" const char* mmc_flip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches n_flip flip attempts of every chain (grid = C chains) on `stream`;
// returns the CUDA error code of the launch (0 on success).  All pointers are
// device pointers to contiguous f32 (int32 for the flag and row tables)
// tensors: coords (C, 3, A_pad), com (C, M, 3), quat (C, M, 4), sfac (C, K,
// 2), act (C, A_pad), actm (C, M), box/temp (C), si2 (C, 2), lrc3 (C, 3) or
// null (no LJ tail), ux (C, n_flip, 8); per species s: body (P_s, 3), qp
// (P_s), eps/sig2 (P_s, T), has_lj/has_q (P_s); tid/molid/q rows (A_pad),
// kvec (K, 3), kw (K).
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
    void* stats_out, int C, int cap_a, int cap_b, int P0, int P1, int a0_b,
    int A_pad, int K, int T, int coulomb, int n_flip, unsigned int seed,
    int threads, float rc2, float qrc2, float kappa_l, float d2_overlap,
    float ln_xi, float factor, void* stream) {
  const size_t smem = mmc_flip_smem_bytes(cap_a + cap_b, P0, P1, A_pad, K, T);
  if (smem > (size_t)kMaxSmemBytes || threads < 64 || threads > kThreads ||
      threads % 32 != 0 || C < 1 || cap_a < 1 || cap_b < 1 || P0 < 1 ||
      P1 < 1 || a0_b < cap_a * P0 || a0_b + cap_b * P1 > A_pad || n_flip < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flip_kernel<<<C, threads, smem, static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<float*>(stats_out), cap_a, cap_b, P0, P1, a0_b, A_pad, K, T,
      coulomb, n_flip, seed, rc2, qrc2, kappa_l, d2_overlap, ln_xi, factor);
  return static_cast<int>(cudaGetLastError());
}
