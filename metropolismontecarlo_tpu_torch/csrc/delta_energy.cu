// Per-move delta-energy kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel metropolismontecarlo_tpu/ops/pallas/delta_energy.py
// delta_energy_pallas / _kernel.  Plain PyTorch twin:
// ops/cuda/delta_energy.py delta_energy_plain.
//
// What it computes: for every chain c and every moved row r (the rows are
// [P old sites; P new sites; pad] of the one molecule m being moved), the
// row's interaction with every atom lane j of the chain's coordinate planes:
//   e_lj[c, r]   = sum_j 4 eps (s^12 - s^6)            (d^2 < rc2)
//   e_coul[c, r] = sum_j q_r q_j f(r)                  (d^2 < qrc2)
//   ovr[c, r]    = #{j : d^2 < d2_overlap, q_r q_j < 0} (d^2 < qrc2)
// with f = erfc(kappa r)/r (ewald, wolf_ref), erfc(kappa r)/r -
// erfc(kappa r_c)/r_c (wolf), 1/r (bare); lanes of molecule m and pad lanes
// (molecule id < 0) drop out; d^2 is floored at 1e-4.  The Coulomb unit
// factor is applied by the caller.  Rows whose flag has_lj / has_q is 0 skip
// that term (water H sites have no LJ; rows >= 2P have neither).
//
// What bounds it on this card: bytes.  A launch reads the three coordinate
// planes once, C * A_pad * 12 bytes (57 MB at 2048 chains x 2304 lanes),
// and does ~25 operations per (row, lane) pair on them: at 8 live rows or
// fewer that is under the f32 rate's share of the read time.  The design:
// one thread block per chain; the block's threads stride over the lanes
// (neighbouring threads on neighbouring words, so the plane reads
// coalesce), each thread keeps a group of 8 rows' partial sums in registers
// so every coordinate is read from device memory once per group (once in
// all, for R = 8), then one warp-shuffle reduction and one pass over the
// warp partials per group write the (C, R) outputs.  No atomics: a chain's
// rows are owned by one block.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

enum Coulomb { kNone = 0, kEwald = 1, kWolf = 2, kWolfRef = 3, kBare = 4 };

constexpr int kGroup = 8;       // rows summed together in registers
constexpr int kMaxRows = 32;
constexpr int kMaxTypes = 64;

__device__ inline float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void delta_energy_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, long long ld, const float* __restrict__ mx,
    const float* __restrict__ my, const float* __restrict__ mz,
    const float* __restrict__ box_in, const float* __restrict__ eps,
    const float* __restrict__ sig2, const float* __restrict__ q8,
    const int* __restrict__ has_lj, const int* __restrict__ has_q,
    const int* __restrict__ tid_row, const int* __restrict__ molid_row,
    const float* __restrict__ q_row, float* __restrict__ e_lj,
    float* __restrict__ e_coul, float* __restrict__ ovr, int A_pad, int R,
    int T, int m, int coulomb, float rc2, float qrc2, float kappa_l,
    float d2_overlap, float wolf_rc) {
  __shared__ float srx[kMaxRows], sry[kMaxRows], srz[kMaxRows], sq8[kMaxRows];
  __shared__ int slj[kMaxRows], sqf[kMaxRows];
  __shared__ float seps4[kMaxRows * kMaxTypes], ssig2[kMaxRows * kMaxTypes];
  __shared__ float sred[32 * 3 * kGroup];  // per-warp partials

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  for (int r = tid; r < R; r += nt) {
    srx[r] = mx[(size_t)c * R + r];
    sry[r] = my[(size_t)c * R + r];
    srz[r] = mz[(size_t)c * R + r];
    sq8[r] = q8[r];
    slj[r] = has_lj[r];
    sqf[r] = has_q[r] && coulomb != kNone;
  }
  for (int i = tid; i < R * T; i += nt) {
    seps4[i] = 4.0f * eps[i];
    ssig2[i] = sig2[i];
  }
  const float box = box_in[c];
  const float inv_box = 1.0f / box;
  const float kappa = kappa_l * inv_box;
  const float sh_w = coulomb == kWolf ? erfcf(kappa * wolf_rc) / wolf_rc : 0.0f;
  const float* xc = x + (size_t)c * ld;
  const float* yc = y + (size_t)c * ld;
  const float* zc = z + (size_t)c * ld;
  __syncthreads();

  for (int g = 0; g < R; g += kGroup) {
    float a_lj[kGroup], a_q[kGroup], a_o[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) a_lj[r] = a_q[r] = a_o[r] = 0.0f;

    for (int j = tid; j < A_pad; j += nt) {
      const int mj = molid_row[j];
      if (mj < 0 || mj == m) continue;
      const float xj = xc[j], yj = yc[j], zj = zc[j], qj = q_row[j];
      const int tj = tid_row[j];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int row = g + r;
        const bool lj = slj[row] != 0;
        const bool uq = sqf[row] != 0;
        if (!lj && !uq) continue;
        float dx = xj - srx[row], dy = yj - sry[row], dz = zj - srz[row];
        dx -= box * rintf(dx * inv_box);
        dy -= box * rintf(dy * inv_box);
        dz -= box * rintf(dz * inv_box);
        const float d2 = fmaxf(dx * dx + dy * dy + dz * dz, 1e-4f);
        const float inv_r = rsqrtf(d2);
        if (lj && d2 < rc2) {
          const float s2 = ssig2[row * T + tj] * (inv_r * inv_r);
          const float s6 = s2 * s2 * s2;
          a_lj[r] += seps4[row * T + tj] * (s6 * s6 - s6);
        }
        if (uq && d2 < qrc2) {
          const float qq = sq8[row] * qj;
          float cp;
          if (coulomb == kBare)
            cp = qq * inv_r;
          else if (coulomb == kWolf)
            cp = qq * (erfcf(kappa * (d2 * inv_r)) * inv_r - sh_w);
          else
            cp = qq * (erfcf(kappa * (d2 * inv_r)) * inv_r);
          a_q[r] += cp;
          if (d2 < d2_overlap && qq < 0.0f) a_o[r] += 1.0f;
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const float s_lj = warp_sum(a_lj[r]);
      const float s_q = warp_sum(a_q[r]);
      const float s_o = warp_sum(a_o[r]);
      if (lane == 0) {
        sred[(warp * 3 + 0) * kGroup + r] = s_lj;
        sred[(warp * 3 + 1) * kGroup + r] = s_q;
        sred[(warp * 3 + 2) * kGroup + r] = s_o;
      }
    }
    __syncthreads();
    if (tid < 3 * kGroup) {
      const int kind = tid / kGroup, r = tid % kGroup;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += sred[(w * 3 + kind) * kGroup + r];
      float* out = kind == 0 ? e_lj : (kind == 1 ? e_coul : ovr);
      out[(size_t)c * R + g + r] = s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int mmc_delta_max_rows() { return kMaxRows; }
extern "C" int mmc_delta_max_types() { return kMaxTypes; }

extern "C" const char* mmc_delta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one delta-energy evaluation (grid = C chains) on `stream`;
// returns the CUDA error code of the launch (0 on success).  x/y/z are
// (C, A_pad) planes with row stride ld floats; mx/my/mz and the outputs
// are contiguous (C, R); eps/sig2 (R, T); q8/has_lj/has_q (R,);
// tid_row/molid_row/q_row (A_pad,).
extern "C" int mmc_delta_energy_launch(
    const void* x, const void* y, const void* z, long long ld, const void* mx,
    const void* my, const void* mz, const void* box, const void* eps,
    const void* sig2, const void* q8, const void* has_lj, const void* has_q,
    const void* tid_row, const void* molid_row, const void* q_row,
    void* e_lj, void* e_coul, void* ovr, int C, int A_pad, int R, int T,
    int m, int coulomb, int threads, float rc2, float qrc2, float kappa_l,
    float d2_overlap, float wolf_rc, void* stream) {
  if (C < 1 || A_pad < 1 || R < kGroup || R > kMaxRows || R % kGroup != 0 ||
      T < 1 || T > kMaxTypes || threads < 3 * kGroup || threads > 1024 ||
      threads % 32 != 0 || ld < A_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  delta_energy_kernel<<<C, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(z), ld, static_cast<const float*>(mx),
      static_cast<const float*>(my), static_cast<const float*>(mz),
      static_cast<const float*>(box), static_cast<const float*>(eps),
      static_cast<const float*>(sig2), static_cast<const float*>(q8),
      static_cast<const int*>(has_lj), static_cast<const int*>(has_q),
      static_cast<const int*>(tid_row), static_cast<const int*>(molid_row),
      static_cast<const float*>(q_row), static_cast<float*>(e_lj),
      static_cast<float*>(e_coul), static_cast<float*>(ovr), A_pad, R, T, m,
      coulomb, rc2, qrc2, kappa_l, d2_overlap, wolf_rc);
  return static_cast<int>(cudaGetLastError());
}
