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
// that term (water H sites have no LJ; pad rows have neither).
//
// What bounds it on this card: bytes.  A launch reads the three coordinate
// planes once, C * A_pad * 12 bytes (57 MB at 2048 chains x 2304 lanes,
// 17 us at 3.35 TB/s).  The operations the function needs are few by
// comparison: one distance per lane to the moved rows' centre, the rows'
// distances only for the lanes within their reach (~15% at the mixture's
// density), and the LJ and erfc terms only for the pairs inside the
// cutoff.  This design does not reach the byte bound: its instructions
// per chain (stage 0 ~30%, stage 1 ~25%, stage 2 ~27% of a launch by
// knock-out copies, the rest a block's fixed cost and the launch) keep it
// issue- and latency-bound at ~3.5x.  The design, one block per chain:
// - Prologue: warp 0 places one 16-byte shared row per moved site (x, y, z
//   and its live cutoff^2: rc2 with LJ, qrc2 with charge, the larger with
//   both, 0 for a pad row, which then never queues a term), the centre of
//   the live rows (row 0 plus their mean minimum-image offset from it) and
//   their reach, the largest live cutoff plus the largest centre-to-row
//   distance, widened by 1e-4 relative plus 1e-3 A.  The kernel is not told
//   P: one sphere around the old and the new pose together costs a move
//   ~ (|displacement| / 2) of extra reach, and one centre distance per lane
//   instead of two.  Every thread copies 4 eps and sig^2 of the R rows by
//   neighbour type.
// - Compacted pair sums in three warp stages, each on full warps:
//   (0) one float4 load per plane and lane group (the warp's 32 threads on
//   32 adjacent float4s, so each plane is read once, coalesced; the first
//   group's loads are issued before the prologue), the molecule ids
//   likewise; each of the 4 lanes' distance to the centre, and the lanes
//   within reach (exact: the minimum-image distance obeys the triangle
//   inequality) go with their coordinates to the warp's near ring, a
//   ballot per lane of the group unless the warp's group has none;
//   (1) 32 near lanes at a time, the live rows' distances, 3 rows per step,
//   the (lane, row) pairs inside the row's live cutoff to the warp's queue
//   of live terms (mmc_common.cuh Queue); (2) 32 live terms at a time, LJ
//   and Coulomb and the overlap count.  Partial flushes end the pass.
// - The real-space Coulomb form is a template parameter (none, erfc,
//   shifted erfc, bare): no run-time branch inside a term.
// - Block shape: one chain per block of 128 threads, __launch_bounds__(128,
//   8): 64 registers, no local memory, 8 blocks per SM (21.5 KB of shared
//   memory each at R 8, T 4), so the 2048 chains of the per-move main path
//   run in two waves of 1056.  Measured in turns on an H100 80GB HBM3 at
//   700 W (PERF.md §6): 59 us per launch against 62-63 at 128 threads with
//   66 registers, 66 at
//   256 threads with 64 registers and 73-74 at 256 threads with 66 (3
//   blocks per SM); staging the planes in shared memory by cp.async (80
//   us: half the blocks per SM), a persistent grid (64) and an interleaved
//   final sum (63) were slower.
// - Per-row sums without run-time indexed registers: a term adds into its
//   thread's own column of a shared (3, R, threads) array of partials, and
//   after one barrier each warp sums whole columns of it, in a fixed lane
//   order, into the chain's (C, R) outputs.  No atomics: the sums, and so
//   a launch's outputs, depend only on the inputs, and one block writes a
//   chain's outputs.
// The distances inside the cutoff tests are rounded step by step (the _rn
// intrinsics) as the plain version's tensor operations round them, with
// the minimum image rounded to nearest, ties to even (round_near): a pair
// at the cutoff is inside for both or for neither.
//
// The planes are read as float4: their base and row stride must be 16-byte
// aligned, A_pad a multiple of 4 (every plane the port builds is: A_pad is
// a multiple of 128), and the molecule-id row aligned likewise; the
// launcher refuses other planes.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mmc_common.cuh"

namespace {

constexpr int kMaxRows = 32;   // a row's index fits the key's site field
constexpr int kMaxTypes = 64;
// One block per chain: 128 threads, registers capped for 8 blocks per SM.
constexpr int kDeltaThreads = 128;
constexpr int kDeltaBlocks = 8;
// A warp's ring of lanes within the rows' reach: x, y, z and the lane's
// column (its bits in the fourth word).  Four appends of at most 32 lanes
// each per float4 group, flushed at 32: 31 left over plus 32 fit.
constexpr int kNearRing = 64;

// Shared-memory words of one block of `threads` threads: the R rows and
// the centre (16-byte rows), the warps' near rings, the row charges and
// flags, the 4 eps and sig^2 tables (R, T), the warps' term queues and the
// (3, R, threads) partials.
size_t smem_words(int R, int T, int threads) {
  const int nw = threads / 32;
  return 4 * (size_t)(kMaxRows + 1) + 4 * (size_t)nw * kNearRing +
         2 * (size_t)kMaxRows + 2 * (size_t)R * T + 2 * (size_t)nw * kQueue +
         3 * (size_t)R * threads;
}

// The warp's sum, in every lane.
__device__ __forceinline__ float warp_sum_all(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Minimum-image d^2 of a pair, floored at 1e-4, rounded operation by
// operation as delta_energy_plain computes it: (x_j - x_r), minus box times
// the rounded (difference / box); then x^2 + y^2, + z^2.
__device__ __forceinline__ float pair_d2(float xj, float yj, float zj,
                                         float ax, float ay, float az,
                                         float box, float inv_box) {
  float dx = __fsub_rn(xj, ax), dy = __fsub_rn(yj, ay), dz = __fsub_rn(zj, az);
  dx = __fsub_rn(dx, __fmul_rn(box, round_near(__fmul_rn(dx, inv_box))));
  dy = __fsub_rn(dy, __fmul_rn(box, round_near(__fmul_rn(dy, inv_box))));
  dz = __fsub_rn(dz, __fmul_rn(box, round_near(__fmul_rn(dz, inv_box))));
  return fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                         __fmul_rn(dz, dz)),
               1e-4f);
}

template <int kQ>
__global__ void __launch_bounds__(kDeltaThreads, kDeltaBlocks)
    delta_energy_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, long long ld, const float* __restrict__ mx,
    const float* __restrict__ my, const float* __restrict__ mz,
    const float* __restrict__ box_in, const float* __restrict__ eps,
    const float* __restrict__ sig2, const float* __restrict__ q8,
    const int* __restrict__ has_lj, const int* __restrict__ has_q,
    const int* __restrict__ tid_row, const int* __restrict__ molid_row,
    const float* __restrict__ q_row, float* __restrict__ e_lj,
    float* __restrict__ e_coul, float* __restrict__ ovr, int A_pad, int R,
    int T, int m, float rc2, float qrc2, float kappa_l, float d2_overlap,
    float wolf_rc) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  float4* srow = smem4;                       // R rows: x, y, z, cutoff^2
  float4* sgeo = smem4 + kMaxRows;            // centre, reach^2
  float4* snear = sgeo + 1;                   // nw x kNearRing
  float* sq8 = reinterpret_cast<float*>(snear + (size_t)nw * kNearRing);
  int* sflag = reinterpret_cast<int*>(sq8 + kMaxRows);  // 1: LJ, 2: charge
  float* seps = reinterpret_cast<float*>(sflag + kMaxRows);  // (R, T) 4 eps
  float* ssig2 = seps + R * T;
  int* qkey = reinterpret_cast<int*>(ssig2 + R * T);    // nw x kQueue
  float* qd2 = reinterpret_cast<float*>(qkey + nw * kQueue);
  float* sacc = qd2 + nw * kQueue;            // (3, R, nt) partials
  float* acc = sacc + tid;                    // this thread's column

  const float box = box_in[c];
  const float inv_box = 1.0f / box;
  const float kappa = kappa_l * inv_box;
  float sh_w = 0.0f;
  if (kQ == kQWolf) sh_w = erfcf(kappa * wolf_rc) / wolf_rc;

  // this thread's first lane group: loads issued before the prologue
  const float4* xc = reinterpret_cast<const float4*>(x + (size_t)c * ld);
  const float4* yc = reinterpret_cast<const float4*>(y + (size_t)c * ld);
  const float4* zc = reinterpret_cast<const float4*>(z + (size_t)c * ld);
  const int4* mol4 = reinterpret_cast<const int4*>(molid_row);
  const int n4 = A_pad >> 2;
  float4 gx, gy, gz;
  int4 gm;
  auto load = [&](int i) {
    gx = gy = gz = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    gm = make_int4(-1, -1, -1, -1);
    if (i < n4) {
      gx = __ldg(xc + i);
      gy = __ldg(yc + i);
      gz = __ldg(zc + i);
      gm = __ldg(mol4 + i);
    }
  };
  const int i_first = warp * 32 + lane;
  load(i_first);

  for (int i = 0; i < 3 * R; ++i) acc[(size_t)i * nt] = 0.0f;
  for (int i = tid; i < R * T; i += nt) {
    seps[i] = 4.0f * eps[i];
    ssig2[i] = sig2[i];
  }
  if (warp == 0) {
    const int r = lane;
    float rx = 0.0f, ry = 0.0f, rz = 0.0f, cut = 0.0f;
    if (r < R) {
      rx = mx[(size_t)c * R + r];
      ry = my[(size_t)c * R + r];
      rz = mz[(size_t)c * R + r];
      const bool lj = has_lj[r] != 0;
      const bool uq = kQ != kQNone && has_q[r] != 0;
      cut = fmaxf(lj ? rc2 : 0.0f, uq ? qrc2 : 0.0f);
      srow[r] = make_float4(rx, ry, rz, cut);
      sq8[r] = q8[r];
      sflag[r] = (lj ? 1 : 0) | (uq ? 2 : 0);
    }
    const bool live = cut > 0.0f;
    // the live rows' centre: row 0 plus their mean minimum-image offset
    // from it (a molecule split by the boundary stays whole)
    const float x0 = __shfl_sync(kFull, rx, 0);
    const float y0 = __shfl_sync(kFull, ry, 0);
    const float z0 = __shfl_sync(kFull, rz, 0);
    float ox = rx - x0, oy = ry - y0, oz = rz - z0;
    ox -= box * round_near(ox * inv_box);
    oy -= box * round_near(oy * inv_box);
    oz -= box * round_near(oz * inv_box);
    const float n = warp_sum_all(live ? 1.0f : 0.0f);
    const float inv_n = 1.0f / fmaxf(n, 1.0f);
    const float cx = x0 + warp_sum_all(live ? ox : 0.0f) * inv_n;
    const float cy = y0 + warp_sum_all(live ? oy : 0.0f) * inv_n;
    const float cz = z0 + warp_sum_all(live ? oz : 0.0f) * inv_n;
    const float rad2 = warp_max_all(
        live ? pair_d2(rx, ry, rz, cx, cy, cz, box, inv_box) : 0.0f);
    const float cut_max = warp_max_all(cut);
    if (lane == 0) {
      const float reach = (sqrtf(cut_max) + sqrtf(rad2)) * 1.0001f + 1e-3f;
      // no live row: a zero reach admits no lane (d^2 >= 1e-4)
      sgeo[0] = make_float4(cx, cy, cz, n > 0.0f ? reach * reach : 0.0f);
    }
  }
  __syncthreads();
  const float4 geo = sgeo[0];
  // rows [0, n_rows) hold every live row
  int n_rows = 0;
  for (int r = R - 1; r >= 0; --r)
    if (srow[r].w > 0.0f) {
      n_rows = r + 1;
      break;
    }

  // ---- stage 2: one live term into this thread's partials ----
  auto term = [&](int key, float d2) {
    const int j = key & (kMaxColumns - 1);
    const int r = key >> kKeySite;
    const int f = sflag[r];
    const float inv_r = rsqrtf(d2);
    if ((f & 1) && d2 < rc2) {
      const int tj = __ldg(tid_row + j);
      const float s2 = ssig2[r * T + tj] * (inv_r * inv_r);
      const float s6 = s2 * s2 * s2;
      acc[(size_t)r * nt] += seps[r * T + tj] * (s6 * s6 - s6);
    }
    if (kQ != kQNone && (f & 2) && d2 < qrc2) {
      const float qq = sq8[r] * __ldg(q_row + j);
      float cp;
      if (kQ == kQBare)
        cp = qq * inv_r;
      else if (kQ == kQWolf)
        cp = qq * (erfcf(kappa * (d2 * inv_r)) * inv_r - sh_w);
      else
        cp = qq * (erfcf(kappa * (d2 * inv_r)) * inv_r);
      acc[(size_t)(R + r) * nt] += cp;
      if (d2 < d2_overlap && qq < 0.0f) acc[(size_t)(2 * R + r) * nt] += 1.0f;
    }
  };

  // ---- stage 1: the n (<= 32, warp-uniform) oldest near lanes ----
  Queue q{qkey + warp * kQueue, qd2 + warp * kQueue, 0, 0};
  float4* ring = snear + (size_t)warp * kNearRing;
  int near_head = 0, near_tail = 0;
  auto near_flush = [&](int n) {
    __syncwarp();
    const bool ok = lane < n;
    const float4 a = ok ? ring[(near_head + lane) & (kNearRing - 1)]
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    near_head += n;
    __syncwarp();
    const int j = __float_as_int(a.w);
    for (int p0 = 0; p0 < n_rows; p0 += kChunk) {
      bool live[kChunk];
      float d2[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        live[k] = false;
        d2[k] = 0.0f;
        if (ok && p0 + k < n_rows) {
          const float4 s = srow[p0 + k];
          d2[k] = pair_d2(a.x, a.y, a.z, s.x, s.y, s.z, box, inv_box);
          live[k] = d2[k] < s.w;
        }
      }
      q.push(n_rows - p0, live, d2, j | p0 << kKeySite, lane, term);
    }
  };
  // ---- stage 0: a lane of the lane group; near lanes to the ring ----
  // the distance to the centre, whose test has its margin: any rounding
  auto near = [&](float xj, float yj, float zj, int mj) -> bool {
    float dx = xj - geo.x, dy = yj - geo.y, dz = zj - geo.z;
    dx -= box * round_near(dx * inv_box);
    dy -= box * round_near(dy * inv_box);
    dz -= box * round_near(dz * inv_box);
    return mj >= 0 && mj != m && dx * dx + dy * dy + dz * dz < geo.w;
  };
  auto append = [&](bool in, float xj, float yj, float zj, int j) {
    const unsigned bal = __ballot_sync(kFull, in);
    if (!bal) return;
    if (in)
      ring[(near_tail + __popc(bal & lanes_below)) & (kNearRing - 1)] =
          make_float4(xj, yj, zj, __int_as_float(j));
    near_tail += __popc(bal);
    if (near_tail - near_head >= 32) near_flush(32);
  };
  auto group = [&](float4 ax, float4 ay, float4 az, int4 am, int j) {
    const bool n0 = near(ax.x, ay.x, az.x, am.x);
    const bool n1 = near(ax.y, ay.y, az.y, am.y);
    const bool n2 = near(ax.z, ay.z, az.z, am.z);
    const bool n3 = near(ax.w, ay.w, az.w, am.w);
    if (!__any_sync(kFull, n0 || n1 || n2 || n3)) return;
    append(n0, ax.x, ay.x, az.x, j);
    append(n1, ax.y, ay.y, az.y, j + 1);
    append(n2, ax.z, ay.z, az.z, j + 2);
    append(n3, ax.w, ay.w, az.w, j + 3);
  };
  for (int i = i_first; i - lane < n4; i += nt) {
    group(gx, gy, gz, gm, 4 * i);
    load(i + nt);
  }
  if (near_tail > near_head) near_flush(near_tail - near_head);
  q.drain(lane, term);
  __syncthreads();

  // ---- the (3, R) sums: whole columns of partials, a fixed order ----
  for (int o = warp; o < 3 * R; o += nw) {
    const float* col = sacc + (size_t)o * nt;
    float s = 0.0f;
    for (int t = lane; t < nt; t += 32) s += col[t];
    s = warp_sum(s);
    if (lane == 0) {
      const int kind = o / R, r = o - kind * R;
      float* out = kind == 0 ? e_lj : (kind == 1 ? e_coul : ovr);
      out[(size_t)c * R + r] = s;
    }
  }
}

using DeltaKernel = decltype(&delta_energy_kernel<kQNone>);

DeltaKernel pick_kernel(int coulomb) {
  switch (coulomb) {
    case kNone: return delta_energy_kernel<kQNone>;
    case kWolf: return delta_energy_kernel<kQWolf>;
    case kBare: return delta_energy_kernel<kQBare>;
    default: return delta_energy_kernel<kQErfc>;  // ewald, wolf_ref
  }
}

}  // namespace

extern "C" int mmc_delta_max_rows() { return kMaxRows; }
extern "C" int mmc_delta_max_types() { return kMaxTypes; }

extern "C" size_t mmc_delta_smem_bytes(int R, int T, int threads) {
  return 4 * smem_words(R, T, threads);
}

// Lets every instantiation take up to kMaxSmemBytes of dynamic shared
// memory; called once when the library is loaded (never during a CUDA
// graph capture).  Returns the CUDA error code (0 on success).
extern "C" int mmc_delta_init() {
  const int codes[] = {kNone, kEwald, kWolf, kBare};
  for (int coulomb : codes) {
    const cudaError_t e = cudaFuncSetAttribute(
        pick_kernel(coulomb), cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// out[0] registers, out[1] local memory bytes, out[2] blocks per SM of the
// instantiation for `coulomb` at (R, T, threads); returns the CUDA error
// code (0 on success).
extern "C" int mmc_delta_occupancy(int coulomb, int R, int T, int threads,
                                   int* out) {
  const DeltaKernel kernel = pick_kernel(coulomb);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, threads, mmc_delta_smem_bytes(R, T, threads));
  return static_cast<int>(e);
}

extern "C" const char* mmc_delta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one delta-energy evaluation (grid = C chains of `threads`
// threads, a multiple of 32 up to 128) on `stream`; returns the CUDA error
// code of the launch (0 on success; cudaErrorMisalignedAddress for planes
// that are not 16-byte aligned).  x/y/z are (C, A_pad) planes with row
// stride ld floats; mx/my/mz and the outputs are contiguous (C, R);
// eps/sig2 (R, T); q8/has_lj/has_q (R,); tid_row/molid_row/q_row (A_pad,).
extern "C" int mmc_delta_energy_launch(
    const void* x, const void* y, const void* z, long long ld, const void* mx,
    const void* my, const void* mz, const void* box, const void* eps,
    const void* sig2, const void* q8, const void* has_lj, const void* has_q,
    const void* tid_row, const void* molid_row, const void* q_row,
    void* e_lj, void* e_coul, void* ovr, int C, int A_pad, int R, int T,
    int m, int coulomb, int threads, float rc2, float qrc2, float kappa_l,
    float d2_overlap, float wolf_rc, void* stream) {
  if (C < 1 || A_pad < 4 || A_pad >= kMaxColumns || R < 1 || R > kMaxRows ||
      T < 1 || T > kMaxTypes || threads < 32 || threads > kDeltaThreads ||
      threads % 32 != 0 || ld < A_pad || coulomb < kNone || coulomb > kBare)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(z) |
                          reinterpret_cast<uintptr_t>(molid_row);
  if (bases % 16 != 0 || ld % 4 != 0 || A_pad % 4 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = mmc_delta_smem_bytes(R, T, threads);
  if (smem > (size_t)kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeltaKernel kernel = pick_kernel(coulomb);
  kernel<<<C, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(z), ld, static_cast<const float*>(mx),
      static_cast<const float*>(my), static_cast<const float*>(mz),
      static_cast<const float*>(box), static_cast<const float*>(eps),
      static_cast<const float*>(sig2), static_cast<const float*>(q8),
      static_cast<const int*>(has_lj), static_cast<const int*>(has_q),
      static_cast<const int*>(tid_row), static_cast<const int*>(molid_row),
      static_cast<const float*>(q_row), static_cast<float*>(e_lj),
      static_cast<float*>(e_coul), static_cast<float*>(ovr), A_pad, R, T, m,
      rc2, qrc2, kappa_l, d2_overlap, wolf_rc);
  return static_cast<int>(cudaGetLastError());
}
