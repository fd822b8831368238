// Full-system energy recompute for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package recomputes the full energy in
// plain jnp (metropolismontecarlo_tpu/models/energy.py energy_breakdown,
// vmapped and chunked by its driver).  The port ran the same plain code in
// chunks of a few chains, each writing and re-reading (chains, A, A) pair
// grids through dozens of elementwise launches; this kernel takes the dense
// route's block-end, init, resync and NPT volume-move recomputes instead.
// Reference and plain PyTorch twin: models/energy.py energy_breakdown
// (dense route).
//
// What it computes, one thread block per chain, all chains in one launch:
// for every unordered pair of sites of different molecules, the minimum
// image in the chain's own box, d^2 floored at 1e-4, the LJ term (shift
// "none" or "linear") below r_cut^2 and its molecular virial with the
// pair-consistent COM image r_ij = r_ab - (d_a - d_b), and with Ewald the
// real-space erfc(kappa r)/r term below qq_cut^2 with its exact virial
// (force term plus the kappa chain-rule term); the intramolecular
// correction and its kappa derivative; S(k) and the reciprocal virial's
// T_k over the K k-vectors from per-site eik rows, with the reciprocal
// energy and virial summed in the kernel.  Each chain's sums come out as
// eight raw columns (ops/cuda/recompute_kernel.py RAW_COLUMNS) and its
// S(k); the O(C) terms (self energy, LJ tail) and the scale factors are
// applied by the wrapper.
//
// What bounds it on this card: instruction issue, not bytes.  A chain
// reads its atoms once (27 KB at 750 SPC/E waters) and writes 2.7 KB of
// S(k), but it makes A (A - 1) / 2 site distances (2.5 million at 2250
// atoms) and evaluates LJ and erfc terms for the ~19% inside the cutoff.
// The design:
// - No pair grid leaves the chip: the atom planes, per-atom tables and
//   COM rows of the chain live in shared memory, every pair term in
//   registers, and each thread keeps its own partial sums.
// - Balanced pair rows: row i pairs atom i with the next (A - 1) / 2
//   atoms cyclically (one more for i < A / 2 when A is even), which covers
//   every unordered pair once with rows of equal length; warp w takes rows
//   w, w + 8, ..., its lanes 32 consecutive columns, conflict-free.
// - Live terms through the warp queues of mmc_common.cuh: a lane whose
//   pair lies inside a cutoff appends (column, row) and d^2 to its warp's
//   ring, and every 32 entries are evaluated by the full warp, so the LJ
//   and erfc bodies run on full warps instead of one lane in five.
// - k-space in tiles of sites: each tile's eik rows (the header's
//   eik_row, the rows the Gibbs and flip kernels carry S(k) with) are
//   built once into the queues' shared memory, then each thread sums its
//   two k-vectors over the tile's charged sites.
// - Deterministic reduction: a chain's sums depend only on its own
//   atoms, in a fixed order (lanes, warps in order, tiles in order), never
//   on the grid, the batch or atomics; a chain's result is bit-equal
//   alone, in a shard or in the full batch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mmc_common.cuh"

namespace {

constexpr float kTwoOverRtPi = 1.1283791670955126f;  // 2 / sqrt(pi)
// Raw sums per chain: LJ energy and virial, real-space Coulomb energy and
// virial, the intramolecular erf sum and Gaussian sum, the reciprocal
// sum of cfac |S|^2 and of cfac Im(conj(S) T).
constexpr int kOut = 8;
// A per-atom info word: bit 0 LJ site, bit 1 charged (Coulomb on), the LJ
// type from kInfoType (kMaxTypes), the molecule from kInfoMol.
constexpr int kInfoType = 2, kInfoMol = 7, kMaxTypes = 32;
// A live pair's queue key: column j in the low kKeyRow bits, row i above.
constexpr int kKeyRow = 12;
constexpr int kMaxAtoms = 1 << kKeyRow;
constexpr int kMaxNk = 127;  // the packed k indices hold 8 bits an axis
// Shared words of the region that holds the warp queues during the pair
// pass and a tile of eik rows during the k-space pass.
constexpr int kRegionWords = 4096;
constexpr int kMaxTile = 64;

// Sites per eik tile: each site 3 rows of 2 nk + 1 complex and 4 words
// of scaled COM offset.
__host__ __device__ inline int recompute_tile(int nk) {
  const int per_site = 6 * (2 * nk + 1) + 4;
  const int n = kRegionWords / per_site;
  return n < kMaxTile ? n : kMaxTile;
}

// Shared-memory words of one block: x, y, z and info rows (A, rounded up
// to 4), the COM planes (M, rounded up to 4), the region, the 4 (T, T)
// LJ tables and the warps' partial sums (mmc_recompute_smem_bytes reports
// it to ops/cuda/recompute_kernel.py occupancy).
__host__ __device__ inline size_t recompute_smem_floats(int A, int M,
                                                        int T) {
  const size_t A4 = (A + 3) & ~3, M4 = (M + 3) & ~3;
  return 4 * A4 + 3 * M4 + kRegionWords + 4 * (size_t)T * T + kWarps * kOut;
}

template <bool kEwald, bool kLinear>
__global__ void __launch_bounds__(kThreads, kMinBlocks) recompute_kernel(
    const float* __restrict__ coords, const float* __restrict__ com,
    const float* __restrict__ box_in, const int* __restrict__ info,
    const float* __restrict__ q_row, const float* __restrict__ ljt,
    const float* __restrict__ kvec, const float* __restrict__ kw,
    float* __restrict__ out, float* __restrict__ sfac_out, int A, int A_pad,
    int M, int T, int K, int nk, float rc2, float qrc2, float kappa_l,
    float factor) {
  extern __shared__ float smem[];
  const int A4 = (A + 3) & ~3, M4 = (M + 3) & ~3;
  float* sx = smem;
  float* sy = sx + A4;
  float* sz = sy + A4;
  int* sinfo = reinterpret_cast<int*>(sz + A4);
  float* scx = reinterpret_cast<float*>(sinfo + A4);
  float* scy = scx + M4;
  float* scz = scy + M4;
  float* region = scz + M4;  // 16-byte aligned: every row above is 4k words
  float* seps = region + kRegionWords;  // 4 eps, (T, T)
  float* ssig2 = seps + T * T;
  float* slam1 = ssig2 + T * T;
  float* slam2 = slam1 + T * T;
  float* sred = slam2 + T * T;  // (kWarps, kOut)

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int nt = kThreads;

  const float* cin = coords + (size_t)c * 3 * A_pad;
  for (int j = tid; j < A; j += nt) {
    sx[j] = cin[j];
    sy[j] = cin[A_pad + j];
    sz[j] = cin[2 * A_pad + j];
    sinfo[j] = info[j];
  }
  const float* cm = com + (size_t)c * 3 * M;
  for (int m = tid; m < M; m += nt) {
    scx[m] = cm[3 * m];
    scy[m] = cm[3 * m + 1];
    scz[m] = cm[3 * m + 2];
  }
  for (int i = tid; i < T * T; i += nt) {
    seps[i] = 4.0f * ljt[i];
    ssig2[i] = ljt[T * T + i];
    slam1[i] = ljt[2 * T * T + i];
    slam2[i] = ljt[3 * T * T + i];
  }
  __syncthreads();

  const float box = box_in[c];
  const float inv_box = 1.0f / box;
  const float kappa = kappa_l * inv_box;
  const float ck = kTwoOverRtPi * kappa;
  // the minimum image of one component, rounded as the sweep kernel's
  auto image = [&](float d) -> float {
    return d - box * round_near(d * inv_box);
  };
  // atom i's minimum-imaged offset from its molecule's COM
  auto offset = [&](int i, float& ox, float& oy, float& oz) {
    const int m = sinfo[i] >> kInfoMol;
    ox = image(sx[i] - scx[m]);
    oy = image(sy[i] - scy[m]);
    oz = image(sz[i] - scz[m]);
  };

  // ---- pair pass: distances on every lane, live terms through queues ----
  float e_lj = 0.0f, w_lj = 0.0f, e_q = 0.0f, w_q = 0.0f;
  // One live pair (row i, column j) at d2: its LJ and Coulomb terms into
  // the lane's sums.
  auto term = [&](int key, float d2) {
    const int i = key >> kKeyRow, j = key & (kMaxAtoms - 1);
    const float dx = image(sx[i] - sx[j]);
    const float dy = image(sy[i] - sy[j]);
    const float dz = image(sz[i] - sz[j]);
    float oix, oiy, oiz, ojx, ojy, ojz;
    offset(i, oix, oiy, oiz);
    offset(j, ojx, ojy, ojz);
    const float dot = (dx - oix + ojx) * dx + (dy - oiy + ojy) * dy +
                      (dz - oiz + ojz) * dz;
    const int ii = sinfo[i], ij = sinfo[j], both = ii & ij;
    const float inv_r = rsqrtf(d2);
    const float inv_d2 = inv_r * inv_r;
    if ((both & 1) && d2 < rc2) {
      const int p = ((ii >> kInfoType) & (kMaxTypes - 1)) * T +
                    ((ij >> kInfoType) & (kMaxTypes - 1));
      const float s2 = ssig2[p] * inv_d2;
      const float s6 = s2 * s2 * s2;
      float pot = seps[p] * (s6 * s6 - s6);
      float wv = 6.0f * seps[p] * (2.0f * s6 * s6 - s6);
      if (kLinear) {
        const float r = sqrtf(d2);
        pot += slam1[p] + slam2[p] * r;
        wv -= slam2[p] * r;
      }
      e_lj += pot;
      w_lj += wv * (dot * inv_d2);
    }
    if (kEwald && (both & 2) && d2 < qrc2) {
      const float qq = (factor * __ldg(q_row + i)) * __ldg(q_row + j);
      const float r = d2 * inv_r;
      const float erfc = erfcf(kappa * r);
      const float gauss = expf(-(kappa * kappa) * d2);
      e_q += qq * (erfc * inv_r);
      w_q += qq * (dot * (erfc * inv_r * inv_d2 + ck * gauss * inv_d2) -
                   ck * gauss);
    }
  };
  {
    int* qkey = reinterpret_cast<int*>(region);
    float* qd2 = region + kWarps * kQueue;
    Queue q{qkey + warp * kQueue, qd2 + warp * kQueue, 0, 0};
    const int H = (A - 1) / 2;
    const bool even = (A & 1) == 0;
    for (int i = warp; i < A; i += kWarps) {
      const float xi = sx[i], yi = sy[i], zi = sz[i];
      const int ii = sinfo[i];
      const int hi = H + ((even && i < A / 2) ? 1 : 0);
      for (int o0 = 1; o0 <= hi; o0 += 32) {
        const int o = o0 + lane;
        bool live = false;
        float d2 = 0.0f;
        int key = 0;
        if (o <= hi) {
          int j = i + o;
          if (j >= A) j -= A;
          const float dx = image(xi - sx[j]);
          const float dy = image(yi - sy[j]);
          const float dz = image(zi - sz[j]);
          d2 = fmaxf(dx * dx + dy * dy + dz * dz, 1e-4f);
          const int ij = sinfo[j], both = ii & ij;
          live = (ij >> kInfoMol) != (ii >> kInfoMol) &&
                 (((both & 1) && d2 < rc2) || ((both & 2) && d2 < qrc2));
          key = j | (i << kKeyRow);
        }
        q.push(1, &live, &d2, key, lane, term);
      }
    }
    q.drain(lane, term);
  }

  // ---- intramolecular correction: each charged site with the later
  // charged sites of its molecule ----
  float e_in = 0.0f, w_in = 0.0f;
  if (kEwald)
    for (int a = tid; a < A; a += nt) {
      const int ia = sinfo[a];
      if (!(ia & 2)) continue;
      const float qa = factor * __ldg(q_row + a);
      for (int b = a + 1; b < A && (sinfo[b] >> kInfoMol) == (ia >> kInfoMol);
           ++b) {
        if (!(sinfo[b] & 2)) continue;
        const float dx = image(sx[a] - sx[b]);
        const float dy = image(sy[a] - sy[b]);
        const float dz = image(sz[a] - sz[b]);
        const float d2 = fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f);
        const float r = sqrtf(d2);
        const float qq = qa * __ldg(q_row + b);
        e_in += qq * ((1.0f - erfcf(kappa * r)) / r);
        w_in += qq * expf(-(kappa * kappa) * d2);
      }
    }

  // ---- k-space: S(k), T_k and the reciprocal sums ----
  float e_k = 0.0f, w_k = 0.0f;
  if (kEwald) {
    const int W = 2 * nk + 1;
    const int tile = recompute_tile(nk);
    float2* tab = reinterpret_cast<float2*>(region);  // (tile, 3, W)
    float* soff = region + 6 * W * tile;               // (tile, 4)
    const float tpl = kTwoPi * inv_box;
    const float vol = box * box * box;
    for (int kb = 0; kb < K; kb += 2 * nt) {
      int idx[2];
      float kx[2], ky[2], kz[2], sre[2], sim[2], tre[2], tim[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = kb + tid + j * nt;
        kx[j] = ky[j] = kz[j] = 0.0f;
        if (k < K) {
          kx[j] = kvec[3 * k];
          ky[j] = kvec[3 * k + 1];
          kz[j] = kvec[3 * k + 2];
        }
        idx[j] = ((int)rintf(kx[j]) + nk) | ((int)rintf(ky[j]) + nk) << 8 |
                 ((int)rintf(kz[j]) + nk) << 16;
        sre[j] = sim[j] = tre[j] = tim[j] = 0.0f;
      }
      for (int a0 = 0; a0 < A; a0 += tile) {
        const int n = min(tile, A - a0);
        __syncthreads();  // the queues' or the last tile's readers are done
        for (int r = tid; r < 3 * n; r += nt) {
          const int s = r / 3, axis = r - 3 * s, a = a0 + s;
          if (!(sinfo[a] & 2)) continue;
          const float x = axis == 0 ? sx[a] : (axis == 1 ? sy[a] : sz[a]);
          eik_row(tab + (3 * s + axis) * W, nk, x, inv_box,
                  axis == 0 ? __ldg(q_row + a) : 1.0f);
        }
        for (int s = tid; s < n; s += nt) {
          float ox, oy, oz;
          offset(a0 + s, ox, oy, oz);
          soff[4 * s] = tpl * ox;
          soff[4 * s + 1] = tpl * oy;
          soff[4 * s + 2] = tpl * oz;
        }
        __syncthreads();
        for (int s = 0; s < n; ++s) {
          if (!(sinfo[a0 + s] & 2)) continue;  // block-uniform
          const float2* row = tab + 3 * s * W;
          const float ox = soff[4 * s], oy = soff[4 * s + 1],
                      oz = soff[4 * s + 2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float2 ea = row[idx[j] & 255],
                         eb = row[W + ((idx[j] >> 8) & 255)],
                         eg = row[2 * W + (idx[j] >> 16)];
            const float abx = ea.x * eb.x - ea.y * eb.y,
                        aby = ea.x * eb.y + ea.y * eb.x;
            const float re = abx * eg.x - aby * eg.y,
                        im = abx * eg.y + aby * eg.x;
            const float kd = kx[j] * ox + ky[j] * oy + kz[j] * oz;
            sre[j] += re;
            sim[j] += im;
            tre[j] += kd * re;
            tim[j] += kd * im;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = kb + tid + j * nt;
        if (k >= K) continue;
        sfac_out[((size_t)c * K + k) * 2] = sre[j];
        sfac_out[((size_t)c * K + k) * 2 + 1] = sim[j];
        const float kt2 =
            tpl * tpl * (kx[j] * kx[j] + ky[j] * ky[j] + kz[j] * kz[j]);
        const float cf = kw[k] * (kTwoPi / vol) *
                         expf(-kt2 / (4.0f * kappa * kappa)) / kt2;
        e_k += cf * (sre[j] * sre[j] + sim[j] * sim[j]);
        w_k += cf * (sre[j] * tim[j] - sim[j] * tre[j]);
      }
    }
  }

  // ---- the chain's sums: lanes, then warps in order ----
  float v[kOut] = {e_lj, w_lj, e_q, w_q, e_in, w_in, e_k, w_k};
#pragma unroll
  for (int t = 0; t < kOut; ++t) v[t] = warp_sum(v[t]);
  if (lane == 0)
#pragma unroll
    for (int t = 0; t < kOut; ++t) sred[warp * kOut + t] = v[t];
  __syncthreads();
  if (tid < kOut) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += sred[w * kOut + tid];
    out[(size_t)c * kOut + tid] = s;
  }
}

using RecomputeKernel = decltype(&recompute_kernel<true, false>);

RecomputeKernel pick_kernel(int ewald, int linear) {
  return ewald ? (linear ? recompute_kernel<true, true>
                         : recompute_kernel<true, false>)
               : (linear ? recompute_kernel<false, true>
                         : recompute_kernel<false, false>);
}

cudaError_t allow_smem(RecomputeKernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" size_t mmc_recompute_smem_bytes(int A, int M, int T) {
  return sizeof(float) * recompute_smem_floats(A, M, T);
}

extern "C" int mmc_recompute_tile(int nk) { return recompute_tile(nk); }

// The instantiation's registers per thread, local memory per thread
// (bytes) and the blocks of this shape one SM holds at once into
// out[0..2]; returns the CUDA error code (0 on success).
extern "C" int mmc_recompute_occupancy(int A, int M, int T, int ewald,
                                       int linear, int* out) {
  const RecomputeKernel kernel = pick_kernel(ewald, linear);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = 0;
  const size_t smem = mmc_recompute_smem_bytes(A, M, T);
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

// Launches the recompute of C chains (grid = C blocks of 256 threads) on
// `stream`; returns the CUDA error code of the launch (0 on success).
// coords (C, 3, A_pad), com (C, M, 3), box (C,), q (A,), ljt (4, T, T) =
// [eps, sigma^2, lam1, lam2] of each type pair, kvec (K, 3) integers as
// f32 and kw (K,) (read with Ewald only) are device f32; info (A,) int32
// (kInfo* bits).  out (C, 8) receives the raw sums, sfac_out (C, K, 2)
// S(k) (with Ewald).
extern "C" int mmc_recompute_launch(const void* coords, const void* com,
                                    const void* box, const void* info,
                                    const void* q, const void* ljt,
                                    const void* kvec, const void* kw,
                                    void* out, void* sfac_out, int C, int A,
                                    int A_pad, int M, int T, int K, int nk,
                                    int ewald, int linear, int threads,
                                    float rc2, float qrc2, float kappa_l,
                                    float factor, void* stream) {
  const size_t smem = mmc_recompute_smem_bytes(A, M, T);
  if (threads != kThreads || C < 1 || A < 1 || A > kMaxAtoms || A > A_pad ||
      M < 1 || M > A || T < 1 || T > kMaxTypes || smem > (size_t)kMaxSmemBytes ||
      (ewald && (K < 1 || nk < 1 || nk > kMaxNk || !kvec || !kw || !sfac_out)))
    return static_cast<int>(cudaErrorInvalidValue);
  const RecomputeKernel kernel = pick_kernel(ewald, linear);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const float*>(com),
      static_cast<const float*>(box), static_cast<const int*>(info),
      static_cast<const float*>(q), static_cast<const float*>(ljt),
      static_cast<const float*>(kvec), static_cast<const float*>(kw),
      static_cast<float*>(out), static_cast<float*>(sfac_out), A, A_pad, M, T,
      ewald ? K : 0, nk, rc2, qrc2, kappa_l, factor);
  return static_cast<int>(cudaGetLastError());
}
