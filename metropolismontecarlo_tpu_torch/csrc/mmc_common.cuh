// Device code shared by the hand-written kernels of this directory
// (sweep_kernel.cu, gibbs_kernel.cu, flip_kernel.cu): the block shape, the
// Coulomb codes, rounding on the FMA pipe, warp reductions, the Philox
// deletion scores, the quaternion rotation, the per-site eik rows of the
// k-space sums and the warp queues of live pair terms.  The kernels' pair
// and k-space terms go through this one copy, so they round alike.
// ops/cuda/build.py hashes this header with each kernel's source.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// RunParams.coulomb as the launchers pass it (ops/cuda/sweep_kernel.py
// COULOMB_CODES).
enum Coulomb { kNone = 0, kEwald = 1, kWolf = 2, kWolfRef = 3, kBare = 4 };
// The real-space Coulomb form of a pair term (a template parameter of the
// Gibbs and flip kernels): none, erfc (ewald, wolf_ref), the shifted erfc
// (wolf) or bare.
enum PairQ { kQNone = 0, kQErfc = 1, kQWolf = 2, kQBare = 3 };
// Where a chain's state lives (ops/cuda/*.py LAYOUTS, in this order): all
// of it in shared memory; the rows that grow with atoms and slots in
// global memory; those and the k rows too.  Only where the words live
// differs: the arithmetic, lane order and reduction order are the same.
enum Layout { kShared = 0, kGlobal = 1, kGlobalK = 2 };

constexpr float kTwoPi = 6.283185307179586f;
constexpr int kMaxSmemBytes = 232448;
constexpr int kThreads = 256;  // one block per chain
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // blocks per SM the registers are capped for
// The same for the global-layout instantiations: their 64-bit row
// pointers spill under the three-block cap, and the states they serve
// fill most of a block's shared memory (one or two blocks per SM) or run
// fewer chains than the card has SMs.
constexpr int kMinBlocksGlobal = 2;
constexpr unsigned kFull = 0xffffffffu;
// A warp's ring of live pair terms: kQueue entries of a key and a d^2.  The
// key's low kKeySite bits hold the plane column and the bits above it the
// site, the pose's sign and the overlap veto (each kernel places those).
// Triples are appended kChunk sites at a time (at most 32 kChunk entries),
// so 31 left over plus a chunk fit the ring.
constexpr int kQueue = 128;
constexpr int kChunk = 3;
constexpr int kQueueWords = 2 * kWarps * kQueue;
constexpr int kKeySite = 20;
constexpr int kMaxColumns = 1 << kKeySite;

// rintf(t) for |t| < 2^22 on the FMA pipe: adding and subtracting
// 1.5 * 2^23 rounds to the nearest integer, ties to even, as rintf does
// (a zero comes out +0).
__device__ __forceinline__ float round_near(float t) {
  return __fsub_rn(__fadd_rn(t, 12582912.0f), 12582912.0f);
}

// The warp's sum, in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// The warp's maximum, in every lane.
__device__ __forceinline__ float warp_max_all(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// First output word of Philox4x32-10 (Salmon et al., SC 2011) for counter
// (c0, c1, 0, 0) and key (k0, k1): the deletion and pick scores.
__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1,
                                                uint32_t k0, uint32_t k1) {
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

// R(q) b, the same expansion as the TPU kernels' _rot_apply.
__device__ __forceinline__ void rot_apply(float w, float x, float y, float z,
                                          float bx, float by, float bz,
                                          float* o) {
  const float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  o[0] = (ww + xx - yy - zz) * bx + 2.0f * ((xy - wz) * by + (xz + wy) * bz);
  o[1] = (ww - xx + yy - zz) * by + 2.0f * ((xy + wz) * bx + (yz - wx) * bz);
  o[2] = (ww - xx - yy + zz) * bz + 2.0f * ((xz - wy) * bx + (yz + wx) * by);
}

// sin and cos of 2 pi t, t reduced to [-1/2, 1/2] first.
__device__ __forceinline__ void sincos_turns(float t, float* s, float* c) {
  sincospif(2.0f * (t - round_near(t)), s, c);
}

// One eik row: q e^{i n theta} at index nk + n and its conjugate at nk - n,
// n = 0..nk, theta = 2 pi x inv, by the recurrence e^{i n theta} =
// e^{i (n - 1) theta} e^{i theta} (nk products; the rounding grows as n
// ulp, below the f32 rounding of the phase itself at |n| <= nk).
__device__ __forceinline__ void eik_row(float2* row, int nk, float x,
                                        float inv, float q) {
  float s1, c1;
  sincos_turns(x * inv, &s1, &c1);
  float re = q, im = 0.0f;
  row[nk] = make_float2(re, im);
  for (int n = 1; n <= nk; ++n) {
    const float r = re * c1 - im * s1;
    im = re * s1 + im * c1;
    re = r;
    row[nk + n] = make_float2(re, im);
    row[nk - n] = make_float2(re, -im);
  }
}

// One charged site's phase factors at two k-vectors, added into dre/dim:
// `row` holds the site's eik rows x, y and z of W = 2 nk + 1 entries each,
// idx0/idx1 the k-vectors' packed indices (n_x + nk) | (n_y + nk) << 8 |
// (n_z + nk) << 16.  Two complex products per k-vector; the two chains of
// loads and products are independent.
__device__ __forceinline__ void eik_add2(const float2* row, int W, int idx0,
                                         int idx1, float* dre, float* dim) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = j ? idx1 : idx0;
    const float2 a = row[idx & 255], b = row[W + ((idx >> 8) & 255)],
                 g = row[2 * W + (idx >> 16)];
    const float abx = a.x * b.x - a.y * b.y, aby = a.x * b.y + a.y * b.x;
    dre[j] += abx * g.x - aby * g.y;
    dim[j] += abx * g.y + aby * g.x;
  }
}

// A warp's ring of live pair terms (head and tail are warp-uniform).  The
// caller's term(key, d2) evaluates one entry and adds it to its sums.
struct Queue {
  int* key;
  float* d2;
  int head;
  int tail;

  // the n (<= 32, warp-uniform) oldest entries, one per lane
  template <class Term>
  __device__ __forceinline__ void flush(int n, int lane, Term&& term) {
    __syncwarp();
    if (lane < n) {
      const int s = (head + lane) & (kQueue - 1);
      term(key[s], d2[s]);
    }
    head += n;
    __syncwarp();
  }

  // the lanes' live triples of sites p0 + k, k < min(n, kChunk) (key:
  // key0 with site p0), appended site by site in lane order; every 32
  // queued are evaluated at once
  template <class Term>
  __device__ __forceinline__ void push(int n, const bool* live,
                                       const float* dd, int key0, int lane,
                                       Term&& term) {
    unsigned bal[kChunk], any = 0u;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      bal[k] = k < n ? __ballot_sync(kFull, live[k]) : 0u;
      any |= bal[k];
    }
    if (!any) return;
    const unsigned lanes_below = (1u << lane) - 1u;
    int before = tail;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < n && live[k]) {
        const int s = (before + __popc(bal[k] & lanes_below)) & (kQueue - 1);
        key[s] = key0 + (k << kKeySite);
        d2[s] = dd[k];
      }
      before += __popc(bal[k]);
    }
    tail = before;
    while (tail - head >= 32) flush(32, lane, term);
  }

  // every entry left
  template <class Term>
  __device__ __forceinline__ void drain(int lane, Term&& term) {
    if (tail > head) flush(tail - head, lane, term);
  }
};

}  // namespace
