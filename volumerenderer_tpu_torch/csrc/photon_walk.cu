// The photon walk for Hopper (sm_90a): every window of every photon of a
// generate_lights call in one launch, with no host read.
//
// Replaces no TPU kernel: the JAX package's walk (volumerenderer_tpu/render/
// photon.py) is plain XLA.  It was added because the port ran the walk's
// window loop in Python (ops/kernels/photon_walk.py's
// `photon_walk_reference`): each window of 256 steps cost about 230 small
// PyTorch launches, most of them the masked int64 RNG hash and the nearest
// fetch, and a host read (`alive.any()`) to decide whether to go on, while
// a frame's walk moves only 16 photons.  The set-up before the loop (the
// seeds, the first direction, the clip) and the world conversion and the
// light clamp after it stay in PyTorch (render/photon.py).
//
// What bounds it: latency.  One photon's steps are serial: each window's
// transmittance and draw indices depend on everything before them.  The
// work is tiny (a tick walks 8 x 16 photons over a few windows each), so
// the kernel's time is the longest photon's chain of dependent fetches,
// products and hashes, not bytes or operations.
//
// Design: a warp per photon.  At each window the 32 lanes first fetch the
// window's samples, lane l taking steps l, l + 32, ... (up to 8 loads in
// flight a lane, the HBM latency paid about once a window), then walk the
// window 32 steps at a time.  A lane computes its step's attenuation and
// its roll with no dependence on the other lanes; the prefix the loop's
// scans give (the transmittance before the step, the draw index) is taken
// across the warp: the product in lane order through shuffles, the count
// of occupied entered steps with a ballot and popc.  The first scatter is
// the lowest lane of a ballot; the warp stops the window there.
//
// What it computes, term for term with the plain loop (its contract):
//   * a window is Wn = min(256, S) steps from t0: t_k = t0 + k * step and
//     pos = o + d * t, each product rounded before the add (the build's
//     -fmad=false keeps every product separate); the nearest fetch
//     (nearest_fetch.cuh, shared with the march);
//   * atten = occupied ? expf(-val * absorption * step) : 1, in that order,
//     IEEE expf;
//   * the window-local inclusive product cum_att restarts at 1 at each
//     window's first step and is taken in sequence, step after step (the
//     association of torch.cumprod on the CPU; the card's scan associates
//     otherwise, and the tests allow for that); excl[0] = 1;
//   * trans_before = excl * trans and int_before = excl * intensity, with
//     the window-start factors; a step is entered while t < tmax (of the
//     photon's first clip, for every segment, as the reference has it),
//     trans_before > 0.001 and int_before > 0.01, compared in f32;
//   * an occupied entered step rolls draw n_draws + occ_rank, occ_rank the
//     occupied entered steps of the window up to and including it; it
//     scatters where roll < scattering_probability;
//   * at the first scatter k*: trans and intensity times cum_att[k*]; the
//     new direction from draws n_draws + occ_rank[k*] + 1 and + 2
//     (random_dir: precise acosf, sinf, cosf and sqrtf, as PyTorch's CUDA
//     ops, and the norm's sum in their order; no fast math);
//     n_draws += occ_rank[k*] + 2; t0 = step; the event stored while
//     n_events < K, else the photon is marked dropped;
//   * without a scatter, the segment goes on in whole windows: seg_steps +=
//     Wn, and it continues while the window's last step was entered and
//     seg_steps < S: trans and intensity times cum_att[Wn - 1], n_draws +=
//     occ_rank[Wn - 1], t0 += f32(Wn * step); otherwise the photon dies;
//   * a photon starts alive where its first clip hit the box, and stops
//     after max_iters windows, the plain loop's bound.
// The wrapper takes absorption >= 0 and step > 0 only, so the attenuation
// cannot exceed 1: the test t < tmax and both products fall along a
// window, and once a step is not entered no later one is.  The warp then
// ends the window at once, as the plain loop's result has it (no scatter,
// the photon dies).
// The volume's box corner is read from a device pointer: no host read.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "nearest_fetch.cuh"

namespace {

constexpr int kWarps = 4;  // photons (warps) a block
constexpr int kGroups = 8;  // 32-step groups of the largest window (256)
constexpr unsigned kAll = 0xffffffffu;
constexpr float kTransCut = 0.001f;  // photon.py's entry tests, in f32
constexpr float kIntensityCut = 0.01f;
// ops/rng.py: the spatial hash's constants; f32(1) / f32(4294967295) is
// 2^-32 (the divisor rounds to 2^32); f32(2 pi).
constexpr uint32_t kHX = 73856093u, kHY = 19349663u, kHZ = 83492791u;
constexpr uint32_t kHM = 0x45D9F3Bu;
constexpr float kInvU32Max = 1.0f / 4294967296.0f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr uint32_t kFirstDraws = 2;  // the first direction's draws, 1 and 2

struct Walk {
  const float* vox;  // (nx, ny, nz)
  const long long* bmin;  // (3,) bbox_min, index space
  int nx, ny, nz;
  float step;
  float absorption;
  float p_scatter;
  float win_dt;  // f32(Wn * step)
  float intensity;  // photon_initial_intensity
  int Wn;  // steps a window
  int S;  // a segment's step bound
  int K;  // event slots a photon
  int max_iters;  // windows a photon
  long long P;  // photons
};

// ops/rng.py hash_uvec3 in uint32 arithmetic.
__device__ __forceinline__ uint32_t hash3(uint32_t x, uint32_t y,
                                          uint32_t z) {
  uint32_t h = (x * kHX) ^ (y * kHY) ^ (z * kHZ);
  h = (h ^ (h >> 16)) * kHM;
  h = (h ^ (h >> 16)) * kHM;
  return h ^ (h >> 16);
}

// ops/rng.py randf_at: draw k of the seed, float(hash) rounded to nearest.
__device__ __forceinline__ float randf_at(const uint32_t s[3], uint32_t k) {
  return __uint2float_rn(hash3(s[0] + k, s[1] + k, s[2] + k)) * kInvU32Max;
}

// ops/rng.py random_dir: theta = acos(clamp(1 - 2 r1, -1, 1)),
// phi = f32(2 pi) r2, normalized by its Euclidean norm.  The norm's sum
// is associated as torch.linalg.vector_norm's CUDA reduction takes it over
// three values, (x^2 + z^2) + y^2 (measured on the H100: equal on 2^24 of
// 2^24 directions; the order x, y, z differs on 6%).
__device__ __forceinline__ void random_dir(float r1, float r2, float d[3]) {
  const float c = fminf(fmaxf(1.0f - 2.0f * r1, -1.0f), 1.0f);
  const float theta = acosf(c);
  const float phi = kTwoPi * r2;
  const float st = sinf(theta);
  d[0] = st * cosf(phi);
  d[1] = st * sinf(phi);
  d[2] = cosf(theta);
  const float n = sqrtf((d[0] * d[0] + d[2] * d[2]) + d[1] * d[1]);
#pragma unroll
  for (int c3 = 0; c3 < 3; ++c3) d[c3] = d[c3] / n;
}

__global__ void __launch_bounds__(32 * kWarps)
    walk_kernel(const float* __restrict__ origin,
                const float* __restrict__ dir, const float* __restrict__ t0_in,
                const float* __restrict__ tmax_in,
                const bool* __restrict__ hit,
                const long long* __restrict__ seed_in, Walk w,
                float* __restrict__ scat, float* __restrict__ inten_out,
                long long* __restrict__ n_events_out,
                bool* __restrict__ dropped_out) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (p >= w.P) return;  // the whole warp
  long long bm[3];
  float o[3], d[3];
  uint32_t seed[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    bm[c] = __ldg(w.bmin + c);
    o[c] = __ldg(origin + 3 * p + c);
    d[c] = __ldg(dir + 3 * p + c);
    seed[c] = static_cast<uint32_t>(__ldg(seed_in + 3 * p + c));
  }
  const float tmax = __ldg(tmax_in + p);
  float t0 = __ldg(t0_in + p);
  bool alive = hit[p];
  float trans = 1.0f, inten = w.intensity;
  uint32_t n_draws = kFirstDraws;
  int n_events = 0, seg_steps = 0;
  bool dropped = false;
  const int groups = (w.Wn + 31) / 32;

  for (int it = 0; it < w.max_iters && alive; ++it) {
    float val[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int k = g * 32 + lane;
      val[g] = 0.0f;
      if (k < w.Wn) {
        const float t = t0 + static_cast<float>(k) * w.step;
        val[g] = fetch_nearest(w.vox, w.nx, w.ny, w.nz, bm, o[0] + d[0] * t,
                               o[1] + d[1] * t, o[2] + d[2] * t);
      }
    }
    float carry = 1.0f;  // cum_att before the group's first step
    uint32_t base = 0;  // occupied entered steps before the group
    bool scattered = false, last_entered = false;
    int k_star = 0;
    float att_star = 1.0f;
    uint32_t rank_star = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (g >= groups) break;
      const int k = g * 32 + lane;
      const bool valid = k < w.Wn;
      const float t = t0 + static_cast<float>(k) * w.step;
      const bool occ = valid && val[g] > 0.0f;
      const float a = occ ? expf(-val[g] * w.absorption * w.step) : 1.0f;
      // excl: cum_att before step k, the lanes' factors taken in order.
      float excl = carry;
#pragma unroll
      for (int j = 0; j < 31; ++j) {
        const float aj = __shfl_sync(kAll, a, j);
        if (j < lane) excl = excl * aj;
      }
      const float incl = excl * a;
      const bool entered = valid && t < tmax && excl * trans > kTransCut &&
                           excl * inten > kIntensityCut;
      const bool rolls = occ && entered;
      const uint32_t m = __ballot_sync(kAll, rolls);
      const uint32_t rank = base + __popc(m & (kAll >> (31 - lane)));
      const float roll = randf_at(seed, n_draws + rank);
      const uint32_t sc = __ballot_sync(kAll, rolls && roll < w.p_scatter);
      if (sc) {
        const int first = __ffs(sc) - 1;
        k_star = g * 32 + first;
        att_star = __shfl_sync(kAll, incl, first);
        rank_star = __shfl_sync(kAll, rank, first);
        scattered = true;
        break;
      }
      base += __popc(m);
      carry = __shfl_sync(kAll, incl, 31);  // lanes past Wn multiply by 1
      const int last = min(31, w.Wn - 1 - g * 32);
      last_entered = (__ballot_sync(kAll, entered) >> last) & 1u;
      if (!last_entered) break;  // no later step is entered
    }

    seg_steps += w.Wn;
    if (scattered) {
      const float ts = t0 + static_cast<float>(k_star) * w.step;
      float s[3], nd[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c] = o[c] + d[c] * ts;
      trans = trans * att_star;
      inten = inten * att_star;
      random_dir(randf_at(seed, n_draws + rank_star + 1),
                 randf_at(seed, n_draws + rank_star + 2), nd);
      if (n_events < w.K) {
        if (lane == 0) {
          const long long e = p * w.K + n_events;
#pragma unroll
          for (int c = 0; c < 3; ++c) scat[3 * e + c] = s[c];
          inten_out[e] = inten;
        }
        ++n_events;
      } else {
        dropped = true;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c] = s[c];
        d[c] = nd[c];
      }
      t0 = w.step;
      n_draws += rank_star + 2;
      seg_steps = 0;
    } else if (last_entered && seg_steps < w.S) {
      trans = trans * carry;
      inten = inten * carry;
      n_draws += base;
      t0 = t0 + w.win_dt;
    } else {
      alive = false;
    }
  }

  // Unused slots are zero, as the plain loop leaves them.
  for (int e = n_events + lane; e < w.K; e += 32) {
    const long long i = p * w.K + e;
    scat[3 * i] = 0.0f;
    scat[3 * i + 1] = 0.0f;
    scat[3 * i + 2] = 0.0f;
    inten_out[i] = 0.0f;
  }
  if (lane == 0) {
    n_events_out[p] = n_events;
    dropped_out[p] = dropped;
  }
}

}  // namespace

// origin, dir: (P, 3) f32 index space; t0, tmax: (P,) f32; hit: (P,) bool;
// seed: (P, 3) int64 holding uint32 values; vox: (nx, ny, nz) f32; bmin:
// (3,) int64.  Writes scat (P, K, 3) f32 index-space scatter positions,
// inten (P, K) f32, n_events (P,) int64 and dropped (P,) bool.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int vr_photon_walk(const float* origin, const float* dir,
                              const float* t0, const float* tmax,
                              const bool* hit, const long long* seed,
                              const float* vox, const long long* bmin, int nx,
                              int ny, int nz, float step, float absorption,
                              float p_scatter, float win_dt, float intensity,
                              int Wn, int S, int K, int max_iters,
                              long long P, float* scat,
                              float* inten, long long* n_events,
                              bool* dropped, void* stream) {
  if (P <= 0) return 0;
  if (Wn < 1 || Wn > 32 * kGroups || K < 1 || S < 1 || max_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (P + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Walk w{vox,  bmin, nx, ny, nz, step, absorption, p_scatter, win_dt,
               intensity, Wn, S, K, max_iters, P};
  walk_kernel<<<static_cast<int>(blocks), 32 * kWarps, 0,
                static_cast<cudaStream_t>(stream)>>>(
      origin, dir, t0, tmax, hit, seed, w, scat, inten, n_events, dropped);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vr_photon_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
