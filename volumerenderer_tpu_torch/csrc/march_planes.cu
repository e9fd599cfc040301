// Uncached transmittance march for Hopper (sm_90a): from the bbox clip to
// the written sample planes, one launch for every ray.
//
// Replaces no TPU kernel: the JAX package's march (volumerenderer_tpu/ops/
// march.py) is plain XLA.  It was added because the port ran the same
// march as ~95 PyTorch ops a tile of 65,536 rays (ops/march.py's `march`,
// then the plane assembly of ops/kernels/march_planes.py): at 1920x1080 a
// coarse frame dispatched ~3,000 launches, with a cumprod scan over rows of
// 16 samples and (N, S) temporaries between them.  This kernel computes the
// subset of that march whose loop is a plain sequential march: nearest
// sampling, no brick gate, every sample kept (no top-k).
//
// What it computes, term for term with ops/march.py (its rounding contract):
//   * the clip: intersect_aabb against the volume box [bbox_min,
//     bbox_max + 1) with tmin = max(0, ...), tmax = min(ray_max_distance,
//     ...), max and min propagating NaN as torch.maximum / amax do; the
//     entry nudge tmin = max(tmin, 0) + f32(ENTRY_EPS * step); with a clip
//     box, the occupied-box advance by whole steps,
//     m = floor(max(u_lo - tmin, 0) / step) (an IEEE divide),
//     tmin += m * step, tmax = min(tmax, u_hi + step);
//   * t_k = tmin + k * step and pos = o + d * t, each product rounded
//     before the add (the build's -fmad=false keeps every product
//     separate);
//   * the nearest fetch at floor(pos), 0 outside the volume
//     (nearest_fetch.cuh, shared with the photon walk);
//   * atten = expf(-val * absorption * step), in that order, IEEE expf;
//   * T, the transmittance before sample k, as a running product (torch's
//     cumprod scan associates differently; the tests allow for that);
//   * active = live & (t < tmax) & (T > 0.001), w = T * val * step;
//   * world positions mm[i,0]*x + mm[i,1]*y + mm[i,2]*z + mv[i], in that
//     order.
// Positions are written for every sample, live or not, as the plain
// version writes them.  The volume's map and box and the clip box are read
// from device pointers: no host read.
//
// What bounds it on this card: bytes.  Each sample writes 16 B (x, y, z,
// w) and a ray reads 24 B; at the drag's shape (1920x1080 rays, 16
// samples) that is 531 MB of plane writes and 50 MB of ray reads, 0.17 ms
// at 3.35 TB/s.  The volume (3.5 MB for 96^3) stays in L2 and is read
// through the read-only path.  About 40 f32 operations a sample and one
// expf are far below the operation bound.
//
// Design: one thread per ray, the sample loop in registers.  A block
// stages its 128 rays' origins and directions through shared memory with
// 16-byte loads (so the ray arrays must be 16-byte aligned).
//   * Lanes layout (4, S, N): sample k of neighbouring rays lies on
//     neighbouring addresses, so each thread stores straight to the planes,
//     coalesced.
//   * Slots layout (4, N, S): a thread's samples lie on one row, so storing
//     them directly would put a warp's 32 stores 4*S bytes apart.  Instead
//     each warp stages its 32 rays' samples in shared memory, kChunk samples
//     at a time (row pitch kChunk + 1: the threads' column writes hit 32
//     distinct banks), and then writes its rows out together, with 16-byte
//     stores where S is a multiple of 4 (consecutive threads on consecutive
//     16 bytes of a row, the warp's rows one after another).  A warp waits
//     only on itself (__syncwarp).  Measured on the H100 against a block-wide
//     stage and against 8-sample chunks, this was the fastest at 16 and at
//     144 samples a ray.

#include <cuda_runtime.h>

#include <climits>

#include "nearest_fetch.cuh"

namespace {

constexpr int kRays = 128;  // rays (threads) a block
constexpr int kChunk = 16;  // samples a slots warp stages per pass
constexpr int kPitch = kChunk + 1;
constexpr int kRayF4 = kRays * 3 / 4;  // float4s of one block's origins
constexpr float kCutoff = 0.001f;  // ops/march.py T_CUTOFF, compared in f32

struct Volume {
  const float* vox;  // (nx, ny, nz), voxel (i, j, k) at vox[i - bx, ...]
  const long long* bmin;  // (3,) bbox_min, index space, inclusive
  const long long* bmax;  // (3,) bbox_max, inclusive
  const float* mm;  // (3, 3) index -> world
  const float* mv;  // (3,)
  const float* clo;  // (3,) clip box corners, or null
  const float* chi;
  int nx, ny, nz;
};

struct March {
  float far;  // ray_max_distance
  float step;
  float absorption;
  float nudge;  // f32(ENTRY_EPS * step)
  int S;  // samples a ray
  long long N;  // rays
};

// torch.maximum / torch.minimum / amax / amin: a NaN operand wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// ops/intersect.py intersect_aabb from (0, far): the clipped interval.
__device__ __forceinline__ void slab(const float o[3], const float inv[3],
                                     const float lo[3], const float hi[3],
                                     float far, float& tmin, float& tmax) {
  float l[3], h[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t0 = (lo[c] - o[c]) * inv[c];
    const float t1 = (hi[c] - o[c]) * inv[c];
    const bool swap = inv[c] < 0.0f;
    l[c] = swap ? t1 : t0;
    h[c] = swap ? t0 : t1;
  }
  tmin = nan_max(0.0f, nan_max(nan_max(l[0], l[1]), l[2]));
  tmax = nan_min(far, nan_min(nan_min(h[0], h[1]), h[2]));
}

// One ray's march state: the clip, then sample after sample.
struct Ray {
  float o[3], d[3];
  float tmin, tmax;
  float T;
  bool live;

  __device__ __forceinline__ void clip(const Volume& v, const March& m,
                                       const long long bm[3]) {
    float inv[3], lo[3], hi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      inv[c] = 1.0f / d[c];
      lo[c] = static_cast<float>(bm[c]);
      hi[c] = static_cast<float>(__ldg(v.bmax + c) + 1);
    }
    slab(o, inv, lo, hi, m.far, tmin, tmax);
    live = (tmax >= tmin) && (tmax > 0.0f);
    tmin = (tmin < 0.0f ? 0.0f : tmin) + m.nudge;
    if (v.clo != nullptr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = __ldg(v.clo + c);
        hi[c] = __ldg(v.chi + c);
      }
      float u_lo, u_hi;
      slab(o, inv, lo, hi, m.far, u_lo, u_hi);
      live = live && (u_hi >= u_lo) && (u_hi > 0.0f);
      float gap = u_lo - tmin;
      gap = gap < 0.0f ? 0.0f : gap;
      const float k = floorf(gap / m.step);
      tmin = tmin + k * m.step;
      tmax = nan_min(tmax, u_hi + m.step);
    }
    T = 1.0f;
  }

  // Sample k: world position (x, y, z) and weight w; advances T.
  __device__ __forceinline__ void sample(const Volume& v, const March& m,
                                         const long long bm[3],
                                         const float mm[9], const float mv[3],
                                         int k, float out[4]) {
    const float t = tmin + static_cast<float>(k) * m.step;
    const float x = o[0] + d[0] * t;
    const float y = o[1] + d[1] * t;
    const float z = o[2] + d[2] * t;
    float w = 0.0f;
    if (live) {
      // The fetch is taken for every sample of a live ray, as the plain
      // version takes it: T after sample k feeds every later sample.
      const float val = fetch_nearest(v.vox, v.nx, v.ny, v.nz, bm, x, y, z);
      if (t < tmax && T > kCutoff) w = T * val * m.step;
      T = T * expf(-val * m.absorption * m.step);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out[i] = mm[3 * i] * x + mm[3 * i + 1] * y + mm[3 * i + 2] * z + mv[i];
    }
    out[3] = w;
  }
};

template <bool kSlots>
__global__ void __launch_bounds__(kRays)
    march_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                 Volume v, March m, float* __restrict__ planes) {
  __shared__ float4 s_ray[2 * kRayF4];  // the block's origins, then dirs
  __shared__ float s_out[kSlots ? 4 * kRays * kPitch : 1];
  const long long n0 = static_cast<long long>(blockIdx.x) * kRays;
  const int nb = static_cast<int>(min(static_cast<long long>(kRays),
                                      m.N - n0));
  const int r = threadIdx.x;
  float* s_rayf = reinterpret_cast<float*>(s_ray);
  if (nb == kRays) {
    const float4* o4 = reinterpret_cast<const float4*>(orig + n0 * 3);
    const float4* d4 = reinterpret_cast<const float4*>(dir + n0 * 3);
    for (int i = r; i < 2 * kRayF4; i += kRays) {
      s_ray[i] = i < kRayF4 ? __ldg(o4 + i) : __ldg(d4 + (i - kRayF4));
    }
  } else {
    for (int i = r; i < 3 * nb; i += kRays) {
      s_rayf[i] = __ldg(orig + n0 * 3 + i);
      s_rayf[3 * kRays + i] = __ldg(dir + n0 * 3 + i);
    }
  }
  __syncthreads();

  const bool mine = r < nb;
  long long bm[3];
  float mm[9], mv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    bm[c] = __ldg(v.bmin + c);
    mv[c] = __ldg(v.mv + c);
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) mm[i] = __ldg(v.mm + i);
  Ray ray;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ray.o[c] = mine ? s_rayf[3 * r + c] : 0.0f;
    ray.d[c] = mine ? s_rayf[3 * kRays + 3 * r + c] : 1.0f;
  }
  ray.clip(v, m, bm);
  ray.live = ray.live && mine;
  const long long plane = static_cast<long long>(m.S) * m.N;
  float out[4];

  if (!kSlots) {
    if (!mine) return;
    float* p = planes + n0 + r;
    for (int k = 0; k < m.S; ++k) {
      ray.sample(v, m, bm, mm, mv, k, out);
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i * plane + static_cast<long long>(k) * m.N] = out[i];
    }
    return;
  }

  // Slots: each warp stages its 32 rays' samples and writes its own rows,
  // so a warp waits on no other warp of the block.
  const int lane = r & 31;
  const int row0 = r - lane;  // the warp's first ray in the block
  const int rows = min(32, nb - row0);
  if (rows <= 0) return;
  const bool vec = (m.S % 4) == 0;
  for (int k0 = 0; k0 < m.S; k0 += kChunk) {
    const int kc = min(kChunk, m.S - k0);
    for (int j = 0; j < kc; ++j) {
      ray.sample(v, m, bm, mm, mv, k0 + j, out);
#pragma unroll
      for (int i = 0; i < 4; ++i) s_out[(i * kRays + r) * kPitch + j] = out[i];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* src = s_out + (i * kRays + row0) * kPitch;
      float* dst = planes + i * plane + (n0 + row0) * m.S + k0;
      if (vec) {
        const int q = kc / 4;  // 16-byte groups a row
        for (int e = lane; e < rows * q; e += 32) {
          const int row = e / q, c = 4 * (e - row * q);
          const float* s = src + row * kPitch + c;
          *reinterpret_cast<float4*>(dst + static_cast<long long>(row) * m.S + c) =
              make_float4(s[0], s[1], s[2], s[3]);
        }
      } else {
        for (int e = lane; e < rows * kc; e += 32) {
          const int row = e / kc, c = e - row * kc;
          dst[static_cast<long long>(row) * m.S + c] = src[row * kPitch + c];
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// planes: (4, S, N) lane-major (slots = 0) or (4, N, S) row-major
// (slots = 1), f32, 16-byte aligned; orig, dir: (N, 3) f32, 16-byte
// aligned; vox: (nx, ny, nz) f32; bmin, bmax: (3,) int64; mm: (3, 3) f32;
// mv: (3,) f32; clo, chi: (3,) f32 or both null.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int vr_march_planes(const float* orig, const float* dir,
                               const float* vox, const long long* bmin,
                               const long long* bmax, const float* mm,
                               const float* mv, const float* clo,
                               const float* chi, int nx, int ny, int nz,
                               float far, float step, float absorption,
                               float nudge, int S, long long N, int slots,
                               float* planes, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  const long long blocks = (N + kRays - 1) / kRays;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Volume v{vox, bmin, bmax, mm, mv, clo, chi, nx, ny, nz};
  const March m{far, step, absorption, nudge, S, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots) {
    march_kernel<true><<<static_cast<int>(blocks), kRays, 0, s>>>(
        orig, dir, v, m, planes);
  } else {
    march_kernel<false><<<static_cast<int>(blocks), kRays, 0, s>>>(
        orig, dir, v, m, planes);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vr_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
