// Slot-layout point/sphere and segment-light gathers for Hopper (sm_90a).
//
// Replaces the TPU kernels of volumerenderer_tpu/ops/pallas/gather_vpu.py,
// one __global__ template per kernel body:
//   * vpu_kernel              <- `gather_vpu` -> `_kernel`: point or sphere
//     lights, exact or paired (one divide per 4 lights);
//   * discrete_kernel (gather_terms.cuh) <- `gather_segments_discrete` ->
//     `_segment_discrete_kernel`: the uncapped sub-light walk of each
//     Ray/VRL (point) or Beam/VBL (sphere) segment, exact or paired: the
//     lane layout's kernel without its lane_need;
//   * analytic_kernel (gather_terms.cuh) <- `gather_segments_analytic` ->
//     `_segment_kernel`: the closed-form VRL line integral, exact or paired
//     (two segments per trip), and (sphere) `_segment_sphere_kernel`: the
//     VBL quadrature under the midpoint, tangent or closed rule, exact or
//     paired; the lane layout's kernel without its lane_need.
// The terms are those of the lane kernels (gather_terms.cuh), so both
// layouts evaluate each (sample, light) and (sample, segment) term the same.
//
// Layout: the planes px, py, pz, w are the (R, C) row-major planes of a
// ViewCache, read as one flat array of N = R * C samples.  Each kernel
// writes out[i] = w[i] * (sum over the lights or segments of
// [start, start + count)), the same (R, C) array the TPU kernel returns.
// The range is read on the device (no host sync).  Each sample keeps one
// running sum across the staged chunks, in the reference order.
//
// Dead samples: the TPU kernel zeroes whole 65,536-sample blocks whose
// weights are all zero.  Here a sample with w == 0 writes 0 without
// evaluating its sum.  That equals the TPU's w * sum wherever the sum is
// finite, which the guards ensure (every divide is by a guarded or floored
// denominator).
//
// What bounds them on this card: f32 divides, square roots and the
// polynomial atan over the live samples, not bytes.  A live sample (16 B
// of planes, 4 B of output) meets every light, every sub-light of every
// segment or every segment; the operands stay on chip (tables in shared
// memory, sums in registers).  Most samples of a ViewCache are dead (~92%
// at the bench config: rays that miss the volume, samples past the
// transmittance cutoff), so the segment kernels run gather_terms.cuh's
// persistent live_sample_loop: blocks that take only live samples, kSamples
// a thread.  The point/sphere kernel still gives one thread to each sample
// (slot_loop), and a block of 256 dead samples returns at once.

#include "gather_terms.cuh"

namespace {

using namespace vr;

// The one-thread-a-sample loop of vpu_kernel:
// stage(c0, n) stages chunk c0's n entries; body(n, c0, x, y, z, acc) adds
// them to a sample's running sum.
template <class Body, class Stage>
__device__ __forceinline__ void slot_loop(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ w, long long N,
    int span, float* __restrict__ out, const Body& body, const Stage& stage) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool in = i < N;
  const float wi = in ? w[i] : 0.0f;
  const bool live = wi != 0.0f;
  if (!__syncthreads_or(live)) {  // uniform in the block
    if (in) out[i] = 0.0f;
    return;
  }
  const float x = live ? px[i] : 0.0f;
  const float y = live ? py[i] : 0.0f;
  const float z = live ? pz[i] : 0.0f;
  float acc = 0.0f;
  for (int c0 = 0; c0 < span; c0 += kChunk) {
    const int n = min(kChunk, span - c0);
    __syncthreads();  // the previous chunk is no longer read
    stage(c0, n);
    __syncthreads();
    if (live) acc = body(n, c0, x, y, z, acc);
  }
  if (in) out[i] = live ? wi * acc : 0.0f;
}

struct LightStage {
  const float* lpos;
  const float* li;
  int L, start;
  float4* s_light;
  __device__ __forceinline__ void operator()(int c0, int n) const {
    stage_lights(lpos, li, L, start + c0, n, s_light);
  }
};

// The valid range [start, start + count) of L slots, read on the device.
__device__ __forceinline__ void light_range(const int* __restrict__ meta,
                                            int L, int* start, int* count) {
  *start = max(meta[0], 0);
  *count = max(min(meta[1], L - *start), 0);
}

// ---- gather_vpu._kernel ----

template <bool kSphere, bool kPaired>
__global__ void __launch_bounds__(kThreads) vpu_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ w,
    const float* __restrict__ lpos, const float* __restrict__ li,
    const int* __restrict__ meta, int L, long long N, float radius,
    float* __restrict__ out) {
  __shared__ float4 s_light[kChunk];
  int start, count;
  light_range(meta, L, &start, &count);
  // The paired tier walks whole groups of 4 from `start`.
  const int span = kPaired ? ((count + 3) / 4) * 4 : count;
  const PointBody<kSphere, kPaired> body{s_light, radius, count};
  slot_loop(px, py, pz, w, N, span, out, body,
            LightStage{lpos, li, L, start, s_light});
}

dim3 blocks_of(long long N) {
  return dim3(static_cast<unsigned>((N + kThreads - 1) / kThreads));
}

template <bool kSphere, bool kPaired>
void launch_vpu(const float* px, const float* py, const float* pz,
                const float* w, const float* lpos, const float* li,
                const int* meta, int L, long long N, float radius, float* out,
                cudaStream_t s) {
  vpu_kernel<kSphere, kPaired><<<blocks_of(N), kThreads, 0, s>>>(
      px, py, pz, w, lpos, li, meta, L, N, radius, out);
}

template <bool kSphere, bool kPaired>
int launch_discrete(const float* px, const float* py, const float* pz,
                    const float* w, const float* table, const int* first,
                    const int* meta, int L, int N, float step, float radius,
                    int* next_span, float* out, cudaStream_t s) {
  static ResidentBlocks resident;
  unsigned blocks = 0;
  const int err = persistent_blocks(discrete_kernel<kSphere, kPaired>,
                                    resident, N, &blocks);
  if (err != 0) return err;
  discrete_kernel<kSphere, kPaired><<<blocks, kThreads, 0, s>>>(
      px, py, pz, w, nullptr, table, first, meta, L, 0, N, step, radius,
      next_span, out);
  return static_cast<int>(cudaGetLastError());
}

template <int kVariant, bool kPaired>
int launch_analytic(const float* px, const float* py, const float* pz,
                    const float* w, const float* table, const float* node_tab,
                    const int* meta, int L, int N, int nodes, float radius,
                    int* next_span, float* out, cudaStream_t s) {
  static ResidentBlocks resident;
  unsigned blocks = 0;
  const int err = persistent_blocks(analytic_kernel<kVariant, kPaired>,
                                    resident, N, &blocks);
  if (err != 0) return err;
  analytic_kernel<kVariant, kPaired><<<blocks, kThreads, 0, s>>>(
      px, py, pz, w, nullptr, table, node_tab, meta, L, 0, N, nodes, radius,
      next_span, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points.  Planes px, py, pz, w and out: N f32 each (the flat
// (R, C) planes); meta: int32 (start, count, ...) on the device.  Each
// launches on `stream` and returns a CUDA error code (0: launched).  The
// point/sphere kernel takes N <= 2^31 * 256; the segment kernels N < 2^31,
// with next_span one int32 set to 0 (the persistent blocks' work counter).

// lpos: (L, 3) f32; li: (L,) f32 = I / (4 pi); meta: int32[2].
extern "C" int vr_gather_vpu(const float* px, const float* py,
                             const float* pz, const float* w,
                             const float* lpos, const float* li,
                             const int* meta, int L, long long N,
                             float radius, int sphere, int paired,
                             float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sphere) {
    if (paired) {
      launch_vpu<true, true>(px, py, pz, w, lpos, li, meta, L, N, radius, out,
                             s);
    } else {
      launch_vpu<true, false>(px, py, pz, w, lpos, li, meta, L, N, radius,
                              out, s);
    }
  } else {
    if (paired) {
      launch_vpu<false, true>(px, py, pz, w, lpos, li, meta, L, N, radius,
                              out, s);
    } else {
      launch_vpu<false, false>(px, py, pz, w, lpos, li, meta, L, N, radius,
                               out, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// table: (L, 8) f32 rows (ax, ay, az, ux, uy, uz, ns as int32 bits,
// I / ns / (4 pi)), 16-byte aligned; first: (L,) i32, the exclusive prefix
// over [start, start + count) of ns_k (paired: ns_k rounded up to a
// multiple of 4); meta: int32[3] = (start, count, total entries).
extern "C" int vr_gather_vpu_discrete(const float* px, const float* py,
                                      const float* pz, const float* w,
                                      const float* table, const int* first,
                                      const int* meta, int L, int N,
                                      float step, float radius, int sphere,
                                      int paired, int* next_span, float* out,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VR_DISCRETE(SPHERE, PAIRED)                                          \
  return launch_discrete<SPHERE, PAIRED>(px, py, pz, w, table, first, meta, \
                                         L, N, step, radius, next_span,     \
                                         out, s)
  if (sphere) {
    if (paired) VR_DISCRETE(true, true);
    VR_DISCRETE(true, false);
  }
  if (paired) VR_DISCRETE(false, true);
  VR_DISCRETE(false, false);
#undef VR_DISCRETE
}

// table: (L, 8) f32 rows (ax, ay, az, ux, uy, uz, length, I / (4 pi L));
// meta: int32[2].
extern "C" int vr_gather_vpu_vrl(const float* px, const float* py,
                                 const float* pz, const float* w,
                                 const float* table, const int* meta, int L,
                                 int N, int paired, int* next_span,
                                 float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return paired ? launch_analytic<kVrl, true>(px, py, pz, w, table, nullptr,
                                              meta, L, N, 0, 0.0f, next_span,
                                              out, s)
                : launch_analytic<kVrl, false>(px, py, pz, w, table, nullptr,
                                               meta, L, N, 0, 0.0f,
                                               next_span, out, s);
}

// table and meta as for vr_gather_vpu_vrl; node_tab: (2, max(nodes, 1)) f32
// node fractions / Gauss-Legendre nodes, then weights; nodes <= 1024.
// variant: 1 midpoint, 2 tangent, 3 closed.
extern "C" int vr_gather_vpu_sphere(const float* px, const float* py,
                                    const float* pz, const float* w,
                                    const float* table,
                                    const float* node_tab, const int* meta,
                                    int L, int N, int nodes, float radius,
                                    int variant, int paired, int* next_span,
                                    float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nodes < 0 || nodes > kMaxNodes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define VR_SPHERE(V)                                                        \
  return paired ? launch_analytic<V, true>(px, py, pz, w, table, node_tab,  \
                                           meta, L, N, nodes, radius,       \
                                           next_span, out, s)               \
                : launch_analytic<V, false>(px, py, pz, w, table, node_tab, \
                                            meta, L, N, nodes, radius,      \
                                            next_span, out, s)
  switch (variant) {
    case kMidpoint:
      VR_SPHERE(kMidpoint);
    case kTangent:
      VR_SPHERE(kTangent);
    case kClosed:
      VR_SPHERE(kClosed);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VR_SPHERE
}

extern "C" const char* vr_vpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
