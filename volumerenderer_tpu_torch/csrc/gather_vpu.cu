// Slot-layout point/sphere and segment-light gathers for Hopper (sm_90a).
//
// Replaces the TPU kernels of volumerenderer_tpu/ops/pallas/gather_vpu.py,
// one __global__ template per kernel body:
//   * vpu_kernel              <- `gather_vpu` -> `_kernel`: point or sphere
//     lights, exact or paired (one divide per 4 lights), over the light
//     range staged once per block (gather_terms.cuh's LightRangeStage);
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
// running sum across the staged chunks, in the reference order; the terms
// take the instruction forms that gather_terms.cuh states.
//
// Dead samples: the TPU kernel zeroes whole 65,536-sample blocks whose
// weights are all zero.  Here a sample with w == 0 writes 0 without
// evaluating its sum.  That equals the TPU's w * sum wherever the sum is
// finite, which the guards ensure (every divide is by a guarded or floored
// denominator).
//
// What bounds them on this card: the live samples' terms (issue slots, the
// special-function unit's reciprocals and roots), and for few lights the
// scan of the weights and the zeros of the dead samples (8 B a sample).  A
// live sample (16 B of planes, 4 B of output) meets every light, every
// sub-light of every segment or every segment; the operands stay on chip
// (tables in shared memory, sums in registers).  Most samples of a
// ViewCache are dead (~92% at the bench config: rays that miss the volume,
// samples past the transmittance cutoff), so every kernel runs
// gather_terms.cuh's persistent live_sample_loop: blocks that take only
// live samples, kSamples a thread, with the next spans' weights fetched
// ahead.

#include "gather_terms.cuh"

namespace {

using namespace vr;

// ---- gather_vpu._kernel ----

template <bool kSphere, bool kPaired>
__global__ void __launch_bounds__(kThreads) vpu_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ w,
    const float* __restrict__ lpos, const float* __restrict__ li,
    const int* __restrict__ meta, int L, int N, float radius,
    int* __restrict__ next_span, float* __restrict__ out) {
  __shared__ float4 s_light[kStage];
  __shared__ LiveShared sh;
  int start, count;
  light_range(meta, L, &start, &count);
  // The paired tier walks whole groups of 4 from `start`.
  const int span = kPaired ? ((count + 3) / 4) * 4 : count;
  LightRangeStage stage{lpos, li, L, start, span, s_light, 0, 0};
  live_sample_loop(px, py, pz, w, nullptr, 0, N, next_span, out, stage,
                   PointSums<kSphere, kPaired>{s_light, radius, count, &stage},
                   sh);
}

template <bool kSphere, bool kPaired>
int launch_vpu(const float* px, const float* py, const float* pz,
               const float* w, const float* lpos, const float* li,
               const int* meta, int L, int N, float radius, int* next_span,
               float* out, cudaStream_t s) {
  static ResidentBlocks resident;
  unsigned blocks = 0;
  const int err = persistent_blocks(vpu_kernel<kSphere, kPaired>, resident,
                                    N, w, out, &blocks);
  if (err != 0) return err;
  vpu_kernel<kSphere, kPaired><<<blocks, kThreads, 0, s>>>(
      px, py, pz, w, lpos, li, meta, L, N, radius, next_span, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSphere, bool kPaired>
int launch_discrete(const float* px, const float* py, const float* pz,
                    const float* w, const float* table, const int* first,
                    const int* meta, int L, int N, float step, float radius,
                    int* next_span, float* out, cudaStream_t s) {
  static ResidentBlocks resident;
  unsigned blocks = 0;
  const int err = persistent_blocks(discrete_kernel<kSphere, kPaired>,
                                    resident, N, w, out, &blocks);
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
                                    resident, N, w, out, &blocks);
  if (err != 0) return err;
  analytic_kernel<kVariant, kPaired><<<blocks, kThreads, 0, s>>>(
      px, py, pz, w, nullptr, table, node_tab, meta, L, 0, N, nodes, radius,
      next_span, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points.  Planes px, py, pz, w and out: N f32 each (the flat
// (R, C) planes), N < 2^31, w and out 16-byte aligned; meta: int32
// (start, count, ...) on the device;
// next_span: one int32 set to 0 (the persistent blocks' work counter).
// Each launches on `stream` and returns a CUDA error code (0: launched).

// lpos: (L, 3) f32; li: (L,) f32 = I / (4 pi); meta: int32[2].
extern "C" int vr_gather_vpu(const float* px, const float* py,
                             const float* pz, const float* w,
                             const float* lpos, const float* li,
                             const int* meta, int L, int N, float radius,
                             int sphere, int paired, int* next_span,
                             float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VR_VPU(SPHERE, PAIRED)                                              \
  return launch_vpu<SPHERE, PAIRED>(px, py, pz, w, lpos, li, meta, L, N,    \
                                    radius, next_span, out, s)
  if (sphere) {
    if (paired) VR_VPU(true, true);
    VR_VPU(true, false);
  }
  if (paired) VR_VPU(false, true);
  VR_VPU(false, false);
#undef VR_VPU
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
