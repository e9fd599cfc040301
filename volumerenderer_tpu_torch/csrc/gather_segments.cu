// Lane-per-ray segment-light gathers for Hopper (sm_90a): Ray/VRL and
// Beam/VBL.
//
// Replaces the TPU kernels of volumerenderer_tpu/ops/pallas/gather_lanes.py:
//   * vr_gather_segments_discrete  <- `gather_segments_discrete_lanes` ->
//     `_discrete_kernel`: each segment k of the valid range holds
//     ns_k = floor(len_k / step) sub-lights at from + (s * step) * u, of
//     intensity ii_k = I / ns / (4 pi), point lights (Ray) or sphere lights
//     of `radius` (Beam).  Exact: one guarded divide per sub-light, one
//     running sum per sample.  Paired: one divide per 4 sub-lights,
//     (s12 q34 + s34 q12) / (q12 q34) with guarded and overrun terms at
//     q = 1e9, each segment's part scaled by ii_k.
//   * vr_gather_segments_analytic  <- `gather_segments_analytic_lanes` ->
//     `_analytic_kernel`: the closed-form VRL line integral, or the VBL
//     sphere-light quadrature under the midpoint, tangent or closed rule
//     (gather_vpu.py `_quad_nodes_nq`, `_node_sum`).  Paired: one divide per
//     4 nodes; the closed-form VRL and the closed-rule VBL instead take two
//     segments per trip and share their divides (`_vrl_paired_sum`,
//     `_closed_paired_sum`), the odd tail repeating the last segment with
//     zero intensity.
//
// Output per lane: sum_{j < lane_need} w[j] * (sum over the segments).
//
// What bounds them on this card: f32 operations, not bytes.  A sample (16 B
// of planes) meets every sub-light of every segment (discrete: ~1,500-1,800
// a frame at the bench config) or every segment with ~50-100 flops each
// (analytic), and the IEEE divide (a reciprocal on the quarter-rate special
// function unit, its refinement and a range check) is the costliest of a
// term's instructions.
//
// discrete_kernel (gather_terms.cuh, shared with the slots kernel of
// gather_vpu.cu): the sub-light positions do not depend on the sample, so
// each block expands them once into shared memory (stage_sublights), from
// an exclusive prefix of ns over the segment range that the wrapper
// computes on the device, and then runs the point or sphere term over that
// table with the many-light kernel's loop (live_sample_loop and
// staged_light_sums / staged_group_sums): persistent blocks that take only
// live samples (w != 0, j < lane_need), kSamples a thread, so one
// shared-memory broadcast feeds kSamples terms and no warp waits for its
// longest lane.  Each sample's w * sum goes to a (Cp, Rc) scratch plane,
// and lane_sum_kernel adds a lane's samples in row order, the reference's
// running sum.  The table is staged whole when it fits in kStage entries
// (32 KB, the bench config's 1,500-1,800 sub-lights), in chunks for every
// batch of samples beyond that.
//
// analytic_kernel (gather_terms.cuh, shared with the slots VRL and VBL
// kernels of gather_vpu.cu) runs the same loop with lane_need: the segment
// table (ax, ay, az, ux, uy, uz, len, ii: 32 B) staged in shared memory in
// chunks of kChunk (896) segments and read as broadcasts, each live sample's
// integral summed in segment order and its w * sum written to the scratch
// plane, then lane_sum_kernel.  A used sample of zero weight costs nothing
// (a thread per lane evaluated it and added w * sum = 0).
//
// The per-(sample, segment) terms live in gather_terms.cuh, shared with
// the slot kernels of gather_vpu.cu; the header states their rounding rules
// (reference term order, no FMA contraction, IEEE divides and roots, apart
// from the stated levers of the staged sums and of the VRL term).

#include "gather_terms.cuh"

namespace {

using namespace vr;

// ---- both kernels in two passes ----

// Pass 1 is gather_terms.cuh's discrete_kernel or analytic_kernel with
// lane_need, into a (Cp, Rc) scratch plane of terms[j, lane] = w * (the
// sample's sum).

// Pass 2: out[lane] = terms[0, lane] + terms[1, lane] + ... over
// j < lane_need, in row order, one thread a lane: the reference's running
// sum over a lane's samples (a dead sample adds 0, which changes no bit).
__global__ void __launch_bounds__(kThreads) lane_sum_kernel(
    const float* __restrict__ terms, const int* __restrict__ lane_need,
    int Cp, int Rc, float* __restrict__ out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= Rc) return;
  const int need = min(lane_need[lane], Cp);
  float sum = 0.0f;
  for (int j = 0; j < need; ++j) {
    sum = sum + terms[static_cast<size_t>(j) * Rc + lane];
  }
  out[lane] = sum;
}

dim3 grid_of(int Rc) { return dim3((Rc + kThreads - 1) / kThreads); }

// Pass 1, `kernel` launched persistent over the N = Cp * Rc samples by
// `launch(blocks)`, then pass 2.  Returns a CUDA error code.
template <class Kernel, class Launch>
int two_passes(Kernel kernel, ResidentBlocks& resident, const float* w,
               const int* lane_need, int Cp, int Rc, const float* terms,
               float* out, cudaStream_t s, Launch launch) {
  const int N = Cp * Rc;
  unsigned blocks = 0;
  const int err = persistent_blocks(kernel, resident, N, w, terms, &blocks);
  if (err != 0) return err;
  if (N > 0) {
    launch(blocks);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
  }
  lane_sum_kernel<<<grid_of(Rc), kThreads, 0, s>>>(terms, lane_need, Cp, Rc,
                                                   out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSphere, bool kPaired>
int launch_discrete(const float* px, const float* py, const float* pz,
                    const float* w, const int* lane_need, const float* table,
                    const int* first, const int* meta, int L, int Cp, int Rc,
                    float step, float radius, int* next_span, float* terms,
                    float* out, cudaStream_t s) {
  static ResidentBlocks resident;
  return two_passes(
      discrete_kernel<kSphere, kPaired>, resident, w, lane_need, Cp, Rc,
      terms, out, s, [&](unsigned blocks) {
        discrete_kernel<kSphere, kPaired><<<blocks, kThreads, 0, s>>>(
            px, py, pz, w, lane_need, table, first, meta, L, Rc, Cp * Rc,
            step, radius, next_span, terms);
      });
}

template <int kVariant, bool kPaired>
int launch_analytic(const float* px, const float* py, const float* pz,
                    const float* w, const int* lane_need, const float* table,
                    const float* node_tab, const int* meta, int L, int Cp,
                    int Rc, int nodes, float radius, int* next_span,
                    float* terms, float* out, cudaStream_t s) {
  static ResidentBlocks resident;
  return two_passes(
      analytic_kernel<kVariant, kPaired>, resident, w, lane_need, Cp, Rc,
      terms, out, s, [&](unsigned blocks) {
        analytic_kernel<kVariant, kPaired><<<blocks, kThreads, 0, s>>>(
            px, py, pz, w, lane_need, table, node_tab, meta, L, Rc, Cp * Rc,
            nodes, radius, next_span, terms);
      });
}

}  // namespace

// Plain C entry points.  Planes px, py, pz, w: (Cp, Rc) f32 row-major;
// lane_need: (Rc,) i32; table: (L, 8) f32 rows (ax, ay, az, ux, uy, uz, c6,
// ii), 16-byte aligned; meta: int32 (start, count, ...) on the device; out:
// (Rc,) f32.  Each launches on `stream` and returns cudaGetLastError().

// c6 = the sub-light count ns as int32 bits; ii = I / ns / (4 pi).
// first: (L,) i32, the exclusive prefix over [start, start + count) of
// ns_k (paired: ns_k rounded up to a multiple of 4); meta: int32[3] =
// (start, count, total entries) on the device; next_span: one int32 set to
// 0; terms: (Cp, Rc) f32 scratch.  Cp * Rc < 2^31.
extern "C" int vr_gather_segments_discrete(
    const float* px, const float* py, const float* pz, const float* w,
    const int* lane_need, const float* table, const int* first,
    const int* meta, int L, int Cp, int Rc, float step, float radius,
    int sphere, int paired, int* next_span, float* terms, float* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VR_DISCRETE(SPHERE, PAIRED)                                          \
  return launch_discrete<SPHERE, PAIRED>(px, py, pz, w, lane_need, table,   \
                                         first, meta, L, Cp, Rc, step,      \
                                         radius, next_span, terms, out, s)
  if (sphere) {
    if (paired) VR_DISCRETE(true, true);
    VR_DISCRETE(true, false);
  }
  if (paired) VR_DISCRETE(false, true);
  VR_DISCRETE(false, false);
#undef VR_DISCRETE
}

// c6 = the segment length; ii = I / (4 pi L).  node_tab: (2, max(nodes, 1))
// f32 node fractions / Gauss-Legendre nodes, then weights; nodes <= 1024.
// variant: 0 VRL, 1 VBL midpoint, 2 VBL tangent, 3 VBL closed.  meta:
// int32[2] = (start, count); next_span: one int32 set to 0; terms: (Cp, Rc)
// f32 scratch.  Cp * Rc < 2^31.
extern "C" int vr_gather_segments_analytic(
    const float* px, const float* py, const float* pz, const float* w,
    const int* lane_need, const float* table, const float* node_tab,
    const int* meta, int L, int Cp, int Rc, int nodes, float radius,
    int variant, int paired, int* next_span, float* terms, float* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nodes < 0 || nodes > kMaxNodes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define VR_ANALYTIC(V)                                                      \
  return paired ? launch_analytic<V, true>(px, py, pz, w, lane_need, table, \
                                           node_tab, meta, L, Cp, Rc,       \
                                           nodes, radius, next_span, terms, \
                                           out, s)                          \
                : launch_analytic<V, false>(px, py, pz, w, lane_need,       \
                                            table, node_tab, meta, L, Cp,   \
                                            Rc, nodes, radius, next_span,   \
                                            terms, out, s)
  switch (variant) {
    case kVrl:
      VR_ANALYTIC(kVrl);
    case kMidpoint:
      VR_ANALYTIC(kMidpoint);
    case kTangent:
      VR_ANALYTIC(kTangent);
    case kClosed:
      VR_ANALYTIC(kClosed);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VR_ANALYTIC
}

extern "C" const char* vr_segments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
