// Lane-per-ray point/sphere light gather for Hopper (sm_90a).
//
// Replaces the TPU kernel volumerenderer_tpu/ops/pallas/gather_lanes.py
// (`gather_lanes` -> `_point_kernel` on the `_slab_loop` skeleton).  For each
// compacted ray (lane) it computes
//
//     out[lane] = sum_{j < lane_need[lane]} w[j, lane] * sum_{k in lights} term(j, k)
//     term      = li_k / max(d2e, 1e-4), or 0 when guarded
//
// with d2e = |p - l|^2 for point lights and (|p - l| - r)^2 for sphere lights
// (guarded when d2e < 1e-4, and for spheres also at the centre).  The paired
// tier sums groups of 4 lights with one reciprocal:
//     ((n1 q2 + n2 q1) q34 + (n3 q4 + n4 q3) q12) / (q12 q34)
// where guarded and overrun terms are (n = 0, q = 1).  The terms are
// gather_terms.cuh's staged sums (staged_light_sums, staged_point_groups),
// shared with the slots kernel of gather_vpu.cu: an FMA in d^2 and in the
// running sum, and rcp.approx.ftz for the divide, with the ranges that
// header states.
//
// What bounds it on this card: issue slots over (used sample, light) terms,
// not bytes.  Each used sample (16 B of planes) meets every light, ~50 a
// frame at the bench config.  The design keeps the operands on chip: one
// thread a lane, the light table staged once per block in shared memory
// (gather_terms.cuh's LightRangeStage, kStage = 2048 entries, which holds
// SMEM_LIGHT_LIMIT slots), and kSamples rows of the lane a thread in
// registers.  Each row's loads are contiguous across the warp; rows past
// the lane's need are masked.  One walk of the table feeds the kSamples
// rows, one shared-memory broadcast kSamples terms.  Lanes arrive sorted
// by descending need, so the threads of a warp have similar trip counts;
// each thread stops at its own lane_need.  There is no scan and no scratch
// plane: a lane's sum stays in a register, w * sum added in row order.
// Beyond kStage slots (direct calls only) the table is re-staged for every
// kSamples rows, up to the block's largest need.

#include "gather_terms.cuh"

namespace {

using namespace vr;

// The largest v of the block, in every thread.  Called by the whole block.
__device__ __forceinline__ int block_max(int v, int* s_warp) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = s_warp[0];
#pragma unroll
  for (int q = 1; q < kWarps; ++q) m = max(m, s_warp[q]);
  return m;
}

template <bool kSphere, bool kPaired>
__global__ void __launch_bounds__(kThreads) gather_lanes_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ w,
    const int* __restrict__ lane_need, const float* __restrict__ lpos,
    const float* __restrict__ li, const int* __restrict__ meta, int L, int Cp,
    int Rc, float radius, float* __restrict__ out) {
  __shared__ float4 s_light[kStage];  // (x, y, z, li) of the staged lights
  __shared__ int s_warp[kWarps];

  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool in = lane < Rc;
  // Light range [start, start + count) read on the device: no host sync.
  int start, count;
  light_range(meta, L, &start, &count);
  // The paired tier walks whole groups of 4 from `start`.
  const int span = kPaired ? ((count + 3) / 4) * 4 : count;
  const int need = in ? min(lane_need[lane], Cp) : 0;
  LightRangeStage stage{lpos, li, L, start, span, s_light, 0, 0};
  const PointSums<kSphere, kPaired> sums{s_light, radius, count, &stage};
  stage.begin();
  const int n_whole = stage.next();
  const bool whole = stage.done();  // the table fits one stage
  // Rows this thread walks: its own need, or, when the table is re-staged
  // (uniformly, with barriers), the block's largest.
  const int rows = whole ? need : block_max(need, s_warp);
  __syncthreads();

  float total = 0.0f;
  for (int j0 = 0; j0 < rows; j0 += kSamples) {
    float x[kSamples], y[kSamples], z[kSamples], wv[kSamples];
    float acc[kSamples], part[kSamples];
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
      const bool use = j0 + s < need;
      const size_t o = use ? static_cast<size_t>(j0 + s) * Rc + lane : 0;
      x[s] = use ? px[o] : 0.0f;
      y[s] = use ? py[o] : 0.0f;
      z[s] = use ? pz[o] : 0.0f;
      wv[s] = use ? w[o] : 0.0f;
      acc[s] = 0.0f;
      part[s] = 0.0f;
    }
    if (whole) {
      sums(n_whole, x, y, z, acc, part);
    } else {
      for (stage.begin(); !stage.done();) {
        __syncthreads();  // the previous stage is no longer read
        const int n = stage.next();
        __syncthreads();
        sums(n, x, y, z, acc, part);
      }
    }
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
      if (j0 + s < need) total = total + wv[s] * acc[s];
    }
  }
  if (in) out[lane] = total;
}

template <bool kSphere, bool kPaired>
void launch(const float* px, const float* py, const float* pz, const float* w,
            const int* lane_need, const float* lpos, const float* li,
            const int* meta, int L, int Cp, int Rc, float radius, float* out,
            cudaStream_t stream) {
  const dim3 grid((Rc + kThreads - 1) / kThreads);
  gather_lanes_kernel<kSphere, kPaired><<<grid, kThreads, 0, stream>>>(
      px, py, pz, w, lane_need, lpos, li, meta, L, Cp, Rc, radius, out);
}

}  // namespace

// Plain C entry point.  Planes px, py, pz, w: (Cp, Rc) f32 row-major;
// lane_need: (Rc,) i32; lpos: (L, 3) f32; li: (L,) f32 (I / 4 pi);
// meta: int32[2] = (start, count) on the device; out: (Rc,) f32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int vr_gather_lanes(const float* px, const float* py,
                               const float* pz, const float* w,
                               const int* lane_need, const float* lpos,
                               const float* li, const int* meta, int L, int Cp,
                               int Rc, float radius, int sphere, int paired,
                               float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sphere) {
    if (paired) {
      launch<true, true>(px, py, pz, w, lane_need, lpos, li, meta, L, Cp, Rc,
                         radius, out, s);
    } else {
      launch<true, false>(px, py, pz, w, lane_need, lpos, li, meta, L, Cp, Rc,
                          radius, out, s);
    }
  } else {
    if (paired) {
      launch<false, true>(px, py, pz, w, lane_need, lpos, li, meta, L, Cp, Rc,
                          radius, out, s);
    } else {
      launch<false, false>(px, py, pz, w, lane_need, lpos, li, meta, L, Cp, Rc,
                           radius, out, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
