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
// tier sums groups of 4 lights with one divide:
//     ((n1 q2 + n2 q1) q34 + (n3 q4 + n4 q3) q12) / (q12 q34)
// where guarded and overrun terms are (n = 0, q = 1).
//
// What bounds it on this card: the f32 divide rate, not bytes.  Each sample
// (16 B of planes) is read once and evaluated against every light, so at the
// main path's ~1000 lights a sample costs ~1000 guarded divides for 16 B of
// traffic.  The design keeps the operands on chip: one thread per lane with
// its samples streamed from the (Cp, Rc) planes (a warp's loads of row j are
// contiguous), the light columns staged once per block in shared memory and
// read by every thread as a broadcast, and the per-lane sum in a register.
// Lanes arrive sorted by descending need, so the threads of a warp have
// similar trip counts; each thread stops at its own lane_need, which replaces
// the TPU's per-1024-lane block bound.  The paired tier is the lever on the
// divide: one divide per 4 lights.
//
// Arithmetic follows the reference term order.  The file is compiled with
// -fmad=false so no multiply-add pair is contracted into an FMA, and without
// fast math, so `/` and sqrtf stay IEEE.  The per-lane sum over samples is
// sequential; the output is one store per lane (deterministic, no atomics).
// The per-(sample, light) terms live in gather_terms.cuh, shared with the
// slot kernels of gather_vpu.cu.

#include "gather_terms.cuh"

namespace {

using namespace vr;

template <bool kSphere, bool kPaired>
__global__ void __launch_bounds__(kThreads) gather_lanes_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ w,
    const int* __restrict__ lane_need, const float* __restrict__ lpos,
    const float* __restrict__ li, const int* __restrict__ meta, int L, int Cp,
    int Rc, float radius, float* __restrict__ out) {
  __shared__ float4 s_light[kChunk];  // (x, y, z, li) of the staged lights

  const int lane = blockIdx.x * kThreads + threadIdx.x;
  // Light range [start, start + count) read on the device: no host sync.
  const int start = max(meta[0], 0);
  const int count = max(min(meta[1], L - start), 0);
  // The paired tier walks whole groups of 4 from `start`.
  const int span = kPaired ? ((count + 3) / 4) * 4 : count;
  const int need = lane < Rc ? min(lane_need[lane], Cp) : 0;
  const PointBody<kSphere, kPaired> body{s_light, radius, count};

  float total = 0.0f;
  for (int c0 = 0; c0 < span; c0 += kChunk) {
    const int n = min(kChunk, span - c0);
    __syncthreads();  // the previous chunk is no longer read
    stage_lights(lpos, li, L, start + c0, n, s_light);
    __syncthreads();
    for (int j = 0; j < need; ++j) {
      const size_t o = static_cast<size_t>(j) * Rc + lane;
      const float acc = body(n, c0, px[o], py[o], pz[o], 0.0f);
      total = total + w[o] * acc;
    }
  }
  if (lane < Rc) out[lane] = total;
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
