// Many-light point/sphere gather for Hopper (sm_90a).
//
// Replaces the TPU kernel of volumerenderer_tpu/ops/pallas/gather_kernel.py,
// `gather_mxu` -> `_kernel` (gather_kernel.py:49): the point or sphere light
// sum over any number of light slots with a per-slot validity, which the
// reference package takes above SMEM_LIGHT_LIMIT = 2048 slots (the compacted
// Ray/Beam sub-light expansion, photon light buffers of reference size).
//
// Layout: the planes px, py, pz, w are any C-contiguous f32 arrays (the (R, C)
// slots of a ViewCache or the (Cp, Rc) lane planes of a CompactView), read as
// one flat array of N samples.  Each thread owns one sample and writes
//
//     out[i] = w[i] * sum over valid slots k, in slot order, of
//              (bad ? 0 : li_k / max(d2e, 1e-4))
//
// with li = I / (4 pi) and d2e, bad from vr::d2e_of (gather_terms.cuh), the
// term every other route evaluates.  Lights are staged through shared memory
// one 256-slot tile at a time (the TPU kernel's TILE_L), as float4
// (x, y, z, li).  A tile whose active flag (any valid slot, computed on the
// device by the wrapper) is 0 is skipped: every thread of the block reads the
// same flag, so the skip and the __syncthreads stay uniform.
//
// Validity: only a tile's valid slots are staged, compacted in slot order (a
// ballot and a prefix count over the block's warps).  The TPU kernel's caller
// instead parks an invalid slot at 1e15 with zero intensity
// (gather_kernel.py:114-115), whose term is exactly 0; leaving it out adds
// the same exact zeros, so the sum is bit for bit the same, and an invalid
// slot is never read, whatever it holds (NaN included).  Measured on the
// H100, a parked slot staged as a term cost about twice a valid one.
//
// Weight fused: a sample with w == 0 writes 0 without its sum, and a block of
// 256 such samples returns after one __syncthreads_or, as in gather_vpu.cu.
// That equals w * sum wherever the guarded sum is finite, which the guards
// ensure (every divide is by a denominator floored at the guard).
//
// Numerics: the TPU kernel takes d^2 = |p|^2 + |l|^2 - 2 p.l as a K = 8
// matmul on the MXU, in volume-centred coordinates, which costs up to ~1e-4
// absolute in d^2 (PARITY #8).  That expansion is a workaround for the MXU:
// here d^2 is taken by direct differences, as the reference's light loop
// does, which removes that error.  Built with -fmad=false and no fast math
// (see gather_terms.cuh), so each term rounds like the plain version's.
//
// What bounds it on this card: f32 operations (13 a point term, 18 a sphere
// term, one IEEE divide among them) over live samples x valid lights, not
// bytes: a live sample reads 16 B and writes 4 B while it meets every valid
// light.  The design keeps the operands on chip (the tile in shared memory,
// read as broadcasts; the sum in a register) and skips dead samples, dead
// blocks and empty tiles.  A tensor-core form of the expanded d^2 is a
// redesign for later.

#include "gather_terms.cuh"

namespace {

using namespace vr;

constexpr int kTileL = 256;  // light slots staged at once (gather_kernel.TILE_L)
static_assert(kTileL == kThreads, "one slot per thread stages a tile");
constexpr int kWarps = kThreads / 32;

// Stages the valid slots of tile [c0, c0 + n) into s_light in slot order;
// returns their count, the same in every thread.  Called by the whole
// block; s_warp holds kWarps counts.  The caller synchronises before it (the
// previous tile is no longer read) and after it (s_light is complete).
__device__ __forceinline__ int stage_valid(
    const float* __restrict__ lpos, const float* __restrict__ li,
    const unsigned char* __restrict__ valid, int c0, int n, float4* s_light,
    int* s_warp) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const bool v = t < n && valid[c0 + t] != 0;
  const unsigned mask = __ballot_sync(0xffffffffu, v);
  if (lane == 0) s_warp[warp] = __popc(mask);
  __syncthreads();
  int before = 0;
  int total = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    const int c = s_warp[q];
    before += q < warp ? c : 0;
    total += c;
  }
  if (v) {
    const int k = c0 + t;
    s_light[before + __popc(mask & ((1u << lane) - 1u))] =
        make_float4(lpos[3 * k], lpos[3 * k + 1], lpos[3 * k + 2], li[k]);
  }
  return total;
}

template <bool kSphere>
__global__ void __launch_bounds__(kThreads) many_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ w,
    const float* __restrict__ lpos, const float* __restrict__ li,
    const unsigned char* __restrict__ valid, const int* __restrict__ active,
    int L, long long N, float radius, float* __restrict__ out) {
  __shared__ float4 s_light[kTileL];
  __shared__ int s_warp[kWarps];
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
  const PointBody<kSphere, false> body{s_light, radius, 0};
  float acc = 0.0f;
  const int tiles = (L + kTileL - 1) / kTileL;
  for (int t = 0; t < tiles; ++t) {
    if (active[t] == 0) continue;  // the same flag for the whole block
    const int c0 = t * kTileL;
    __syncthreads();  // the previous tile is no longer read
    const int n = stage_valid(lpos, li, valid, c0, min(kTileL, L - c0),
                              s_light, s_warp);
    __syncthreads();
    if (live) acc = body(n, c0, x, y, z, acc);
  }
  if (in) out[i] = live ? wi * acc : 0.0f;
}

template <bool kSphere>
void launch_many(const float* px, const float* py, const float* pz,
                 const float* w, const float* lpos, const float* li,
                 const unsigned char* valid, const int* active, int L,
                 long long N, float radius, float* out, cudaStream_t s) {
  const dim3 blocks(static_cast<unsigned>((N + kThreads - 1) / kThreads));
  many_kernel<kSphere><<<blocks, kThreads, 0, s>>>(
      px, py, pz, w, lpos, li, valid, active, L, N, radius, out);
}

}  // namespace

// Plain C entry point.  Planes px, py, pz, w and out: N f32 each, read flat;
// lpos: (L, 3) f32; li: (L,) f32 = I / (4 pi); valid: (L,) bytes (torch.bool);
// active: int32[ceil(L / 256)], tile t's flag = any valid slot in it.
// Launches on `stream` and returns cudaGetLastError().  N < 2^31 * 256,
// 3 L < 2^31.
extern "C" int vr_gather_many(const float* px, const float* py,
                              const float* pz, const float* w,
                              const float* lpos, const float* li,
                              const unsigned char* valid, const int* active,
                              int L, long long N, float radius, int sphere,
                              float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sphere) {
    launch_many<true>(px, py, pz, w, lpos, li, valid, active, L, N, radius,
                      out, s);
  } else {
    launch_many<false>(px, py, pz, w, lpos, li, valid, active, L, N, radius,
                       out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vr_many_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
