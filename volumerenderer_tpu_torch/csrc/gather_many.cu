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
// one flat array of N samples.  The kernel writes
//
//     out[i] = w[i] * sum over valid slots k, in slot order, of
//              (bad ? 0 : li_k / max(d2e, 1e-4))
//
// with li = I / (4 pi) and d2e, bad as vr::staged_d2e (gather_terms.cuh)
// computes them, the term every other route evaluates.  Lights are staged
// through shared memory as float4 (x, y, z, li), one 256-slot tile (the TPU
// kernel's TILE_L) after another.  A tile whose active flag (any valid slot,
// computed on the device by the wrapper) is 0 is skipped: every thread of
// the block reads the same flag, so the skip and the __syncthreads stay
// uniform.
//
// Validity: only a tile's valid slots are staged, compacted in slot order (a
// prefix count over the block, gather_terms.cuh's block_offset).  The TPU
// kernel's caller instead parks an invalid slot at 1e15 with zero intensity
// (gather_kernel.py:114-115), whose term is exactly 0; leaving it out adds
// the same exact zeros, so the sum is bit for bit the same, and an invalid
// slot is never read, whatever it holds (NaN included).  Measured on the
// H100, a parked slot staged as a term cost about twice a valid one.
//
// Numerics: the TPU kernel takes d^2 = |p|^2 + |l|^2 - 2 p.l as a K = 8
// matmul on the MXU, in volume-centred coordinates, which costs up to ~1e-4
// absolute in d^2 (PARITY #8).  That expansion is a workaround for the MXU:
// here d^2 is taken by direct differences, as the reference's light loop
// does, which removes that error.  The term's levers (an FMA in d^2 and in
// the running sum, an approximate reciprocal) are those of
// gather_terms.cuh's staged_light_sums.
//
// What bounds it on this card: f32 instructions over live samples x valid
// lights, not bytes: a live sample reads 16 B and writes 4 B while it
// meets every valid light.  A point term is ~10 instructions with one
// reciprocal on the quarter-rate special-function unit, so the issue rate
// (one instruction a clock per SM quarter) sets the pace; a sphere term
// adds a reciprocal square root and ~10 instructions.  Most samples are
// dead (w == 0), and a thread per sample would leave most threads of a live
// block idle, so the kernel is the persistent live-sample loop of
// gather_terms.cuh (live_sample_loop): blocks take only live samples,
// kSamples a thread, through the staged table
// (staged_light_sums), the loop the discrete lane kernel shares.  The light
// table is staged once per block when its valid slots fit in kStage
// entries (the bench config's 1,500-1,700 do), in chunks for every batch
// beyond that.  A tensor-core form of the expanded d^2 speeds up only d^2's
// 5 operations and brings back the PARITY #8 error, so it is not taken.

#include "gather_terms.cuh"

namespace {

using namespace vr;

constexpr int kTileL = 256;  // light slots per tile flag (gather_kernel.TILE_L)
static_assert(kTileL == kThreads, "one slot per thread stages a tile");

// Stages the valid slots of tile [c0, c0 + n) into s_light in slot order;
// returns their count, the same in every thread.  Called by the whole
// block; s_warp holds kWarps counts (a prefix count over the block).  The
// caller synchronises before it (the previous tile is no longer read) and
// after it (s_light is complete).
__device__ __forceinline__ int stage_valid(
    const float* __restrict__ lpos, const float* __restrict__ li,
    const unsigned char* __restrict__ valid, int c0, int n, float4* s_light,
    int* s_warp) {
  const int t = threadIdx.x;
  const bool v = t < n && valid[c0 + t] != 0;
  int total;
  const int rank = block_offset(v ? 1 : 0, s_warp, &total);
  if (v) {
    const int k = c0 + t;
    s_light[rank] =
        make_float4(lpos[3 * k], lpos[3 * k + 1], lpos[3 * k + 2], li[k]);
  }
  return total;
}

// The light table for live_sample_loop: each next() stages the valid slots
// of the active tiles from the cursor on, in slot order, while a whole tile
// still fits in kStage entries.
struct TileStage {
  const float* lpos;
  const float* li;
  const unsigned char* valid;
  const int* active;
  int L;
  float4* s_light;
  int (*s_warp)[kWarps];
  int cursor;

  __device__ __forceinline__ int tiles() const {
    return (L + kTileL - 1) / kTileL;
  }
  __device__ __forceinline__ void begin() { cursor = 0; }
  __device__ __forceinline__ bool done() const { return cursor == tiles(); }
  __device__ __forceinline__ int next() {
    int fill = 0;
    int parity = 0;  // stage_valid's counts alternate between two buffers
    for (; cursor < tiles() && fill + kTileL <= kStage; ++cursor) {
      if (active[cursor] == 0) continue;  // the same flag for the whole block
      const int c0 = cursor * kTileL;
      fill += stage_valid(lpos, li, valid, c0, min(kTileL, L - c0),
                          s_light + fill, s_warp[parity]);
      parity ^= 1;
    }
    return fill;
  }
};

template <bool kSphere>
__global__ void __launch_bounds__(kThreads) many_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ w,
    const float* __restrict__ lpos, const float* __restrict__ li,
    const unsigned char* __restrict__ valid, const int* __restrict__ active,
    int L, int N, float radius, int* __restrict__ next_span,
    float* __restrict__ out) {
  __shared__ float4 s_light[kStage];
  __shared__ LiveShared sh;
  TileStage stage{lpos, li, valid, active, L, s_light, sh.warp, 0};
  live_sample_loop(px, py, pz, w, nullptr, 0, N, next_span, out, stage,
                   LightSums<kSphere>{s_light, radius}, sh);
}

template <bool kSphere>
int launch_many(const float* px, const float* py, const float* pz,
                const float* w, const float* lpos, const float* li,
                const unsigned char* valid, const int* active, int L, int N,
                float radius, int* next_span, float* out, cudaStream_t s) {
  static ResidentBlocks resident;
  unsigned blocks = 0;
  const int err =
      persistent_blocks(many_kernel<kSphere>, resident, N, w, out,
                        &blocks);
  if (err != 0) return err;
  many_kernel<kSphere><<<blocks, kThreads, 0, s>>>(
      px, py, pz, w, lpos, li, valid, active, L, N, radius, next_span, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point.  Planes px, py, pz, w and out: N f32 each, read flat;
// lpos: (L, 3) f32; li: (L,) f32 = I / (4 pi); valid: (L,) bytes (torch.bool);
// active: int32[ceil(L / 256)], tile t's flag = any valid slot in it;
// next_span: one int32 set to 0, the blocks' work counter.  Launches on
// `stream` and returns cudaGetLastError().  N < 2^31, 3 L < 2^31.
extern "C" int vr_gather_many(const float* px, const float* py,
                              const float* pz, const float* w,
                              const float* lpos, const float* li,
                              const unsigned char* valid, const int* active,
                              int L, int N, float radius, int sphere,
                              int* next_span, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sphere) {
    return launch_many<true>(px, py, pz, w, lpos, li, valid, active, L, N,
                             radius, next_span, out, s);
  }
  return launch_many<false>(px, py, pz, w, lpos, li, valid, active, L, N,
                            radius, next_span, out, s);
}

extern "C" const char* vr_many_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
