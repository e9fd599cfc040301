// The nearest-voxel fetch of grid.dense.DenseGrid.sample_nearest, shared by
// the march (march_planes.cu) and the photon walk (photon_walk.cu): the
// voxel at floor(p), 0 outside the volume.

#pragma once

#include <cuda_runtime.h>

// vox: (nx, ny, nz) f32, voxel (i, j, k) of index space at
// vox[i - bm[0], j - bm[1], k - bm[2]].  floor(p) converts to int64 as
// torch's .to(torch.int64) does; anything beyond +-4e18 (or NaN) is far
// outside every volume.  The voxel is read through the read-only path.
__device__ __forceinline__ float fetch_nearest(const float* vox, int nx,
                                               int ny, int nz,
                                               const long long bm[3], float x,
                                               float y, float z) {
  const float f[3] = {floorf(x), floorf(y), floorf(z)};
  const int n[3] = {nx, ny, nz};
  long long r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (!(f[c] >= -4.0e18f && f[c] < 4.0e18f)) return 0.0f;
    r[c] = static_cast<long long>(f[c]) - bm[c];
    if (r[c] < 0 || r[c] >= n[c]) return 0.0f;
  }
  return __ldg(vox + (r[0] * ny + r[1]) * nz + r[2]);
}
