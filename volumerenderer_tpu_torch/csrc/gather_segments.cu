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
// What bounds it on this card: f32 divides, square roots and the
// polynomial atan, not bytes.  A sample (16 B of planes) meets every
// sub-light of every segment (discrete: thousands per frame) or every
// segment with ~50-100 flops each (analytic).  The design keeps operands on
// chip as the point kernel does (gather_lanes.cu): one thread per lane,
// samples streamed from the (Cp, Rc) planes (a warp's loads of row j are
// contiguous), the segment table (ax, ay, az, ux, uy, uz, ns or len, ii:
// 32 B) staged in shared memory in chunks of 1024 segments and read as
// broadcasts, the sums in registers.  The sub-light loop bound ns_k is the
// same for every thread, so warps do not diverge on it.  Each thread stops
// at its own lane_need.  When the segments span more than one chunk, the
// block walks its busiest lane's samples and re-stages the chunks for each
// sample, so that each sample keeps one running sum in the reference order.
//
// Arithmetic follows the reference term order.  The file is compiled with
// -fmad=false (no multiply-add contracted into an FMA) and without fast
// math, so `/` and sqrtf are IEEE.  jax.lax.rsqrt becomes 1.0f / sqrtf(x),
// two IEEE roundings, rather than rsqrtf, whose approximation differs from
// the CPU's by more than an ulp.  The polynomial atan and cos are kept:
// libdevice's atanf differs from them by up to ~2e-5 rad.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // lanes per block
constexpr int kChunk = 1024;      // segments staged at once (32 KB)
constexpr int kMaxNodes = 1024;   // quadrature nodes staged (8 KB)
constexpr float kGuard = 1e-4f;   // d^2 guard, common_functions.h:190
constexpr float kPairBig = 1e9f;  // gather_lanes.py PAIR_BIG
constexpr float kHalfPi = 1.5707963267948966f;
constexpr float kPi = 3.1415927410125732f;

enum Variant { kVrl = 0, kMidpoint = 1, kTangent = 2, kClosed = 3 };

// ---- device twins of the gather_vpu.py helpers, term for term ----

__device__ __forceinline__ float rsqrt_ieee(float x) { return 1.0f / sqrtf(x); }

__device__ __forceinline__ float atan_core(float z) {
  const float z2 = z * z;
  return z * (0.9998660f +
              z2 * (-0.3302995f +
                    z2 * (0.1801410f + z2 * (-0.0851330f + z2 * 0.0208351f))));
}

// gather_vpu._atan
__device__ __forceinline__ float atan_poly(float x) {
  const float ax = fabsf(x);
  const bool inv = ax > 1.0f;
  const float z = inv ? 1.0f / fmaxf(ax, 1e-30f) : ax;
  float p = atan_core(z);
  p = inv ? kHalfPi - p : p;
  return x < 0.0f ? -p : p;
}

// gather_vpu._atan_pos_poly
__device__ __forceinline__ float atan_pos_poly(float z, bool inverted,
                                               float den) {
  float p = atan_core(z);
  p = inverted ? kHalfPi - p : p;
  return den < 0.0f ? kPi - p : p;
}

// gather_vpu._atan_pos_ratio: atan(num/den) + pi (den < 0), num >= 0.
__device__ __forceinline__ float atan_pos_ratio(float num, float den) {
  const float ad = fabsf(den);
  const float lo = fminf(num, ad);
  const float hi = fmaxf(num, ad);
  return atan_pos_poly(lo / fmaxf(hi, 1e-30f), num > ad, den);
}

// gather_vpu._paired_pos_ratio_atans: two angles, one divide.
__device__ __forceinline__ void paired_atans(float num_a, float den_a,
                                             float num_b, float den_b,
                                             float* ang_a, float* ang_b) {
  const float ad_a = fabsf(den_a);
  const float ad_b = fabsf(den_b);
  const float lo_a = fminf(num_a, ad_a), hi_a = fmaxf(num_a, ad_a);
  const float lo_b = fminf(num_b, ad_b), hi_b = fmaxf(num_b, ad_b);
  const float inv = 1.0f / fmaxf(hi_a * hi_b, 1e-30f);
  *ang_a = atan_pos_poly(lo_a * (hi_b * inv), num_a > ad_a, den_a);
  *ang_b = atan_pos_poly(lo_b * (hi_a * inv), num_b > ad_b, den_b);
}

// gather_vpu._cos on (-pi/2, pi/2)
__device__ __forceinline__ float cos_poly(float x) {
  const float z = x * x;
  return 1.0f +
         z * (-4.9999936e-01f +
              z * (4.1664074e-02f + z * (-1.3856462e-03f + z * 2.3204736e-05f)));
}

// gather_vpu._cross_q2: |d x u|^2, floored at the guard.
__device__ __forceinline__ float cross_q2(float dx, float dy, float dz,
                                          float ux, float uy, float uz) {
  const float cx = dy * uz - dz * uy;
  const float cy = dz * ux - dx * uz;
  const float cz = dx * uy - dy * ux;
  return fmaxf(cx * cx + cy * cy + cz * cz, kGuard);
}

// gather_vpu._subtended_angle
__device__ __forceinline__ float subtended_angle(float b, float q2, float qd,
                                                 float ll) {
  return atan_pos_ratio(ll * qd, q2 - b * (ll - b));
}

// A sample's offset from a segment's start, and its projection b on u.
struct Geom {
  float dx, dy, dz, ux, uy, uz, b, ll;
};

// Segment table rows staged as two float4: (ax, ay, az, ux), (uy, uz, c6, ii)
// with c6 the sub-light count's bits (discrete) or the length (analytic).
__device__ __forceinline__ Geom geom_of(float x, float y, float z, float4 a,
                                        float4 c) {
  Geom g;
  g.dx = x - a.x;
  g.dy = y - a.y;
  g.dz = z - a.z;
  g.ux = a.w;
  g.uy = c.x;
  g.uz = c.y;
  g.b = g.dx * g.ux + g.dy * g.uy + g.dz * g.uz;
  g.ll = c.z;
  return g;
}

// gather_vpu._closed_pre: ds = ds_num / ds_den, plus (qc, d0, d1).
struct ClosedPre {
  float ds_num, ds_den, qc, d0, d1;
};

__device__ __forceinline__ ClosedPre closed_pre(const Geom& g, float radius) {
  ClosedPre p;
  const float q2 = cross_q2(g.dx, g.dy, g.dz, g.ux, g.uy, g.uz);
  p.qc = fmaxf(sqrtf(q2), radius * 1.015625f);
  const float qc2 = p.qc * p.qc;
  const float lb = g.ll - g.b;
  p.d0 = sqrtf(qc2 + g.b * g.b);
  p.d1 = sqrtf(qc2 + lb * lb);
  const float p0 = lb * p.d0;
  const float p1 = g.b * p.d1;
  const float den_c = p0 - p1;
  const bool inside = (g.b >= 0.0f) && (g.b <= g.ll);
  p.ds_num = inside ? p0 + p1 : qc2 * g.ll * (g.ll - 2.0f * g.b);
  p.ds_den = inside ? 1.0f : (den_c == 0.0f ? 1e-30f : den_c);
  return p;
}

// gather_vpu._closed_post: the antiderivative's parts except its atan.
struct ClosedPost {
  float n_r, q_r, t_pre, numt, dent, qc;
};

__device__ __forceinline__ ClosedPost closed_post(float ds, const Geom& g,
                                                  float radius,
                                                  const ClosedPre& p) {
  ClosedPost o;
  const float lb = g.ll - g.b;
  const float sl = p.qc * g.ll;
  const float A = (p.qc - radius) * (p.qc + radius);
  const float irA = rsqrt_ieee(A);
  const float kappa = (p.qc + radius) * irA;
  o.n_r = radius * (ds - radius * g.ll);
  o.q_r = (A * p.qc) * ((p.d0 - radius) * (p.d1 - radius));
  o.numt = kappa * (ds + sl);
  o.dent = (p.d0 + p.qc) * (p.d1 + p.qc) - (kappa * kappa) * (g.b * lb);
  o.t_pre = (2.0f * p.qc) * (irA * irA * irA);
  o.qc = p.qc;
  return o;
}

// ---- the shared lane loop ----

__device__ __forceinline__ void stage(const float* __restrict__ table,
                                      int first, int n, float4* s_a,
                                      float4* s_c) {
  const float4* t4 = reinterpret_cast<const float4*>(table);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s_a[i] = t4[2 * (first + i)];
    s_c[i] = t4[2 * (first + i) + 1];
  }
}

// Walks each lane's samples against the segments [start, start + count)
// staged in chunks; body(n, c0, x, y, z, acc) adds chunk c0's n segments to
// a sample's running sum.  Writes out[lane] = sum_j w[j] * acc_j.
template <class Body>
__device__ __forceinline__ void lane_loop(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ w,
    const int* __restrict__ lane_need, const float* __restrict__ table,
    int start, int count, int Cp, int Rc, float* __restrict__ out,
    float4* s_a, float4* s_c, const Body& body) {
  __shared__ int s_block_need;
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const int need = lane < Rc ? min(lane_need[lane], Cp) : 0;
  const int nchunk = (count + kChunk - 1) / kChunk;  // uniform in the block
  int loop_need = nchunk > 0 ? need : 0;
  if (nchunk == 1) {
    stage(table, start, count, s_a, s_c);
    __syncthreads();
  } else if (nchunk > 1) {
    if (threadIdx.x == 0) s_block_need = 0;
    __syncthreads();
    atomicMax(&s_block_need, need);
    __syncthreads();
    loop_need = s_block_need;
  }
  float total = 0.0f;
  for (int j = 0; j < loop_need; ++j) {
    const bool live = j < need;
    const size_t o = static_cast<size_t>(j) * Rc + lane;
    const float x = live ? px[o] : 0.0f;
    const float y = live ? py[o] : 0.0f;
    const float z = live ? pz[o] : 0.0f;
    float acc = 0.0f;
    for (int c = 0; c < nchunk; ++c) {
      const int c0 = c * kChunk;
      const int n = min(kChunk, count - c0);
      if (nchunk > 1) {
        __syncthreads();  // the previous chunk is no longer read
        stage(table, start + c0, n, s_a, s_c);
        __syncthreads();
      }
      if (live) acc = body(n, c0, x, y, z, acc);
    }
    if (live) total = total + w[o] * acc;
  }
  if (lane < Rc) out[lane] = total;
}

// ---- kernel 2: discrete sub-lights ----

template <bool kSphere>
__device__ __forceinline__ float sub_d2e(float x, float y, float z, float4 a,
                                         float4 c, int s, float step,
                                         float radius, bool* bad) {
  const float sf = static_cast<float>(s) * step;
  const float dx = x - (a.x + sf * a.w);
  const float dy = y - (a.y + sf * c.x);
  const float dz = z - (a.z + sf * c.y);
  const float d2 = dx * dx + dy * dy + dz * dz;
  if constexpr (kSphere) {
    const float dist = sqrtf(d2);
    const float dd = dist - radius;
    const float d2e = dd * dd;
    *bad = (d2e < kGuard) || (dist == 0.0f);
    return d2e;
  } else {
    *bad = d2 < kGuard;
    return d2;
  }
}

template <bool kSphere, bool kPaired>
struct DiscreteBody {
  const float4* s_a;
  const float4* s_c;
  float step, radius;

  __device__ __forceinline__ float operator()(int n, int /*c0*/, float x,
                                              float y, float z,
                                              float acc) const {
    for (int k = 0; k < n; ++k) {
      const float4 a = s_a[k];
      const float4 c = s_c[k];
      const int ns = __float_as_int(c.z);
      const float ii = c.w;
      if constexpr (kPaired) {
        float part = 0.0f;
        for (int g = 0; g < (ns + 3) / 4; ++g) {
          float q[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int s = g * 4 + t;
            bool bad;
            const float d2e = sub_d2e<kSphere>(x, y, z, a, c, s, step, radius,
                                               &bad);
            q[t] = (bad || s >= ns) ? kPairBig : d2e;
          }
          const float q12 = q[0] * q[1];
          const float q34 = q[2] * q[3];
          const float s12 = q[0] + q[1];
          const float s34 = q[2] + q[3];
          part = part + (s12 * q34 + s34 * q12) / (q12 * q34);
        }
        acc = acc + ii * part;
      } else {
        for (int s = 0; s < ns; ++s) {
          bool bad;
          const float d2e = sub_d2e<kSphere>(x, y, z, a, c, s, step, radius,
                                             &bad);
          acc = acc + (bad ? 0.0f : ii / fmaxf(d2e, kGuard));
        }
      }
    }
    return acc;
  }
};

template <bool kSphere, bool kPaired>
__global__ void __launch_bounds__(kThreads) discrete_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ w,
    const int* __restrict__ lane_need, const float* __restrict__ table,
    const int* __restrict__ meta, int L, int Cp, int Rc, float step,
    float radius, float* __restrict__ out) {
  __shared__ float4 s_a[kChunk];
  __shared__ float4 s_c[kChunk];
  // Segment range [start, start + count) read on the device: no host sync.
  const int start = max(meta[0], 0);
  const int count = max(min(meta[1], L - start), 0);
  const DiscreteBody<kSphere, kPaired> body{s_a, s_c, step, radius};
  lane_loop(px, py, pz, w, lane_need, table, start, count, Cp, Rc, out, s_a,
            s_c, body);
}

// ---- kernel 3: analytic segment integrals ----

// The VBL node rules: node j's (n, q), j < nodes (padding nodes are (0, 1)).
template <int kVariant>
struct Nodes {
  const float* nx;  // midpoint fractions or Gauss-Legendre nodes
  const float* nw;  // Gauss-Legendre weights
  int nodes;
  float radius;
  // midpoint: c = |d|^2; tangent: t0, dt, qd
  float c, b, ll, t0, dt, qd;

  __device__ __forceinline__ void at(int j, float* n, float* q) const {
    if (j >= nodes) {
      *n = 0.0f;
      *q = 1.0f;
      return;
    }
    if constexpr (kVariant == kMidpoint) {
      const float s = nx[j] * ll;
      const float d = sqrtf(fmaxf(c - 2.0f * b * s + s * s, 0.0f));
      const float dd = d - radius;
      const float d2e = dd * dd;
      const bool bad = (d2e < kGuard) || (d == 0.0f);
      *n = bad ? 0.0f : 1.0f;
      *q = bad ? 1.0f : d2e;
    } else {
      const float cth = cos_poly(t0 + nx[j] * dt);
      const float e = qd - radius * cth;
      const float e2 = e * e;
      const bool bad = e2 < kGuard * (cth * cth);
      *n = bad ? 0.0f : nw[j];
      *q = bad ? 1.0f : e2;
    }
  }
};

// gather_vpu._node_sum
template <int kVariant, bool kPaired>
__device__ __forceinline__ float node_sum(const Nodes<kVariant>& nd) {
  float total = 0.0f;
  if constexpr (kPaired) {
    for (int j0 = 0; j0 < nd.nodes; j0 += 4) {
      float n1, q1, n2, q2, n3, q3, n4, q4;
      nd.at(j0, &n1, &q1);
      nd.at(j0 + 1, &n2, &q2);
      nd.at(j0 + 2, &n3, &q3);
      nd.at(j0 + 3, &n4, &q4);
      const float q12 = q1 * q2;
      const float q34 = q3 * q4;
      const float n12 = n1 * q2 + n2 * q1;
      const float n34 = n3 * q4 + n4 * q3;
      total = total + (n12 * q34 + n34 * q12) / (q12 * q34);
    }
  } else {
    for (int j = 0; j < nd.nodes; ++j) {
      float n, q;
      nd.at(j, &n, &q);
      total = total + n / q;
    }
  }
  return total;
}

template <int kVariant, bool kPaired>
struct AnalyticBody {
  const float4* s_a;
  const float4* s_c;
  const float* nx;
  const float* nw;
  int nodes, count;
  float radius;

  // One segment, one divide or more per segment (the unpaired forms and
  // the node rules).
  __device__ __forceinline__ float one(const Geom& g, float ii,
                                       float acc) const {
    if constexpr (kVariant == kVrl) {
      const float q2 = cross_q2(g.dx, g.dy, g.dz, g.ux, g.uy, g.uz);
      const float iq = rsqrt_ieee(q2);
      const float integral = subtended_angle(g.b, q2, q2 * iq, g.ll) * iq;
      return acc + ii * integral;
    } else if constexpr (kVariant == kClosed) {
      const ClosedPre p = closed_pre(g, radius);
      const ClosedPost o = closed_post(p.ds_num / p.ds_den, g, radius, p);
      const float t_term = o.t_pre * atan_pos_ratio(o.numt, o.dent);
      float total = 0.0f;
      total = total + o.n_r / o.q_r;
      total = total + t_term / 1.0f;
      return acc + ii * o.qc * total;
    } else {
      Nodes<kVariant> nd{nx, nw, nodes, radius, 0.0f, g.b, g.ll,
                         0.0f, 0.0f, 0.0f};
      float scale;
      if constexpr (kVariant == kMidpoint) {
        nd.c = g.dx * g.dx + g.dy * g.dy + g.dz * g.dz;
        scale = g.ll / static_cast<float>(nodes);
      } else {
        const float q2 = cross_q2(g.dx, g.dy, g.dz, g.ux, g.uy, g.uz);
        const float iq = rsqrt_ieee(q2);
        nd.qd = q2 * iq;
        nd.t0 = atan_poly(-g.b * iq);
        nd.dt = subtended_angle(g.b, q2, nd.qd, g.ll);
        scale = nd.dt * nd.qd;
      }
      const float total = node_sum<kVariant, kPaired>(nd);
      return acc + ii * scale * total;
    }
  }

  // Two segments per trip, their divides shared (gather_vpu
  // _vrl_paired_sum / _closed_paired_sum).
  __device__ __forceinline__ float two(const Geom& ga, float ii_a,
                                       const Geom& gb, float ii_b,
                                       float acc) const {
    if constexpr (kVariant == kVrl) {
      const float q2a = cross_q2(ga.dx, ga.dy, ga.dz, ga.ux, ga.uy, ga.uz);
      const float iqa = rsqrt_ieee(q2a);
      const float q2b = cross_q2(gb.dx, gb.dy, gb.dz, gb.ux, gb.uy, gb.uz);
      const float iqb = rsqrt_ieee(q2b);
      float ang_a, ang_b;
      paired_atans(ga.ll * (q2a * iqa), q2a - ga.b * (ga.ll - ga.b),
                   gb.ll * (q2b * iqb), q2b - gb.b * (gb.ll - gb.b), &ang_a,
                   &ang_b);
      return acc + ii_a * (ang_a * iqa) + ii_b * (ang_b * iqb);
    }
    const ClosedPre pa = closed_pre(ga, radius);
    const ClosedPre pb = closed_pre(gb, radius);
    const float rec = 1.0f / (pa.ds_den * pb.ds_den);  // divide 1 of 3
    const ClosedPost oa = closed_post(pa.ds_num * (pb.ds_den * rec), ga,
                                      radius, pa);
    const ClosedPost ob = closed_post(pb.ds_num * (pa.ds_den * rec), gb,
                                      radius, pb);
    float ang_a, ang_b;
    paired_atans(oa.numt, oa.dent, ob.numt, ob.dent, &ang_a,
                 &ang_b);  // divide 2 of 3
    const float sa = ii_a * oa.qc;
    const float sb = ii_b * ob.qc;
    const float rat = ((sa * oa.n_r) * ob.q_r + (sb * ob.n_r) * oa.q_r) /
                      (oa.q_r * ob.q_r);  // divide 3 of 3
    return acc + rat + sa * (oa.t_pre * ang_a) + sb * (ob.t_pre * ang_b);
  }

  __device__ __forceinline__ float operator()(int n, int c0, float x, float y,
                                              float z, float acc) const {
    if constexpr (kPaired && (kVariant == kVrl || kVariant == kClosed)) {
      // Chunks hold an even number of segments, so a pair never straddles
      // two; the tail's partner clamps to the last segment, ii zeroed.
      for (int i = 0; i < n; i += 2) {
        const int i1 = min(i + 1, n - 1);
        const Geom ga = geom_of(x, y, z, s_a[i], s_c[i]);
        const Geom gb = geom_of(x, y, z, s_a[i1], s_c[i1]);
        const float ii_b = (c0 + i + 1 < count) ? s_c[i1].w : 0.0f;
        acc = two(ga, s_c[i].w, gb, ii_b, acc);
      }
      return acc;
    }
    for (int k = 0; k < n; ++k) {
      acc = one(geom_of(x, y, z, s_a[k], s_c[k]), s_c[k].w, acc);
    }
    return acc;
  }
};

template <int kVariant, bool kPaired>
__global__ void __launch_bounds__(kThreads) analytic_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ w,
    const int* __restrict__ lane_need, const float* __restrict__ table,
    const float* __restrict__ node_tab, const int* __restrict__ meta, int L,
    int Cp, int Rc, int nodes, float radius, float* __restrict__ out) {
  __shared__ float4 s_a[kChunk];
  __shared__ float4 s_c[kChunk];
  __shared__ float s_nx[kMaxNodes];
  __shared__ float s_nw[kMaxNodes];
  const int start = max(meta[0], 0);
  const int count = max(min(meta[1], L - start), 0);
  // node_tab is (2, max(nodes, 1)): fractions or nodes, then weights.
  const int stride = max(nodes, 1);
  for (int i = threadIdx.x; i < nodes; i += kThreads) {
    s_nx[i] = node_tab[i];
    s_nw[i] = node_tab[stride + i];
  }
  __syncthreads();
  const AnalyticBody<kVariant, kPaired> body{s_a, s_c, s_nx, s_nw,
                                             nodes, count, radius};
  lane_loop(px, py, pz, w, lane_need, table, start, count, Cp, Rc, out, s_a,
            s_c, body);
}

dim3 grid_of(int Rc) { return dim3((Rc + kThreads - 1) / kThreads); }

template <bool kSphere, bool kPaired>
void launch_discrete(const float* px, const float* py, const float* pz,
                     const float* w, const int* lane_need, const float* table,
                     const int* meta, int L, int Cp, int Rc, float step,
                     float radius, float* out, cudaStream_t s) {
  discrete_kernel<kSphere, kPaired><<<grid_of(Rc), kThreads, 0, s>>>(
      px, py, pz, w, lane_need, table, meta, L, Cp, Rc, step, radius, out);
}

template <int kVariant, bool kPaired>
void launch_analytic(const float* px, const float* py, const float* pz,
                     const float* w, const int* lane_need, const float* table,
                     const float* node_tab, const int* meta, int L, int Cp,
                     int Rc, int nodes, float radius, float* out,
                     cudaStream_t s) {
  analytic_kernel<kVariant, kPaired><<<grid_of(Rc), kThreads, 0, s>>>(
      px, py, pz, w, lane_need, table, node_tab, meta, L, Cp, Rc, nodes,
      radius, out);
}

}  // namespace

// Plain C entry points.  Planes px, py, pz, w: (Cp, Rc) f32 row-major;
// lane_need: (Rc,) i32; table: (L, 8) f32 rows (ax, ay, az, ux, uy, uz, c6,
// ii), 16-byte aligned; meta: int32[2] = (start, count) on the device; out:
// (Rc,) f32.  Each launches on `stream` and returns cudaGetLastError().

// c6 = the sub-light count ns as int32 bits; ii = I / ns / (4 pi).
extern "C" int vr_gather_segments_discrete(
    const float* px, const float* py, const float* pz, const float* w,
    const int* lane_need, const float* table, const int* meta, int L, int Cp,
    int Rc, float step, float radius, int sphere, int paired, float* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sphere) {
    if (paired) {
      launch_discrete<true, true>(px, py, pz, w, lane_need, table, meta, L,
                                  Cp, Rc, step, radius, out, s);
    } else {
      launch_discrete<true, false>(px, py, pz, w, lane_need, table, meta, L,
                                   Cp, Rc, step, radius, out, s);
    }
  } else {
    if (paired) {
      launch_discrete<false, true>(px, py, pz, w, lane_need, table, meta, L,
                                   Cp, Rc, step, radius, out, s);
    } else {
      launch_discrete<false, false>(px, py, pz, w, lane_need, table, meta, L,
                                    Cp, Rc, step, radius, out, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// c6 = the segment length; ii = I / (4 pi L).  node_tab: (2, max(nodes, 1))
// f32 node fractions / Gauss-Legendre nodes, then weights; nodes <= 1024.
// variant: 0 VRL, 1 VBL midpoint, 2 VBL tangent, 3 VBL closed.
extern "C" int vr_gather_segments_analytic(
    const float* px, const float* py, const float* pz, const float* w,
    const int* lane_need, const float* table, const float* node_tab,
    const int* meta, int L, int Cp, int Rc, int nodes, float radius,
    int variant, int paired, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nodes < 0 || nodes > kMaxNodes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define VR_ANALYTIC(V)                                                      \
  do {                                                                      \
    if (paired) {                                                           \
      launch_analytic<V, true>(px, py, pz, w, lane_need, table, node_tab,   \
                               meta, L, Cp, Rc, nodes, radius, out, s);     \
    } else {                                                                \
      launch_analytic<V, false>(px, py, pz, w, lane_need, table, node_tab,  \
                                meta, L, Cp, Rc, nodes, radius, out, s);    \
    }                                                                       \
  } while (0)
  switch (variant) {
    case kVrl:
      VR_ANALYTIC(kVrl);
      break;
    case kMidpoint:
      VR_ANALYTIC(kMidpoint);
      break;
    case kTangent:
      VR_ANALYTIC(kTangent);
      break;
    case kClosed:
      VR_ANALYTIC(kClosed);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VR_ANALYTIC
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vr_segments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
