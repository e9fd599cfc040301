"""Plain PyTorch reference of the renderer, frozen for the benchmark.

It implements the semantics of the reference shaders as the port documents
them (light_gen.comp, point/sphere/ray/beam_compute_color.comp,
path_compute_color.comp): a pinhole camera, the slab clip, a fixed-step
front-to-back march with the T <= 0.001 cutoff, the photon walk that turns
scatter events into lights, the per-sample light sums and PATH's
single-scattering walk.  It is written from those semantics alone, with
plain tensor operations and no caching, banding, occupancy skipping or
kernel.  It imports nothing of the program.

Where a rounding choice decides a discrete outcome (which voxel a position
falls in, whether a photon scatters), it follows the documented contract,
so that both sides make the same choice on the same inputs:

  * the march distance is ``t0 + k * step`` (the product rounded alone),
    a position ``o + d * t``;
  * the photon walk advances ``t`` in windows of ``min(256, S)`` steps
    (``S`` the segment bound, the diagonal of the brick-padded volume in
    steps, plus 2), and a segment that crosses ``S`` steps ends;
  * the RNG is the reference's integer hash with uint32 wraparound; a
    direction is ``acos``/``sin``/``cos`` of two draws, normalized;
  * world <-> index maps are 3x3 products written as multiply-adds.

``dtype`` selects the precision of the shading (the march weights, the
light terms and their sums).  float32 is the configuration's precision;
the benchmark's control runs the same code in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32
ENTRY_EPS = 1e-3
T_CUTOFF = 1e-3
BRICK = 8
_MASK = 0xFFFFFFFF
_INV_U32_MAX = float(np.float32(1.0) / np.float32(4294967295.0))
_TWO_PI = float(np.float32(2.0 * math.pi))
_FOUR_PI = float(np.float32(4.0) * np.float32(math.pi))


def f32(x) -> float:
    return float(np.float32(x))


# ---------------- volume ----------------


class Volume:
    """A dense density array over an index-space box, with a uniform voxel
    size and a translation (index -> world: ``mat @ p + vec``).  Positions
    outside the box read 0."""

    def __init__(self, values: torch.Tensor, bbox_min, voxel_size: float,
                 translation):
        dev = values.device
        self.values = values.contiguous().to(F32)
        self.shape = tuple(int(s) for s in values.shape)
        self.bbox_min = torch.as_tensor(np.asarray(bbox_min, np.int64),
                                        device=dev)
        mat = np.eye(3, dtype=np.float32) * np.float32(voxel_size)
        self.mat = torch.as_tensor(mat, device=dev)
        self.inv = torch.as_tensor(np.linalg.inv(mat).astype(np.float32),
                                   device=dev)
        self.vec = torch.as_tensor(np.asarray(translation, np.float32),
                                   device=dev)
        self.box_min = self.bbox_min.to(F32)
        self.box_max = (self.bbox_min
                        + torch.as_tensor(self.shape, device=dev)).to(F32)

    @classmethod
    def active(cls, values: torch.Tensor, bbox_min, voxel_size, translation):
        """The volume a sparse file stores: its nonzero (active) voxels,
        over their tight bounding box."""
        nz = torch.nonzero(values)
        lo = nz.min(dim=0).values.tolist()
        hi = (nz.max(dim=0).values + 1).tolist()
        sub = values[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        return cls(sub, np.asarray(bbox_min, np.int64) + np.asarray(lo),
                   voxel_size, translation)

    @property
    def padded_shape(self):
        return tuple(-(-s // BRICK) * BRICK for s in self.shape)

    def segment_bound(self, step: float, cap: int = 2500) -> int:
        """Steps a straight segment can take inside the (brick-padded)
        volume: its diagonal in steps, plus 2."""
        diag = math.sqrt(sum(float(s) ** 2 for s in self.padded_shape))
        return max(1, min(cap, int(math.ceil(diag / float(step))) + 2))

    def sample(self, pos: torch.Tensor) -> torch.Tensor:
        rel = torch.floor(pos).to(torch.int64) - self.bbox_min
        nx, ny, nz = self.shape
        inside = ((rel >= 0).all(dim=-1) & (rel[..., 0] < nx)
                  & (rel[..., 1] < ny) & (rel[..., 2] < nz))
        i = rel[..., 0].clamp(0, nx - 1)
        j = rel[..., 1].clamp(0, ny - 1)
        k = rel[..., 2].clamp(0, nz - 1)
        v = self.values.reshape(-1)[(i * ny + j) * nz + k]
        return torch.where(inside, v, 0.0)

    def to_world(self, p):
        return _matvec(self.mat, p) + self.vec

    def to_index(self, p):
        return _matvec(self.inv, p - self.vec)

    def dir_to_index(self, d):
        return _matvec(self.inv, d)


def _matvec(m, p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
                        m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
                        m[2, 0] * x + m[2, 1] * y + m[2, 2] * z], dim=-1)


def _norm(d):
    return torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def intersect(o, d, bmin, bmax, tmin, tmax):
    inv = 1.0 / d
    ta = (bmin - o) * inv
    tb = (bmax - o) * inv
    swap = inv < 0.0
    lo = torch.where(swap, tb, ta)
    hi = torch.where(swap, ta, tb)
    tmin = torch.maximum(tmin, lo.amax(dim=-1))
    tmax = torch.minimum(tmax, hi.amin(dim=-1))
    return tmax >= tmin, tmin, tmax


# ---------------- RNG ----------------


def _hash(x, y, z):
    h = ((x * 73856093) & _MASK) ^ ((y * 19349663) & _MASK) \
        ^ ((z * 83492791) & _MASK)
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _MASK
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _MASK
    return h ^ (h >> 16)


def randf_at(seed, k):
    """The k-th draw (1-based) of a uvec3 seed: hash(seed + k) / (2^32-1)."""
    h = _hash((seed[..., 0] + k) & _MASK, (seed[..., 1] + k) & _MASK,
              (seed[..., 2] + k) & _MASK)
    return h.to(F32) * _INV_U32_MAX


def random_dir(r1, r2):
    theta = torch.arccos(torch.clamp(1.0 - 2.0 * r1, -1.0, 1.0))
    phi = _TWO_PI * r2
    st = torch.sin(theta)
    d = torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                     torch.cos(theta)], dim=-1)
    return d / _norm(d)


# ---------------- camera and march ----------------


def camera_rays(vol: Volume, width: int, height: int, fov: float,
                camera_pos):
    """Index-space origins and unit directions of every pixel, row-major."""
    dev = vol.values.device
    scale = torch.tan(torch.tensor(fov, dtype=F32, device=dev)
                      * f32(0.5 * math.pi / 180.0))
    aspect = f32(width / height)
    px = torch.arange(width, dtype=F32, device=dev)[None, :]
    py = torch.arange(height, dtype=F32, device=dev)[:, None]
    x = ((px + 0.5) * f32(2.0 / width) - 1.0) * (aspect * scale)
    y = (1.0 - (py + 0.5) * f32(2.0 / height)) * scale
    x, y = x.expand(height, width), y.expand(height, width)
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1).reshape(-1, 3)
    d = d / _norm(d)
    o = torch.as_tensor(np.asarray(camera_pos, np.float32),
                        device=dev).expand(d.shape)
    d_i = vol.dir_to_index(d)
    return vol.to_index(o), d_i / _norm(d_i)


def march_samples(vol: Volume, o, d, *, step: float, absorption: float,
                  ray_max_distance: float, block_elems: int = 1 << 24):
    """Every ray's march, reduced to its samples of nonzero weight:
    (ray index (M,), weight (M,), world position (M, 3)), in ray order."""
    dev = o.device
    n = o.shape[0]
    zero = torch.zeros(n, dtype=F32, device=dev)
    hit, tmin, tmax = intersect(o, d, vol.box_min, vol.box_max, zero,
                                zero + ray_max_distance)
    live = hit & (tmax > 0.0)
    tmin = torch.clamp(tmin, min=0.0) + f32(np.float32(ENTRY_EPS)
                                             * np.float32(step))
    span = torch.where(live, tmax - tmin, 0.0)
    S = max(1, int(math.ceil(float(span.max()) / step)) + 1)
    k = torch.arange(S, dtype=F32, device=dev)
    rays, ws, ps = [], [], []
    blk = max(1, block_elems // S)
    for a in range(0, n, blk):
        b = slice(a, min(n, a + blk))
        t = tmin[b, None] + k * step
        pos = o[b, None, :] + d[b, None, :] * t[..., None]
        val = vol.sample(pos)
        att = torch.exp(-val * absorption * step)
        trans = torch.cat([torch.ones_like(att[:, :1]),
                           torch.cumprod(att[:, :-1], dim=-1)], dim=-1)
        active = live[b, None] & (t < tmax[b, None]) & (trans > T_CUTOFF)
        w = torch.where(active, trans * val * step, 0.0)
        r, s = torch.nonzero(w, as_tuple=True)
        rays.append(r + a)
        ws.append(w[r, s])
        ps.append(vol.to_world(pos[r, s]))
    return torch.cat(rays), torch.cat(ws), torch.cat(ps)


# ---------------- photon walk ----------------


def photon_events(vol: Volume, frame_counts, *, step: float,
                  absorption: float, scattering: float, intensity0: float,
                  light_world, ray_max_distance: float, segment_bound: int,
                  num_photons: int = 16, max_events: int = 256,
                  max_photon_steps: int = 4096):
    """The scatter events of every photon of the given frames, one step at a
    time for all photons at once.  Returns events (F*P, K, 7) = (from xyz,
    to xyz, intensity) and their counts (F*P,), photon-major per frame."""
    dev = vol.values.device
    fcs = [int(f) for f in frame_counts]
    n_side = int(round(num_photons ** 0.5))
    P = len(fcs) * num_photons
    K = max_events
    pid = torch.arange(num_photons, device=dev).repeat(len(fcs))
    fc = torch.repeat_interleave(torch.as_tensor(fcs, device=dev),
                                 num_photons).to(torch.int64)
    seed = torch.stack([((pid % n_side) * fc) & _MASK,
                        ((pid // n_side) * fc) & _MASK,
                        torch.zeros_like(fc)], dim=-1)
    origin_w = torch.stack([torch.full((P,), float(v), dtype=F32, device=dev)
                            for v in np.asarray(light_world, np.float32)], -1)
    d_i = vol.dir_to_index(random_dir(randf_at(seed, 1), randf_at(seed, 2)))
    dirn = d_i / _norm(d_i)
    origin = vol.to_index(origin_w)
    zero = torch.zeros(P, dtype=F32, device=dev)
    hit, tmin, tmax = intersect(origin, dirn, vol.box_min, vol.box_max, zero,
                                zero + ray_max_distance)
    S = int(segment_bound)
    Wn = min(256, S)
    max_windows = (K + 1) + max(1, max_photon_steps // Wn)
    base = tmin + f32(np.float32(ENTRY_EPS) * np.float32(step))
    j = torch.zeros(P, dtype=torch.int64, device=dev)
    seg = torch.zeros_like(j)
    windows = torch.ones_like(j)
    draws = torch.full_like(j, 2)
    trans = torch.ones(P, dtype=F32, device=dev)
    inten = torch.full((P,), f32(intensity0), dtype=F32, device=dev)
    prev = origin_w
    n_ev = torch.zeros_like(j)
    events = torch.zeros((P, K, 7), dtype=F32, device=dev)
    alive = hit.clone()
    rows = torch.arange(P, device=dev)
    while bool(alive.any()):
        t = base + j.to(F32) * step
        pos = origin + dirn * t[:, None]
        val = vol.sample(pos)
        alive = alive & (t < tmax) & (trans > T_CUTOFF) & (inten > 0.01)
        occ = alive & (val > 0.0)
        att = torch.exp(-val * absorption * step)
        trans = torch.where(occ, trans * att, trans)
        inten = torch.where(occ, inten * att, inten)
        draws = draws + occ.to(torch.int64)
        scat = occ & (randf_at(seed, draws) < scattering)
        new_dir = random_dir(randf_at(seed, draws + 1),
                             randf_at(seed, draws + 2))
        world = vol.to_world(pos)
        store = scat & (n_ev < K)
        slot = n_ev.clamp(max=K - 1)
        record = torch.cat([prev, world, inten[:, None]], dim=-1)
        events[rows, slot] = torch.where(store[:, None], record,
                                         events[rows, slot])
        prev = torch.where(store[:, None], world, prev)
        n_ev = n_ev + store.to(torch.int64)
        draws = torch.where(scat, draws + 2, draws)
        origin = torch.where(scat[:, None], pos, origin)
        dirn = torch.where(scat[:, None], new_dir, dirn)
        base = torch.where(scat, torch.full_like(base, f32(step)), base)
        seg = torch.where(scat, 0, seg)
        windows = windows + scat.to(torch.int64)
        j = torch.where(scat, 0, j + 1)
        # A window ends: the segment goes on into the next window while it
        # is within its bound.
        end = alive & ~scat & (j == Wn)
        seg = torch.where(end, seg + Wn, seg)
        go_on = end & (seg < S)
        alive = alive & ~(end & ~go_on)
        base = torch.where(go_on, base + float(Wn) * step, base)
        j = torch.where(end, 0, j)
        windows = windows + go_on.to(torch.int64)
        alive = alive & (windows <= max_windows)
    return events, n_ev


def frame_lights(events, n_ev, frame: int, *, num_photons: int = 16,
                 max_lights: int = 1000, light_capacity: int = 1000):
    """Frame ``frame``'s lights, photon-major, clamped to maxLights:
    (from (L, 3), to (L, 3), intensity (L,)).  The clamp keeps
    min(total, max_lights) lights, and the frame divides by that count."""
    K = events.shape[1]
    ev = events[frame * num_photons:(frame + 1) * num_photons].reshape(-1, 7)
    valid = (torch.arange(K, device=ev.device)[None, :]
             < n_ev[frame * num_photons:(frame + 1) * num_photons, None])
    ev = ev[valid.reshape(-1)][:min(max_lights, light_capacity)]
    return ev[:, 0:3], ev[:, 3:6], ev[:, 6]


def sub_lights(pos_from, pos_to, intensity, light_ray_step: float):
    """Ray/Beam sub-lights: each segment cut every lightRayStepSize into
    n = floor(length / step) lights of intensity I / n."""
    seg = pos_to - pos_from
    length = torch.linalg.vector_norm(seg, dim=-1)
    n = (length / f32(light_ray_step)).to(torch.int64)
    keep = n > 0
    u = seg[keep] / length[keep, None]
    n_k = n[keep]
    owner = torch.repeat_interleave(torch.arange(n_k.shape[0],
                                                 device=seg.device), n_k)
    first = torch.cumsum(n_k, 0) - n_k
    s = (torch.arange(owner.shape[0], device=seg.device)
         - first[owner]).to(F32)
    pos = pos_from[keep][owner] + (s * f32(light_ray_step))[:, None] * u[owner]
    return pos, (intensity[keep] / n_k.to(F32))[owner]


def light_table(algorithm: str, pos_from, pos_to, intensity,
                light_ray_step: float):
    """(positions, intensities, sphere) of the point or sphere lights a frame
    shades with."""
    if algorithm == "POINT":
        return pos_to, intensity, False
    if algorithm == "SPHERE":
        return pos_from, intensity, True
    pos, inten = sub_lights(pos_from, pos_to, intensity, light_ray_step)
    return pos, inten, algorithm == "BEAM"


# ---------------- gather ----------------


def light_sums(samples, lights, inten, *, sphere: bool, radius: float,
               dtype=F32, max_elems: int = 1 << 27):
    """Sum over the lights of I / (4 pi d^2) at each sample (d^2 < 1e-4
    gives 0); sphere lights take the point on the sphere of ``radius``
    nearest the sample.  (M, 3) samples -> (M,) in ``dtype``."""
    M = samples.shape[0]
    out = torch.zeros(M, dtype=dtype, device=samples.device)
    E = lights.shape[0]
    if E == 0 or M == 0:
        return out
    lx, ly, lz = (lights[:, c].to(dtype) for c in range(3))
    li = inten.to(dtype)
    four_pi = torch.tensor(_FOUR_PI, dtype=dtype, device=samples.device)
    blk = max(1, max_elems // E)
    for a in range(0, M, blk):
        s = samples[a:a + blk].to(dtype)
        sx, sy, sz = s[:, 0:1], s[:, 1:2], s[:, 2:3]
        if sphere:
            dx, dy, dz = sx - lx, sy - ly, sz - lz
            nrm = torch.sqrt(dx * dx + dy * dy + dz * dz)
            safe = torch.where(nrm == 0, 1.0, nrm)
            cx = lx + dx / safe * radius
            cy = ly + dy / safe * radius
            cz = lz + dz / safe * radius
            ex, ey, ez = cx - sx, cy - sy, cz - sz
            d2 = ex * ex + ey * ey + ez * ez
            bad = (nrm == 0) | (d2 < 1e-4)
        else:
            ex, ey, ez = lx - sx, ly - sy, lz - sz
            d2 = ex * ex + ey * ey + ez * ez
            bad = d2 < 1e-4
        c = li / (four_pi * torch.where(bad, 1.0, d2))
        out[a:a + blk] = torch.where(bad, 0.0, c).sum(dim=-1)
    return out


def shade(rays, weights, samples, n_rays: int, lights, inten, count: int, *,
          sphere: bool, radius: float, dtype=F32):
    """One frame: per pixel, the weighted light sums of its samples over
    the frame's light count, clamped to [0, 1]; (n_rays,) float32."""
    ls = light_sums(samples, lights, inten, sphere=sphere, radius=radius,
                    dtype=dtype)
    acc = torch.zeros(n_rays, dtype=dtype, device=samples.device)
    acc.index_add_(0, rays, weights.to(dtype) * ls)
    return torch.clamp(acc.to(F32) / float(max(count, 1)), 0.0, 1.0)


# ---------------- PATH ----------------


def path_frame(vol: Volume, o, d, frame_count: int, *, width: int,
               step: float, absorption: float, scattering: float,
               intensity0: float, light_world, ray_max_distance: float,
               max_segments: int, dtype=F32, block: int = 1 << 19):
    """One PATH frame (REFERENCE fidelity): per pixel, march; at each
    occupied voxel roll a scatter (a new direction from there, t = 0) and
    add val * step * light(p), where light(p) = I / 1e4 times the
    attenuation at the one point one step from the light, raised to the
    number of steps from the light to p.  The walk ends past the camera
    ray's clipped tmax or after ``max_segments`` scatters.  (n_rays,)."""
    dev = o.device
    n = o.shape[0]
    light = vol.to_index(torch.as_tensor(np.asarray(light_world, np.float32),
                                         device=dev)[None, :])[0]
    out = torch.zeros(n, dtype=F32, device=dev)
    i0 = f32(intensity0)
    if not i0 > 0.01:
        return out
    zero = torch.zeros(n, dtype=F32, device=dev)
    hit, tmin, tmax = intersect(o, d, vol.box_min, vol.box_max, zero,
                                zero + ray_max_distance)
    t_entry = tmin + f32(np.float32(ENTRY_EPS) * np.float32(step))
    idx = torch.arange(n, device=dev)
    px, py = idx % width, idx // width
    fc = int(frame_count)
    seed_all = torch.stack([(px * fc) & _MASK, (py * fc) & _MASK,
                            torch.zeros_like(px)], dim=-1)
    for a in range(0, n, block):
        b = slice(a, min(n, a + block))
        out[b] = _path_block(vol, o[b], d[b], t_entry[b], tmax[b], hit[b],
                             seed_all[b], light, step=step,
                             absorption=absorption, scattering=scattering,
                             i0=i0, max_segments=max_segments, dtype=dtype)
    return torch.clamp(out, 0.0, 1.0)


def _light_term(vol, light, p, *, step, absorption, i0, dtype):
    ray = light - p
    length = torch.sqrt((ray * ray).sum(-1))
    rd = torch.where(length[:, None] > 0,
                     ray / torch.where(length > 0, length, 1.0)[:, None], 0.0)
    probe = light + rd * step
    val = vol.sample(probe)
    n_steps = (length / step).to(torch.int64)
    att = torch.exp(-val * absorption * step).to(dtype)
    return (i0 / 10000.0) * att.to(torch.float64).pow(n_steps).to(dtype)


def _path_block(vol, o, d, t0, tmax, hit, seed, light, *, step, absorption,
                scattering, i0, max_segments, dtype):
    dev = o.device
    m = o.shape[0]
    origin, dirn = o.clone(), d.clone()
    base = t0.clone()
    j = torch.zeros(m, dtype=torch.int64, device=dev)
    draws = torch.zeros_like(j)
    segs = torch.zeros_like(j)
    color = torch.zeros(m, dtype=dtype, device=dev)
    alive = hit.clone()
    rows = torch.arange(m, device=dev)
    while True:
        t = base + j.to(F32) * step
        alive = alive & (t < tmax) & (segs < max_segments)
        if not bool(alive.any()):
            break
        sel = rows[alive]
        ts = t[sel]
        pos = origin[sel] + dirn[sel] * ts[:, None]
        val = vol.sample(pos)
        occ = val > 0.0
        dr = draws[sel] + occ.to(torch.int64)
        sd = seed[sel]
        scat = occ & (randf_at(sd, dr) < scattering)
        new_dir = random_dir(randf_at(sd, dr + 1), randf_at(sd, dr + 2))
        term = _light_term(vol, light, pos, step=step, absorption=absorption,
                           i0=i0, dtype=dtype)
        add = torch.where(occ, val.to(dtype) * step * term, 0.0).to(dtype)
        color[sel] = color[sel] + add
        draws[sel] = torch.where(scat, dr + 2, dr)
        origin[sel] = torch.where(scat[:, None], pos, origin[sel])
        dirn[sel] = torch.where(scat[:, None], new_dir, dirn[sel])
        base[sel] = torch.where(scat, 0.0, base[sel])
        j[sel] = torch.where(scat, 1, j[sel] + 1)
        segs[sel] = segs[sel] + scat.to(torch.int64)
    return color.to(F32)
