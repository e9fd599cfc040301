"""The photon walk's window loop: CUDA kernel wrapper and plain version.

``render.photon.walk_start`` sets the walk up (the seeds, the first
direction in index space, the clip against the volume box) and
``generate_lights`` hands that per-photon start state here; what comes
back is each photon's events, (P, K, 7) rows of (pos_from, pos_to,
intensity) in world space, its count of stored events and whether a
scatter found no free slot.

``photon_walk_reference`` is the plain version: the loop evaluates a
window of steps for every photon at once (the RNG is counter-based, so
every roll of a window is one vectorized call) and finds each photon's
first accepted scatter with an argmax.  It stops when no photon is alive,
one host read a window (counted as a "sync" at "photon.walk"), or at the
iteration bound.

``photon_walk`` is the one rule for where a walk runs: the tensors'
device.  For CUDA tensors it launches csrc/photon_walk.cu, one launch for
every photon of the call, with no host read, and counts it in
``launches["walk"]``; then converts the scatter positions to world space
and rebuilds each event's ``pos_from`` (the photon's previous stored
event's ``pos_to``, the light for its first) in PyTorch.  For CPU tensors
it runs the plain version.  It never sends a CUDA tensor to the plain
version.  Each call counts one "walk" at "photon.walk.kernel" or
"photon.walk.plain", by its route.  The kernel keeps the plain version's
rounding term for term but for the transmittance, whose window product it
takes in sequence, as torch.cumprod does on the CPU (on the card the scan
associates otherwise).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import profiling
from .. import rng

launches = {"walk": 0}  # kernel launches made by photon_walk

WINDOW = 256  # steps a window, at most


def windows(max_steps: int, max_events: int, max_photon_steps: int):
    """(Wn, max_iters): the steps a window, min(256, ``max_steps``), and the
    windows a photon walks at most, (K + 1) + max(1, max_photon_steps //
    Wn)."""
    Wn = min(WINDOW, max_steps)
    return Wn, (max_events + 1) + max(1, max_photon_steps // Wn)


def photon_walk_reference(grid, seed0, origin, direction, t0, tmax, alive,
                          origin_world, *, step: float, absorption: float,
                          scattering_probability: float, intensity: float,
                          max_events: int, max_steps: int,
                          max_photon_steps: int):
    """The plain version: (events (P, K, 7), n_events (P,) int64,
    dropped (P,) bool); K = ``max_events``, a segment at most
    ``max_steps`` steps, the windows as ``windows`` gives them."""
    dev = origin.device
    f32 = torch.float32
    P = origin.shape[0]
    K = max_events
    S = max_steps
    n_draws = torch.full((P,), 2, dtype=torch.int64, device=dev)
    trans = torch.ones((P,), dtype=f32, device=dev)
    intensity = torch.full((P,), intensity, dtype=f32, device=dev)
    prev_pos = origin_world
    n_events = torch.zeros((P,), dtype=torch.int64, device=dev)
    events = torch.zeros((P, K, 7), dtype=f32, device=dev)
    seg_steps = torch.zeros((P,), dtype=torch.int64, device=dev)
    dropped = torch.zeros((P,), dtype=torch.bool, device=dev)

    Wn, max_iters = windows(S, K, max_photon_steps)
    ks = torch.arange(Wn, dtype=f32, device=dev)
    ones = torch.ones((P, 1), dtype=f32, device=dev)
    it = 0
    while it < max_iters:
        profiling.count("sync", "photon.walk")
        if not bool(alive.any()):
            break
        it += 1
        t = t0[:, None] + ks[None, :] * step  # (P, Wn)
        pos = origin[:, None, :] + direction[:, None, :] * t[:, :, None]
        val = grid.sample_nearest(pos)
        occ = val > 0.0

        atten = torch.where(occ, torch.exp(-val * absorption * step), 1.0)
        cum_att = torch.cumprod(atten, dim=-1)  # inclusive
        excl = torch.cat([ones, cum_att[:, :-1]], dim=-1)
        trans_before = excl * trans[:, None]
        int_before = excl * intensity[:, None]
        # Loop-entry condition at step k (light_gen.comp:51), on the
        # pre-attenuation values, within tmax of the initial clip.
        entered = (
            alive[:, None]
            & (t < tmax[:, None])
            & (trans_before > 0.001)
            & (int_before > 0.01)
        )

        # Occupied voxel k consumes one draw after its attenuation; the
        # draw index is n_draws + #occupied in [0..k].
        occ_rank = torch.cumsum((occ & entered).to(torch.int64), dim=-1)
        roll = rng.randf_at(seed0[:, None, :], n_draws[:, None] + occ_rank)
        scatter = occ & entered & (roll < scattering_probability)

        any_scatter = scatter.any(dim=-1)
        k_star = torch.argmax(scatter.to(torch.int8), dim=-1)[:, None]
        att_at = torch.gather(cum_att, 1, k_star)[:, 0]
        new_trans = trans * att_at
        new_int = intensity * att_at
        draws_used = torch.gather(occ_rank, 1, k_star)[:, 0]
        scat_pos = torch.gather(pos, 1, k_star[:, :, None].expand(-1, 1, 3))[:, 0]

        # New direction: two more draws (light_gen.comp:72), used
        # directly in index space as the reference does.
        nd1 = rng.randf_at(seed0, n_draws + draws_used + 1)
        nd2 = rng.randf_at(seed0, n_draws + draws_used + 2)
        new_dir = rng.random_dir(nd1, nd2)

        # Emit into the photon's next free slot; a scatter with no free
        # slot is a dropped event (the truncation signal).
        scat_world = grid.index_to_world(scat_pos)
        can_store = any_scatter & (n_events < K)
        dropped = dropped | (any_scatter & ~can_store)
        slot = torch.clamp(n_events, 0, K - 1)[:, None, None].expand(-1, 1, 7)
        record = torch.cat([prev_pos, scat_world, new_int[:, None]], dim=-1)
        events.scatter_(
            1, slot,
            torch.where(can_store[:, None, None], record[:, None, :],
                        torch.gather(events, 1, slot)),
        )

        # No scatter in this window: the segment continues into the next
        # window iff the walk was live at the window's end and the
        # segment is still within its bbox-crossing bound S.
        seg_steps = seg_steps + Wn
        cont = ~any_scatter & entered[:, -1] & (seg_steps < S)
        win_att = cum_att[:, -1]

        origin = torch.where(any_scatter[:, None], scat_pos, origin)
        direction = torch.where(any_scatter[:, None], new_dir, direction)
        # After a scatter currentT = 0, then += step before the next sample.
        t0 = torch.where(any_scatter, torch.full_like(t0, step),
                         t0 + float(Wn) * step)
        trans = torch.where(any_scatter, new_trans,
                            torch.where(cont, trans * win_att, trans))
        intensity = torch.where(any_scatter, new_int,
                                torch.where(cont, intensity * win_att, intensity))
        prev_pos = torch.where(can_store[:, None], scat_world, prev_pos)
        n_draws = n_draws + torch.where(
            any_scatter, draws_used + 2,
            torch.where(cont, occ_rank[:, -1], torch.zeros_like(draws_used)),
        )
        n_events = n_events + can_store.to(torch.int64)
        alive = alive & (any_scatter | cont)
        seg_steps = torch.where(any_scatter, torch.zeros_like(seg_steps),
                                seg_steps)
    return events, n_events, dropped


def events_from(grid, origin_world, scat, inten):
    """(P, K, 7) event rows from the kernel's index-space scatter positions
    (P, K, 3) and intensities (P, K): ``pos_to`` in world space,
    ``pos_from`` the previous slot's ``pos_to`` (the light for slot 0).
    Slots past a photon's count hold no event."""
    world = grid.index_to_world(scat)
    pos_from = torch.cat([origin_world[:, None, :], world[:, :-1]], dim=1)
    return torch.cat([pos_from, world, inten[..., None]], dim=-1)


def _check(grid, seed0, origin, direction, t0, tmax, alive, origin_world):
    """Validate what the kernel takes."""
    dev = origin.device
    P = origin.shape[0] if origin.dim() == 2 else -1
    need = [("seed0", seed0, (P, 3), torch.int64),
            ("origin", origin, (P, 3), torch.float32),
            ("direction", direction, (P, 3), torch.float32),
            ("t0", t0, (P,), torch.float32),
            ("tmax", tmax, (P,), torch.float32),
            ("alive", alive, (P,), torch.bool),
            ("origin_world", origin_world, (P, 3), torch.float32),
            ("voxels", grid.voxels, tuple(grid.voxels.shape), torch.float32),
            ("bbox_min", grid.bbox_min, (3,), torch.int64)]
    for name, t, want, dtype in need:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, photons on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if grid.voxels.dim() != 3:
        raise ValueError("voxels must be (nx, ny, nz)")
    if max(grid.voxels.shape) >= 2**31:
        raise ValueError("photon_walk: a volume axis exceeds int32")


def _lib():
    from ._build import library

    lib = library("photon_walk")
    if not getattr(lib, "_vr_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vr_photon_walk.argtypes = ([p] * 8 + [i, i, i, f, f, f, f, f,
                                                  i, i, i, i,
                                                  ctypes.c_longlong]
                                       + [p] * 5)
        lib.vr_photon_walk.restype = i
        lib.vr_photon_walk_error_string.argtypes = [i]
        lib.vr_photon_walk_error_string.restype = ctypes.c_char_p
        lib._vr_typed = True
    return lib


def photon_walk(grid, seed0, origin, direction, t0, tmax, alive,
                origin_world, *, step: float, absorption: float,
                scattering_probability: float, intensity: float,
                max_events: int, max_steps: int, max_photon_steps: int):
    """Walk P photons from their start state: ``seed0`` (P, 3) int64
    seeds, ``origin`` and unit ``direction`` (P, 3) in index space, ``t0``
    the first step's distance, ``tmax`` the first clip's exit, ``alive``
    the clip's hit, ``origin_world`` the light in world space; a segment at
    most ``max_steps`` steps, the windows as ``windows`` gives them.  Returns
    (events (P, K, 7), n_events (P,) int64, dropped (P,) bool).  Either
    route takes ``absorption`` >= 0 and ``step`` > 0 only, where a step's
    attenuation is at most 1 (the kernel's early window end rests on it),
    and raises ValueError otherwise."""
    _check(grid, seed0, origin, direction, t0, tmax, alive, origin_world)
    if not (absorption >= 0.0 and step > 0.0):
        raise ValueError(f"photon_walk: absorption {absorption} must be >= 0 "
                         f"and step {step} > 0")
    walk = dict(step=step, absorption=absorption,
                scattering_probability=scattering_probability,
                intensity=intensity, max_events=max_events,
                max_steps=max_steps, max_photon_steps=max_photon_steps)
    dev = origin.device
    if dev.type == "cpu":
        profiling.count("walk", "photon.walk.plain")
        return photon_walk_reference(grid, seed0, origin, direction, t0,
                                     tmax, alive, origin_world, **walk)
    if dev.type != "cuda":
        raise ValueError(f"photon_walk: unsupported device {dev}")
    if not 1 <= max_steps < 2**31 or not 1 <= max_events < 2**31:
        raise ValueError(f"photon_walk: max_steps {max_steps} or max_events "
                         f"{max_events} out of range")
    Wn, max_iters = windows(max_steps, max_events, max_photon_steps)
    if not 0 <= max_iters < 2**31:
        raise ValueError(f"photon_walk: max_iters {max_iters} out of range")
    profiling.count("walk", "photon.walk.kernel")
    P, K = origin.shape[0], max_events
    scat = torch.empty((P, K, 3), dtype=torch.float32, device=dev)
    inten = torch.empty((P, K), dtype=torch.float32, device=dev)
    n_events = torch.empty((P,), dtype=torch.int64, device=dev)
    dropped = torch.empty((P,), dtype=torch.bool, device=dev)
    if P:
        nx, ny, nz = grid.voxels.shape
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.vr_photon_walk(
                origin.data_ptr(), direction.data_ptr(), t0.data_ptr(),
                tmax.data_ptr(), alive.data_ptr(), seed0.data_ptr(),
                grid.voxels.data_ptr(), grid.bbox_min.data_ptr(), nx, ny, nz,
                step, absorption, scattering_probability, float(Wn) * step,
                intensity, Wn, max_steps, K, max_iters, P, scat.data_ptr(),
                inten.data_ptr(), n_events.data_ptr(), dropped.data_ptr(),
                stream,
            )
        if err != 0:
            msg = lib.vr_photon_walk_error_string(err).decode()
            raise RuntimeError(f"photon_walk kernel launch failed: {msg} "
                               f"({err})")
        launches["walk"] += 1
    return events_from(grid, origin_world, scat, inten), n_events, dropped
