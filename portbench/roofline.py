"""The least time the card could take for a frame's gather, frozen.

Peaks and per-term operation counts are copied from ``chip_smoke.py``
(``PEAK_F32``, ``PEAK_BYTES``, ``TERM_OPS``, ``EXPAND_OPS``, ``bound``,
``ops_per_sample``, ``call_ops``, ``lane_bound``), with the work counted
from what the inputs need rather than from the program's planes: the live
samples (nonzero march weight) of the benchmark's reference march, and each
frame's lights or discrete sub-lights from the reference photon walk.

  * operations: live samples x lights x the term's operations, plus the
    sub-light expansion once per sub-light (Ray/Beam discrete);
  * bytes: each live sample's weight and position read once (16 B), each
    hit ray's sum written once (4 B), the light table read once (28 B a
    light: from, to, intensity).

The least time is the larger of operations at ``PEAK_F32`` and bytes at
``PEAK_BYTES`` (NVIDIA's H100 SXM data sheet, at a 700 W limit; the card's
own limit is printed beside the metric)."""

from __future__ import annotations

import torch

from reference import render as ref

PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
TERM_OPS = {"point": 13, "sphere": 18}
EXPAND_OPS = 8
FRAMES_PER_WALK = 1024


def bound(ops: float, nbytes: float):
    """(seconds, "operations" or "bytes")."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def frame_work(algorithm: str, live: int, hit_rays: int, lights: int,
               sub: int):
    """(operations, bytes) of one frame's gather."""
    segments = algorithm in ("RAY", "BEAM")
    term = TERM_OPS["sphere" if algorithm in ("SPHERE", "BEAM") else "point"]
    n = sub if segments else lights
    ops = live * n * term + (sub * EXPAND_OPS if segments else 0)
    return ops, 16 * live + 4 * hit_rays + 28 * lights


def least_time(inputs, algorithm: str, camera, frame_counts, device):
    """(seconds, bound_by counts) of the gathers of ``frame_counts`` at a
    still camera, from the reference march and walk."""
    from check import volume_of

    p = inputs["params"]
    step = float(p["ray_marching_step_size"])
    vol = volume_of(inputs, device)
    o, d = ref.camera_rays(vol, inputs["width"], inputs["height"], p["fov"],
                           camera)
    rays, _, _ = ref.march_samples(vol, o, d, step=step,
                                   absorption=p["absorption_coefficient"],
                                   ray_max_distance=p["ray_max_distance"])
    live, hit_rays = int(rays.numel()), int(torch.unique(rays).numel())
    del rays, o, d
    total, by = 0.0, {"operations": 0, "bytes": 0}
    fcs = list(frame_counts)
    for a in range(0, len(fcs), FRAMES_PER_WALK):
        chunk = fcs[a:a + FRAMES_PER_WALK]
        events, n_ev = ref.photon_events(
            vol, chunk, step=step, absorption=p["absorption_coefficient"],
            scattering=p["scattering_probability"],
            intensity0=p["photon_initial_intensity"],
            light_world=p["light_source_world_pos"],
            ray_max_distance=p["ray_max_distance"],
            segment_bound=vol.segment_bound(step, inputs["max_march_steps"]),
            num_photons=inputs["num_photons"],
            max_events=inputs["max_events_per_photon"],
            max_photon_steps=inputs["max_photon_steps"])
        for i in range(len(chunk)):
            pf, pt, it = ref.frame_lights(
                events, n_ev, i, num_photons=inputs["num_photons"],
                max_lights=p["max_lights"],
                light_capacity=inputs["light_capacity"])
            sub = 0
            if algorithm in ("RAY", "BEAM"):
                sub = int(ref.sub_lights(pf, pt, it,
                                         p["light_ray_step_size"])[1].numel())
            t, which = bound(*frame_work(algorithm, live, hit_rays,
                                         int(pt.shape[0]), sub))
            total += t
            by[which] += 1
    return total, by
