"""The comparison that decides ``correct``.

Each sample is a tick of the window: the image before it and after it, the
frame counts at both, and the camera.  The image is the progressive average,
so ``img1 * n1 - img0 * n0`` is the sum of the tick's frames as the program
rendered them.  The reference (``reference/render.py``) renders those
frames again from the inputs the harness made (the volume array, the
camera, the parameters and the frame counters), and the number compared is
the relative L1 distance of the two sums over every pixel:

    rel_l1 = sum |port - ref| / sum |ref|   (``rel_l1``)

with a floor under the denominator, so that neither an all-but-black frame
nor the rounding of the average at a high frame count reads as an error.

Drag frames (coarse) and the settled exact frames are compared apart, as
``drag_rel_l1`` and ``settled_rel_l1``; converging ticks as
``frame_rel_l1``.  Each number has its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import render as ref

F32 = torch.float32


def volume_of(inputs, device):
    v = inputs["volume"]
    vals = torch.as_tensor(v["values"], device=device)
    build = ref.Volume.active if v["active"] else ref.Volume
    return build(vals, v["bbox_min"], v["voxel_size"], v["translation"])


def reference_frames(vol, inputs, camera, frame_counts, *, algorithm: str,
                     coarse: bool, dtype=F32):
    """The frames ``frame_counts`` at ``camera``: (F, n_rays) float32."""
    p = inputs["params"]
    W, H = inputs["width"], inputs["height"]
    step = float(p["ray_marching_step_size"])
    if coarse:
        step = ref.f32(step * int(inputs["motion_stride"]))
    o, d = ref.camera_rays(vol, W, H, p["fov"], camera)
    if algorithm == "PATH":
        return torch.stack([ref.path_frame(
            vol, o, d, fc, width=W, step=step,
            absorption=p["absorption_coefficient"],
            scattering=p["scattering_probability"],
            intensity0=p["photon_initial_intensity"],
            light_world=p["light_source_world_pos"],
            ray_max_distance=p["ray_max_distance"],
            max_segments=inputs["max_path_segments"], dtype=dtype)
            for fc in frame_counts])
    rays, w, pos = ref.march_samples(
        vol, o, d, step=step, absorption=p["absorption_coefficient"],
        ray_max_distance=p["ray_max_distance"])
    events, n_ev = ref.photon_events(
        vol, frame_counts, step=step,
        absorption=p["absorption_coefficient"],
        scattering=p["scattering_probability"],
        intensity0=p["photon_initial_intensity"],
        light_world=p["light_source_world_pos"],
        ray_max_distance=p["ray_max_distance"],
        segment_bound=vol.segment_bound(step, inputs["max_march_steps"]),
        num_photons=inputs["num_photons"],
        max_events=inputs["max_events_per_photon"],
        max_photon_steps=inputs["max_photon_steps"])
    out = []
    for i in range(len(frame_counts)):
        pf, pt, it = ref.frame_lights(
            events, n_ev, i, num_photons=inputs["num_photons"],
            max_lights=p["max_lights"],
            light_capacity=inputs["light_capacity"])
        lp, li, sphere = ref.light_table(algorithm, pf, pt, it,
                                         p["light_ray_step_size"])
        out.append(ref.shade(rays, w, pos, W * H, lp, li, pt.shape[0],
                             sphere=sphere, radius=p["beam_radius"],
                             dtype=dtype))
    return torch.stack(out)


# The denominator's floor, a pixel: a quarter of the display's 8-bit step
# for each frame of the tick, or RESOLUTION times what the program's float32
# average can resolve of the tick there (``resolution``), whichever is
# larger.
FLOOR = 1e-3
RESOLUTION = 1e4


def resolution(img, n: int) -> np.ndarray:
    """The rounding step of ``img * n`` (``img`` the float32 average of
    ``n`` frames), a pixel: ``n * 2**-24 * |img|``.  The tick's frames are
    read back from two such products, so a frame that is all but black
    reads this rounding, and it grows with ``n``."""
    return n * 2.0 ** -24 * np.abs(np.asarray(img, np.float64).reshape(-1))


def rel_l1(port_sum, ref_sum, frames: int, res=0.0) -> float:
    """sum |port - ref| / sum |ref|, the denominator at least the sum over
    pixels of max(FLOOR * frames, RESOLUTION * res): a frame that is all but
    black compares by its absolute error, and the average's rounding, about
    ``res`` a pixel, adds no more than a few 1 / RESOLUTION to the reading
    at any frame count."""
    port_sum = np.asarray(port_sum, np.float64).reshape(-1)
    ref_sum = np.asarray(ref_sum, np.float64).reshape(-1)
    res = np.broadcast_to(np.asarray(res, np.float64), ref_sum.shape)
    floor = np.maximum(FLOOR * frames, RESOLUTION * res).sum()
    den = max(np.abs(ref_sum).sum(), floor)
    return float(np.abs(port_sum - ref_sum).sum() / den)


def port_sum(sample) -> np.ndarray:
    """The sum of the tick's frames as the program rendered them."""
    img1 = np.asarray(sample["img"], np.float64)
    img0 = (np.zeros_like(img1) if sample["prev"] is None
            else np.asarray(sample["prev"], np.float64))
    return img1 * sample["n1"] - img0 * sample["n0"]


def number_of(sample) -> str:
    if sample["coarse"]:
        return "drag_rel_l1"
    return "settled_rel_l1" if sample.get("settled") else "frame_rel_l1"


def compare(samples, inputs, algorithm: str, device, dtype=F32,
            log=None) -> dict:
    """{number name: worst reading over the samples}; ``log`` gets a line a
    sample."""
    vol = volume_of(inputs, device)
    worst: dict = {}
    for s in samples:
        fcs = list(range(s["n0"] + 1, s["n1"] + 1))
        frames = reference_frames(vol, inputs, s["camera"], fcs,
                                  algorithm=algorithm, coarse=s["coarse"],
                                  dtype=dtype)
        want = frames.double().sum(dim=0).cpu().numpy()
        got = port_sum(s).reshape(-1)
        name = number_of(s)
        v = rel_l1(got, want, len(fcs), resolution(s["img"], s["n1"]))
        worst[name] = max(worst.get(name, 0.0), v)
        if log:
            log(f"portbench: sample {name} frames {fcs[0]}-{fcs[-1]} "
                f"rel_l1 {v:.4g} mean frame {want.mean() / len(fcs):.4g} "
                f"mean image {np.mean(s['img']):.4g}")
        del frames
    return worst
