"""The CUDA march kernel (csrc/march_planes.cu) against its plain PyTorch
version on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch for CUDA (tests/conftest.py imports JAX, so skip
it there):

    python -m pytest tests/test_torch_gpu_march.py -m gpu --noconftest -q -s

Without a GPU every test skips.  The shapes are the main path's: the
coarse drag frame (1920x1080 rays, step 12, the 96^3 cloud: 16 samples a
ray, slots layout, no clip box) and the slots view's build (step 1, the
occupied clip box, its step bound), plus the drag frame in lanes layout.
The kernel is held against its plain version on CPU copies of the inputs
(torch.cumprod on the CPU multiplies in the kernel's order) and on the
card (torch.cumprod's scan there associates otherwise).  Positions must be
bit-equal to both; weights within rtol 1e-6 of both at the drag's 16
samples, and within half an ulp a sample (``weight_rtol``) at the slots
build's 144; a sample that one side weights and the other not must sit at
T within one ulp of the 0.001 cutoff.  ``-s`` prints each shape's count
of such samples and its largest weight errors against both.
"""

import numpy as np
import pytest
import torch

import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch.ops import march as march_ops
from volumerenderer_tpu_torch.ops.kernels import march_planes as tmarch
from volumerenderer_tpu_torch.render import color as tcolor

CASES = {  # name: (step, clip box, lanes)
    "drag": (12.0, False, False),
    "slots_build": (1.0, True, False),
    "drag_lanes": (12.0, False, True),
}


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    grid = vt.grid.procedural.cloud(n=96, device="cuda")
    config = vt.StaticConfig(width=1920, height=1080, compact_view=False)
    r = vt.Renderer(grid, config, vt.RenderParams.default().replace(
        camera_pos=(0.0, 20.0, -75.0)), device="cuda")
    return r


def marched(r, step, clip, lanes):
    """The kernel's planes and the plain version's, on the card and on CPU
    copies of the same inputs, all (4, N, S); the march's arguments; the
    rays."""
    params = r.params.replace(ray_marching_step_size=step)
    o_i, d_i = tcolor.camera_rays_index(r.grid, params, r.config)
    S = tcolor.required_march_steps(r.grid, step, r.config.max_march_steps)
    box = None
    if clip:
        box, view_steps = r._occupied_clip()
        S = min(S, view_steps)
    kw = dict(ray_max_distance=params.ray_max_distance, step_size=step,
              absorption=params.absorption_coefficient, max_steps=S,
              lanes=lanes)
    n0 = tmarch.launches["march"]
    got = tmarch.march_planes(r.grid, o_i, d_i, clip_box=box, **kw)
    torch.cuda.synchronize()
    assert tmarch.launches["march"] == n0 + 1
    card = tmarch.march_planes_reference(r.grid, o_i, d_i, clip_box=box, **kw)
    cpu_box = None if box is None else tuple(c.cpu() for c in box)
    host = tmarch.march_planes(r.grid.to("cpu"), o_i.cpu(), d_i.cpu(),
                               clip_box=cpu_box, **kw)
    planes = [got.cpu(), card.cpu(), host]
    if lanes:
        planes = [p.transpose(1, 2) for p in planes]
    kw.pop("lanes")
    return planes, dict(kw, clip_box=cpu_box), (o_i.cpu(), d_i.cpu())


def weight_rtol(S: int) -> float:
    """1e-6, or half an f32 ulp (2^-24) for each factor of an S-sample
    transmittance product where that is more: the last bit of expf differs
    between CUDA and PyTorch's CPU exp, and on the card torch.cumprod's
    scan associates otherwise, so the drift grows with the samples a ray
    (measured on the H100: 5.7e-7 at 16 samples, 1.85e-6 at 144)."""
    return max(1e-6, S * 2.0**-24)


def weight_err(w, wp):
    """Largest relative difference where both weight a sample."""
    both = (w != 0) & (wp != 0)
    if not both.any():
        return 0.0
    return ((w[both].double() - wp[both].double()).abs()
            / wp[both].double()).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_march_kernel_matches_plain_version(bench, name):
    """Against the plain version on CPU copies (the same association of the
    transmittance product; only expf against PyTorch's CPU exp differs) and
    on the card (torch.cumprod's scan there)."""
    step, clip, lanes = CASES[name]
    (got, card, host), kw, (o_i, d_i) = marched(bench, step, clip, lanes)
    assert got.shape == card.shape == host.shape
    assert torch.equal(got[:3], host[:3]) and torch.equal(got[:3], card[:3])
    w = got[3]
    err_host, err_card = weight_err(w, host[3]), weight_err(w, card[3])
    flip = ((w != 0) != (host[3] != 0)) | ((w != 0) != (card[3] != 0))
    rays, ks = torch.nonzero(flip, as_tuple=True)
    cutoff = np.float32(march_ops.T_CUTOFF)
    ulps = 0.0
    if rays.numel():
        m = march_ops.march(bench.grid.to("cpu"), o_i[rays], d_i[rays], **kw)
        T = m.trans[torch.arange(rays.numel()), ks].numpy()
        ulps = float(np.abs(T - cutoff).max() / np.spacing(cutoff))
    print(f"\n{name}: samples {w.numel()}, weighted {int((w != 0).sum())}, "
          f"weight rel err max {err_host:.3e} (CPU plain), {err_card:.3e} "
          f"(card plain), weighted on one side only {rays.numel()} (T at "
          f"most {ulps:.2f} ulp from the cutoff)")
    rtol = weight_rtol(kw["max_steps"])
    assert err_host <= rtol and err_card <= rtol
    assert ulps <= 1.0
    assert int((w != 0).sum()) > 10**6


@pytest.mark.gpu
def test_cuda_march_kernel_refuses_bad_inputs(bench):
    """A wrong dtype, device or alignment raises; nothing is launched."""
    grid = bench.grid
    o_i, d_i = tcolor.camera_rays_index(grid, bench.params, bench.config)
    kw = dict(ray_max_distance=2500.0, step_size=12.0, absorption=0.05,
              max_steps=16, lanes=False)
    n0 = tmarch.launches["march"]
    with pytest.raises(TypeError):
        tmarch.march_planes(grid, o_i.double(), d_i, **kw)
    with pytest.raises(ValueError):
        tmarch.march_planes(grid, o_i.cpu(), d_i.cpu(), **kw)
    flat = torch.empty(o_i.numel() + 1, device=o_i.device)
    odd = flat[1:].view(o_i.shape)  # 4 bytes past a 16-byte boundary
    odd.copy_(o_i)
    with pytest.raises(ValueError, match="aligned"):
        tmarch.march_planes(grid, odd, d_i, **kw)
    assert tmarch.launches["march"] == n0


@pytest.mark.gpu
def test_cuda_march_kernel_makes_no_host_sync(bench):
    """A march through the kernel reads nothing back: under
    ``torch.cuda.set_sync_debug_mode("error")`` a synchronizing call
    raises (the wrapper's checks read only shapes, dtypes and pointers)."""
    grid = bench.grid
    params = bench.params.replace(ray_marching_step_size=12.0)
    o_i, d_i = tcolor.camera_rays_index(grid, params, bench.config)
    box, _ = bench._occupied_clip()
    kw = dict(ray_max_distance=2500.0, step_size=12.0, absorption=0.05,
              max_steps=16, lanes=False, clip_box=box)
    tmarch.march_planes(grid, o_i, d_i, **kw)  # loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        planes = tmarch.march_planes(grid, o_i, d_i, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert planes.shape == (4, o_i.shape[0], 16)
