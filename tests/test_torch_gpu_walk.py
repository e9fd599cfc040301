"""The CUDA photon walk (csrc/photon_walk.cu) against the plain loop on the
card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch for CUDA (tests/conftest.py imports JAX, so skip
it there):

    python -m pytest tests/test_torch_gpu_walk.py -m gpu --noconftest -q -s

Without a GPU every test skips.  Each case runs ``generate_lights`` on the
card (one kernel launch), the kernel on its start state (``walk_start``:
seeds, first directions, clips), and the plain loop on that same start
state twice: on the card (whose torch.cumprod scan associates the
window's product otherwise) and on CPU copies (the kernel's association;
PyTorch's CPU acos, sin, cos and exp against CUDA's).  Held to: each
photon's event count and dropped flag equal; the stored events' positions
within atol 1e-4 and intensities within rtol 2e-6
(tests/test_torch_photon.py's tolerances); and the lights (count, valid,
truncated equal; positions and intensities as above).  The cases: the
golden scene at 1 and 8 frames, the bench's cloud(n=96), a bunny-class fog
(scripts/make_asset.py at a quarter of its size), the coarse drag step
with its step bound, a light outside the box (photons that miss) and 4
event slots a photon (a truncated population).  ``-s`` prints each case's
stored events and how many positions are bit-equal.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch.ops.kernels import photon_walk as pw
from volumerenderer_tpu_torch.render import color as tcolor
from volumerenderer_tpu_torch.render import photon as tphoton

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = dict(light=(0.0, 20.0, 20.0), p=0.15,
              config=dict(width=64, height=64, max_events_per_photon=32,
                          light_capacity=512))
CASES = {  # name: (volume, frames, light, scattering p, step, config)
    "golden_f1": ("golden", [1], GOLDEN["light"], 0.15, 1.0, {}),
    "golden_f8": ("golden", list(range(3, 11)), GOLDEN["light"], 0.15, 1.0,
                  {}),
    "cloud96_f8": ("cloud96", list(range(9, 17)), (0.0, 20.0, 20.0), 0.05,
                   1.0, {}),
    "bunny_f8": ("bunny", list(range(1, 9)), (-10.0, 28.0, 8.0), 0.05, 1.0,
                 {}),
    "cloud96_drag": ("cloud96", [40], (0.0, 20.0, 20.0), 0.05, 12.0, {}),
    "light_outside": ("golden", list(range(2, 10)), (-40.0, 20.0, 20.0),
                      0.15, 1.0, {}),
    "truncated": ("golden", list(range(1, 9)), GOLDEN["light"], 0.15, 1.0,
                  {"max_events_per_photon": 4}),
}


@pytest.fixture(scope="module")
def volumes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    sys.path.insert(0, str(ROOT / "scripts"))
    import make_asset

    fog = make_asset.make_volume(n=(98, 90, 78), seed=42)
    return {
        "golden": vt.grid.procedural.cloud(
            n=48, seed=7, center_world=(0.0, 20.0, 20.0), world_extent=70.0,
            device="cuda"),
        "cloud96": vt.grid.procedural.cloud(n=96, device="cuda"),
        "bunny": vt.grid.from_dense(fog, bbox_min=(-49, -45, -39),
                                    voxel_size=0.5,
                                    translation=(0.0, 20.0, 20.0),
                                    device="cuda"),
    }


def run_case(grid, name):
    """The lights on the card (kernel) and from CPU copies (plain); the
    kernel's events and the plain loop's on the card and on CPU copies of
    its start state, each (events, n_events, dropped) on the CPU."""
    _, frames, light, p, step, fields = CASES[name]
    config = vt.StaticConfig(**{**GOLDEN["config"], **fields})
    params = vt.RenderParams.default().replace(
        light_source_world_pos=light, scattering_probability=p,
        ray_marching_step_size=step)
    S = tcolor.required_march_steps(grid, step, config.max_march_steps)
    n0 = pw.launches["walk"]
    lights = tphoton.generate_lights(grid, params, frames, config,
                                     max_steps=S)
    torch.cuda.synchronize()
    assert pw.launches["walk"] == n0 + 1
    args, kw = tphoton.walk_start(grid, params, frames, config, S)
    out = pw.photon_walk(*args, **kw)
    host_lights = tphoton.generate_lights(grid.to("cpu"), params, frames,
                                          config, max_steps=S)
    cpu = lambda out: tuple(t.cpu() for t in out)
    card = pw.photon_walk_reference(*args, **kw)
    host = pw.photon_walk_reference(grid.to("cpu"),
                                    *(a.cpu() for a in args[1:]), **kw)
    return (lights, host_lights), cpu(out), cpu(card), cpu(host), args


def events_agree(got, want):
    """Counts and drops equal; stored positions within atol 1e-4 and
    intensities within rtol 2e-6.  Returns (stored, bit-equal positions)."""
    (ev, n, dr), (ev_w, n_w, dr_w) = got, want
    assert torch.equal(n, n_w) and torch.equal(dr, dr_w)
    valid = torch.arange(ev.shape[1])[None, :] < n[:, None]
    a, b = ev[valid], ev_w[valid]
    np.testing.assert_allclose(a[:, :6].numpy(), b[:, :6].numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(a[:, 6].numpy(), b[:, 6].numpy(), rtol=2e-6)
    return int(valid.sum()), int((a[:, :6] == b[:, :6]).all(dim=1).sum())


def lights_agree(lt, lh):
    assert torch.equal(lt.count.cpu(), lh.count)
    assert torch.equal(lt.valid.cpu(), lh.valid)
    assert torch.equal(lt.truncated.cpu(), lh.truncated)
    for name in ("pos_from", "pos_to"):
        np.testing.assert_allclose(getattr(lt, name).cpu().numpy(),
                                   getattr(lh, name).numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(lt.intensity.cpu().numpy(),
                               lh.intensity.numpy(), rtol=2e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_walk_matches_plain_loop(volumes, name):
    grid = volumes[CASES[name][0]]
    (lights, host_lights), got, card, host, args = run_case(grid, name)
    stored, same_card = events_agree(got, card)
    _, same_host = events_agree(got, host)
    lights_agree(lights, host_lights)
    print(f"\n{name}: photons {got[1].numel()}, missed "
          f"{int((~args[6]).sum())}, stored {stored}, dropped "
          f"{int(got[2].sum())}, positions bit-equal {same_card} (card "
          f"plain), {same_host} (CPU plain)")
    assert stored > 0
    if name == "light_outside":
        assert not bool(args[6].all())
    if name == "truncated":
        assert bool(got[2].any()) and bool(lights.truncated.any())


@pytest.mark.gpu
def test_cuda_walk_refuses_bad_inputs(volumes):
    """A CUDA tensor of the wrong dtype or shape, or on another device, a
    negative absorption or a step not above 0, raises; nothing is
    launched."""
    grid = volumes["golden"]
    args, kw = tphoton.walk_start(grid, vt.RenderParams.default(), [1],
                                  vt.StaticConfig(max_events_per_photon=8), 64)
    n0 = pw.launches["walk"]
    for i, bad, err in ((2, args[2].double(), TypeError),
                        (1, args[1].to(torch.int32), TypeError),
                        (3, args[3][:, :2].contiguous(), ValueError),
                        (4, args[4][:-1], ValueError),
                        (5, args[5].cpu(), ValueError)):
        call = list(args)
        call[i] = bad
        with pytest.raises(err):
            pw.photon_walk(*call, **kw)
    for bad in (dict(absorption=-0.05), dict(step=0.0)):
        with pytest.raises(ValueError):
            pw.photon_walk(*args, **{**kw, **bad})
    assert pw.launches["walk"] == n0


@pytest.mark.gpu
def test_cuda_walk_makes_no_host_sync(volumes):
    """A walk on the card reads nothing back: under
    ``torch.cuda.set_sync_debug_mode("error")`` a synchronizing call
    raises (the set-up makes its draw indices on the device)."""
    grid = volumes["cloud96"]
    params = vt.RenderParams.default()
    config = vt.StaticConfig()
    S = tcolor.required_march_steps(grid, 1.0, config.max_march_steps)
    tphoton.generate_lights(grid, params, [1], config, max_steps=S)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lights = tphoton.generate_lights(grid, params, list(range(2, 10)),
                                         config, max_steps=S)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(lights.count.sum()) > 0
