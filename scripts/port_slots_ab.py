"""Hold the slots discrete and VBL kernels and the lane discrete kernel of
this checkout against those of an earlier checkout, in one process on one
card: outputs bit for bit and times at the bench config's whole shapes.

    python3 scripts/port_slots_ab.py build/parent

``build/parent`` is an unpacked ``git archive`` of the earlier commit
(under a gitignored directory).  Its ``csrc/gather_vpu.cu`` and
``csrc/gather_segments.cu`` are built with this checkout's nvcc flags into
``build/ab/`` and called through their own C signatures, on inputs that
this checkout's wrappers prepare.  The signatures are those of commit
5a99ec8: the slots discrete and VBL entry points took ``long long N`` and
no sub-light prefix or work counter.

Prints the card's name and power limit, then one JSON line a comparison:

  * ``vbl_bits``: the slots VBL kernel (midpoint, tangent, closed; exact,
    paired) on chip_smoke's slotkernel case and on the whole 1080p
    ViewCache of a RAY slots session: whether the two outputs are equal
    bit for bit;
  * ``time``: each kernel on the whole ViewCache (slots discrete RAY/BEAM
    exact/paired, slots VBL every rule and tier) or the whole widest band (lane
    discrete RAY/BEAM exact/paired), in the order parent, change, change,
    parent, 5 launches each, by CUDA events; with the change's max
    relative deviation from the parent's output.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from volumerenderer_tpu_torch.ops.march import f32  # noqa: E402

REPS = 5


def build_parent(parent: Path) -> dict:
    """Build the parent's two sources with this checkout's flags; returns
    the loaded libraries by name."""
    from volumerenderer_tpu_torch.ops.kernels import _build

    csrc = parent / "volumerenderer_tpu_torch" / "csrc"
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    jobs = {}
    for name in ("gather_vpu", "gather_segments"):
        so = out_dir / f"lib{name}-parent.so"
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
             str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    vpu = libs["gather_vpu"]
    vpu.vr_gather_vpu_discrete.argtypes = [p] * 6 + [i, ll, f, f, i, i, p, p]
    vpu.vr_gather_vpu_sphere.argtypes = [p] * 7 + [i, ll, i, f, i, i, p, p]
    seg = libs["gather_segments"]
    seg.vr_gather_segments_discrete.argtypes = (
        [p] * 8 + [i, i, i, f, f, i, i, p, p, p, p])
    for fn in (vpu.vr_gather_vpu_discrete, vpu.vr_gather_vpu_sphere,
               seg.vr_gather_segments_discrete):
        fn.restype = i
    return libs


def call(fn, dev, *args):
    import torch

    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args), stream)
    if err != 0:
        raise RuntimeError(f"parent kernel launch failed ({err})")


def parent_vbl(libs, planes, segs, radius, rule, paired):
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.ops.kernels import segment_math as sm
    from volumerenderer_tpu_torch.ops.kernels.gather_lanes import _meta

    dev = planes[0].device
    nodes = sm.effective_quad_nodes(rule, 16)
    u, length, ii, start, count = gs.analytic_cols(*segs)
    table = gs._table(segs[0], u, length, ii)
    out = torch.empty_like(planes[0])
    call(libs["gather_vpu"].vr_gather_vpu_sphere, dev, *planes, table,
         gs.node_table(rule, nodes, dev), _meta(start, count, dev),
         segs[0].shape[0], planes[0].numel(), nodes, f32(radius),
         gs._VARIANTS[rule], int(paired), out)
    return out


def parent_slot_discrete(libs, planes, segs, step, radius, paired):
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.ops.kernels.gather_lanes import _meta

    dev = planes[0].device
    u, ns, ii, start, count = gs.discrete_cols(*segs, step)
    table = gs._table(segs[0], u, ns.view(torch.float32), ii)
    out = torch.empty_like(planes[0])
    call(libs["gather_vpu"].vr_gather_vpu_discrete, dev, *planes, table,
         _meta(start, count, dev), segs[0].shape[0], planes[0].numel(),
         f32(step), f32(0.0 if radius is None else radius),
         int(radius is not None), int(paired), out)
    return out


def parent_lane_discrete(libs, planes, need, segs, step, radius, paired):
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs

    dev = planes[0].device
    Cp, Rc = planes[0].shape
    u, ns, ii, start, count = gs.discrete_cols(*segs, step)
    table = gs._table(segs[0], u, ns.view(torch.float32), ii)
    first, meta = gs.sublight_prefix(ns, start, count, paired)
    next_span = torch.zeros(1, dtype=torch.int32, device=dev)
    terms = torch.empty_like(planes[0])
    out = torch.empty(Rc, dtype=torch.float32, device=dev)
    call(libs["gather_segments"].vr_gather_segments_discrete, dev, *planes,
         need, table, first, meta, segs[0].shape[0], Cp, Rc, f32(step),
         f32(0.0 if radius is None else radius), int(radius is not None),
         int(paired), next_span, terms, out)
    return out


def frame_inputs(r):
    from volumerenderer_tpu_torch.render import photon

    lights = photon.generate_lights(
        r.grid, r.params, [r.state.frame_count + 1], r.config,
        max_steps=r._max_steps)
    return (lights.pos_from[0], lights.pos_to[0], lights.intensity[0],
            lights.valid[0])


def bits_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def timed_pair(label, parent_fn, change_fn, **fields):
    """Parent, change, change, parent; prints ms of each and the change's
    max relative deviation from the parent."""
    times = []
    for fn in (parent_fn, change_fn, change_fn, parent_fn):
        fn()  # first launch outside the timing
        _, ms = cs.cuda_timed(fn, REPS)
        times.append(ms)
    dev = cs.rel_err(change_fn(), parent_fn())
    print(json.dumps({"case": "time", "kernel": label, **fields,
                      "parent_ms": [times[0], times[3]],
                      "change_ms": [times[1], times[2]],
                      "change_vs_parent_max_rel_err": dev}), flush=True)


def main(argv) -> int:
    if len(argv) != 1 or not (Path(argv[0]) / "volumerenderer_tpu_torch"
                              / "csrc").is_dir():
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv

    if not torch.cuda.is_available():
        print("port_slots_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(cs.nvidia_smi_line(), flush=True)
    libs = build_parent(Path(argv[0]))
    dev = torch.device("cuda")

    # Row 7 bit for bit on the slotkernel case.
    planes, segs, _need = cs.segment_case(cs.SYNTH_CP, cs.SEG_RC, 11, dev)
    for rule in ("midpoint", "tangent", "closed"):
        for paired in (False, True):
            got = gv.gather_segments_analytic(
                *planes, *segs, sphere_radius=0.3, quad_rule=rule,
                quad_nodes=16, paired=paired)
            want = parent_vbl(libs, planes, segs, 0.3, rule, paired)
            print(json.dumps({"case": "vbl_bits", "planes": "slotkernel",
                              "rule": rule, "paired": paired,
                              "equal": bits_equal(got, want)}), flush=True)
    del planes

    # The whole 1080p ViewCache of a RAY slots session and one frame's
    # segments.
    r = cs.bench_renderer("exact", vt.Algorithm.RAY, compact_view=False)
    r.step(8)
    v = r._view
    full = (v.wx, v.wy, v.wz, v.weight)
    segs = frame_inputs(r)
    step, radius = r.params.light_ray_step_size, r.params.beam_radius
    live = int((v.weight != 0).sum())
    for rule in ("midpoint", "tangent", "closed"):
        for paired in (False, True):
            kw = dict(sphere_radius=radius, quad_rule=rule, quad_nodes=16,
                      paired=paired)
            got = gv.gather_segments_analytic(*full, *segs, **kw)
            want = parent_vbl(libs, full, segs, radius, rule, paired)
            print(json.dumps({"case": "vbl_bits", "planes": "ViewCache",
                              "rule": rule, "paired": paired,
                              "equal": bits_equal(got, want)}), flush=True)
            del got, want
            timed_pair(
                f"slots VBL {rule} {'paired' if paired else 'exact'}",
                lambda: parent_vbl(libs, full, segs, radius, rule, paired),
                lambda: gv.gather_segments_analytic(*full, *segs, **kw),
                shape=list(full[0].shape), live_samples=live,
                segments=int(segs[3].sum()))
    for name, rad in (("RAY", None), ("BEAM", radius)):
        for paired in (False, True):
            timed_pair(
                f"slots discrete {name} {'paired' if paired else 'exact'}",
                lambda: parent_slot_discrete(libs, full, segs, step, rad,
                                             paired),
                lambda: gv.gather_segments_discrete(
                    *full, *segs, step, sphere_radius=rad, paired=paired),
                shape=list(full[0].shape), live_samples=live,
                sublights=cs.sublights(segs, step))
    del r, v, full
    torch.cuda.empty_cache()

    # The lane discrete kernel on the whole widest band of a RAY compact
    # session: the paired tier's reciprocal.
    r = cs.bench_renderer("exact", vt.Algorithm.RAY)
    r.step(8)
    band = max(r._view.bands, key=lambda b: b.wx.shape[0])
    planes = (band.wx, band.wy, band.wz, band.weight)
    segs = frame_inputs(r)
    for name, rad in (("RAY", None), ("BEAM", radius)):
        for paired in (False, True):
            timed_pair(
                f"lane discrete {name} {'paired' if paired else 'exact'}",
                lambda: parent_lane_discrete(libs, planes, band.lane_need,
                                             segs, step, rad, paired),
                lambda: gs.gather_segments_discrete_lanes(
                    *planes, *segs, step, sphere_radius=rad,
                    lane_need=band.lane_need, paired=paired),
                shape=list(planes[0].shape),
                live_samples=int((band.weight != 0).sum()),
                sublights=cs.sublights(segs, step))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
