"""Hold the analytic kernels of this checkout (the lane kernel, row 3 of
PERF.md's kernel table; the slots VRL and VBL kernels, rows 6 and 7)
against those of an earlier checkout, in one process on one card.

    python3 scripts/port_analytic_ab.py build/parent

``build/parent`` is an unpacked ``git archive`` of the earlier commit
(under a gitignored directory).  Its ``csrc/gather_vpu.cu`` and
``csrc/gather_segments.cu`` are built with this checkout's nvcc flags, and
so are this checkout's, all into ``build/ab/``, one nvcc a library, all
started together.  Each build is called through its own C signature on
inputs that this checkout's wrappers prepare.  An earlier checkout whose
``vr_gather_vpu_vrl`` takes ``long long N`` (commit 18ec2b3 and before)
is called as such: that entry had no work counter, and its
``vr_gather_segments_analytic`` no work counter and no scratch plane.

Prints the card's name and power limit, then one JSON line each:

  * ``ptxas``: registers, spill stores and shared memory of each analytic
    template of each build;
  * ``bits``: whether this checkout's output equals the earlier one's bit
    for bit, for rows 3 (four variants, both tiers), 6 (both tiers) and 7
    (three rules, both tiers), on chip_smoke's segkernel and slotkernel
    cases and on the whole widest band of a RAY compact session or the
    whole 1080p ViewCache of a RAY slots session;
  * ``time``: this checkout against the earlier one on those whole shapes,
    in the order parent, change, change, parent, 5 launches each, by CUDA
    events, with the change's max relative deviation from the parent.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from port_slots_ab import bits_equal, call, frame_inputs  # noqa: E402
from volumerenderer_tpu_torch.ops.march import f32  # noqa: E402

REPS = 5
RULES = ((None, "midpoint"), (0.3, "midpoint"), (0.3, "tangent"),
         (0.3, "closed"))
SOURCES = ("gather_vpu", "gather_segments")


def emit(kind: str, **fields) -> None:
    print(json.dumps({"case": kind, **fields}), flush=True)


def ptxas_summary(log: str) -> list:
    """(function, registers, spill stores, smem) of each analytic template
    in an nvcc -Xptxas -v log."""
    rows, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            spill = None
            continue
        if fn is None or not re.search(
                r"analytic_kernel|segment_kernel|segment_sphere_kernel", fn):
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            t = re.search(r"(analytic_kernel|segment_sphere_kernel|"
                          r"segment_kernel)I(?:Li(\d)E)?Lb(\d)E", fn)
            rows.append(dict(kernel=t.group(1), variant=t.group(2),
                             paired=t.group(3) == "1",
                             registers=int(m.group(1)), spill_stores=spill,
                             smem=int(m.group(2))))
            fn = None
    return rows


def build_all(parent: Path) -> tuple:
    """Build the parent's two sources and this checkout's, all nvcc
    processes at once; returns {build: {source: CDLL}} and whether the
    parent has the old signatures."""
    from volumerenderer_tpu_torch.ops.kernels import _build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    setups = {"parent": parent / "volumerenderer_tpu_torch" / "csrc",
              "change": _build.CSRC}
    old = bool(re.search(r"vr_gather_vpu_vrl\([^)]*long long N",
                         (setups["parent"] / "gather_vpu.cu").read_text()))
    jobs = {}
    for name, csrc in setups.items():
        for src in SOURCES:
            so = out_dir / f"lib{src}-{name}.so"
            jobs[name, src] = (so, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
                 str(csrc / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, src), (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}'s {src}.cu:\n{log}")
        emit("ptxas", build=name, source=src, templates=ptxas_summary(log))
        libs.setdefault(name, {})[src] = ctypes.CDLL(str(so))
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    for name, lib in libs.items():
        o = old and name == "parent"
        vpu, seg = lib["gather_vpu"], lib["gather_segments"]
        vpu.vr_gather_vpu_vrl.argtypes = (
            [p] * 6 + ([i, ll, i, p, p] if o else [i, i, i, p, p, p]))
        vpu.vr_gather_vpu_sphere.argtypes = [p] * 7 + [i, i, i, f, i, i, p,
                                                        p, p]
        seg.vr_gather_segments_analytic.argtypes = (
            [p] * 8 + [i, i, i, i, f, i, i] + [p] * (2 if o else 4))
        for fn in (vpu.vr_gather_vpu_vrl, vpu.vr_gather_vpu_sphere,
                   seg.vr_gather_segments_analytic):
            fn.restype = i
    return libs, old


def prepare(segs, radius, rule):
    """The kernels' inputs for one segment table: (table, node table, meta,
    nodes)."""
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.ops.kernels import segment_math as sm
    from volumerenderer_tpu_torch.ops.kernels.gather_lanes import _meta

    dev = segs[0].device
    u, length, ii, start, count = gs.analytic_cols(*segs)
    nodes = 0 if radius is None else sm.effective_quad_nodes(rule, 16)
    rule = None if radius is None else rule
    return (gs._table(segs[0], u, length, ii), gs.node_table(rule, nodes, dev),
            _meta(start, count, dev), nodes)


def slot_run(lib, old, planes, segs, prep, radius, rule, paired):
    """Rows 6 (radius None) and 7 of one build on (R, C) planes."""
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs

    dev = planes[0].device
    table, nodes_t, meta, nodes = prep
    out = torch.empty_like(planes[0])
    next_span = torch.zeros(1, dtype=torch.int32, device=dev)
    L, N = segs[0].shape[0], planes[0].numel()
    vpu = lib["gather_vpu"]
    if radius is None:
        tail = (out,) if old else (next_span, out)
        call(vpu.vr_gather_vpu_vrl, dev, *planes, table, meta, L, N,
             int(paired), *tail)
    else:
        call(vpu.vr_gather_vpu_sphere, dev, *planes, table, nodes_t, meta, L,
             N, nodes, f32(radius), gs._VARIANTS[rule], int(paired),
             next_span, out)
    return out


def lane_run(lib, old, planes, need, segs, prep, radius, rule, paired):
    """Row 3 of one build on (Cp, Rc) planes."""
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs

    dev = planes[0].device
    table, nodes_t, meta, nodes = prep
    Cp, Rc = planes[0].shape
    out = torch.empty(Rc, dtype=torch.float32, device=dev)
    if old:
        tail = (out,)
    else:
        tail = (torch.zeros(1, dtype=torch.int32, device=dev),
                torch.empty((Cp, Rc), dtype=torch.float32, device=dev), out)
    call(lib["gather_segments"].vr_gather_segments_analytic, dev, *planes,
         need, table, nodes_t, meta, segs[0].shape[0], Cp, Rc, nodes,
         f32(0.0 if radius is None else radius),
         gs._VARIANTS[None if radius is None else rule], int(paired), *tail)
    return out


def label(row, radius, rule, paired) -> str:
    name = "vrl" if radius is None else f"vbl-{rule}"
    return f"row {row} {name} {'paired' if paired else 'exact'}"


def alternate(fn_a, fn_b) -> list:
    """ms of a, b, b, a, REPS launches each after one outside the timing."""
    times = []
    for fn in (fn_a, fn_b, fn_b, fn_a):
        fn()
        times.append(cs.cuda_timed(fn, REPS)[1])
    return times


def cases(libs, old, planes, need, segs, where, rows, timed):
    """Bits (and, timed, times) of the given rows on one set of planes
    (need None: slots)."""
    lane = need is not None
    for radius, rule in RULES:
        row = 3 if lane else (6 if radius is None else 7)
        if row not in rows:
            continue
        prep = prepare(segs, radius, rule)
        for paired in (False, True):
            def run(name, paired=paired):
                lib, o = libs[name], old and name == "parent"
                if lane:
                    return lane_run(lib, o, planes, need, segs, prep,
                                    radius, rule, paired)
                return slot_run(lib, o, planes, segs, prep, radius, rule,
                                paired)

            want = run("parent")
            got = run("change")
            emit("bits", row=row, kernel=label(row, radius, rule, paired),
                 planes=where, equal=bits_equal(got, want))
            if timed:
                t = alternate(lambda: run("parent"), lambda: run("change"))
                emit("time", kernel=label(row, radius, rule, paired),
                     planes=where, shape=list(planes[0].shape),
                     parent_ms=[t[0], t[3]], change_ms=[t[1], t[2]],
                     change_vs_parent_max_rel_err=cs.rel_err(got, want))


def main(argv) -> int:
    if len(argv) != 1 or not (Path(argv[0]) / "volumerenderer_tpu_torch"
                              / "csrc").is_dir():
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    import volumerenderer_tpu_torch as vt

    if not torch.cuda.is_available():
        print("port_analytic_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(cs.nvidia_smi_line(), flush=True)
    libs, old = build_all(Path(argv[0]))
    dev = torch.device("cuda")

    # chip_smoke's segkernel (lanes) and slotkernel (slots) cases.
    planes, segs, need = cs.segment_case(cs.SYNTH_CP, cs.SEG_RC, 7, dev)
    cases(libs, old, planes, need, segs, "segkernel", (3,), False)
    planes, segs, _ = cs.segment_case(cs.SYNTH_CP, cs.SEG_RC, 11, dev)
    cases(libs, old, planes, None, segs, "slotkernel", (6, 7), False)
    del planes

    # The whole widest band of a RAY compact session, one frame's segments.
    r = cs.bench_renderer("exact", vt.Algorithm.RAY,
                          segment_mode="analytic")
    r.step(8)
    band = max(r._view.bands, key=lambda b: b.wx.shape[0])
    planes = (band.wx, band.wy, band.wz, band.weight)
    segs = frame_inputs(r)
    cases(libs, old, planes, band.lane_need, segs, "widest band", (3,),
          True)
    del r, band, planes
    torch.cuda.empty_cache()

    # The whole 1080p ViewCache of a RAY slots session.
    r = cs.bench_renderer("exact", vt.Algorithm.RAY, segment_mode="analytic",
                          compact_view=False)
    r.step(8)
    v = r._view
    planes = (v.wx, v.wy, v.wz, v.weight)
    segs = frame_inputs(r)
    cases(libs, old, planes, None, segs, "ViewCache", (6, 7), True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
