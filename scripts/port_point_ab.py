"""Hold the port's gather kernels of this checkout against those of earlier
checkouts, in one process on one card: the point kernels (rows 1 and 4 of
PERF.md's kernel table) and every kernel on the live-sample loop (rows 2,
3, 5, 6, 7 and 8).

    python3 scripts/port_point_ab.py build/parent [build/step1 ...]

Each argument is an unpacked ``git archive`` of an earlier commit (under a
gitignored directory): the first is the parent, any others are steps
between it and this checkout.  Every checkout's four kernel sources are
built with this checkout's nvcc flags into ``build/ab/``, one nvcc a
source, all started together, and called through this checkout's
wrappers, on the same inputs.  A checkout whose ``vr_gather_vpu`` takes
``long long N`` (commit 41292b0 and before: the point slot kernel before
the live-sample loop) is called through that signature for row 4.

Prints the card's name and power limit, then one JSON line each:

  * ``ptxas``: registers, spill stores, shared memory and the resident
    blocks an SM (from the registers and shared memory, 256 threads a
    block) of every kernel template of every build;
  * ``bits``: for each kernel and each build, whether its output equals
    the parent's bit for bit (else the max relative deviation), on
    chip_smoke's synthetic cases (rows 1 and 4, at L up to 1,000 where the
    parent's chunks of 1,024 lights keep the order) and on the whole
    shapes a frame launches: the widest band of a RAY compact session
    (rows 1, 2, 3, 8) and the whole 1080p ViewCache of a RAY slots session
    (rows 4, 5, 6, 7, 8);
  * ``time``: each kernel on those whole shapes, the builds in the order
    parent, ..., change, change, ..., parent, 5 launches each after one
    outside the timing, by CUDA events; for row 4 also the launch over an
    empty light range (the live-sample scan alone).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

REPS = 5
SOURCES = ("gather_lanes", "gather_vpu", "gather_segments", "gather_many")
MAX_SMEM_SM = 233472  # shared memory an SM gives its blocks (228 KB)


def emit(kind: str, **fields) -> None:
    print(json.dumps({"case": kind, **fields}), flush=True)


def ptxas_rows(log: str) -> list:
    """(template, registers, spill stores, smem, resident blocks) of each
    kernel in an nvcc -Xptxas -v log."""
    rows, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and fn:
            regs, smem = int(m.group(1)), int(m.group(2))
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(65536 // (8 * per_warp), MAX_SMEM_SM // (smem + 1024),
                         8)
            name = fn[:fn.find("EEv") + 2] if "EEv" in fn else fn
            rows.append(dict(template=name, registers=regs,
                             spill_stores=spill, smem=smem,
                             resident_blocks=blocks))
            fn = None
    return rows


def build_all(dirs: dict) -> dict:
    """Build every checkout's sources; returns {label: {source: CDLL}}."""
    from volumerenderer_tpu_torch.ops.kernels import _build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    jobs = {}
    for label, csrc in dirs.items():
        for src in SOURCES:
            so = out_dir / f"lib{src}-{label}.so"
            jobs[label, src] = (so, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
                 str(csrc / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (label, src), (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}'s {src}.cu:\n{log}")
        emit("ptxas", build=label, source=src, templates=ptxas_rows(log))
        libs.setdefault(label, {})[src] = ctypes.CDLL(str(so))
    return libs


@contextlib.contextmanager
def using(libs: dict):
    """The wrappers load ``libs`` (one build's libraries) while inside."""
    from volumerenderer_tpu_torch.ops.kernels import _build

    saved = _build.library
    _build.library = lambda name: libs[name]
    try:
        yield
    finally:
        _build.library = saved


def old_vpu(lib, planes, lpos, lint, start, count, *, sphere, radius,
            paired):
    """Row 4 through the signature of a checkout before the live-sample
    loop: (..., int L, long long N, float radius, int sphere, int paired,
    float* out, stream)."""
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv
    from volumerenderer_tpu_torch.ops.march import f32

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib["vr_gather_vpu"]  # a fresh function object: its own argtypes
    fn.argtypes = [p] * 7 + [i, ctypes.c_longlong, f, i, i, p, p]
    fn.restype = i
    dev = planes[0].device
    out = torch.empty_like(planes[0])
    li = lint * gv._INV_FOUR_PI
    meta = gv._meta(start, count, dev)
    err = fn(*(t.data_ptr() for t in (*planes, lpos, li, meta)),
             lpos.shape[0], planes[0].numel(), f32(radius), int(sphere),
             int(paired), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vr_gather_vpu (old signature) failed ({err})")
    return out


class Runner:
    """Calls a kernel through each build: ``call(label, fn)`` runs ``fn``
    (a call of this checkout's wrapper) on that build's libraries, or, for
    row 4 of an old build, ``old``."""

    def __init__(self, libs, old):
        self.libs, self.old = libs, old

    def call(self, label, fn, old_fn=None):
        if old_fn is not None and label in self.old:
            return old_fn(self.libs[label]["gather_vpu"])
        with using(self.libs[label]):
            return fn()


def compare(runner, labels, kernel, where, fn, old_fn=None, timed=True,
            **fields):
    """Bits against the first build and, ``timed``, the palindrome of
    times."""
    import torch

    outs = {b: runner.call(b, fn, old_fn) for b in labels}
    want = outs[labels[0]]
    bits = {b: bool(torch.equal(outs[b].view(torch.int32),
                                want.view(torch.int32))) for b in labels[1:]}
    dev = {b: cs.rel_err(outs[b], want) for b in labels[1:]}
    del outs
    emit("bits", kernel=kernel, planes=where, equal=bits,
         max_rel_vs_parent=dev)
    if not timed:
        return
    order = list(labels) + list(reversed(labels))
    ms = {b: [] for b in labels}
    for b in order:
        run = lambda: runner.call(b, fn, old_fn)
        run()  # first launch outside the timing
        ms[b].append(cs.cuda_timed(run, REPS)[1])
    emit("time", kernel=kernel, planes=where, ms=ms, **fields)


def point_lights(segs):
    """A frame's point lights: pos_to, intensity and the valid range."""
    import torch

    valid = segs[3].to(torch.int32)
    return segs[1], segs[2], int(valid.argmax()), int(valid.sum())


def main(argv) -> int:
    dirs = [Path(a) / "volumerenderer_tpu_torch" / "csrc" for a in argv]
    if not argv or not all(d.is_dir() for d in dirs):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import _build
    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl
    from volumerenderer_tpu_torch.ops.kernels import gather_many as gm
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv
    from volumerenderer_tpu_torch.render import color
    from port_slots_ab import frame_inputs

    if not torch.cuda.is_available():
        print("port_point_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(cs.nvidia_smi_line(), flush=True)
    names = ["parent"] + [f"step{k}" for k in range(1, len(dirs))]
    checkouts = dict(zip(names, dirs))
    checkouts["change"] = _build.CSRC
    labels = list(checkouts)
    old = {b for b, d in checkouts.items() if re.search(
        r"vr_gather_vpu\([^)]*long long N", (d / "gather_vpu.cu").read_text())}
    runner = Runner(build_all(checkouts), old)
    dev = torch.device("cuda")

    # Rows 1 and 4 on chip_smoke's synthetic cases (L <= 1,000).
    for ci, (L, start, count) in enumerate([(37, 5, 30), (1000, 3, 995)]):
        planes, lpos, lint, need, _, _ = cs.synthetic_case(
            cs.SYNTH_CP, cs.SEG_RC, L, start, count, 100 + ci, dev)
        for sphere in (False, True):
            for paired in (False, True):
                kw = dict(sphere=sphere, radius=0.3, paired=paired)
                tier = f"{'sphere' if sphere else 'point'} " + (
                    "paired" if paired else "exact")
                compare(runner, labels, f"row 1 {tier}", f"kernel L={L}",
                        lambda: gl.gather_lanes(*planes, lpos, lint, start,
                                                count, lane_need=need, **kw),
                        timed=False)
    planes, _, _ = cs.segment_case(cs.SYNTH_CP, cs.SEG_RC, 11, dev)
    _, lpos, lint, _, _, _ = cs.synthetic_case(8, 8, 1100, 0, 0, 12, dev)
    for sphere in (False, True):
        for paired in (False, True):
            kw = dict(sphere=sphere, radius=0.3, paired=paired)
            tier = f"{'sphere' if sphere else 'point'} " + (
                "paired" if paired else "exact")
            compare(runner, labels, f"row 4 {tier}", "slotkernel L=1093",
                    lambda: gv.gather_vpu(*planes, lpos, lint, 3, 1093, **kw),
                    lambda lib: old_vpu(lib, planes, lpos, lint, 3, 1093,
                                        **kw), timed=False)
    del planes
    torch.cuda.empty_cache()

    # The whole widest band of a RAY compact session, one frame's lights.
    r = cs.bench_renderer("exact", vt.Algorithm.RAY,
                          segment_mode="discrete_expanded")
    r.step(8)
    band = max(r._view.bands, key=lambda b: b.wx.shape[0])
    full = (band.wx, band.wy, band.wz, band.weight)
    need = band.lane_need
    segs = frame_inputs(r)
    step, radius = r.params.light_ray_step_size, r.params.beam_radius
    where = f"widest band {list(full[0].shape)}"
    lpos, lint, start, count = point_lights(segs)
    for sphere, paired in ((False, False), (False, True), (True, False)):
        kw = dict(sphere=sphere, radius=radius, paired=paired)
        compare(runner, labels,
                f"row 1 {'sphere' if sphere else 'point'} "
                f"{'paired' if paired else 'exact'}", where,
                lambda: gl.gather_lanes(*full, lpos, lint, start, count,
                                        lane_need=need, **kw),
                lights=count)
    for rad in (None, radius):
        for paired in (False, True):
            compare(runner, labels,
                    f"row 2 {'beam' if rad else 'ray'} "
                    f"{'paired' if paired else 'exact'}", where,
                    lambda: gs.gather_segments_discrete_lanes(
                        *full, *segs, step, sphere_radius=rad,
                        lane_need=need, paired=paired),
                    sublights=cs.sublights(segs, step))
    for rad, rule in ((None, "midpoint"), (radius, "midpoint"),
                      (radius, "tangent"), (radius, "closed")):
        for paired in (False, True):
            compare(runner, labels,
                    f"row 3 {'vrl' if rad is None else 'vbl-' + rule} "
                    f"{'paired' if paired else 'exact'}", where,
                    lambda: gs.gather_segments_analytic_lanes(
                        *full, *segs, sphere_radius=rad, quad_rule=rule,
                        quad_nodes=16, lane_need=need, paired=paired))
    pos, inten, valid, _ = color._expanded_lights(r.lights, r.params,
                                                  r.algorithm, r.config, 0)
    for sphere in (False, True):
        compare(runner, labels, f"row 8 {'sphere' if sphere else 'point'}",
                where, lambda: gm.gather_many(*full, pos, inten, valid,
                                              sphere=sphere, radius=radius),
                valid_slots=int(valid.sum()))
    # (d): the frame's point lights in a buffer of 100,000 slots.
    n = segs[3].shape[0]
    big_pos = torch.zeros((100_000, 3), device=dev)
    big_int = torch.zeros(100_000, device=dev)
    few = torch.zeros(100_000, dtype=torch.bool, device=dev)
    big_pos[:n], big_int[:n], few[:n] = segs[1], segs[2], segs[3]
    compare(runner, labels, "row 8 point (d) 100,000 slots", where,
            lambda: gm.gather_many(*full, big_pos, big_int, few,
                                   sphere=False), valid_slots=int(few.sum()))
    del r, band, full
    torch.cuda.empty_cache()

    # The whole 1080p ViewCache of a RAY slots session.
    r = cs.bench_renderer("exact", vt.Algorithm.RAY, compact_view=False,
                          segment_mode="discrete_expanded")
    r.step(8)
    v = r._view
    full = (v.wx, v.wy, v.wz, v.weight)
    segs = frame_inputs(r)
    where = f"ViewCache {list(full[0].shape)}"
    lpos, lint, start, count = point_lights(segs)
    for sphere, paired, c in ((False, False, count), (False, True, count),
                              (True, False, count), (False, False, 0)):
        kw = dict(sphere=sphere, radius=radius, paired=paired)
        compare(runner, labels,
                f"row 4 {'sphere' if sphere else 'point'} "
                f"{'paired' if paired else 'exact'}"
                + (" empty range (scan)" if c == 0 else ""), where,
                lambda: gv.gather_vpu(*full, lpos, lint, start, c, **kw),
                lambda lib: old_vpu(lib, full, lpos, lint, start, c, **kw),
                lights=c, live_samples=int((v.weight != 0).sum()))
    for rad in (None, radius):
        for paired in (False, True):
            compare(runner, labels,
                    f"row 5 {'beam' if rad else 'ray'} "
                    f"{'paired' if paired else 'exact'}", where,
                    lambda: gv.gather_segments_discrete(
                        *full, *segs, step, sphere_radius=rad, paired=paired))
    for rad, rule in ((None, "midpoint"), (radius, "midpoint"),
                      (radius, "tangent"), (radius, "closed")):
        for paired in (False, True):
            row = 6 if rad is None else 7
            compare(runner, labels,
                    f"row {row} {'vrl' if rad is None else 'vbl-' + rule} "
                    f"{'paired' if paired else 'exact'}", where,
                    lambda: gv.gather_segments_analytic(
                        *full, *segs, sphere_radius=rad, quad_rule=rule,
                        quad_nodes=16, paired=paired))
    pos, inten, valid, _ = color._expanded_lights(r.lights, r.params,
                                                  r.algorithm, r.config, 0)
    compare(runner, labels, "row 8 point (c)", where,
            lambda: gm.gather_many(*full, pos, inten, valid, sphere=False),
            valid_slots=int(valid.sum()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
