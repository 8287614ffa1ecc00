"""Where the time of the two tracked frames, the mapping step, the
inertial back end, the keyframe step's neighbourhood work, the whole
keyframe step over a keyframe sequence and the tracked sequence goes, on
one CUDA card.

    python3 -m plvio_tpu_torch.profile_frames \
        [frames | sequence | tracked | system | loop | mh_loop | stereo |
         stereo_points | kb8 | kb8_vi | line_modes | ed | dist]

Builds the synthetic inputs of `chip_smoke.py` (EuRoC geometry: 480x752,
1000 ORB features, 256 line features, 2048 map points, 128 map lines; 16
frames, and frames 1..15 with their IMU windows for the VI frame), and for
the point+line frame (`tracking_step_pl`) and the VI frame
(`tracking_step_vi`) on the kernel path, after one warm-up pass:

- wall ms/frame: CUDA events around one pass of all frames;
- device busy ms/frame and device kernels/frame: the device events of one
  more pass under `torch.profiler` (one stream, so they do not overlap);
  idle share = 1 - busy / wall;
- the device kernels with the most time, and the torch ops issued most
  often, per frame;
- per stage (ORB, lines, IMU, point match, line match, pose optimizer):
  device ms/frame between CUDA events recorded around the stage, and the
  host's enqueue ms/frame, from a third pass;
- the calls that synchronize the host with the card, per frame, from a
  fourth pass under torch.cuda's sync debug mode (`count_syncs`).
  `frames` as the argument stops here.

The keyframe mapping step (`mapping_step`, both window sizes, from
`inputs.perturb_window`'s start, 8 steps a pass) gets the same figures
per step, with the stages epipolar match, triangulate and local BA.  The
inertial window solve (`inertial_ba_step`, both buckets, perturbed start,
4 solves a pass) and the IMU initialization with its refinement
(`imu_init`, 4 of each a pass) get them per call, with each kernel's
device time as the stages.  The keyframe step's neighbourhood work
(`neighborhood_step`, both maps of `inputs.build_keyframe_map`, 2 steps a
pass, each on a fresh copy of the map made before the pass) gets them per
step, with the stages create_new_lines, search_in_neighbors and local_ba
and the step's host syncs (device-to-host reads).  The keyframe sequence
(`keyframe_sequence`, production's sizes) gets wall ms, device busy ms,
idle share and host syncs per step, split by the step's BA path (lba,
liba, liba_half, viba), and the device kernels with the most time;
`sequence` as the argument runs that part alone.  The tracked sequence
(`tracked_sequence`, 180 rendered frames at production's sizes) gets wall
ms, device busy ms, idle share and host syncs per frame, split into the
bootstrap frames, the tracked frames and the frames that make a
keyframe, the device kernels with the most time and the pyramid's own,
and the device ms of the ORB front end and of the pyramid inside it;
`tracked` runs that part alone.  The whole `System` over the MH replay
(`mh_replay`, 166 rendered frames at production's sizes, then
`global_refine`) gets the same figures per frame, split into the
bootstrap, tracked, keyframe and relocalization frames, the share of a
keyframe frame's wall and device time spent in `bow_transform`, and the
relocalization case on its final map (`entry.relocalization_case`);
`system` runs that part alone.  `loop` profiles the loop closer at
production caps on the hand-made maps (`entry.loop_closure`, the drifted
circle and the merge): wall and device busy ms per keyframe fed, the
closing keyframe apart, and the device kernels with the most time.
`mh_loop` runs the whole `System` with its default configuration (loop
closing on) over the 28 s circuit (`entry.mh_loop`, 560 rendered frames)
and gives the per-frame figures of `system` (bootstrap, tracked,
keyframe, relocalization frames) and the loop-closing stage's wall ms per
keyframe (`Metrics`).  `stereo` runs the whole `System` over the 8 s
stereo-inertial replay (`entry.stereo_replay`, 166 rectified pairs,
IMU_STEREO with lines, loop closing on) and gives the per-frame figures
of `system` (bootstrap, tracked and keyframe frames), the device kernels
with the most time, and the right view's front end (its ORB and line
extraction, CUDA events around it alone on every pair's right view):
ms a frame and its share of a tracked frame's wall and of a frame's.
`stereo_points` runs the point-only STEREO room (`entry.stereo_room`
without lines, 15 pairs) and the RGB-D room with bf = 40
(`entry.rgbd_room`, 12 frames), `kb8` the fisheye room
(`entry.kb8_room`, 30 frames, loop closing on): each the per-frame
figures of `system` (bootstrap, tracked and keyframe frames) and the
device kernels with the most time.  `kb8_vi` runs the fisheye MH replay
with the IMU (`entry.kb8_vi_replay`, 8 s), without and with lines, and
`line_modes` the MH replay's frames under SLAM modes 1, 2 and 3
(`entry.line_mode_replay`): the same per-frame figures and kernels.
`ed` runs the MH replay under the ED line detector with the prior-map
relocalizer (`entry.ed_replay`) with the same figures, the relocalizer's
stage and its alignment attempt's wall and device ms, then the STEREO
room under the ED detector (`entry.ed_stereo_room`).  `dist` profiles
the sharded inertial window solve at C = 16 and 64 on 1, 2 and 4 shards
of the card and `System` over the MH replay on 2 shards
(`profile_dist`).

Prints the card's `nvidia-smi` name and power limit first.  Needs one
card; JAX is never imported.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from . import entry as E
from .inputs import build_imu_windows, build_inputs, perturb_window
from .ops import imu as IMU
from .state import from_numpy

H, W, N_FEAT, CAP_PTS, CAP_LNS, N_LINE, N_FRAMES = 480, 752, 1000, 2048, 128, \
    256, 16
N_MAP = 8
N_LIBA = 4
N_NBH = 2


def _device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_summary(prof, n_frames: int, top: int = 12):
    """(busy ms/frame, device events/frame, [(name, n/frame, ms/frame)],
    [(torch op, n/frame)]) of a profiled pass."""
    dev_rows, cpu_rows = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_rows.append((e.key, e.count, _device_time_us(e) / 1e3))
        elif e.key.startswith("aten::"):
            cpu_rows.append((e.key, e.count))
    busy = sum(ms for _, _, ms in dev_rows) / n_frames
    n_dev = sum(n for _, n, _ in dev_rows) / n_frames
    dev_rows.sort(key=lambda r: -r[2])
    cpu_rows.sort(key=lambda r: -r[1])
    return (busy, n_dev,
            [(k, n / n_frames, ms / n_frames) for k, n, ms in dev_rows[:top]],
            [(k, n / n_frames) for k, n in cpu_rows[:10]])


class Spans:
    """CUDA events and host time around named stages."""

    def __init__(self):
        self.pending = []
        self.host = defaultdict(float)

    def wrap(self, name, fn):
        def timed(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            self.host[name] += (time.perf_counter() - t) * 1e3
            self.pending.append((name, e0, e1))
            return out
        return timed

    def read(self, n_frames: int):
        torch.cuda.synchronize()
        dev = defaultdict(float)
        for name, e0, e1 in self.pending:
            dev[name] += e0.elapsed_time(e1)
        return ({k: round(v / n_frames, 3) for k, v in dev.items()},
                {k: round(v / n_frames, 3) for k, v in self.host.items()})


def stage_spans(step, run, n_frames: int):
    """Device and host ms/frame of each stage of `step`, from one pass of
    `run`; the stage functions are wrapped for that pass only."""
    sp = Spans()
    step.orb.forward = sp.wrap("orb", step.orb.forward)
    step.lines.forward = sp.wrap("lines", step.lines.forward)
    patches = [(E, "point_projection_match", "point match"),
               (E, "line_proj_match_core", "line match"),
               (E, "fast_pose_opt_pl", "pose opt"),
               (IMU, "imu_preint", "imu")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, name in patches:
        setattr(mod, attr, sp.wrap(name, getattr(mod, attr)))
    had_vi = hasattr(step, "vi_opt")
    if had_vi:
        vi_opt = step.vi_opt
        step.vi_opt = sp.wrap("pose opt", vi_opt)
    try:
        run()
        return sp.read(n_frames)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        del step.orb.forward, step.lines.forward    # the class's again
        if had_vi:
            step.vi_opt = vi_opt


def mapping_spans(step, run, n_steps: int):
    """Device and host ms/step of the mapping step's three stages."""
    sp = Spans()
    saved = {a: getattr(step, a) for a in ("epi", "tri", "lba")}
    for attr, name in (("epi", "epipolar match"), ("tri", "triangulate"),
                       ("lba", "local BA")):
        setattr(step, attr, sp.wrap(name, saved[attr]))
    try:
        run()
        return sp.read(n_steps)
    finally:
        for attr, fn in saved.items():
            setattr(step, attr, fn)


def neighborhood_spans(step, run, n_steps: int):
    """Device and host ms/step of the neighbourhood step's three calls."""
    sp = Spans()
    mp = step.mapper
    names = ("create_new_lines", "search_in_neighbors", "local_ba")
    for attr in names:
        setattr(mp, attr, sp.wrap(attr, getattr(mp, attr)))
    try:
        run()
        return sp.read(n_steps)
    finally:
        for attr in names:
            delattr(mp, attr)                   # the class's again


def no_spans(step, run, n: int):
    """Paths whose stages are single kernels: the profile's kernel table
    says where their time goes."""
    return {}, {}


def profile(name, step, run, n_frames: int, spans=stage_spans,
            unit: str = "frame"):
    run()                                        # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    wall = e0.elapsed_time(e1) / n_frames
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    busy, n_dev, kernels, ops = device_summary(prof, n_frames)
    idle = 1.0 - busy / wall if wall > 0 else float("nan")
    print(f"== {name}: wall {wall:.3f} ms/{unit}; device busy {busy:.3f} "
          f"ms/{unit}; idle share {idle:.1%}; device kernels "
          f"{n_dev:.1f}/{unit}")
    for k, n, ms in kernels:
        print(f"   {k[:70]:70s} n/{unit} {n:6.1f} dev ms/{unit} {ms:.4f}")
    print(f"   torch ops by count/{unit}: "
          f"{[(k, round(n, 1)) for k, n in ops]}")
    dev, host = spans(step, run, n_frames)
    print(f"   stage device ms/{unit}: {dev}")
    print(f"   stage host enqueue ms/{unit}: {host}")


def count_syncs(run) -> int:
    """The calls that synchronize the host with the card during `run()`
    (device-to-host reads, blocking host-to-device copies from pageable
    memory), as torch.cuda's sync debug mode reports them."""
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in got)


def step_path(st) -> str:
    """A keyframe step's BA path: "viba" when it ran a full-map solve,
    else its window solve's ("lba", "liba", "liba_half")."""
    paths = [b[0] for b in st.ba]
    return "viba" if "viba" in paths else (paths[0] if paths else "none")


def profile_sequence(dev):
    """The keyframe sequence at production's sizes: a warm-up run, one run
    for the wall ms and host syncs of each step (`process_keyframe`
    between host clocks, synchronized), one under `torch.profiler` with
    each step in a `record_function` range, its device busy ms the
    device events that start inside the range; split by the step's BA
    path."""
    step, seq = E.keyframe_sequence(device=dev)
    with torch.no_grad():
        step(seq)
        out = step(seq)
    from .models.local_mapping import LocalMapper
    inner = LocalMapper.process_keyframe

    def ranged(self, kf, protect=()):
        with torch.profiler.record_function("seq step"):
            res = inner(self, kf, protect)
            torch.cuda.synchronize()
        return res
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    LocalMapper.process_keyframe = ranged
    try:
        with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
            out_p = step(seq)
    finally:
        LocalMapper.process_keyframe = inner
    cuda_t = torch.autograd.DeviceType.CUDA
    evts = prof.events()
    # the range's CPU event (the profiler also marks it on the device)
    ranges = sorted((e.time_range.start, e.time_range.end) for e in evts
                    if e.name == "seq step" and e.device_type != cuda_t)
    dev_ev = [(e.time_range.start, e.time_range.end - e.time_range.start,
               e.name) for e in evts
              if e.device_type == cuda_t and e.name != "seq step"]
    busy = [sum(d for t, d, _ in dev_ev if a <= t <= b) / 1e3
            for a, b in ranges]
    rows = defaultdict(list)
    for st, stp, b in zip(out.steps, out_p.steps, busy):
        rows[step_path(stp)].append((st.ms, b, st.host_syncs))
    print(f"== keyframe sequence ({len(out.steps)} steps, production's "
          f"sizes; {len(ranges)} profiled steps): per step by BA path")
    for path, r in sorted(rows.items()):
        r = np.array(r)
        wall, dbusy = r[:, 0].mean(), r[:, 1].mean()
        print(f"   {path:10s} steps {len(r):3d} wall {wall:8.3f} ms/step "
              f"device busy {dbusy:8.3f} ms/step idle share "
              f"{1 - dbusy / wall:6.1%} host syncs {r[:, 2].mean():6.1f}/step")
    tot = np.array([x for r in rows.values() for x in r])
    print(f"   all        steps {len(tot):3d} wall {tot[:, 0].mean():8.3f} "
          f"ms/step device busy {tot[:, 1].mean():8.3f} ms/step idle share "
          f"{1 - tot[:, 1].sum() / tot[:, 0].sum():6.1%}")
    per = defaultdict(lambda: [0, 0.0])
    for _, d, name in dev_ev:
        per[name][0] += 1
        per[name][1] += d / 1e3
    n = len(out_p.steps)
    print(f"   device operations (kernels, memsets, copies) "
          f"{len(dev_ev) / n:.1f}/step")
    for name, (c, ms) in sorted(per.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"   {name[:70]:70s} n/step {c / n:6.1f} dev ms/step "
              f"{ms / n:.4f}")


def profile_tracked(dev):
    """The tracked sequence at production's sizes: a warm-up run, one run
    for the wall ms and host syncs of each frame (the entry point's own
    host clocks, synchronized), one under `torch.profiler` with each frame
    in a `record_function` range (device busy ms: the device events that
    start inside it), split into the bootstrap frames, the tracked frames
    and the frames that make a keyframe; and one with CUDA events around
    the ORB front end and the pyramid inside it."""
    from .ops import frontend as FE
    step, S = E.tracked_sequence(device=dev)
    with torch.no_grad():
        step(S)
        out = step(S)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        step(S, frame_ctx=lambda i: torch.profiler.record_function("frame"))
    cuda_t = torch.autograd.DeviceType.CUDA
    evts = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end) for e in evts
                    if e.name == "frame" and e.device_type != cuda_t)
    dev_ev = [(e.time_range.start, e.time_range.end - e.time_range.start,
               e.name) for e in evts
              if e.device_type == cuda_t and e.name != "frame"]
    busy = [sum(d for t, d, _ in dev_ev if a <= t <= b) / 1e3
            for a, b in ranges]
    rows = defaultdict(list)
    for i, (f, b) in enumerate(zip(out.frames, busy)):
        kind = "bootstrap" if i <= out.init_frame else (
            "keyframe" if f.keyframe else "tracked")
        rows[kind].append((f.ms, b, f.host_syncs))
    print(f"== tracked sequence ({len(out.frames)} frames, production's "
          f"sizes; {len(ranges)} profiled frames): per frame")
    for kind in ("bootstrap", "tracked", "keyframe"):
        r = np.array(rows[kind])
        wall, dbusy = r[:, 0].mean(), r[:, 1].mean()
        print(f"   {kind:10s} frames {len(r):3d} wall {wall:8.3f} ms/frame "
              f"device busy {dbusy:8.3f} ms/frame idle share "
              f"{1 - dbusy / wall:6.1%} host syncs {r[:, 2].mean():5.1f}/"
              "frame")
    tot = np.array([x for r in rows.values() for x in r])
    print(f"   all        frames {len(tot):3d} wall {tot[:, 0].mean():8.3f} "
          f"ms/frame device busy {tot[:, 1].mean():8.3f} ms/frame idle share"
          f" {1 - tot[:, 1].sum() / tot[:, 0].sum():6.1%}")
    per = defaultdict(lambda: [0, 0.0])
    for _, d, name in dev_ev:
        per[name][0] += 1
        per[name][1] += d / 1e3
    n = len(out.frames)
    for name, (c, ms) in sorted(per.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"   {name[:70]:70s} n/frame {c / n:6.1f} dev ms/frame "
              f"{ms / n:.4f}")
    for name, (c, ms) in sorted(per.items()):
        if "pyramid" in name:
            print(f"   {name[:70]:70s} n/frame {c / n:6.1f} dev ms/frame "
                  f"{ms / n:.4f} (the pyramid's own kernels)")
    sp = Spans()
    inner = FE.build_pyramid
    FE.build_pyramid = sp.wrap("pyramid", inner)
    step.orb.forward = sp.wrap("orb (pyramid included)", step.orb.forward)
    try:
        with torch.no_grad():
            step(S)
        dev_ms, host_ms = sp.read(n)
    finally:
        FE.build_pyramid = inner
        del step.orb.forward
    print(f"   spans, device ms/frame {dev_ms}, host ms/frame {host_ms}")


def _frame_ranges(prof):
    """The profiled frames' host ranges and the device events (start,
    duration us, name)."""
    cuda_t = torch.autograd.DeviceType.CUDA
    evts = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end) for e in evts
                    if e.name == "frame" and e.device_type != cuda_t)
    dev_ev = [(e.time_range.start, e.time_range.end - e.time_range.start,
               e.name) for e in evts
              if e.device_type == cuda_t and e.name != "frame"]
    return ranges, dev_ev


def profile_system(dev):
    """The System over the MH replay at production's sizes: a warm-up run,
    one run for the wall ms and host syncs of each frame, one under
    `torch.profiler` with each frame in a `record_function` range (device
    busy ms), split into bootstrap, tracked, keyframe and relocalization
    frames, with `bow_transform`'s device ms inside the keyframe frames;
    then the relocalization case on the last run's map, profiled."""
    step, S = E.mh_replay(device=dev, use_loop_closing=False)
    with torch.no_grad():
        step(S)
        out = step(S)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        prof_out = step(S, frame_ctx=lambda i: torch.profiler.record_function(
            "frame"))
    ranges, dev_ev = _frame_ranges(prof)
    busy = [sum(d for t, d, _ in dev_ev if a <= t <= b) / 1e3
            for a, b in ranges]
    bow = [sum(d for t, d, nm in dev_ev if a <= t <= b and "bow_transform"
               in nm) / 1e3 for a, b in ranges]
    rows = defaultdict(list)
    for i, (f, b, bw) in enumerate(zip(out.frames, busy, bow)):
        kind = "bootstrap" if i <= out.init_frame else (
            "relocalize" if f.reloc_tried else
            "keyframe" if f.keyframe else "tracked")
        rows[kind].append((f.ms, b, f.host_syncs, bw))
    n = len(out.frames)
    print(f"== System over the MH replay ({n} frames, production's sizes; "
          f"{len(ranges)} profiled frames, keyframes {out.keyframes}, "
          f"relocalizations {out.reloc_tried}): per frame")
    for kind in ("bootstrap", "tracked", "keyframe", "relocalize"):
        if not rows[kind]:
            print(f"   {kind:10s} frames   0")
            continue
        r = np.array(rows[kind])
        wall, dbusy = r[:, 0].mean(), r[:, 1].mean()
        print(f"   {kind:10s} frames {len(r):3d} wall {wall:8.3f} ms/frame "
              f"device busy {dbusy:8.3f} ms/frame idle share "
              f"{1 - dbusy / wall:6.1%} host syncs {r[:, 2].mean():5.1f}/"
              f"frame bow_transform {r[:, 3].mean():.4f} dev ms/frame")
    k = np.array(rows["keyframe"])
    if len(k):
        print(f"   bow_transform in a keyframe frame: {k[:, 3].mean():.4f} "
              f"dev ms = {k[:, 3].sum() / k[:, 0].sum():.3%} of its wall, "
              f"{k[:, 3].sum() / max(k[:, 1].sum(), 1e-9):.3%} of its "
              "device busy time")
    tot = np.array([x for r in rows.values() for x in r])
    print(f"   all        frames {len(tot):3d} wall {tot[:, 0].mean():8.3f} "
          f"ms/frame device busy {tot[:, 1].mean():8.3f} ms/frame idle share"
          f" {1 - tot[:, 1].sum() / tot[:, 0].sum():6.1%}")
    for name, (c, ms) in sorted(_per_name(dev_ev).items(),
                                key=lambda kv: -kv[1][1])[:12]:
        print(f"   {name[:70]:70s} n/frame {c / n:6.1f} dev ms/frame "
              f"{ms / n:.4f}")
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("frame"):
            case = E.relocalization_case(prof_out.system, S, prof_out.poses,
                                         max_frames=1)
    ranges, dev_ev = _frame_ranges(prof)
    b = sum(d for t, d, _ in dev_ev) / 1e3
    print(f"   relocalization case (the profiled run's map): frames "
          f"{case['frames']}, wall {case.get('ms', float('nan')):.3f} ms, "
          f"device busy {b:.3f} ms, centre gap {case['centre_m']:.4f} m")
    for name, (c, ms) in sorted(_per_name(dev_ev).items(),
                                key=lambda kv: -kv[1][1])[:8]:
        print(f"     {name[:68]:68s} n {c:4d} dev ms {ms:.4f}")


def profile_loop(dev):
    """The loop closer at production caps on the drifted circle and the
    merge: a warm-up run each, then one under `torch.profiler` with each
    keyframe fed in a range."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for case in ("circle", "merge"):
        step, inputs = E.loop_closure(case, device=dev)
        with torch.no_grad():
            step(inputs)
            import plvio_tpu_torch.models.loop_closing as LC
            pk = LC.LoopCloser.process_keyframe

            def ranged(self, kf):
                with torch.profiler.record_function("frame"):
                    return pk(self, kf)
            LC.LoopCloser.process_keyframe = ranged
            try:
                with torch.profiler.profile(activities=acts) as prof:
                    out = step(inputs)
            finally:
                LC.LoopCloser.process_keyframe = pk
        ranges, dev_ev = _frame_ranges(prof)
        busy = [sum(d for t, d, _ in dev_ev if a <= t <= b) / 1e3
                for a, b in ranges]
        print(f"== loop closure, {case} (production caps): closed "
              f"{out.closed}, graph {out.graph}")
        for i, (ms, b) in enumerate(zip(out.ms, busy)):
            print(f"   keyframe {i} ({'closing' if out.closed[i] else 'no '}"
                  f") wall {ms:9.3f} ms device busy {b:9.3f} ms idle share "
                  f"{1 - b / ms:6.1%}")
        for name, (c, ms) in sorted(_per_name(dev_ev).items(),
                                    key=lambda kv: -kv[1][1])[:12]:
            print(f"   {name[:70]:70s} n {c:5d} dev ms {ms:.4f}")


def profile_mh_loop(dev):
    """The System with loop closing over the 28 s circuit: one run for the
    wall ms of each frame, one under `torch.profiler` for the device busy
    ms, split by frame kind; the loop-closing stage from `Metrics`."""
    step, S = E.mh_loop(device=dev)
    with torch.no_grad():
        out = step(S)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        step(S, frame_ctx=lambda i: torch.profiler.record_function("frame"))
    ranges, dev_ev = _frame_ranges(prof)
    busy = [sum(d for t, d, _ in dev_ev if a <= t <= b) / 1e3
            for a, b in ranges]
    rows = defaultdict(list)
    for i, (f, b) in enumerate(zip(out.frames, busy)):
        kind = "bootstrap" if i <= out.init_frame else (
            "relocalize" if f.reloc_tried else
            "keyframe" if f.keyframe else "tracked")
        rows[kind].append((f.ms, b, f.host_syncs))
    lcs = out.metrics.get("loop_closing", {})
    print(f"== System over the 28 s circuit ({len(out.frames)} frames): "
          f"tracked {out.n_tracked}, keyframes {out.keyframes}, maps "
          f"{out.maps}, loops {out.loops}, merges {out.merges}, Sim3 "
          f"verifications {out.verifications}, ATE {out.ate_sim3:.4f} / "
          f"{out.ate_se3:.4f} m; loop_closing stage {lcs}")
    for kind in ("bootstrap", "tracked", "keyframe", "relocalize"):
        if not rows[kind]:
            continue
        r = np.array(rows[kind])
        wall, dbusy = r[:, 0].mean(), r[:, 1].mean()
        print(f"   {kind:10s} frames {len(r):3d} wall {wall:8.3f} ms/frame "
              f"device busy {dbusy:8.3f} ms/frame idle share "
              f"{1 - dbusy / wall:6.1%} host syncs {r[:, 2].mean():5.1f}")
    n = len(out.frames)
    for name, (c, ms) in sorted(_per_name(dev_ev).items(),
                                key=lambda kv: -kv[1][1])[:12]:
        print(f"   {name[:70]:70s} n/frame {c / n:6.1f} dev ms/frame "
              f"{ms / n:.4f}")


def profile_stereo(dev):
    """The System over the stereo-inertial replay (`_profile_run`), then
    the right view's front end alone on every pair."""
    step, S = E.stereo_replay(device=dev)
    out, rows, tot = _profile_run(
        step, S, "System over the stereo-inertial replay (production's "
        "sizes)", lambda o: f", lines {o.lines}, IMU initialized at frame "
        f"{o.imu_init_frame}")
    n = len(out.frames)
    slam = out.system
    imgs = [torch.from_numpy(im).to(dev) for im in S["right"]]
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    from .models.system import orb_and_line_level

    def front(img):
        _, level1 = orb_and_line_level(slam.extract, slam.extract_lines, img)
        slam.extract_lines(img, level1)
    with torch.no_grad():
        for img in imgs[:3]:
            front(img)
        torch.cuda.synchronize()
        t0.record()
        for img in imgs:
            front(img)
        t1.record()
        torch.cuda.synchronize()
    right = t0.elapsed_time(t1) / n
    tracked = np.array(rows["tracked"])[:, 0].mean()
    print(f"   the right view's front end (ORB + lines): {right:.3f} ms a "
          f"frame = {right / tracked:.1%} of a tracked frame's wall, "
          f"{right / tot[:, 0].mean():.1%} of a frame's")


def _profile_run(step, S, title: str, detail=lambda out: ""):
    """A SystemRun over S: a warm-up run, one for the wall ms and host
    syncs of each frame, one under `torch.profiler` for the device busy
    ms; per frame kind and the device kernels with the most time.
    Returns (out, rows by frame kind, all rows)."""
    with torch.no_grad():
        step(S)
        out = step(S)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        step(S, frame_ctx=lambda i: torch.profiler.record_function("frame"))
    ranges, dev_ev = _frame_ranges(prof)
    busy = [sum(d for t, d, _ in dev_ev if a <= t <= b) / 1e3
            for a, b in ranges]
    rows = defaultdict(list)
    for i, (f, b) in enumerate(zip(out.frames, busy)):
        kind = "bootstrap" if i <= out.init_frame else (
            "relocalize" if f.reloc_tried else
            "keyframe" if f.keyframe else "tracked")
        rows[kind].append((f.ms, b, f.host_syncs))
    n = len(out.frames)
    print(f"== {title} ({n} frames): tracked {out.n_tracked}, keyframes "
          f"{out.keyframes}, points {out.points}{detail(out)}, ATE "
          f"{out.ate_sim3:.4f} / {out.ate_se3:.4f} m; per frame")
    for kind in ("bootstrap", "tracked", "keyframe", "relocalize"):
        if not rows[kind]:
            continue
        r = np.array(rows[kind])
        wall, dbusy = r[:, 0].mean(), r[:, 1].mean()
        print(f"   {kind:10s} frames {len(r):3d} wall {wall:8.3f} ms/frame "
              f"device busy {dbusy:8.3f} ms/frame idle share "
              f"{1 - dbusy / wall:6.1%} host syncs {r[:, 2].mean():5.1f}")
    tot = np.array([x for r in rows.values() for x in r])
    print(f"   all        frames {len(tot):3d} wall {tot[:, 0].mean():8.3f} "
          f"ms/frame device busy {tot[:, 1].mean():8.3f} ms/frame idle share"
          f" {1 - tot[:, 1].sum() / tot[:, 0].sum():6.1%}")
    for name, (c, ms) in sorted(_per_name(dev_ev).items(),
                                key=lambda kv: -kv[1][1])[:14]:
        print(f"   {name[:70]:70s} n/frame {c / n:6.1f} dev ms/frame "
              f"{ms / n:.4f}")
    return out, rows, tot


def profile_stereo_points(dev):
    """The point-only STEREO room and the RGB-D room with bf = 40."""
    step, S = E.stereo_room(device=dev, use_lines=False)
    _profile_run(step, S, "STEREO room without lines")
    step, S = E.rgbd_room(device=dev, bf=40.0)
    _profile_run(step, S, "RGB-D room, bf 40")


def profile_kb8(dev):
    """The KB8 fisheye room, monocular, loop closing on."""
    step, S = E.kb8_room(device=dev)
    _profile_run(step, S, "KB8 fisheye room")


def profile_kb8_vi(dev):
    """The fisheye MH replay with the IMU (`entry.kb8_vi_replay`, 8 s,
    loop closing on), without and with lines."""
    for lines in (False, True):
        step, S = E.kb8_vi_replay(device=dev, use_lines=lines)
        _profile_run(step, S, f"KB8 fisheye replay with the IMU, lines "
                     f"{'on' if lines else 'off'}",
                     lambda o: f", IMU init frame {o.imu_init_frame}")


def profile_line_modes(dev):
    """SLAM modes 1-3 over the MH replay's frames (`entry.line_mode_replay`,
    8 s, MONOCULAR with lines, loop closing on), the replay rendered once."""
    from .inputs import build_mh_replay
    S = build_mh_replay()
    S["imu"] = [None] * len(S["frames"])
    for mode in (1, 2, 3):
        step = E.SystemRun(device=dev, cfg=E.line_mode_config(mode))
        _profile_run(step, S, f"SLAM mode {mode} over the MH replay")


def profile_ed(dev):
    """The MH replay under the ED line detector with the prior-map
    relocalizer (`entry.ed_replay`, 8 s, IMU_MONOCULAR with lines, loop
    closing on): the per-frame figures of `system`; the relocalizer's
    stage ("prior_reloc", wall ms a keyframe, `Metrics`); its alignment
    attempt (`_try_align` on the keyframe that aligned, again on the final
    map: wall ms between synchronizations and device busy ms under
    `torch.profiler`); then the STEREO room with lines under the ED
    detector (`entry.ed_stereo_room`)."""
    step, S = E.ed_replay(device=dev)
    out, _, _ = _profile_run(
        step, S, "MH replay, ED detector, prior-map relocalizer",
        lambda o: f", IMU init frame {o.imu_init_frame}, prior aligned "
        f"{o.prior_aligned} at keyframe {o.prior_align_kf}, "
        f"{o.prior_n} keyframes relocalized, {o.prior_err:.4f} m RMSE")
    st = out.metrics.get("prior_reloc")
    if st:
        print(f"   prior_reloc stage: {json.dumps(st)}")
    rl = out.system.relocalizer
    if rl.aligned_kf >= 0:
        def attempt():
            rl.T_prior_from_live = None
            rl._try_align(rl.aligned_kf)
            torch.cuda.synchronize()
        with torch.no_grad():
            attempt()
            t0 = time.perf_counter()
            for _ in range(5):
                attempt()
            wall = (time.perf_counter() - t0) / 5 * 1e3
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                attempt()
        busy = sum(d for _, d, _ in _frame_ranges(prof)[1]) / 1e3
        print(f"   _try_align on keyframe {rl.aligned_kf}: wall "
              f"{wall:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.1%}, tried {rl.attempts[-1]}")
    step, S = E.ed_stereo_room(device=dev)
    _profile_run(step, S, "STEREO room with lines, ED detector")


def profile_dist(dev):
    """Slice 15: one sharded inertial window solve (`entry.dist_window`,
    C = 16 and C = 64) on 1, 2 and 4 shards of the card, 4 solves a pass
    (wall and device busy ms, idle share, the device kernels with the most
    time per solve; 6 host reads a solve, its outputs), then `System` over
    the MH replay with the mapper's runner on 2 shards
    (`entry.dist_replay`, loop closing off) with the per-frame figures of
    `system`."""
    for big in (False, True):
        for D in (1, 2, 4):
            step, Wa, _ = E.dist_window(D, big=big, device=dev)

            def run(step=step, Wa=Wa):
                with torch.no_grad():
                    for _ in range(N_LIBA):
                        step(Wa)
            profile(f"sharded window solve, C = {64 if big else 16}, D = "
                    f"{D} (6 host reads a solve)", step, run, N_LIBA,
                    spans=no_spans, unit="solve")
    step, S = E.dist_replay(2, device=dev, use_loop_closing=False)
    _profile_run(step, S, "System over the MH replay, 2 shards",
                 lambda out: f"sharded window solves "
                 f"{out.metrics['mapping/dist_solves']['calls']}, dropped "
                 f"observations "
                 f"{out.metrics['mapping/dist_dropped_obs']['calls']}")


def _per_name(dev_ev):
    per = defaultdict(lambda: [0, 0.0])
    for _, d, name in dev_ev:
        per[name][0] += 1
        per[name][1] += d / 1e3
    return per


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_frames: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0])
    if sys.argv[1:] == ["sequence"]:
        profile_sequence(dev)
        return 0
    if sys.argv[1:] == ["tracked"]:
        profile_tracked(dev)
        return 0
    if sys.argv[1:] == ["system"]:
        profile_system(dev)
        return 0
    if sys.argv[1:] == ["loop"]:
        profile_loop(dev)
        return 0
    if sys.argv[1:] == ["mh_loop"]:
        profile_mh_loop(dev)
        return 0
    if sys.argv[1:] == ["stereo"]:
        profile_stereo(dev)
        return 0
    if sys.argv[1:] == ["stereo_points"]:
        profile_stereo_points(dev)
        return 0
    if sys.argv[1:] == ["kb8"]:
        profile_kb8(dev)
        return 0
    if sys.argv[1:] == ["kb8_vi"]:
        profile_kb8_vi(dev)
        return 0
    if sys.argv[1:] == ["line_modes"]:
        profile_line_modes(dev)
        return 0
    if sys.argv[1:] == ["ed"]:
        profile_ed(dev)
        return 0
    if sys.argv[1:] == ["dist"]:
        profile_dist(dev)
        return 0
    (frames, poses, pt_xyz, pt_desc, pt_valid, ln_ep6, ln_desc, ln_valid,
     traj) = build_inputs(N_FRAMES, CAP_PTS, CAP_LNS, H, W,
                          n_features=N_FEAT, device=dev)
    st = from_numpy(dict(pt_xyz=pt_xyz, pt_desc=pt_desc, pt_valid=pt_valid,
                         ln_ep6=ln_ep6, ln_desc=ln_desc, ln_valid=ln_valid),
                    dev)
    map_args = tuple(st[k] for k in ("pt_xyz", "pt_desc", "pt_valid",
                                     "ln_ep6", "ln_desc", "ln_valid"))
    imgs = [torch.from_numpy(f).to(dev) for f in frames]
    gyro, acc, dts, carry0 = build_imu_windows(traj, N_FRAMES)
    carry0 = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in carry0)
    windows = [tuple(torch.from_numpy(a[j]).to(dev) for a in (gyro, acc, dts))
               for j in range(N_FRAMES - 1)]
    pl, _ = E.tracking_step_pl(H, W, N_FEAT, CAP_PTS, CAP_LNS, N_LINE,
                               device=dev)
    vi, _ = E.tracking_step_vi(H, W, N_FEAT, CAP_PTS, N_LINE, device=dev)
    pose0 = torch.from_numpy(poses[0]).to(dev)

    @torch.no_grad()
    def run_pl():
        p = pose0
        for img in imgs:
            p, _ = pl(img, p, *map_args)

    @torch.no_grad()
    def run_vi():
        c = carry0
        for i in range(1, N_FRAMES):
            c, _ = vi(c, (imgs[i], *windows[i - 1]), *map_args)

    profile(f"point+line frame ({N_FRAMES} frames)", pl, run_pl, N_FRAMES)
    profile(f"VI frame ({N_FRAMES - 1} frames)", vi, run_vi, N_FRAMES - 1)
    for name, run, n in (("point+line", run_pl, N_FRAMES),
                         ("VI", run_vi, N_FRAMES - 1)):
        print(f"   {name} frame: {count_syncs(run) / n:g} synchronizing "
              "calls a frame (torch.cuda sync debug mode)")
    if sys.argv[1:] == ["frames"]:
        return 0
    for name, sz in (("worst", E.MAPPING_WORST),
                     ("typical", E.MAPPING_TYPICAL)):
        ms, A = E.mapping_step(**sz, device=dev)
        P, X = perturb_window(A["kf_poses"].cpu().numpy(),
                              A["pt_xyz"].cpu().numpy())
        A["kf_poses"], A["pt_xyz"] = (torch.from_numpy(P).to(dev),
                                      torch.from_numpy(X).to(dev))

        @torch.no_grad()
        def run_map(ms=ms, A=A):
            for _ in range(N_MAP):
                ms(A)

        profile(f"mapping step, {name} ({N_MAP} steps, perturbed start)",
                ms, run_map, N_MAP, spans=mapping_spans, unit="step")
    for name, sz in (("worst", E.LIBA_WORST), ("half", E.LIBA_HALF)):
        lb, win = E.inertial_ba_step(**sz, perturbed=True, device=dev)

        @torch.no_grad()
        def run_liba(lb=lb, win=win):
            for _ in range(N_LIBA):
                lb(win)

        profile(f"inertial window solve, {name} ({N_LIBA} solves, perturbed "
                "start)", lb, run_liba, N_LIBA, spans=no_spans, unit="solve")
    ii, B = E.imu_init(device=dev)

    @torch.no_grad()
    def run_init():
        for _ in range(N_LIBA):
            ii(B)
            ii.refine(B)

    profile(f"IMU initialization + refinement ({N_LIBA} of each)", ii,
            run_init, N_LIBA, spans=no_spans, unit="pair")
    from .inputs import build_keyframe_map
    from .state import mapstore_from_numpy
    for name, conf in (("points", False), ("confirmed lines", True)):
        arrays, _ = build_keyframe_map(conf)
        ns, _ = E.neighborhood_step(conf, device=dev)
        maps = [mapstore_from_numpy(arrays) for _ in range(4 * N_NBH)]
        syncs = []

        @torch.no_grad()
        def run_nbh(ns=ns, maps=maps, syncs=syncs):
            for _ in range(N_NBH):
                syncs.append(ns(maps.pop()).host_syncs)

        profile(f"neighbourhood step, {name} map ({N_NBH} steps)", ns,
                run_nbh, N_NBH, spans=neighborhood_spans, unit="step")
        print(f"   host syncs per step: {syncs}")
    profile_sequence(dev)
    profile_tracked(dev)
    profile_system(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
