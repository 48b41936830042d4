"""A profiled stretch of the window, read from ``torch.profiler``'s trace.

``window_whole`` is a frozen copy of ``chip_smoke.window_whole``: the
profiler now and then loses a window's device events, so a traced stretch
counts only when it holds exactly the port's kernel launches that the
program's own launch counters saw, and is taken again otherwise.

What is read: the traced stretch's length (the harness's annotation around
it), the device's busy time (the union of every device operation's
interval), the device kernels launched, device time by kernel name, and the
idle gaps between device operations, each put down to the innermost host
operation running at its middle (or to host code outside any operator:
Python between the program's calls).
"""
from __future__ import annotations

import bisect
import dataclasses

import torch

WINDOW_MARK = "vbench.traced"
TRIES = 3  # traced stretches taken before the run gives up
TOP = 10  # entries of each breakdown list


def window_whole(named: int, iters: int, per_call: int) -> bool:
    """Whether a profiler window of iters calls kept every kernel they
    launched: exactly iters x per_call named kernel events (copied from
    ``chip_smoke.window_whole``)."""
    return per_call >= 1 and named == iters * per_call


@dataclasses.dataclass
class Trace:
    window_s: float  # the traced stretch, on the trace's clock
    busy_s: float  # union of device operations' intervals inside it
    kernels: int  # device kernel launches (copies and fills apart)
    by_kernel: dict  # kernel name -> device seconds
    idle_by_host: dict  # innermost host operation -> idle device seconds

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the kernels whose names contain one of names."""
        return sum(s for k, s in self.by_kernel.items() if any(n in k for n in names))

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return dict(device_ops=top(self.by_kernel), idle_gaps=top(self.idle_by_host))


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def short(name: str) -> str:
    """A kernel's function name, without return type, template arguments and
    parameters: the instances of one template add up under it."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut]


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof) -> Trace:
    """Reduce a finished profile whose stretch the harness marked with
    ``WINDOW_MARK``."""
    from torch.autograd import DeviceType

    events = prof.events()
    mark = [e for e in events if e.name == WINDOW_MARK]
    if not mark:
        raise RuntimeError(f"the trace holds no {WINDOW_MARK} mark")
    w0, w1 = mark[0].time_range.start, mark[0].time_range.end
    dev, host = [], []
    by_kernel: dict = {}
    kernels = 0
    for e in events:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if getattr(e, "is_user_annotation", False) or e.name == WINDOW_MARK:
            continue  # the harness's own marks, on the host's side and the device's
        if e.device_type == DeviceType.CUDA:
            if t <= s:
                continue
            dev.append((s, t))
            if _is_kernel(e.name):
                kernels += 1
                key = short(e.name)
                by_kernel[key] = by_kernel.get(key, 0.0) + (t - s) / 1e6
        elif t > s:
            host.append((e.time_range.start, e.time_range.end, e.name))
    busy = _union(dev)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle: dict = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        name = "host code outside any operator"
        # the innermost host operation holding the middle: the latest-starting
        # one that still runs there (nested operations start later)
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
            if mid - host[j][0] > 1e6:  # nothing a second back holds it
                break
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=sum(t - s for s, t in busy) / 1e6,
                 kernels=kernels, by_kernel=by_kernel, idle_by_host=idle)


# the port's kernel forms that launch one device kernel a call, by the
# launch counter's name and the kernel's name in the trace
ONE_KERNEL_FORMS = {
    "pq_adc.gathered": "adc_staged_kernel",
    "pq_adc.gathered_l2": "adc_l2_kernel",
    "topk_select.rank": "topk_bitonic_kernel",
    "flat_l2.gathered": "flat_gathered_kernel",
    "pq_encode": "pq_encode_kernel",
}


def traced(fn, launch_counts, device) -> Trace:
    """Run ``fn()`` (a stretch of requests) under the profiler until a
    stretch holds as many kernels of ONE_KERNEL_FORMS as the program's
    launch counters (``launch_counts()``) saw it launch, at most TRIES
    times; the reading of the stretch that held. On the CPU (the tests) only
    the host's side is traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def counted() -> int:
        c = launch_counts()
        return sum(c[f] for f in ONE_KERNEL_FORMS)

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    seen = []
    for _ in range(TRIES):
        sync()
        before = counted()
        with profile(activities=activities) as prof:
            with record_function(WINDOW_MARK):
                fn()
                sync()
        launched = counted() - before
        named = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                    and any(k in e.name for k in ONE_KERNEL_FORMS.values()))
        if window_whole(named, launched, 1):
            return read(prof)
        seen.append((named, launched))
    raise RuntimeError(f"no whole traced stretch in {TRIES} tries (kernels traced, "
                       f"launched): {seen}")
