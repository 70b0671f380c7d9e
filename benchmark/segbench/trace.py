"""What a torch.profiler session of the traced window recorded, read from
its raw kineto events (building the profiler's event tree takes seconds
for a train step's ~50,000 operations): the device's activities, the
host's operations, and user annotations.

Busy time is the union of the device's kernel, copy and set intervals;
the window runs from the first recorded activity to the last.
"""

import bisect
from dataclasses import dataclass, field

# bookkeeping records of the profiler itself
UTILITY = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new",
    "profiler::_record_function_exit", "aten::is_leaf", "aten::output_nr",
    "aten::_version"))
LABEL_PREFIX = "segbench::"  # the benchmark's own profiler ranges


@dataclass
class Trace:
    kernels: list = field(default_factory=list)  # (start us, end us, name, corr, linked)
    device: list = field(default_factory=list)  # busy (start us, end us)
    host: list = field(default_factory=list)  # (start us, end us, name, corr)
    runtime: dict = field(default_factory=dict)  # correlation -> start us
    host_start: dict = field(default_factory=dict)  # correlation -> start us
    annotations: list = field(default_factory=list)  # (start, end, name) host

    @property
    def span(self):
        times = [t for a in (self.device, self.host) for s, e, *_ in a
                 for t in (s, e)]
        return (min(times), max(times)) if times else (0.0, 0.0)

    def window_s(self):
        t0, t1 = self.span
        return (t1 - t0) / 1e6

    def busy_intervals(self):
        out = []
        for s, e in sorted(self.device):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_launch_time(self, k):
        """Host time (us) at which kernel ``k`` was launched: its runtime
        call's, else the start of the operation it is linked to."""
        t = self.runtime.get(k[3])
        return self.host_start.get(k[4]) if t is None else t


def read(prof):
    """The session's events, classified by activity type where this
    torch reports it, else by name: the benchmark's own ranges are named
    ``segbench::...``, copies and sets ``Memcpy ...`` / ``Memset ...``,
    and CUDA API calls ``cuda...`` / ``cu...``."""
    from torch.autograd import DeviceType

    tr = Trace()
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        name = e.name()
        if (start <= 0 or name in UTILITY
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        s, d = start / 1e3, e.duration_ns() / 1e3
        kind = getattr(e, "activity_type", lambda: None)()
        ours = name.startswith(LABEL_PREFIX)
        if e.device_type() == DeviceType.CUDA:
            if ours or kind == "gpu_user_annotation":
                continue  # a range's shadow on the device, not work
            tr.device.append((s, s + d))
            if not (kind in ("gpu_memcpy", "gpu_memset")
                    or name.startswith(("Memcpy", "Memset"))):
                tr.kernels.append((s, s + d, name, e.correlation_id(),
                                   e.linked_correlation_id()))
        elif ours or kind == "user_annotation":
            tr.annotations.append((s, s + d, name))
        else:
            if kind in ("cuda_runtime", "cuda_driver") or name.startswith(
                    "cu"):
                tr.runtime[e.correlation_id()] = s
            tr.host.append((s, s + d, name, e.correlation_id()))
            tr.host_start[e.correlation_id()] = s
    return tr


def kernel_time_in(tr, label):
    """Seconds of device time of the kernels launched inside the host
    ranges named ``label``; None when no kernel was."""
    ranges = sorted((s, e) for s, e, n in tr.annotations if n == label)
    if not ranges:
        return None
    starts = [s for s, _ in ranges]
    total, found = 0.0, 0
    for k in tr.kernels:
        t = tr.kernel_launch_time(k)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            total += k[1] - k[0]
            found += 1
    return total / 1e6 if found else None


def breakdown(tr, top=10):
    """{"device_ops": the kernels that took the most device time, summed
    by name; "idle_gaps": the idle time between device activities, summed
    by the innermost host operation running at each gap's middle}, each
    [[name, seconds], ...], longest first."""
    by_name = {}
    for s, e, name, *_ in tr.kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = tr.busy_intervals()
    t0, t1 = tr.span
    edges = [t0] + [t for iv in busy for t in iv] + [t1]
    host = sorted(tr.host + [(s, e, n, None) for s, e, n in tr.annotations],
                  key=lambda h: h[0])
    gaps, stack, i = {}, [], 0
    for a, b in zip(edges[0::2], edges[1::2]):  # midpoints ascend
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(no host operation)"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[n[:160], v] for n, v in idle]}
