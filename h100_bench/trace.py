"""The traced epoch's device activities, read from ``torch.profiler``:
every kernel, copy and memset with its interval, the time the device was
busy (their union), the operations that took most time, and the longest
idle gaps named by what the host was doing at the gap's middle: the
innermost ``bench.*`` span and the outermost host operation inside it."""
from __future__ import annotations

import dataclasses

import torch

#: A device operation's name as the breakdown gives it: its first
#: characters (a kernel's full name spells out its template arguments).
NAME_CHARS = 160


@dataclasses.dataclass
class Activity:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


def _events(prof):
    return prof.profiler.kineto_results.events()


def device_activities(prof) -> list[Activity]:
    """Kernels, copies and memsets on the device, by start."""
    cuda = torch.autograd.DeviceType.CUDA
    out = [Activity(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
           for e in _events(prof)
           if e.device_type() == cuda and not e.is_user_annotation()
           and not e.name().startswith("ProfilerStep")]
    return sorted(out, key=lambda a: a.start_us)


def host_ranges(prof) -> list[Activity]:
    """Host-side ranges: the benchmark's spans and the host operations."""
    cpu = torch.autograd.DeviceType.CPU
    return [Activity(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in _events(prof) if e.device_type() == cpu]


def busy_intervals(acts: list[Activity]) -> list[tuple[float, float]]:
    """The union of the activities' intervals."""
    merged: list[list[float]] = []
    for a in acts:
        if merged and a.start_us <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], a.end_us)
        else:
            merged.append([a.start_us, a.end_us])
    return [(s, e) for s, e in merged]


def busy_s(acts: list[Activity]) -> float:
    return sum(e - s for s, e in busy_intervals(acts)) / 1e6


def top_ops(acts: list[Activity], n: int = 10) -> list:
    """[[name, seconds]] of the ``n`` device operations with most time."""
    tot: dict[str, float] = {}
    for a in acts:
        tot[a.name] = tot.get(a.name, 0.0) + a.us / 1e6
    return [[k[:NAME_CHARS], v]
            for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(acts: list[Activity], hosts: list[Activity], t0_us: float,
              t1_us: float, n: int = 10) -> list:
    """[[what the host was doing, seconds]] of the ``n`` longest gaps in
    ``[t0_us, t1_us]`` with nothing on the device."""
    gaps, cursor = [], t0_us
    for s, e in busy_intervals(acts):
        if s > cursor:
            gaps.append((cursor, min(s, t1_us)))
        cursor = max(cursor, e)
    if cursor < t1_us:
        gaps.append((cursor, t1_us))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        mid = (s + e) / 2
        open_ = [h for h in hosts if h.start_us <= mid <= h.end_us]
        spans = [h for h in open_ if h.name.startswith("bench.")]
        span = min(spans, key=lambda h: h.us) if spans else None
        ops = [h for h in open_ if not h.name.startswith("bench.")
               and (span is None or h.start_us >= span.start_us)]
        op = max(ops, key=lambda h: h.us).name if ops else None
        label = " > ".join(x for x in (span and span.name, op) if x)
        out.append([label or "host (no recorded operation)", (e - s) / 1e6])
    return out
