"""The reduction of one traced window (`torch.profiler`, CPU and CUDA
activities) to what the per-layer metrics read: device time by kernel,
the union of device activity (busy time), idle gaps named by what the
host did meanwhile, and the host time between a launch's segment read and
the start of the next megakernel."""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

# the megakernels of the render path: K1 (`mega_kernel`, sphere-only
# scenes) and K2+K3 (`mega_kernel_surfaces`, rects, lights and media);
# matched as whole identifiers in the kernel's demangled name
K1 = re.compile(r"(?<![\w])mega_kernel(?![\w])")
K23 = re.compile(r"(?<![\w])mega_kernel_surfaces(?![\w])")
MEGA = re.compile(r"(?<![\w])mega_kernel\w*")
# the waits that end a launch: the render loop's segment read (a read of a
# CUDA tensor to the host, an operator that holds a runtime
# synchronisation; a read of a CPU tensor holds none) and the
# synchronisation that ends an image
READ_OP = "aten::_local_scalar_dense"
SYNC_RUNTIME = re.compile(r"Synchronize")
IMAGE_END = "cudaDeviceSynchronize"
CUDA_API = re.compile(r"cuda[A-Z]|cu[A-Z]")


def short_name(name: str, width: int = 120) -> str:
    """A kernel's demangled name cut to `width` characters."""
    return name if len(name) <= width else name[:width - 3] + "..."


@dataclass
class Window:
    """The events of a traced window, times in ns on the profiler's
    clock, each list sorted by start: `device` (name, start, end) of every
    kernel, copy and memset on the card; `host` of every CPU operator and
    CUDA runtime call, `runtime` of the runtime calls alone."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    runtime: list = field(default_factory=list)

    def kernel_seconds(self, pattern: re.Pattern) -> float:
        return sum(e - s for n, s, e in self.device
                   if pattern.search(n)) * 1e-9

    def kernel_count(self, pattern: re.Pattern) -> int:
        return sum(1 for n, _, _ in self.device if pattern.search(n))

    def other_seconds(self, pattern: re.Pattern) -> float:
        """Device seconds of every activity that `pattern` does not
        match."""
        return sum(e - s for n, s, e in self.device
                   if not pattern.search(n)) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the device activity intervals, merged."""
        out = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def top_device_ops(self, n: int = 10) -> list:
        """The `n` device operations that took most time: [name, s]."""
        tot: dict = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[short_name(name), ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The `n` longest gaps between device activity, each named by
        the host event (CPU operator or runtime call) that overlaps it
        most: [name, s]."""
        busy = self.busy_intervals()
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(busy, busy[1:]) if b[0] > a[1]),
                      reverse=True)[:n]
        starts = [s for _, s, _ in self.host]
        longest = max((e - s for _, s, e in self.host), default=0)
        out = []
        for length, g0, g1 in gaps:
            best, best_ov = "host idle", 0
            lo = bisect.bisect_left(starts, g0 - longest)
            hi = bisect.bisect_right(starts, g1)
            for name, s, e in self.host[lo:hi]:
                ov = min(e, g1) - max(s, g0)
                if ov > best_ov:
                    best, best_ov = name, ov
            out.append([best, length * 1e-9])
        return out

    def host_gaps_before(self, pattern: re.Pattern) -> list:
        """For each device event matching `pattern` after the first: the
        seconds from the end of the wait that ended the previous launch
        (its segment read, or the previous image's synchronisation) to its
        start on the card. The stream is idle at the wait's end, so this
        is the host's time to the launch, and the few microseconds of the
        launch. (The kernels' library links the CUDA runtime statically,
        so the trace holds no runtime call for their launches.)"""
        syncs = [s for n, s, _ in self.runtime if SYNC_RUNTIME.search(n)]
        waits = sorted(
            [e for n, s, e in self.host
             if n == READ_OP and bisect.bisect_right(syncs, e)
             > bisect.bisect_left(syncs, s)]
            + [e for n, _, e in self.runtime if n == IMAGE_END])
        out = []
        for name, s, _ in self.device:
            if not pattern.search(name):
                continue
            i = bisect.bisect_right(waits, s)
            if i:
                out.append((s - waits[i - 1]) * 1e-9)
        return out[1:] if len(out) > 1 else out


def from_profiler(prof) -> Window:
    """The window of a finished `torch.profiler.profile`. Events on a CUDA
    device are the card's; of the others, the CUDA API calls (by name:
    `cuda...`, `cu<Name>`) are runtime calls and the rest CPU
    operators."""
    w = Window()
    on_card: dict = {}   # device type -> a CUDA device (str() is slow)
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        name = ev.name()
        item = (name, s, s + ev.duration_ns())
        dt = ev.device_type()
        if dt not in on_card:
            on_card[dt] = "CUDA" in str(dt)
        if on_card[dt]:
            w.device.append(item)
        elif CUDA_API.match(name):
            w.runtime.append(item)
        else:
            w.host.append(item)
    w.device.sort(key=lambda t: t[1])
    w.runtime.sort(key=lambda t: t[1])
    w.host = sorted(w.host + w.runtime, key=lambda t: t[1])
    return w
