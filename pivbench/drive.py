"""The one driver of every traffic mix: a closed loop of one client over a
pool of pairs held in host memory as float32 arrays, the form a campaign's
decoded frames take.

A mix file sets:
  ``entry``        "scan": each call hands ``compile.scan_pipeline(name)`` a
                   stack of ``stack`` pairs; "pair": each call hands
                   ``compile.compiled_pipeline(name)`` one pair;
  ``pool``         the number of distinct pairs, cycled in order (a scan
                   cycles the pool's consecutive stacks);
  ``trace_calls``  the calls of the traced window.
Each call then fetches the flows into host memory, into page-locked
buffers allocated once for each unit at set-up (as the program's campaign
runner does), and the next call starts only after that.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from pivbench.trace import span

WARM_SECONDS = 2.0      # how long the set-up runs the loop before the window


@dataclass
class Call:
    unit: int          # which stack or pair of the pool
    pairs: list        # the pool indices it carried
    u: np.ndarray      # (pairs, H, W) host flows
    v: np.ndarray


@dataclass
class Window:
    start: float
    end: float
    pairs: int = 0
    latencies: list = field(default_factory=list)   # s, per call
    entry_s: float = 0.0                            # host time inside the entry's calls
    event_ms: float | None = None                   # the loop by CUDA events, traced
    visits: dict = field(default_factory=dict)      # pool index -> calls that carried it
    kept: dict = field(default_factory=dict)        # unit -> Call


class Driver:
    """Drives the entry of ``registry`` over the pool (im1s, im2s: (P, H, W)
    float32 numpy arrays) on ``device``."""

    def __init__(self, traffic: dict, registry: str, im1s: np.ndarray, im2s: np.ndarray,
                 device: torch.device):
        from opticalflow_ri_tpu_torch import compile as pipelines

        self.device = device
        self.entry = traffic["entry"]
        pool = int(traffic["pool"])
        if im1s.shape[0] != pool:
            raise ValueError(f"a pool of {pool} pairs was asked for, {im1s.shape[0]} made")
        if self.entry == "scan":
            k = int(traffic["stack"])
            if pool % k:
                raise ValueError(f"a pool of {pool} pairs does not cut into stacks of {k}")
            self.units = [(list(range(i, i + k)), im1s[i:i + k], im2s[i:i + k])
                          for i in range(0, pool, k)]
            self.fn = pipelines.scan_pipeline(registry)
        elif self.entry == "pair":
            self.units = [([i], im1s[i], im2s[i]) for i in range(pool)]
            self.fn = pipelines.compiled_pipeline(registry)
        else:
            raise ValueError(f"unknown entry {self.entry!r}: 'scan' or 'pair'")
        # each unit's flows land in its own host buffers, and a spare set takes
        # their place when ``run`` keeps a call for the comparison
        pin = device.type == "cuda"
        self.out, self.spare = ([self._buffers(len(pairs), im1s.shape[1:], pin)
                                 for pairs, _, _ in self.units] for _ in range(2))

    @staticmethod
    def _buffers(pairs: int, hw: tuple, pin: bool) -> tuple:
        return tuple(torch.empty((pairs, *hw), dtype=torch.float32, pin_memory=pin)
                     for _ in range(2))

    def call(self, i: int, traced: bool = False) -> tuple:
        """Call ``i`` of the loop: its unit handed to the entry, the flows
        fetched into the unit's host buffers.  Returns the ``Call`` and the
        host seconds inside the entry."""
        unit = i % len(self.units)
        pairs, a, b = self.units[unit]
        hu, hv = self.out[unit]
        t = time.perf_counter()
        with span("entry", traced):
            u, v = self.fn(a, b, device=self.device)
        entry_s = time.perf_counter() - t
        with span("fetch", traced):
            hu.view(u.shape).copy_(u)
            hv.view(v.shape).copy_(v)
        return Call(unit, pairs, hu.numpy(), hv.numpy()), entry_s

    def keep(self, c: Call) -> Call:
        """``c`` kept for the comparison: its unit's later calls write the
        spare buffers."""
        self.out[c.unit], self.spare[c.unit] = self.spare[c.unit], self.out[c.unit]
        return c

    def warm_up(self) -> float:
        """Two calls, then calls for ``WARM_SECONDS``; returns the calls a second.
        The first call captures the graph of the pool's shape (every unit
        has it); the host's allocations of the copies settle over the first
        calls of a loop, which the window must not see."""
        t = time.perf_counter()
        i = 0
        while i < 2 or time.perf_counter() - t < WARM_SECONDS:
            self.call(i)
            i += 1
        return i / (time.perf_counter() - t)

    def run(self, seconds: float, seed: int, rate: float, calls: int = 0,
            traced: bool = False) -> Window:
        """The closed loop: calls for ``seconds``, or ``calls`` calls (under
        the ``loop`` span and timed by CUDA events too where ``traced``).
        For the comparison it keeps one call of each unit, its k-th, k drawn
        from ``seed`` among the first quarter of the unit's calls that
        ``rate`` (calls a second) lets the window expect.  A unit whose k-th
        call the window did not reach is called once more after it closes."""
        rng = random.Random(seed)
        n = len(self.units)
        expect = calls / n if calls else seconds * rate / n / 4
        target = [rng.randint(1, max(1, int(expect))) for _ in range(n)]
        seen = [0] * n
        events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if traced and self.device.type == "cuda" else None)
        if events:
            events[0].record()
        w = Window(time.perf_counter(), 0.0)
        w.end = w.start
        i = 0
        with span("loop", traced):
            while (i < calls) if calls else (time.perf_counter() - w.start < seconds):
                t = time.perf_counter()
                c, entry_s = self.call(i, traced)
                w.end = time.perf_counter()
                w.latencies.append(w.end - t)
                w.entry_s += entry_s
                w.pairs += len(c.pairs)
                for j in c.pairs:
                    w.visits[j] = w.visits.get(j, 0) + 1
                seen[c.unit] += 1
                if seen[c.unit] == target[c.unit]:
                    w.kept[c.unit] = self.keep(c)
                i += 1
        if events:
            events[1].record()
            events[1].synchronize()
            w.event_ms = events[0].elapsed_time(events[1])
        for unit in range(n):
            if unit not in w.kept:
                w.kept[unit] = self.keep(self.call(unit)[0])
        return w

    def release(self) -> None:
        self.fn.release()
