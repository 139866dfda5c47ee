"""Cross-event request batching for the fused engine.

The validators ask for scores per (scorer, haplotype, read group), and
the window refiner for one self-comparison per refinement step: each on
its own would be one small launch whose host work outlasts its kernel.
This backend coalesces the requests into combined launches:

* the 2-4 haplotype requests of one event always merge, and
* with the CLI pipeline (``--pipeline N``) requests of *different*
  events merge too, grouped by (H, R, mode, window).

Work rows are (read x haplotype) pairs and ``fused_batch`` takes a hap
per row, so grouping never changes a per-row result: the scores equal
the unbatched backend's exactly (tests/test_torch_batching.py).

A request waits, unlaunched, until some caller asks for a result that is
not launched yet.  That caller flushes every pending request: groups
them, splits each group at ``_row_cap`` rows and launches it (uploads
from pinned host buffers, then a non-blocking copy of the packed rows
back to pinned host memory and a CUDA event behind it).  Each request
then waits on its own group's event.  The CLI pipeline advances every
in-flight event to its next request before it waits on the oldest one,
so a flush holds one round of requests of all of them.  The launches
run on the caller's thread: a dispatcher thread would wait for the
interpreter lock at every torch call while the main thread runs Python
(measured in PERF.md).  A launch that raises fails the requests of its group:
each of them raises the exception from ``result()``.
"""
from __future__ import annotations

import threading
from collections import defaultdict

import numpy as np
import torch

from ..utils import trace
from .fused import FusedBackend, fused_batch
from .window_device import self_stats_rows

# cells (rows x H x R) per launch: at most CELL_BUDGET, and never fewer
# than 16 rows (the JAX package's value)
CELL_BUDGET = 1 << 29


def _row_cap(H: int, R: int) -> int:
    """Rows of one launch of (H, R) rows."""
    return max(16, CELL_BUDGET // (H * R))


class _Req:
    """One request, and its future: ``result()`` -> (None, None, its
    packed rows as a host int64 array)."""

    __slots__ = ("hap", "fw", "rlens", "ms", "B", "key", "backend",
                 "group", "row", "error")

    def result(self, timeout=None):
        if self.group is None and self.error is None:
            self.backend._flush_pending(timeout)
        if self.error is not None:
            raise self.error
        host, done = self.group
        if done is not None:
            with trace.span("batch.sync"):
                done.synchronize()
        return None, None, host.numpy()[self.row:self.row + self.B]


class _RowFut:
    """View of a request's future as its one row."""

    __slots__ = ("_r",)

    def __init__(self, r: _Req):
        self._r = r

    def result(self, timeout=None):
        return self._r.result(timeout)[2][0]


class BatchingBackend(FusedBackend):
    """Fused backend that coalesces requests across events: the
    production scoring backend (``--backend torch``)."""

    name = "torch"

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._pending = []
        self._lock = threading.Lock()          # guards _pending
        self._flush_lock = threading.Lock()    # one flush at a time

    # -- request side --------------------------------------------------

    def _submit(self, hap_codes, enc, window, H, R, scorer):
        r = _Req()
        r.hap, (r.fw, r.rlens, r.ms) = hap_codes, enc
        r.B = r.fw.shape[0]
        return self._put(r, (H, R, scorer, window // 10 - 1))

    def submit_selfstats(self, hap, length, window, H):
        """Window-refiner request: the (H,) hap row against itself at
        k = window.  Returns a future of its (3,) [total, diag, below]
        row; refiner steps of pipelined events in one (H, window) group
        share a launch."""
        r = _Req()
        r.hap = hap.reshape(1, -1)
        r.fw = r.ms = None
        r.rlens = np.asarray([length], np.int32)
        r.B = 1
        return _RowFut(self._put(r, (H, H, "selfstats", window // 10 - 1)))

    def _put(self, r: _Req, key) -> _Req:
        r.key, r.backend, r.group, r.error = key, self, None, None
        with self._lock:
            self._pending.append(r)
        return r

    # -- launch side ---------------------------------------------------

    def _flush_pending(self, timeout=None) -> None:
        """Launches every pending request (another thread's flush may
        have launched the caller's request meanwhile)."""
        if not self._flush_lock.acquire(
                timeout=-1 if timeout is None else timeout):
            raise TimeoutError("a flush of the batching backend is still "
                               "running")
        try:
            with self._lock:
                batch, self._pending = self._pending, []
            with trace.span("batch.flush"):
                self._flush(batch)
        finally:
            self._flush_lock.release()

    def _flush(self, batch):
        """Groups the requests by key and launches each group, split at
        _row_cap rows; a launch that raises fails its own requests."""
        groups = defaultdict(list)
        for r in batch:
            groups[r.key].append(r)
        for key, reqs in groups.items():
            cap = _row_cap(key[0], key[1])
            subs, rows = [[]], 0
            for r in reqs:
                if subs[-1] and rows + r.B > cap:
                    subs.append([])
                    rows = 0
                subs[-1].append(r)
                rows += r.B
            for sub in subs:
                try:
                    self._launch(key, sub)
                except Exception as exc:
                    for r in sub:
                        r.error = exc

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor, from a pinned buffer on CUDA (the
        caching host allocator reuses it only after the copy is done)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _launch(self, key, sub):
        """One combined launch; gives each request of `sub` its group:
        (packed rows on the host or on their way there, the CUDA event
        that ends the copy or None) and its first row there."""
        H, R, scorer, kidx = key
        rlens = self._upload(np.concatenate([r.rlens for r in sub]))
        if scorer == "selfstats":
            out = self_stats_rows(
                self._upload(np.concatenate([r.hap for r in sub])), rlens,
                10 * (kidx + 1))
        else:
            # one row per distinct hap; reads index into them
            slot, uniq, idx = {}, [], []
            for r in sub:
                s = slot.setdefault(r.hap.tobytes(), len(slot))
                if s == len(uniq):
                    uniq.append(r.hap)
                idx.append(np.full(r.B, s, np.int64))
            _, _, out = fused_batch(
                self._upload(np.stack(uniq)),
                self._upload(np.concatenate([r.fw for r in sub])), rlens,
                self._upload(np.concatenate([r.ms for r in sub])), kidx,
                H=H, R=R, scorer=scorer,
                hap_index=self._upload(np.concatenate(idx)))
        done = None
        if self.device.type == "cuda":
            out = out.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        row = 0
        for r in sub:
            r.group, r.row = (out, done), row
            row += r.B
