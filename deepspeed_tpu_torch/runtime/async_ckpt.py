"""Async preemption-safe checkpointing: snapshot-to-host, background
writer, and a two-phase atomic commit (a copy of
``deepspeed_tpu/runtime/async_ckpt.py``, which imports no JAX; the port
keeps its own copy so that it imports nothing of the JAX package).

1. **Snapshot** (in the step window, exposed): the engine copies each
   flat buffer of its state whole to pinned host memory, with the
   scalars stacked into one tensor, and waits on the card once; it
   builds a :class:`CheckpointSnapshot`: host arrays plus lazy blob
   builders. No serialization happens here.
2. **Write** (background, overlapped): :class:`AsyncCheckpointer`'s
   writer thread runs the blob builders (the moments' layout
   conversion and the msgpack encoding) and the commit off the
   critical path, guarded by a dedicated hang watchdog
   (monitor/health.py).
3. **Commit** (:func:`commit_snapshot`, shared with the sync path): a
   two-phase atomic protocol. Blobs land in ``<tag>.tmp.<pid>.<tid>``;
   ``engine_meta.json`` is written LAST and seals the dir (its presence
   is the completeness marker the load path checks); the sealed dir
   renames to ``<tag>`` in one ``os.rename``; ``latest`` flips via a
   tmp file + ``os.replace``. A kill at ANY byte offset leaves either
   the previous or the new checkpoint fully loadable — never a torn
   one.

**Per-rank writers** (dp > 1): every rank commits its own blobs (its
optimizer file) into one staging dir that all ranks name alike,
``<tag>.tmp.<token>`` (the token starts with the sealing rank's pid),
each file written under a private name and renamed into place whole.
The sealing rank (rank 0) writes its blobs, waits until every other
rank's file is there, then seals, publishes and flips ``latest`` as
above: a tag is committed only after every rank's file is on disk, and
a rank killed mid-write leaves an unsealed staging dir (swept once its
pid is dead) and the previous tag loadable.

Preemption-safety end to end: :class:`PreemptSaver` hooks SIGTERM
(chaining with whatever handler preceded it, as monitor/flight.py's
``dispatch_prev_handler`` does) and asks the engine for a final
snapshot+commit when one isn't already in flight, then re-raises so the
exit code stays honest.

Crash-point injection (``DS_CKPT_CRASH_POINT``) lets the crash-matrix
tests SIGKILL the process at exact protocol offsets — a real kill, not
a mocked one, so the atomicity claim is subprocess-tested with honest
exit codes. ``DS_CKPT_TEST_WRITE_DELAY_S`` slows the writer so external
kills can land mid-write deterministically.

The telemetry hooks take ``telemetry=None``: the port has no telemetry
yet (its config block raises), so the writer's wall is kept in
``AsyncCheckpointer.write_wall_s`` only.
"""
from __future__ import annotations

import atexit
import glob
import json
import os
import queue
import shutil
import signal
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ..parallel.comm import any_ranks as comm_any_ranks
from ..utils.logging import log_dist, logger

LATEST_FILE = "latest"
META_FILE = "engine_meta.json"
TMP_SUFFIX = ".tmp"

# Crash-matrix injection points, in protocol order. Each names an exact
# byte offset in the commit; setting DS_CKPT_CRASH_POINT to one makes
# the process SIGKILL ITSELF there (no cleanup, no atexit — the honest
# simulation of a preemption landing at that instant).
CRASH_POINTS = ("after_snapshot", "mid_blob_write", "pre_seal",
                "pre_commit", "pre_latest", "mid_latest")


def crash_point(name: str) -> None:
    if os.environ.get("DS_CKPT_CRASH_POINT") == name:
        os.kill(os.getpid(), signal.SIGKILL)


# A blob is (filename, bytes | zero-arg builder returning bytes). The
# builder form defers serialization to the writer thread — the snapshot
# phase only captures host arrays.
Blob = Tuple[str, Union[bytes, Callable[[], bytes]]]


@dataclass
class CheckpointSnapshot:
    """Host-side capture of one checkpoint: everything the writer needs,
    nothing that can touch a device."""
    save_dir: str
    tag: str
    save_latest: bool
    meta: Dict[str, Any]
    blobs: List[Blob]
    is_writer: bool = True
    fsync: bool = False
    created_ts: float = field(default_factory=time.time)
    # Per-rank writers: the staging token every rank's commit shares
    # (None: this process stages alone), the other ranks' files the
    # sealing rank waits for, and how long it waits.
    shared: Optional[str] = None
    await_files: Tuple[str, ...] = ()
    await_timeout_s: float = 300.0

    @property
    def path(self) -> str:
        return os.path.join(self.save_dir, str(self.tag))


def is_complete(path: str) -> bool:
    """The completeness marker: ``engine_meta.json`` is written last
    inside the tmp dir, so a committed tag dir always carries it and a
    torn one never does."""
    return os.path.isfile(os.path.join(path, META_FILE))


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_blob(path: str, data: bytes, fsync: bool) -> None:
    """Write one blob with a mid-write crash point: the first half lands
    and is flushed before the (armed) kill, so 'kill at any byte offset'
    is tested against a genuinely half-written file."""
    with open(path, "wb") as f:
        half = len(data) // 2
        f.write(data[:half])
        f.flush()
        crash_point("mid_blob_write")
        f.write(data[half:])
        if fsync:
            _fsync_file(f)


def _tmp_pid(path: str) -> Optional[int]:
    """The pid embedded in a ``<tag>.tmp.<pid>.<tid>`` staging-dir name
    (None for legacy/unparsable names)."""
    parts = path.rsplit(TMP_SUFFIX + ".", 1)
    if len(parts) != 2:
        return None
    try:
        return int(parts[1].split(".", 1)[0])
    except ValueError:
        return None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass
    return True


def write_latest(save_dir: str, tag: str, fsync: bool = False) -> None:
    """Flip the ``latest`` pointer atomically: tmp file + ``os.replace``.
    A reader never observes a partial pointer."""
    tmp = os.path.join(
        save_dir,
        f"{LATEST_FILE}.tmp.{os.getpid()}.{threading.get_ident()}")
    # Sweep pointer tmp files orphaned by a kill between write and
    # os.replace (same dead-pid rule as the staging-dir sweep) so a
    # long-lived save_dir doesn't accumulate junk across preemptions.
    for stale in glob.glob(os.path.join(save_dir, LATEST_FILE + ".tmp*")):
        pid = _tmp_pid(stale)
        if stale != tmp and (pid is None or not _pid_alive(pid)):
            try:
                os.remove(stale)
            except OSError:
                pass
    with open(tmp, "w") as f:
        f.write(str(tag))
        if fsync:
            _fsync_file(f)
    crash_point("mid_latest")
    os.replace(tmp, os.path.join(save_dir, LATEST_FILE))
    if fsync:
        _fsync_dir(save_dir)


def _await_files(tmp_dir: str, names: Tuple[str, ...],
                 timeout_s: float) -> None:
    """Wait until every file of ``names`` is in ``tmp_dir`` (each lands by
    a rename, so present means whole); OSError after ``timeout_s``."""
    t0 = time.monotonic()
    missing = list(names)
    while missing:
        missing = [n for n in missing
                   if not os.path.isfile(os.path.join(tmp_dir, n))]
        if not missing:
            return
        if time.monotonic() - t0 > timeout_s:
            raise OSError(f"checkpoint {tmp_dir}: the other ranks' files "
                          f"{missing} did not land within {timeout_s:.0f} s;"
                          " the tag is not committed")
        time.sleep(0.01)


def commit_snapshot(snap: CheckpointSnapshot) -> str:
    """Serialize and commit a snapshot with the two-phase protocol.
    Host-only — safe to run on the writer thread or inline (the sync
    path and the async path share this byte-for-byte, which is what the
    async-vs-sync artifact bit-identity test checks). With per-rank
    writers (``snap.shared``) a rank that does not seal writes its blobs
    into the shared staging dir and returns."""
    final = snap.path
    shared = snap.shared is not None
    if not snap.is_writer and not shared:
        # Non-writer SPMD processes participated in the snapshot fetch
        # (the device_get is collective-shaped) but write nothing.
        return final
    delay = float(os.environ.get("DS_CKPT_TEST_WRITE_DELAY_S", "0") or 0)
    # The tmp dir is pid+thread-unique: a preemption-save racing a
    # wedged background writer on the SAME tag must not share (and
    # rmtree-stomp) the writer's staging dir — each commit stages in
    # its own dir, each rename publishes an internally-complete dir,
    # and the last rename wins whole. Per-rank writers share one dir,
    # named by a token that starts with the sealing rank's pid.
    tmp_dir = f"{final}{TMP_SUFFIX}.{snap.shared}" if shared else \
        f"{final}{TMP_SUFFIX}.{os.getpid()}.{threading.get_ident()}"
    if snap.is_writer:
        for stale in glob.glob(final + TMP_SUFFIX + "*"):
            # Stale tmp dirs (a killed writer's — never renamed, garbage
            # by construction) are cleared; a LIVE process's staging dir
            # is left alone, and so is the shared dir the other ranks
            # may be writing into. Legacy/unparsable names count as
            # stale.
            pid = _tmp_pid(stale)
            if stale == tmp_dir:
                if not shared:
                    shutil.rmtree(stale, ignore_errors=True)
            elif pid is None or not _pid_alive(pid):
                shutil.rmtree(stale, ignore_errors=True)
    os.makedirs(tmp_dir, exist_ok=shared)
    for fname, builder in snap.blobs:
        data = builder() if callable(builder) else builder
        if shared:
            # (published whole by the rename: the sealing rank waits
            # for the name)
            part = os.path.join(tmp_dir, f".{fname}.part.{os.getpid()}")
            _write_blob(part, data, snap.fsync)
            os.replace(part, os.path.join(tmp_dir, fname))
        else:
            _write_blob(os.path.join(tmp_dir, fname), data, snap.fsync)
        if delay > 0:
            time.sleep(delay)
    if not snap.is_writer:
        return final
    _await_files(tmp_dir, snap.await_files, snap.await_timeout_s)
    crash_point("pre_seal")
    # The seal: meta is written LAST, so its presence certifies every
    # blob above it landed whole (within this tmp dir).
    meta_tmp = os.path.join(tmp_dir, META_FILE)
    with open(meta_tmp, "w") as f:
        json.dump(snap.meta, f)
        if snap.fsync:
            _fsync_file(f)
    if snap.fsync:
        _fsync_dir(tmp_dir)
    crash_point("pre_commit")
    # Publish: swing the sealed staging dir in. When the tag already
    # exists (same-tag overwrite, or a racing commit of the same tag
    # just published), park the old dir under a unique trash name and
    # retry — each published dir is internally complete, so whichever
    # rename lands last wins whole. The only non-atomic window is
    # between the two renames of a same-tag overwrite; the auto-save /
    # preemption cycle always uses fresh global_stepN tags and never
    # enters it.
    trash = f"{final}.old.{os.getpid()}.{threading.get_ident()}"
    for _ in range(8):
        if os.path.exists(final):
            if os.path.isdir(trash):
                shutil.rmtree(trash)
            try:
                os.rename(final, trash)
            except FileNotFoundError:
                pass          # a racing commit moved it first
        try:
            os.rename(tmp_dir, final)
            break
        except OSError:
            continue          # final reappeared under the race; re-park
    else:
        raise OSError(f"could not publish checkpoint {final}")
    shutil.rmtree(trash, ignore_errors=True)
    if snap.fsync:
        _fsync_dir(snap.save_dir)
    crash_point("pre_latest")
    if snap.save_latest:
        write_latest(snap.save_dir, snap.tag, fsync=snap.fsync)
    return final


class AsyncCheckpointer:
    """Single background writer serializing/committing snapshots off the
    critical path.

    - Submission order IS commit order (one thread, one queue), so
      ``latest`` only ever moves forward.
    - ``wait_below(n)`` bounds host memory: the engine blocks (exposed,
      counted in the goodput ``checkpoint`` bucket via the enclosing
      snapshot span) until fewer than ``n`` snapshots are pending.
    - A dedicated hang watchdog (factor=1, min timeout =
      ``writer_timeout_s``) guards each write: a wedged writer fires an
      all-thread stack dump + telemetry event instead of silently
      stalling the next snapshot forever.
    - Write wall is reported to the goodput ledger's BACKGROUND
      ``checkpoint_write`` bucket — visible, but not charged against
      the window (it overlaps the step stream).
    """

    def __init__(self, telemetry=None, writer_timeout_s: float = 300.0,
                 dump_dir: str = "."):
        self._telemetry = telemetry
        self.writer_timeout_s = float(writer_timeout_s)
        self.dump_dir = dump_dir
        self._q: "queue.Queue[Optional[CheckpointSnapshot]]" = queue.Queue()
        # RLock, not Lock: preempt_save runs in a SIGNAL HANDLER on the
        # main thread, which may have been interrupted INSIDE submit()/
        # wait_below() while holding this lock — a non-reentrant lock
        # would deadlock the handler (and lose the final preemption
        # save). Condition handles the recursive hold via
        # _release_save/_acquire_restore.
        self._lock = threading.RLock()
        self._idle = threading.Condition(self._lock)
        self._pending = 0
        self._thread: Optional[threading.Thread] = None
        self._watchdog = None
        self.writes = 0
        self.write_wall_s = 0.0
        self.last_error: Optional[BaseException] = None
        self._closed = False
        atexit.register(self.close)

    # ------------------------------------------------------------------ #
    @property
    def in_flight(self) -> bool:
        with self._lock:
            return self._pending > 0

    def submit(self, snap: CheckpointSnapshot) -> None:
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        with self._lock:
            self._pending += 1
        self._q.put(snap)
        self._ensure_thread()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted snapshot has committed (or failed
        — check ``last_error``). True when drained."""
        return self.wait_below(1, timeout=timeout)

    def wait_below(self, n: int, timeout: Optional[float] = None) -> bool:
        with self._idle:
            return self._idle.wait_for(lambda: self._pending < n,
                                       timeout=timeout)

    def close(self, flush: bool = True) -> None:
        """Flush pending writes and stop the thread. Registered atexit
        (AFTER the engine's Telemetry, so LIFO ordering settles the last
        write's background seconds before telemetry's final drain)."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        if flush and self._thread is not None:
            self.wait(timeout=self.writer_timeout_s)
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    # ------------------------------------------------------------------ #
    def _ensure_thread(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ds-ckpt-writer")
        self._thread.start()

    def _ensure_watchdog(self):
        if self._watchdog is None and self.writer_timeout_s > 0:
            from ..monitor.health import HangWatchdog
            self._watchdog = HangWatchdog(
                factor=1.0, min_timeout_s=self.writer_timeout_s,
                dump_dir=self.dump_dir, on_fire=self._on_watchdog_fire)
            self._watchdog.start()
        return self._watchdog

    def _on_watchdog_fire(self, event: Dict[str, Any]) -> None:
        logger.warning(
            "checkpoint writer exceeded its timeout "
            f"({self.writer_timeout_s:.0f}s) — stacks at "
            f"{event.get('stack_dump_path')}")
        tl = self._telemetry
        if tl is not None:
            try:
                tl.event("watchdog", {**event, "source": "checkpoint_writer"})
            except Exception:
                pass

    def _run(self) -> None:
        while True:
            snap = self._q.get()
            if snap is None:
                return
            wd = self._ensure_watchdog()
            if wd is not None:
                wd.pending(f"checkpoint_write:{snap.tag}")
                wd.beat()
            t0 = time.perf_counter()
            err: Optional[BaseException] = None
            try:
                commit_snapshot(snap)
                self.writes += 1
            except BaseException as e:   # the writer must never die silently
                err = e
                self.last_error = e
                logger.error(
                    f"background checkpoint write of tag '{snap.tag}' "
                    f"failed: {type(e).__name__}: {e}")
            finally:
                if wd is not None:
                    wd.disarm()
                dt = time.perf_counter() - t0
                self.write_wall_s += dt
                tl = self._telemetry
                if tl is not None:
                    try:
                        tl.note_checkpoint_write_bg(dt)
                        if err is None:
                            tl.event("checkpoint_commit", {
                                "tag": str(snap.tag),
                                "write_s": round(dt, 6),
                                "queued_s": round(
                                    t0 - snap.created_ts, 6)})
                        else:
                            tl.event("checkpoint_write_error", {
                                "tag": str(snap.tag),
                                "error":
                                    f"{type(err).__name__}: {err}"[:300]})
                    except Exception:
                        pass
                with self._idle:
                    self._pending -= 1
                    self._idle.notify_all()


class PreemptSaver:
    """SIGTERM → final snapshot+commit, then chain.

    Across ranks (``engine.dp > 1``) the save is collective, and a
    signal reaches the ranks at different moments (or one rank only), so
    the handler only records it. At every collective boundary (the end
    of a step or of ``eval_batch``: ``fire_held``) the ranks agree on
    the flag, and on whether any rank's step raised, by one host-side
    all-reduce (max; ``parallel/comm.any_ranks``: no device read); when
    any rank holds one, every rank saves the same tag through the
    per-rank writers (no rank saves after a step that raised on any)
    and exits as the one-rank path does (a rank that got no signal
    exits by SIGTERM too). A signal still held when the process reaches
    ``engine.close()`` or exits (``release``) is not swallowed: the
    rank exits by it without a save, which one rank alone cannot make.

    Installed AFTER the engine's Telemetry builds its flight recorder,
    so on a preemption this handler runs FIRST (last installed wins the
    dispatch), saves the final checkpoint, and then chains to the flight
    recorder's handler — which persists FLIGHT.json and re-raises under
    the default disposition, keeping the exit code honest
    (``-SIGTERM``). The stale-chain passthrough mirrors
    monitor/flight.py: a newer handler may still point at us after
    uninstall, and a dead engine must not block the signal."""

    def __init__(self, engine, save_dir: str):
        self._ref = weakref.ref(engine)
        self.save_dir = save_dir
        self.fired = False
        self._installed = False
        self._prev: Dict[int, Any] = {}
        self._chain_prev: Dict[int, Any] = {}
        # (signum, frame) of a SIGTERM that arrived inside a step
        self._held: Optional[Tuple[int, Any]] = None

    def install(self) -> None:
        if self._installed:
            return
        self._installed = True
        atexit.register(self.release)
        signum = getattr(signal, "SIGTERM", None)
        if signum is None:
            return
        try:
            self._prev[int(signum)] = signal.signal(signum, self._on_signal)
        except (ValueError, OSError):
            # Not the main thread / restricted env: preemption saving is
            # best-effort; periodic auto-saves still bound the loss.
            pass

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        atexit.unregister(self.release)
        self._chain_prev.update(self._prev)
        for signum, prev in self._prev.items():
            try:
                if signal.getsignal(signum) == self._on_signal:
                    signal.signal(signum, signal.SIG_DFL
                                  if prev is None else prev)
            except (ValueError, OSError, TypeError):
                pass
        self._prev = {}

    def _on_signal(self, signum, frame) -> None:
        from ..monitor.flight import dispatch_prev_handler
        if not self._installed:
            dispatch_prev_handler(
                self._chain_prev.get(int(signum), signal.SIG_DFL),
                signum, frame, self._on_signal)
            return
        eng = self._ref()
        if eng is not None and (eng._in_step or eng.dp > 1):
            # Inside a step the state is part old, part new: handled at
            # the step's end (fire_held), where global_steps names it.
            # Across ranks, always there: the save is collective.
            self._held = (signum, frame)
            return
        self._fire(signum, frame, save=True)

    def fire_held(self, save: bool = True) -> None:
        """Handle a SIGTERM held during a step (the engine calls this at
        the step's end; ``save=False`` after a step that raised, whose
        state is not one step's). Across ranks every rank calls this at
        every collective boundary: the ranks agree whether any holds a
        signal and whether any step raised."""
        eng = self._ref()
        if eng is not None and eng.dp > 1 and self._installed:
            held_any, raised_any = comm_any_ranks(self._held is not None,
                                                  not save)
            if not held_any:
                return
            held = self._held or (int(signal.SIGTERM), None)
            self._held = None
            self._fire(*held, save=not raised_any)
            return
        if self._held is not None:
            signum, frame = self._held
            self._held = None
            self._fire(signum, frame, save=save)

    def release(self) -> None:
        """A held SIGTERM with no boundary left to take it up (the
        engine's ``close``, the interpreter's exit): exit by it, without
        a save (local: no collective)."""
        if self._held is not None and self._installed:
            signum, frame = self._held
            self._held = None
            self._fire(signum, frame, save=False)

    def _fire(self, signum, frame, save: bool) -> None:
        from ..monitor.flight import dispatch_prev_handler
        self.fired = True
        prev = self._prev.get(int(signum), signal.SIG_DFL)
        eng = self._ref()
        if eng is not None and save:
            try:
                eng.preempt_save(reason="SIGTERM")
            except Exception as e:
                # A failed final save must not mask the preemption.
                try:
                    logger.error(f"preemption save failed: "
                                 f"{type(e).__name__}: {e}")
                except Exception:
                    pass
        self.uninstall()
        dispatch_prev_handler(prev, signum, frame, self._on_signal)


__all__ = ["CheckpointSnapshot", "AsyncCheckpointer", "PreemptSaver",
           "commit_snapshot", "write_latest", "is_complete", "crash_point",
           "CRASH_POINTS", "LATEST_FILE", "META_FILE"]
