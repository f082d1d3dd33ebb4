"""Depth pipeline: the output-camera equivalent.

The reference's ``OutputCamera`` free-runs: read the latest left/right
PNGs from disk, run the worker-pool SAD, write ``output.png``, log elapsed
(``pkg/camera/output.go:44-210``). Here the loop blocks on the in-memory
bus for a fresh stereo pair, runs the device disparity engine (the
``BlockMatcher`` model, live-retunable), publishes the depth map to the
``out`` slot, and keeps rolling fps / latency metrics — the first-class
perf counters the reference lacked (SURVEY.md section 5).
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

from steroscopic_hardware_tpu.models.blockmatch import BlockMatcher
from steroscopic_hardware_tpu.runtime.bus import FrameBus
from steroscopic_hardware_tpu.runtime.logger import get_logger
from steroscopic_hardware_tpu.utils.devlock import device_lock


def _mean_pool2d(img: np.ndarray, k: int) -> np.ndarray:
    """k x k host-side mean pool (uint8 in/out), matching the on-device
    preview downscale so the host-LUT light mode previews identical
    content instead of an aliased [::k, ::k] subsample (ADVICE r3)."""
    if k <= 1:
        return img
    H, W = img.shape[:2]
    h, w = H - H % k, W - W % k
    pooled = (
        img[:h, :w].reshape(h // k, k, w // k, k)
        .astype(np.float32).mean(axis=(1, 3))
    )
    return np.round(pooled).astype(np.uint8)


class DepthPipeline:
    def __init__(self, bus: FrameBus, matcher: BlockMatcher | None = None,
                 left_slot="left", right_slot="right", out_slot="out",
                 lr_check: bool = False, colorize: bool = True,
                 rectifier=None, depth_slot="depth", max_batch: int = 8,
                 preview_scale: int = 1, host_colorize: bool = True,
                 max_queue: int | None = None, slam_pipeline=None,
                 fuse_slam: bool = True, dedup_uploads: bool = False):
        self.bus = bus
        self.matcher = matcher or BlockMatcher()
        self.max_batch = max_batch
        # fused serve+track (VERDICT r4 directive #1): when a SLAM
        # pipeline rides the same frames, ONE dispatch per batch computes
        # the depth serve AND the tracking step — the stereo pair crosses
        # the wire once, and the track results ride the same fetch.
        self.slam_pipeline = slam_pipeline
        self._fused = None
        if (slam_pipeline is not None and fuse_slam
                and hasattr(self.matcher, "compute_serve_async")):
            from steroscopic_hardware_tpu.runtime.fused import (
                FusedServeTrack,
            )

            self._fused = FusedServeTrack(self.matcher,
                                          slam_pipeline.slam)
            slam_pipeline.enable_fused()
        # preview_scale > 1 switches the fused serve dispatch to "light"
        # fetches: only the newest depth comes back full-res and the RGB
        # preview is k x k mean-pooled ON DEVICE before colorization —
        # ~14x less fetch traffic at B=8/k=2 for bandwidth-bound links
        # (ROADMAP gap 4). The out/depth bus slots then carry one frame
        # per batch (latest-frame semantics, same as the reference's
        # free-running loop).
        self.preview_scale = max(1, int(preview_scale))
        # host_colorize: fetch uint8 disparity only and apply the Turbo
        # palette host-side via the 256-entry LUT — 1 byte/pixel instead
        # of 1+3 on the wire (~1 ms of host work at VGA), the dominant
        # fetch-traffic cut for bandwidth-limited transports (VERDICT r2
        # directive #6). Device colorization remains available
        # (host_colorize=False) for hosts where even the LUT gather
        # matters.
        self.host_colorize = host_colorize
        self.left_slot = left_slot
        self.right_slot = right_slot
        self.out_slot = out_slot
        self.depth_slot = depth_slot
        self.lr_check = lr_check
        self.colorize = colorize
        # optional StereoRectifier: lets raw (unrectified, distorted)
        # cameras feed the engine directly (--calib in __main__)
        self.rectifier = rectifier
        self.log = get_logger("pipeline")
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        self._times = collections.deque(maxlen=100)   # per-frame latency
        self._pub_times = collections.deque(maxlen=100)  # publish stamps
        self._times_lock = threading.Lock()
        # queue-depth cap (drop-OLDEST): backlog converts to counted
        # drops instead of latency — a live viewer wants the newest
        # frame, not a 10-frame-deep pipeline (VERDICT r3 weak #7).
        # Default: one batch deep.
        self.max_queue = max(1, int(max_queue)) if max_queue else max_batch
        # capture->publish latency decomposition (seconds):
        #   queue  — capture to dispatch start (backlog wait)
        #   serve  — device dispatch + wire fetch (the RPC window)
        #   host   — host colorize + bus publish
        self._lat_parts = {
            "queue": collections.deque(maxlen=100),
            "serve": collections.deque(maxlen=100),
            "host": collections.deque(maxlen=100),
        }
        self.frames = 0
        self.errors = 0
        self.dropped = 0        # coalesced in light mode / batch-trimmed
        self.queue_dropped = 0  # overwritten in the capped inbox
        # opt-in: skip byte-identical consecutive pairs before upload.
        # A paused/static camera re-publishes the same frame at tick
        # rate; uploading it again buys nothing. Off by
        # default: live cameras never produce identical frames, and the
        # serving benchmark intentionally measures full upload load.
        self.dedup_uploads = dedup_uploads
        self.dup_skipped = 0
        self._last_pair_crc: int | None = None
        self._busy_since: float | None = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 5.0):
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def _frames_in(self):
        lf = self.bus.latest(self.left_slot)
        rf = self.bus.latest(self.right_slot)
        if lf is None or rf is None:
            return None
        left, right = lf.data, rf.data
        if left.shape != right.shape:
            # mismatched feeds: crop to the common size, the tolerant
            # behavior the reference approximates by full-frame reads
            h = min(left.shape[0], right.shape[0])
            w = min(left.shape[1], right.shape[1])
            left, right = left[:h, :w], right[:h, :w]
        if self.rectifier is not None:
            left, right = self.rectifier(left, right)
        return left, right

    def _step_batch(self, pairs) -> np.ndarray:
        """Compute and publish one micro-batch.

        When the matcher supports the fused serve dispatch
        (BlockMatcher), B frame pairs ride ONE host->device transfer +
        one executable covering disparity, optional LR check, and
        on-device colorization of the newest frame, and ONE packed-result
        fetch. Every synchronous transfer pays a fixed latency, so
        batching amortizes both transfers across B frames (VERDICT r1
        weak #6)."""
        t0s = [t for t, _ in pairs]
        t_start = time.time()
        t_serve_end = None
        rgb = None
        k = self.preview_scale
        # each matcher call below runs inside the process-wide dispatch
        # lock, a no-op unless serialization is forced
        # (utils/devlock.py)
        if self._fused is not None:
            # ONE dispatch serves the batch AND tracks the newest pair
            # (runtime/fused.py); the SLAM pipeline consumes the track
            # result on its own thread. Zero duplicate uploads.
            from steroscopic_hardware_tpu.runtime.fused import split_serve

            if not self.colorize:
                sargs = dict(lr=self.lr_check, fetch_all=True,
                             colorize_dev=False)
            elif self.host_colorize:
                sargs = dict(lr=self.lr_check, fetch_all=(k == 1),
                             colorize_dev=False)
            elif k > 1:
                sargs = dict(lr=self.lr_check, preview_scale=k,
                             fetch_all=False)
            else:
                sargs = dict(lr=self.lr_check)
            flat, track = self._fused.step([p for _, p in pairs],
                                           **sargs)
            t_serve_end = time.time()
            track.t_capture = t0s[-1]
            self.slam_pipeline.submit_track(track)
            H, W = pairs[-1][1][0].shape
            depths, rgb = split_serve(
                flat, len(pairs), H, W,
                preview_scale=sargs.get("preview_scale", 1),
                fetch_all=sargs.get("fetch_all", True),
                colorize_dev=sargs.get("colorize_dev", True),
            )
            if self.colorize and self.host_colorize:
                from steroscopic_hardware_tpu.ops.colorize import (
                    colorize_disparity_lut,
                )

                rgb = colorize_disparity_lut(_mean_pool2d(depths[-1], k))
        elif (self.colorize and self.host_colorize
                and hasattr(self.matcher, "compute_serve_async")):
            # depth-only fetch + host LUT colorize; preview_scale > 1
            # additionally coalesces to the newest frame (light mode) and
            # mean-pools the preview host-side before the LUT (same
            # content as the on-device downscale path)
            with device_lock:
                depths = np.asarray(self.matcher.compute_serve_async(
                    [p for _, p in pairs], lr=self.lr_check,
                    fetch_all=(k == 1), colorize_dev=False,
                ))
            t_serve_end = time.time()
            from steroscopic_hardware_tpu.ops.colorize import (
                colorize_disparity_lut,
            )

            rgb = colorize_disparity_lut(_mean_pool2d(depths[-1], k))
        elif (self.colorize and k > 1
                and hasattr(self.matcher, "compute_serve_async")):
            # light fetch: 1D [newest depth | downscaled RGB preview]
            H, W = pairs[-1][1][0].shape
            with device_lock:
                flat = np.asarray(self.matcher.compute_serve_async(
                    [p for _, p in pairs], lr=self.lr_check,
                    preview_scale=k, fetch_all=False,
                ))
            want = H * W + (H // k) * (W // k) * 3
            if flat.size != want:
                raise ValueError(
                    f"light serve fetch returned {flat.size} elements, "
                    f"expected {want} for shape {H}x{W} preview_scale={k}"
                )
            t_serve_end = time.time()
            depths = flat[: H * W].reshape(1, H, W)
            rgb = flat[H * W:].reshape(H // k, W // k, 3)
        elif self.colorize and hasattr(self.matcher, "compute_serve_async"):
            with device_lock:
                packed = np.asarray(self.matcher.compute_serve_async(
                    [p for _, p in pairs], lr=self.lr_check
                ))
            t_serve_end = time.time()
            B = len(pairs)
            depths = packed[:B]
            rgb = packed[B:].transpose(1, 2, 0)
        else:
            outs = []
            for _, (left, right) in pairs:
                if self.lr_check and hasattr(self.matcher,
                                             "compute_checked"):
                    depth, _ = self.matcher.compute_checked(left, right)
                else:
                    depth = self.matcher.compute(left, right)
                outs.append(depth)
            depths = np.stack(outs)
        if t_serve_end is None:
            t_serve_end = time.time()
        for b in range(depths.shape[0]):
            self.bus.publish(self.out_slot, depths[b],
                             source="DepthPipeline")
        if self.colorize:
            if rgb is None:
                from steroscopic_hardware_tpu.ops.colorize import (
                    colorize_disparity,
                )

                rgb = colorize_disparity(depths[-1])
            self.bus.publish(
                self.depth_slot, np.ascontiguousarray(rgb),
                source="DepthPipeline",
            )
        # Honest accounting (ADVICE r2): in light mode only
        # ``depths.shape[0]`` frames were actually computed and published
        # (XLA dead-code-eliminates the rest); fps must reflect published
        # throughput, with the coalesced frames counted separately.
        published = depths.shape[0]
        now = time.time()
        with self._times_lock:
            # all three decomposition deques sample once per PUBLISHED
            # frame so their p50/p95 cover the same frames and windows
            # (ADVICE r4: per-batch serve/host vs per-frame queue made
            # the percentiles mutually incomparable under batching)
            for t0 in t0s[-published:]:
                self._times.append(now - t0)
                self._pub_times.append(now)
                self._lat_parts["queue"].append(t_start - t0)
                self._lat_parts["serve"].append(t_serve_end - t_start)
                self._lat_parts["host"].append(now - t_serve_end)
        self.frames += published
        self.dropped += len(t0s) - published
        return depths[-1]

    def step(self) -> np.ndarray | None:
        """One synchronous pipeline iteration (for tests and batch use)."""
        self._busy_since = time.time()
        try:
            pair = self._frames_in()
            if pair is None:
                return None
            return self._step_batch([(time.time(), pair)])
        finally:
            self._busy_since = None

    def _collect(self, buf, lock, fresh):
        """Collector thread: snapshot every new bus pair into ``buf`` so
        the compute thread can batch the frames that arrived while the
        previous batch was in flight (the latest-frame bus itself keeps
        no history)."""
        last_seq = 0
        while not self._closed.is_set():
            f = self.bus.wait_next(self.left_slot, last_seq, timeout=0.5)
            if f is None:
                continue
            last_seq = f.seq
            pair = self._frames_in()
            if pair is None:
                continue
            if self.dedup_uploads:
                import zlib

                crc = (zlib.crc32(pair[0].tobytes())
                       ^ (zlib.crc32(pair[1].tobytes()) << 1))
                if crc == self._last_pair_crc:
                    self.dup_skipped += 1
                    continue
                self._last_pair_crc = crc
            with lock:
                if len(buf) == buf.maxlen:
                    # drop-OLDEST at the queue cap: backlog becomes a
                    # counted drop, never latency
                    self.queue_dropped += 1
                buf.append((time.time(), pair))
            fresh.set()

    def _run(self):
        buf = collections.deque(maxlen=min(self.max_queue,
                                           self.max_batch))
        lock = threading.Lock()
        fresh = threading.Event()
        collector = threading.Thread(
            target=self._collect, args=(buf, lock, fresh), daemon=True
        )
        collector.start()
        while not self._closed.is_set():
            if not fresh.wait(timeout=0.5):
                continue
            with lock:
                pairs = list(buf)
                buf.clear()
                fresh.clear()
            if not pairs:
                continue
            # power-of-two batch of the NEWEST pairs: stable jit buckets
            # (B in {1, 2, 4, 8}), older frames drop — the latest-frame
            # semantics the reference's free-running loop also has.
            # Synchronous (no software pipelining): overlap would add a
            # full batch of latency.
            B = 1
            while B * 2 <= len(pairs) and B * 2 <= self.max_batch:
                B *= 2
            self.dropped += len(pairs) - B
            pairs = pairs[-B:]
            try:
                self._busy_since = time.time()
                self._step_batch(pairs)
                self._busy_since = None
            except Exception as e:  # keep the loop alive (output.go:106-122)
                self._busy_since = None
                self.errors += 1
                self.log.warning("pipeline error: %s", e)
                time.sleep(0.01)

    def _state(self) -> str:
        """Human-readable pipeline state: surfaces a stuck first compile
        (e.g. a slow first compile) instead of a silent frames=0."""
        busy = self._busy_since
        if busy is not None:
            elapsed = time.time() - busy
            if self.frames == 0:
                return (f"compiling first kernel ({elapsed:.0f}s)"
                        if elapsed > 2 else "computing")
            if elapsed > 10:
                return f"stalled in compute ({elapsed:.0f}s)"
            return "computing"
        return "running" if self.frames else "waiting for frames"

    def metrics(self) -> dict:
        with self._times_lock:
            times = list(self._times)
            pubs = list(self._pub_times)
        if not times:
            return {"frames": self.frames, "errors": self.errors,
                    "dropped": self.dropped,
                    "queue_dropped": self.queue_dropped,
                    "state": self._state()}
        with self._times_lock:
            lat = {k: list(v) for k, v in self._lat_parts.items()}
        return self._metrics_with_times(times, pubs, lat)

    def _metrics_with_times(self, times, pubs=(), lat=None) -> dict:
        p = self.matcher.get_params()
        arr = np.array(times)
        # throughput from publish intervals (the pipelined loop overlaps
        # frames, so latency alone understates fps); latency percentiles
        # from dispatch->publish times
        if len(pubs) >= 2:
            fps = (len(pubs) - 1) / max(pubs[-1] - pubs[0], 1e-6)
        else:
            fps = 1.0 / float(arr.mean())
        out = {
            "frames": self.frames,
            "errors": self.errors,
            "dropped": self.dropped,
            "queue_dropped": self.queue_dropped,
            "dup_skipped": self.dup_skipped,
            "state": self._state(),
            "fps": round(float(fps), 2),
            "ms_mean": round(float(arr.mean()) * 1000, 2),
            "ms_p50": round(float(np.median(arr)) * 1000, 2),
            "ms_p95": round(float(np.percentile(arr, 95)) * 1000, 2),
            "block_size": p.block_size,
            "max_disparity": p.max_disparity,
        }
        # capture->publish latency decomposed (VERDICT r3 weak #7):
        # queue wait vs device RPC vs host colorize+publish, p50/p95 ms
        for name, vals in (lat or {}).items():
            if vals:
                a = np.array(vals) * 1000
                out[f"lat_{name}_p50"] = round(float(np.median(a)), 2)
                out[f"lat_{name}_p95"] = round(
                    float(np.percentile(a, 95)), 2)
        return out


class SlamPipeline:
    """Live stereo SLAM over the frame bus.

    Pairs the newest left/right frames, feeds them through
    :class:`~steroscopic_hardware_tpu.models.slam.StereoSLAM`, and exposes
    the running trajectory — the product surface for the north-star SLAM
    capability (served at ``GET /slam``).
    """

    def __init__(self, bus: FrameBus, camera, *, left_slot="left",
                 right_slot="right", slam_kwargs=None,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 50, rectifier=None):
        from steroscopic_hardware_tpu.models.slam import StereoSLAM

        # live serving runs the ASYNCHRONOUS backend by default: BA and
        # pose-graph optimization must never stall the frame loop (a
        # loop closure costs ~1 s of solver time at a few hundred
        # keyframes — VERDICT r3 weak #1). Callers can force the
        # synchronous engine with slam_kwargs={"async_backend": False}.
        slam_kwargs = dict(slam_kwargs or {})
        slam_kwargs.setdefault("async_backend", True)
        self.bus = bus
        self.left_slot = left_slot
        self.right_slot = right_slot
        self.rectifier = rectifier
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.log = get_logger("slam")
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.frames = 0
        self.errors = 0
        self._warm_done = False
        # fused mode (runtime/fused.py): the depth pipeline computes
        # tracking inside its serve dispatch and submits TrackResults
        # here; the run loop consumes them instead of re-uploading bus
        # pairs (VERDICT r4 directive #1)
        self.fused = False
        self._fused_q = None
        self.fused_dropped = 0

        # elastic recovery: resume from the newest checkpoint if present
        self.slam = None
        if checkpoint_dir is not None:
            from steroscopic_hardware_tpu.utils import checkpoint as ckpt

            path = ckpt.latest(checkpoint_dir)
            if path is not None:
                try:
                    self.slam = StereoSLAM.load_checkpoint(
                        path, **slam_kwargs
                    )
                    self.frames = self.slam.frame_idx
                    self.log.info("resumed SLAM from %s (frame %d)",
                                  path, self.frames)
                except Exception as e:
                    self.log.warning("checkpoint resume failed: %s", e)
        if self.slam is None:
            self.slam = StereoSLAM(camera, **slam_kwargs)

    def start(self):
        if self._thread is None:
            # AOT-warm the backend solver programs (BA windows, loop
            # match/PnP, pose-graph bucket, BoW) in a boot thread: the
            # first loop closure of a live session must execute, not
            # compile (VERDICT r4 directive #2 — the round-4 matrix's
            # slam rows spent their whole window compiling). Lock-free
            # ('sporadic' dispatches), so streaming starts immediately.
            if hasattr(self.slam, "warmup_backend"):
                def _warm():
                    try:
                        t0 = time.time()
                        n = self.slam.warmup_backend(
                            should_stop=self._closed.is_set)
                        self.log.info(
                            "backend warmup: %d programs in %.1fs",
                            n, time.time() - t0)
                        self._warm_done = True
                    except Exception as e:
                        self.log.warning("backend warmup failed: %s", e)

                self._warm_thread = threading.Thread(
                    target=_warm, daemon=True, name="slam-warmup")
                self._warm_thread.start()
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 5.0):
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout)
        # join the warmup thread through at most one in-flight program:
        # a daemon thread killed mid-compile at interpreter exit escapes
        # a C++ exception and ABORTS the process (observed as SIGABRT
        # after a green pytest summary)
        warm = getattr(self, "_warm_thread", None)
        if warm is not None:
            warm.join(120.0)
        if hasattr(self.slam, "close"):
            self.slam.close()

    def enable_fused(self):
        """Switch to fused ingestion (called by the DepthPipeline that
        owns the fused serve+track dispatch, before start())."""
        import queue

        self._fused_q = queue.Queue()
        self.fused = True
        return self

    def submit_track(self, track) -> None:
        """Hand one TrackResult from the depth compute thread to this
        pipeline's thread. Host-side bookkeeping per item is
        microseconds, so the queue stays near-empty; the backstop only
        guards against a dead consumer thread (dropping an item loses
        that frame's relative motion — counted, never silent)."""
        q = self._fused_q
        if q is None:
            return
        if q.qsize() > 1000:
            try:
                q.get_nowait()
                self.fused_dropped += 1
            except Exception:
                pass
        q.put(track)

    def step(self):
        lf = self.bus.latest(self.left_slot)
        rf = self.bus.latest(self.right_slot)
        if lf is None or rf is None:
            return None
        left, right = lf.data, rf.data
        if left.shape != right.shape:
            # mismatched feeds: crop to the common size like DepthPipeline
            h = min(left.shape[0], right.shape[0])
            w = min(left.shape[1], right.shape[1])
            left, right = left[:h, :w], right[:h, :w]
        if self.rectifier is not None:
            left, right = self.rectifier(left, right)
        xi = self.slam.process(left, right)
        self.frames += 1
        self._after_step()
        return xi

    def _after_step(self):
        # refresh the cached snapshot under the lock so /slam never blocks
        # behind a long compute (e.g. a first-kernel compile)
        snap = {
            "frames": self.frames,
            "errors": self.errors,
            "keyframes": len(self.slam.kf_history),
            "ba_runs": self.slam.ba_runs,
            "loops_closed": self.slam.loops_closed,
            "backend_pending": getattr(self.slam, "backend_pending", 0),
            "backend_coalesced": getattr(
                self.slam, "backend_coalesced", 0),
            "loop_checks_skipped": getattr(
                self.slam, "loop_checks_skipped", 0),
            "culled_keyframes": getattr(
                self.slam, "culled_keyframes", 0),
            "warm": getattr(self, "_warm_done", False),
            "fused": self.fused,
            "fused_dropped": self.fused_dropped,
            # cumulative per-stage seconds (vo/ba/loop/graph): lets a
            # soak derive per-closure optimize time over the run's life
            "stage_s": {k: round(v, 3)
                        for k, v in self.slam.stage_s.items()},
            "inliers": list(self.slam.vo.n_inliers[-20:]),
            # tail only: with every depth frame tracked (fused mode) the
            # trajectory grows at stream rate, and serializing the whole
            # of it per /slam poll would grow without bound over an
            # hours-long session; positions_total keeps the count honest
            "positions": self.slam.vo.positions(tail=4096).tolist(),
            "positions_total": len(self.slam.vo.trajectory),
        }
        with self._lock:
            self._snapshot = snap
        if (self.checkpoint_dir is not None
                and self.frames % self.checkpoint_every == 0):
            self._save_checkpoint()

    def _save_checkpoint(self):
        import os

        from steroscopic_hardware_tpu.utils import checkpoint as ckpt

        try:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            path = os.path.join(
                self.checkpoint_dir, f"slam-{self.frames:08d}.ckpt"
            )
            self.slam.save_checkpoint(path)
            ckpt.prune(self.checkpoint_dir, keep=3)
            self.log.info("checkpoint saved %s", path)
        except Exception as e:
            self.log.warning("checkpoint save failed: %s", e)

    def _run(self):
        if self.fused:
            self._run_fused()
            return
        last_seq = 0
        while not self._closed.is_set():
            f = self.bus.wait_next(self.left_slot, last_seq, timeout=0.5)
            if f is None:
                continue
            last_seq = f.seq
            try:
                self.step()
            except Exception as e:
                self.errors += 1
                self.log.warning("slam error: %s", e)
                time.sleep(0.01)

    def _run_fused(self):
        """Consume externally tracked frames (fused serve+track): every
        queued TrackResult is processed IN ORDER — each carries one
        link of the relative-pose chain."""
        import queue

        while not self._closed.is_set():
            try:
                track = self._fused_q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                self.slam.process_tracked(track)
                self.frames += 1
                self._after_step()
            except Exception as e:
                self.errors += 1
                self.log.warning("slam fused error: %s", e)

    def snapshot(self) -> dict:
        with self._lock:
            snap = getattr(self, "_snapshot", None)
        if snap is None:
            return {"frames": 0, "errors": self.errors, "keyframes": 0,
                    "ba_runs": 0, "loops_closed": 0, "inliers": [],
                    "positions": []}
        return snap
