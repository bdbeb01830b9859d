"""Batch inference serving (counterpart of omnivggt_tpu/serving.py).

  - `InferenceSession`: owns a model on its device and answers scenes given
    as numpy arrays. The default pad_mode="bucket" pads the frame count up
    to the next bucket; padded frames are masked out of every cross-frame
    attention (num_valid_frames through the model, handed over as an int32
    scalar on the device, so the kernels take their dynamic valid-key
    variant and nothing syncs with the host), and the real frames' outputs
    match the unpadded forward's up to the order of the sums. An exact-fit
    request runs unmasked. pad_mode="exact" never pads. PyTorch runs
    eagerly, so there are no compiled executables to cache: `exec_key`
    stays as the identity under which scenes may share one batch, and the
    session records which keys it has served.
  - `Batcher`: coalesces concurrent same-key requests into one batched
    forward (scenes stacked over the leading B axis).
  - `serve()`: a stdlib HTTP endpoint. POST /infer with an .npz body
    (images [+ extrinsics / intrinsics / depth / mask + camera_gt_index /
    depth_gt_index]) returns an .npz of predictions; GET /healthz reports
    liveness with a deadline-bounded device probe; POST /infer_glb takes
    the same body (plus optional conf_thres / mask_black_bg / mask_white_bg
    / prediction_mode) and returns the scene as a binary GLB; optional
    bearer `token` auth.
"""

from __future__ import annotations

import io
import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler
from socketserver import ThreadingTCPServer
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from omnivggt_tpu_torch.utils.profiling import record_since, span


DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


class InferenceTimeout(TimeoutError):
    """An inference dispatch exceeded its deadline: a wedged device must
    surface as an error to the caller, never as a thread blocked for good."""


def _call_with_deadline(fn, timeout_s: Optional[float], **kwargs):
    """Run fn(**kwargs) with a wall-clock deadline. A device dispatch cannot
    be cancelled, so the work runs on a daemon thread and the caller is
    released with InferenceTimeout when the deadline passes."""
    if timeout_s is None:
        return fn(**kwargs)
    box: dict = {}
    done = threading.Event()

    def run():
        try:
            box["result"] = fn(**kwargs)
        except Exception as e:  # noqa: BLE001 — re-raised in the caller
            box["error"] = e
        done.set()

    threading.Thread(target=run, daemon=True).start()
    if not done.wait(timeout_s):
        raise InferenceTimeout(
            f"inference exceeded the {timeout_s:.1f}s deadline "
            "(device backend wedged or queue saturated)"
        )
    if "error" in box:
        raise box["error"]
    return box["result"]


class BackendProbe:
    """Cached device-liveness probe: a tiny reduction on `device` fetched to
    the host, run on a daemon thread with a deadline so /healthz itself
    never hangs.

    status() returns {"backend": "ok" | "wedged" | "unknown", "age_s": t}.
    "unknown" = no probe has completed yet and the in-flight one is still
    within its deadline. One probe is in flight at a time; a wedged probe
    thread is abandoned (daemon) and a fresh one is attempted once the
    cached verdict goes stale."""

    def __init__(self, interval_s: float = 15.0, timeout_s: float = 5.0, device="cuda"):
        self.device = device
        self.interval = interval_s
        self.timeout = timeout_s
        self._lock = threading.Lock()
        self._verdict: Optional[str] = None
        self._verdict_t = 0.0
        self._inflight_t: Optional[float] = None

    def _probe_once(self) -> bool:
        return float(torch.ones((8, 8), device=self.device).sum().item()) == 64.0

    def _launch(self):
        self._inflight_t = time.monotonic()

        def run():
            try:
                ok = self._probe_once()
            except Exception:  # noqa: BLE001 — a raising backend is down
                ok = False
            with self._lock:
                self._verdict = "ok" if ok else "wedged"
                self._verdict_t = time.monotonic()
                self._inflight_t = None

        threading.Thread(target=run, daemon=True).start()

    def status(self) -> dict:
        with self._lock:
            now = time.monotonic()
            fresh = self._verdict is not None and (
                now - self._verdict_t < self.interval
            )
            if not fresh and self._inflight_t is None:
                self._launch()
            # an in-flight probe past its deadline IS the wedged signal
            if (
                self._inflight_t is not None
                and now - self._inflight_t > self.timeout
            ):
                return {"backend": "wedged", "age_s": 0.0}
            if self._verdict is None:
                return {"backend": "unknown", "age_s": None}
            return {
                "backend": self._verdict,
                "age_s": round(now - self._verdict_t, 3),
            }


class InferenceSession:
    """Thread-safe scene-inference session with frame-count bucketing."""

    def __init__(self, model=None, config=None, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 sharding=None, pad_mode: str = "bucket", compress_trunk: bool = False,
                 device=None, seed: int = 0):
        """model: an OmniVGGT (its own config and device are used); else one
        is built from `config` on `device` (default "cuda") with random
        weights from `seed`. compress_trunk stores the trunk's weights in
        bf16 (checkpoint.cast_trunk_params). sharding: a
        parallel.sharding.ModelSharding whose mesh lies on the model's
        device; every forward then runs under it. With the mesh's seq axis
        over processes (every process calls `infer` with the same request)
        the frames split over them: a bucket is rounded up to a multiple
        of the seq processes, and in exact mode the frame count must be
        one."""
        from omnivggt_tpu_torch.models.omnivggt import OmniVGGT

        if pad_mode not in ("exact", "bucket"):
            raise ValueError(f"pad_mode must be 'exact' or 'bucket', got {pad_mode}")
        if (
            pad_mode == "bucket"
            and sharding is not None
            and getattr(sharding, "global_attn", None) in ("ring", "ring_fused")
        ):
            raise ValueError(
                "bucket mode masks padded frames out of attention, which the "
                "ring strategies do not support; use "
                "ModelSharding(..., global_attn='allgather') or "
                "pad_mode='exact'"
            )
        if model is None:
            model = OmniVGGT(config, device=device, seed=seed)
        if compress_trunk:
            from omnivggt_tpu_torch.checkpoint import cast_trunk_params

            model = cast_trunk_params(model)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.buckets = tuple(sorted(buckets))
        self.sharding = sharding
        self.pad_mode = pad_mode
        mesh = getattr(sharding, "mesh", None)
        self._frames_multiple = mesh.seq if mesh is not None and mesh.seq_processes else 1
        self._lock = threading.Lock()  # guards _served
        self._forward_lock = threading.Lock()  # one forward at a time on the device
        self._served: Dict[tuple, int] = {}  # exec key + batch size -> forwards run

    def _bucket(self, S: int) -> int:
        n = self._frames_multiple
        if self.pad_mode == "exact":
            if S % n:
                raise ValueError(f"{S} frames do not divide over the {n} seq processes of the "
                                 "mesh, and exact mode does not pad: send a multiple of "
                                 f"{n} frames, or use bucket mode under allgather")
            return S
        b = next((b for b in self.buckets if S <= b), S)
        return -(-b // n) * n

    def _prepare(
        self,
        images: np.ndarray,
        extrinsics=None,
        intrinsics=None,
        depth=None,
        mask=None,
        camera_gt_index: Optional[Sequence[int]] = None,
        depth_gt_index: Optional[Sequence[int]] = None,
    ) -> dict:
        """Validate + frame-pad one scene; returns the unbatched arrays and
        the compatibility keys under which scenes run alike (exec_key) and
        may be stacked into one batch (key)."""
        from omnivggt_tpu_torch.utils.validation import validate_batch

        # normalise gt indices early: numpy arrays would crash the truthiness
        # checks below (multi-element) or silently key single-element arrays
        # as empty
        if camera_gt_index is not None:
            camera_gt_index = [int(i) for i in camera_gt_index]
        if depth_gt_index is not None:
            depth_gt_index = [int(i) for i in depth_gt_index]

        images = np.asarray(images, np.float32)
        if images.ndim != 4:
            raise ValueError(f"images must be (S,H,W,3); got {images.shape}")
        S, H, W, _ = images.shape

        def batched(x, shape):
            if x is None:
                return None
            x = np.asarray(x)
            return x.reshape(shape)[None] if x.size == np.prod(shape) else x[None]

        validate_batch(
            images[None],
            batched(extrinsics, (S, 3, 4)),
            batched(intrinsics, (S, 3, 3)),
            batched(depth, (S, H, W, 1)),
            batched(mask, (S, H, W)),
            depth_gt_index,
            camera_gt_index,
            patch_size=self.model.config.patch_size,
        )

        Sb = self._bucket(S)
        pad = Sb - S

        def pad_frames(x, shape, fill=0.0):
            if x is None:
                return None
            x = np.asarray(x, np.float32).reshape(shape)
            if pad == 0:
                return x
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, widths, constant_values=fill)

        has_cam = camera_gt_index is not None and len(camera_gt_index) > 0
        has_depth = depth_gt_index is not None and len(depth_gt_index) > 0
        # exact-fit requests (pad == 0) run unmasked, identical to exact
        # mode. Padded requests run masked, with num_valid_frames a scalar
        # on the device.
        masked = self.pad_mode == "bucket" and pad > 0
        return {
            "images": pad_frames(images, (S, H, W, 3)),
            "extrinsics": pad_frames(extrinsics, (S, 3, 4)),
            "intrinsics": pad_frames(intrinsics, (S, 3, 3)),
            "depth": pad_frames(depth, (S, H, W, 1)),
            "mask": pad_frames(mask, (S, H, W)),
            "camera_gt_index": camera_gt_index,
            "depth_gt_index": depth_gt_index,
            "S": S,
            "Sb": Sb,
            # which forward runs: S and the gt indices are data (the
            # num_valid_frames scalar, mask arrays), so one key covers
            # every S below the bucket and any gt-index layout
            "exec_key": (Sb, H, W, has_cam, has_depth, masked),
            # batch identity: aux masks and num_valid_frames are shared
            # across a stacked batch, so batchable scenes must also agree on
            # S, the gt-index tuples, AND which aux arrays are present
            # (np.stack can't mix a scene carrying a mask with one that
            # doesn't)
            "key": (
                Sb, H, W, has_cam, has_depth, masked, S,
                tuple(camera_gt_index or ()), tuple(depth_gt_index or ()),
                extrinsics is not None, intrinsics is not None,
                depth is not None, mask is not None,
            ),
        }

    def _execute(self, reqs: List[dict]) -> List[Dict[str, np.ndarray]]:
        """Run one batched forward over prepared scenes sharing one key."""
        from omnivggt_tpu_torch.models import omnivggt as M

        key = reqs[0]["key"]
        if any(r["key"] != key for r in reqs):
            raise ValueError("batched scenes must share one key")
        B = len(reqs)
        S, Sb = reqs[0]["S"], reqs[0]["Sb"]
        masked = key[5]
        dev = self.device

        def stack(name):
            if reqs[0][name] is None:
                return None
            return np.stack([r[name] for r in reqs])

        with self._forward_lock, torch.inference_mode():
            with span("serve.stage_in"):
                aux = M.make_aux(
                    Sb, stack("extrinsics"), stack("intrinsics"), stack("depth"), stack("mask"),
                    reqs[0]["depth_gt_index"], reqs[0]["camera_gt_index"], device=dev,
                )
                # a device scalar: the kernels' dynamic valid-key variant, no host sync
                nv = torch.tensor(S, dtype=torch.int32, device=dev) if masked else None
                images = torch.as_tensor(stack("images"), device=dev)
            with span("serve.forward", scenes=B, frames_run=B * Sb, frames_requested=B * S):
                preds = M.apply(self.model, images, self.model.config, aux,
                                num_valid_frames=nv, sharding=self.sharding)
            with span("serve.copy_out"):
                arrays = {k: v.float().cpu().numpy() for k, v in preds.items()}
                outs: List[Dict[str, np.ndarray]] = [{} for _ in range(B)]
                for k, arr in arrays.items():
                    for b in range(B):
                        if k == "pose_enc_list":
                            outs[b][k] = arr[:, b, :S]
                        else:
                            outs[b][k] = arr[b, :S]
        with self._lock:
            served = (*reqs[0]["exec_key"], B)
            self._served[served] = self._served.get(served, 0) + 1
        return outs

    def infer(
        self,
        images: np.ndarray,
        extrinsics=None,
        intrinsics=None,
        depth=None,
        mask=None,
        camera_gt_index: Optional[Sequence[int]] = None,
        depth_gt_index: Optional[Sequence[int]] = None,
    ) -> Dict[str, np.ndarray]:
        """images: (S, H, W, 3) float [0,1]. Returns numpy predictions with
        the padding frames stripped."""
        req = self._prepare(
            images, extrinsics, intrinsics, depth, mask,
            camera_gt_index, depth_gt_index,
        )
        return self._execute([req])[0]

    def infer_batch(
        self, requests: List[dict], max_batch: int = 8
    ) -> List[Dict[str, np.ndarray]]:
        """Run several scenes, stacking compatible ones (same frame count,
        resolution, and modality layout) into shared batched forwards.
        Each request is a kwargs dict for `infer`. Results keep order.

        Groups are chunked to at most `max_batch` scenes per forward, which
        bounds the activation memory of one dispatch."""
        prepared = [self._prepare(**r) for r in requests]
        groups: Dict[tuple, List[int]] = {}
        for i, p in enumerate(prepared):
            groups.setdefault(p["key"], []).append(i)
        results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(requests)
        for idxs in groups.values():
            for i0 in range(0, len(idxs), max_batch):
                chunk = idxs[i0:i0 + max_batch]
                outs = self._execute([prepared[i] for i in chunk])
                for i, out in zip(chunk, outs):
                    results[i] = out
        return results

    @staticmethod
    def _dummy_request(S: int, H: int, W: int,
                       camera_gt: bool, depth_gt: bool) -> dict:
        """A validation-passing zero scene of the given shape/modality combo
        (identity cameras, unit depth): what a forward costs depends on
        shapes, not values, so this warms what real traffic of that shape
        will run."""
        req: dict = {"images": np.zeros((S, H, W, 3), np.float32)}
        if camera_gt:
            ex = np.zeros((S, 3, 4), np.float32)
            ex[:, 0, 0] = ex[:, 1, 1] = ex[:, 2, 2] = 1.0
            K = np.zeros((S, 3, 3), np.float32)
            K[:, 0, 0] = K[:, 1, 1] = float(max(H, W))
            K[:, 0, 2] = W / 2.0
            K[:, 1, 2] = H / 2.0
            K[:, 2, 2] = 1.0
            req.update(extrinsics=ex, intrinsics=K, camera_gt_index=[0])
        if depth_gt:
            req.update(
                depth=np.ones((S, H, W, 1), np.float32),
                mask=np.ones((S, H, W), np.float32),
                depth_gt_index=[0],
            )
        return req

    def warmup(
        self,
        frame_counts: Sequence[int] = (8,),
        hw: tuple = (518, 518),
        batch_sizes: Sequence[int] = (1,),
        include_masked: bool = True,
        modalities: Sequence[tuple] = ((False, False),),
    ) -> List[tuple]:
        """Run the forwards serving is expected to need once, up front.

        The first forward of a new shape pays the kernels' build (nvcc at
        first use), the libraries' plan selection and the allocator's
        growth; without warmup that lands on a real caller and can blow
        its request deadline. This runs one zero scene through each
        expected key instead.

        frame_counts: expected scene sizes. Each warms its enclosing
            bucket's exact-fit forward, plus, in bucket mode and when
            `include_masked`, the masked forward that serves every smaller
            S in that bucket.
        hw: input resolution to warm.
        batch_sizes: Batcher stack sizes to warm.
        modalities: (camera_gt, depth_gt) combos to warm.

        Returns the keys (exec key + batch size) newly served, in order.
        """
        H, W = hw
        before = set(self._served)
        sizes: List[int] = []
        for S in frame_counts:
            Sb = self._bucket(S)
            if Sb not in sizes:
                sizes.append(Sb)  # exact-fit (unmasked) forward
            # the masked forward only exists for buckets that can
            # receive a smaller S (e.g. bucket 2 over buckets (1, 2) can't:
            # S=1 routes to bucket 1)
            if (include_masked and self.pad_mode == "bucket" and Sb > 1
                    and self._bucket(Sb - 1) == Sb and Sb - 1 not in sizes):
                sizes.append(Sb - 1)
        for camera_gt, depth_gt in modalities:
            for S in sizes:
                req = self._dummy_request(S, H, W, bool(camera_gt), bool(depth_gt))
                for B in batch_sizes:
                    if B <= 1:
                        self.infer(**req)
                    else:
                        self.infer_batch([dict(req) for _ in range(B)],
                                         max_batch=B)
        return [k for k in self._served if k not in before]


class Batcher:
    """Coalesces concurrent requests into batched forwards.

    Requests arriving within `window_ms` of each other that share a
    key (frame count, resolution, modality layout) are stacked
    along the batch axis and served by one forward.
    `submit()` blocks the calling thread until its scene's result is ready.
    """

    def __init__(self, session: InferenceSession, max_batch: int = 8,
                 window_ms: float = 4.0):
        self.session = session
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self._cv = threading.Condition()
        self._pending: Dict[tuple, List[dict]] = {}  # key -> [entry]
        self._ids = itertools.count()  # request ids, for the queue spans
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, timeout: Optional[float] = None,
               **request) -> Dict[str, np.ndarray]:
        """Block until this scene's result is ready, or `timeout` seconds
        elapse: a wedged device dispatch must deliver InferenceTimeout, not
        block the caller for good. A request still queued at the deadline is
        withdrawn; one already dispatched is abandoned (its result is
        dropped)."""
        prepared = self.session._prepare(**request)
        entry = {
            "req": prepared,
            "event": threading.Event(),
            "result": None,
            "error": None,
            "t": time.monotonic(),
            "id": next(self._ids),
            "t_ns": time.time_ns(),
        }
        with self._cv:
            self._pending.setdefault(prepared["key"], []).append(entry)
            self._cv.notify()
        if not entry["event"].wait(timeout):
            with self._cv:
                pend = self._pending.get(prepared["key"])
                if pend is not None and entry in pend:
                    pend.remove(entry)  # never dispatched: withdraw
                    if not pend:
                        del self._pending[prepared["key"]]
            # the dispatch may have completed between the wait timing out
            # and the lock being taken — deliver the result if so
            if not entry["event"].is_set():
                raise InferenceTimeout(
                    f"batched inference exceeded the {timeout:.1f}s deadline "
                    "(device backend wedged or queue saturated)"
                )
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"]

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)

    def _take_group(self) -> Optional[List[dict]]:
        """Wait for the next group to dispatch; None once closed and
        drained."""
        with self._cv:
            while True:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop and not self._pending:
                    return None
                # a FULL group dispatches immediately regardless of age —
                # waiting on the oldest key's window would starve it
                key = next(
                    (k for k, v in self._pending.items()
                     if len(v) >= self.max_batch),
                    None,
                )
                if key is None:
                    # otherwise serve the key whose oldest request has waited
                    # longest, once its window has elapsed
                    key = min(
                        self._pending,
                        key=lambda k: self._pending[k][0]["t"],
                    )
                    age = time.monotonic() - self._pending[key][0]["t"]
                    if age < self.window:
                        self._cv.wait(timeout=self.window - age)
                        continue
                entries = self._pending[key]
                group = entries[: self.max_batch]
                del entries[: self.max_batch]
                if not entries:
                    del self._pending[key]
                for e in group:
                    record_since("serve.queue", e["t_ns"], request=e["id"])
                return group

    def _loop(self):
        while True:
            with span("serve.batch_wait"):
                group = self._take_group()
            if group is None:
                return
            try:
                outs = self.session._execute([e["req"] for e in group])
                for e, out in zip(group, outs):
                    e["result"] = out
            except Exception as err:  # noqa: BLE001 — delivered to callers
                for e in group:
                    e["error"] = err
            for e in group:
                e["event"].set()


def _glb_from_preds(preds: Dict[str, np.ndarray], H: int, W: int,
                    **glb_kwargs) -> bytes:
    """predictions -> binary GLB (the inference CLI's --save_glb pipeline)."""
    from omnivggt_tpu_torch.utils.geometry import (
        pose_encoding_to_extri_intri, unproject_depth_map_to_point_map,
    )
    from omnivggt_tpu_torch.viz.glb import predictions_to_glb_data, write_glb

    extrinsic, intrinsic = pose_encoding_to_extri_intri(
        torch.from_numpy(np.asarray(preds["pose_enc"]))[None], (H, W)
    )
    p = dict(preds)
    p["extrinsic"] = extrinsic[0].numpy()
    p["intrinsic"] = intrinsic[0].numpy()
    # unproject the depth only when the export mode uses it (mirrors
    # predictions_to_glb_data's branch)
    mode = glb_kwargs.get("prediction_mode", "Predicted Pointmap")
    if not ("Pointmap" in mode and "world_points" in p):
        p["world_points_from_depth"] = unproject_depth_map_to_point_map(
            p["depth"], p["extrinsic"], p["intrinsic"]
        )
    points, colors, cam_meshes = predictions_to_glb_data(p, **glb_kwargs)
    buf = io.BytesIO()
    write_glb(buf, points, colors, cam_meshes)
    return buf.getvalue()


def serve(session: InferenceSession, port: int = 8000, background: bool = False,
          token: Optional[str] = None, batch_window_ms: float = 0.0,
          max_batch: int = 8, request_timeout_s: Optional[float] = None,
          probe: Optional[BackendProbe] = None,
          warmup_frame_counts: Optional[Sequence[int]] = None,
          warmup_hw: tuple = (518, 518)):
    """POST /infer (npz body) -> npz predictions; POST /infer_glb -> binary
    GLB; GET /healthz -> JSON with a deadline-bounded device-liveness
    verdict. `token` enables bearer auth;
    `batch_window_ms` > 0 coalesces concurrent compatible requests into
    batched forwards (see Batcher); `request_timeout_s` bounds every
    inference dispatch, and a wedged device returns 503 instead of hanging
    the connection. `warmup_frame_counts` runs those buckets at `warmup_hw`
    before traffic is accepted. The port binds and `/healthz` answers before
    warmup runs: it reports `{"status": "warming", "ready": false}` (200)
    until warmup finishes, and inference POSTs get 503 meanwhile. TF32 is
    turned off for the process (utils/platform.ensure_platform)."""
    from omnivggt_tpu_torch.utils.platform import ensure_platform

    ensure_platform(session.device)
    warming = {"active": bool(warmup_frame_counts)}
    batcher = (
        Batcher(session, max_batch=max_batch, window_ms=batch_window_ms)
        if batch_window_ms > 0
        else None
    )
    probe = probe if probe is not None else BackendProbe(device=session.device)

    def run_infer(**kwargs):
        if batcher is not None:
            return batcher.submit(timeout=request_timeout_s, **kwargs)
        return _call_with_deadline(session.infer, request_timeout_s, **kwargs)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype, extra=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _authed(self) -> bool:
            if token is None:
                return True
            import hmac

            if hmac.compare_digest(
                self.headers.get("Authorization", ""), f"Bearer {token}"
            ):
                return True
            self._send(
                401, b'{"error": "unauthorized"}', "application/json"
            )
            return False

        def do_GET(self):
            if self.path.rstrip("/") == "/healthz" or self.path == "/":
                with session._lock:  # _execute inserts concurrently
                    compiled = [str(k) for k in session._served]
                if warming["active"]:
                    # the device is held by the warmup forwards: a liveness
                    # probe now could time out and misreport "wedged";
                    # report alive but not ready instead
                    body = json.dumps(
                        {"status": "warming", "ready": False,
                         "buckets": session.buckets,
                         "batching": batcher is not None,
                         "request_timeout_s": request_timeout_s,
                         "compiled": compiled}
                    ).encode()
                    self._send(200, body, "application/json")
                    return
                liveness = probe.status()
                body = json.dumps(
                    {"status": "ok" if liveness["backend"] != "wedged"
                     else "degraded",
                     "ready": liveness["backend"] != "wedged",
                     "buckets": session.buckets,
                     "batching": batcher is not None,
                     "request_timeout_s": request_timeout_s,
                     "compiled": compiled,
                     **liveness}
                ).encode()
                code = 200 if liveness["backend"] != "wedged" else 503
                self._send(code, body, "application/json")
            else:
                self._send(404, b"{}", "application/json")

        def do_POST(self):
            route = self.path.rstrip("/")
            if route not in ("/infer", "/infer_glb"):
                self._send(404, b"{}", "application/json")
                return
            if not self._authed():
                return
            if warming["active"]:
                # do not queue traffic behind the warmup forwards
                self._send(
                    503, b'{"error": "warming up"}', "application/json",
                    {"Retry-After": "30"},
                )
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                data = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                kwargs = {k: data[k] for k in data.files}
                for idx_key in ("camera_gt_index", "depth_gt_index"):
                    if idx_key in kwargs:
                        kwargs[idx_key] = [int(i) for i in kwargs[idx_key]]
                glb_kwargs = {}
                if route == "/infer_glb":
                    for gk, cast in (
                        ("conf_thres", float), ("mask_black_bg", bool),
                        ("mask_white_bg", bool), ("prediction_mode", str),
                    ):
                        if gk in kwargs:
                            glb_kwargs[gk] = cast(kwargs.pop(gk))
                t0 = time.time()
                preds = run_infer(**kwargs)
                dt = time.time() - t0
                hdr = {"X-Inference-Seconds": f"{dt:.3f}"}
                if route == "/infer_glb":
                    H, W = np.asarray(kwargs["images"]).shape[1:3]
                    body = _glb_from_preds(preds, H, W, **glb_kwargs)
                    self._send(200, body, "model/gltf-binary", hdr)
                else:
                    buf = io.BytesIO()
                    # the client's own images are not echoed back
                    np.savez(buf, **{k: v for k, v in preds.items() if k != "images"})
                    self._send(200, buf.getvalue(), "application/octet-stream", hdr)
            except Exception as e:  # noqa: BLE001 — report to the client
                body = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                code = 503 if isinstance(e, InferenceTimeout) else 400
                self._send(code, body, "application/json")

        def log_message(self, *a):
            pass

    ThreadingTCPServer.allow_reuse_address = True  # survive TIME_WAIT restarts
    httpd = ThreadingTCPServer(("0.0.0.0", port), Handler)
    httpd.daemon_threads = True
    # bind and serve /healthz before warmup, so startup probes see the
    # process alive while it warms
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    print(
        f"inference server on :{httpd.server_address[1]} "
        "(POST /infer, POST /infer_glb, GET /healthz)"
    )
    if warmup_frame_counts:
        t0 = time.time()
        keys = session.warmup(frame_counts=warmup_frame_counts, hw=warmup_hw)
        print(
            f"warmup: {len(keys)} forwards run in {time.time() - t0:.1f}s"
        )
        warming["active"] = False
    if background:
        return httpd, t
    try:
        while t.is_alive():
            t.join(timeout=1.0)
    except KeyboardInterrupt:
        httpd.shutdown()
    return httpd, None
