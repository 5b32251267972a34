"""Texture-generation service: a job queue and an HTTP API over the
pipeline (port of unitex_tpu/serving.py).

A long-lived server loads the weights once and serves (image, mesh) ->
textured-GLB jobs over a stdlib HTTP API.  Two worker threads: a
preprocess thread runs job N+1's host work (mesh normalize, decimate and
unwrap, and the matting where it runs on the host) while the device
thread runs job N's conditioning, diffusion and bake.  Exactly one thread
touches the card: where the pipeline's matting model sits on the card
(``pipeline.rembg.device``), the reference image is matted on the device
thread instead.  With the pipeline's ``async_io`` a job is marked done
from the pipeline's writer thread, once its files are written.

Across GPUs (a pipeline on a mesh, under ``torchrun``): rank 0 keeps the
HTTP front end, the preprocess thread and the job records; every other
rank runs the pipeline's ``follow()``, with no HTTP.  The pipeline
announces each device job rank 0's device thread runs (a job or the
prewarm) to the followers, which run their part in step; a job whose
part on rank 0 fails at a host-side point ends for them too, and the next
job starts in step (``pipeline.py``'s module docstring).  ``stop()``
releases the followers (``release_followers()``).

API (JSON unless noted):
  POST /jobs                submit {"image_b64"|"image_path", "mesh_b64"+
                            "mesh_ext"|"mesh_path", "name"?, "export_video"?}
  GET  /jobs                all job records
  GET  /jobs/<id>           one job record (status: queued | preprocessing |
                            generating | done | failed)
  GET  /jobs/<id>/result    textured_mesh.glb bytes
  GET  /jobs/<id>/rembg     rembg_image.png bytes
  GET  /healthz             liveness + queue depth
"""

from __future__ import annotations

import base64
import json
import os
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

MESH_EXTS = (".glb", ".obj", ".ply")


class TextureJobServer:
    """Owns the pipeline, the job store, and the two worker threads."""

    def __init__(
        self,
        pipeline,
        work_dir: str,
        prefetch: bool = True,
        prewarm: bool = False,
    ):
        self.pipeline = pipeline
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.jobs: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._q_pre: queue.Queue = queue.Queue()
        self._q_dev: queue.Queue = queue.Queue()
        self._prefetch = prefetch
        self.prewarm_timings: Optional[Dict[str, float]] = None
        if prewarm:
            # every device stage once on the device thread before the first
            # job, overlapping the first job's host preprocessing
            self._q_dev.put(("__prewarm__", None))
        self._threads = [
            threading.Thread(target=self._pre_worker, daemon=True),
            threading.Thread(target=self._dev_worker, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ submit

    def submit(
        self,
        image_path: str,
        mesh_path: str,
        name: Optional[str] = None,
        export_video: bool = False,
    ) -> str:
        job_id = uuid.uuid4().hex[:12]
        return self._enqueue(job_id, image_path, mesh_path, name, export_video,
                             os.path.join(self.work_dir, job_id))

    def submit_request(self, body: dict) -> str:
        """Handle a POST /jobs payload: either server-local paths or
        base64-inlined bytes (written under the job's directory)."""
        job_id = uuid.uuid4().hex[:12]
        out_dir = os.path.join(self.work_dir, job_id)
        os.makedirs(out_dir, exist_ok=True)

        if "image_b64" in body:
            image_path = os.path.join(out_dir, "input_image.png")
            with open(image_path, "wb") as f:
                f.write(base64.b64decode(body["image_b64"]))
        else:
            image_path = body["image_path"]
        if "mesh_b64" in body:
            ext = body.get("mesh_ext", ".glb").lower()
            if ext not in MESH_EXTS:
                raise ValueError(f"mesh_ext must be one of {MESH_EXTS}")
            mesh_path = os.path.join(out_dir, "input_mesh" + ext)
            with open(mesh_path, "wb") as f:
                f.write(base64.b64decode(body["mesh_b64"]))
        else:
            mesh_path = body["mesh_path"]
        return self._enqueue(job_id, image_path, mesh_path, body.get("name"),
                             body.get("export_video", False), out_dir)

    def _enqueue(self, job_id, image_path, mesh_path, name, export_video,
                 out_dir) -> str:
        job = {
            "id": job_id,
            "name": name or job_id,
            "status": "queued",
            "submitted": time.time(),
            "image": image_path,
            "mesh": mesh_path,
            "export_video": bool(export_video),
            "out_dir": out_dir,
        }
        with self._lock:
            self.jobs[job_id] = job
        self._q_pre.put(job_id)
        return job_id

    # ------------------------------------------------------------ status

    def public_record(self, job_id: str) -> Optional[dict]:
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None:
                return None
            rec = {k: job[k] for k in ("id", "name", "status", "submitted",
                                       "export_video")}
            for k in ("started", "finished", "error", "preprocess_s", "device_s"):
                if k in job:
                    rec[k] = job[k]
            return rec

    def queue_depth(self) -> int:
        with self._lock:
            return sum(
                1 for j in self.jobs.values()
                if j["status"] in ("queued", "preprocessing", "generating")
            )

    def artifact_path(self, job_id: str, artifact: str) -> Optional[str]:
        with self._lock:
            job = self.jobs.get(job_id)
        if job is None or job["status"] != "done":
            return None
        path = job.get(artifact)
        return path if path and os.path.exists(path) else None

    # ------------------------------------------------------------ workers

    def _set(self, job_id: str, **fields) -> dict:
        with self._lock:
            self.jobs[job_id].update(fields)
            return dict(self.jobs[job_id])

    def _matting_on_device(self) -> bool:
        return self.pipeline.rembg.device.type != "cpu"

    def _pre_worker(self) -> None:
        while True:
            job_id = self._q_pre.get()
            if job_id is None:
                self._q_dev.put(None)
                return
            job = self._set(job_id, status="preprocessing", started=time.time())
            pre = None
            if self._prefetch:
                t0 = time.perf_counter()
                try:
                    if self._matting_on_device():
                        cache = os.path.join(job["out_dir"], "cache")
                        os.makedirs(cache, exist_ok=True)
                        pre = (self.pipeline.preprocess_blank_mesh_stage(
                            cache, job["mesh"]), None)
                    else:
                        pre = self.pipeline.preprocess_job(
                            job["out_dir"], job["image"], job["mesh"])
                    self._set(job_id, preprocess_s=time.perf_counter() - t0)
                except Exception as e:  # noqa: BLE001 -- job-level isolation
                    self._set(job_id, status="failed", error=str(e),
                              finished=time.time())
                    continue
            self._q_dev.put((job_id, pre))

    def _dev_worker(self) -> None:
        while True:
            item = self._q_dev.get()
            if item is None:
                if getattr(self.pipeline, "device_mesh", None) is not None:
                    self.pipeline.release_followers()
                return
            job_id, pre = item
            if job_id == "__prewarm__":
                try:
                    self.prewarm_timings = self.pipeline.prewarm()
                    print(f"[server] prewarm done: {self.prewarm_timings}")
                except Exception as e:  # noqa: BLE001 -- warm-up best effort
                    print(f"[server] prewarm failed: {e}")
                continue
            job = self._set(job_id, status="generating")
            t0 = time.perf_counter()
            try:
                if pre is not None and pre[1] is None:
                    # the matting model is on the card: matte here
                    pre = (pre[0], self.pipeline.preprocess_reference_image_stage(
                        os.path.join(job["out_dir"], "cache"), job["image"]))
                rembg, glb = self.pipeline(
                    job["out_dir"], job["image"], job["mesh"],
                    export_video=job["export_video"], preprocessed=pre,
                )
            except Exception as e:  # noqa: BLE001 -- job-level isolation
                self._set(job_id, status="failed", error=str(e),
                          finished=time.time())
                continue
            # behind the job's writes on the pipeline's writer thread (at
            # once without async_io)
            self.pipeline._submit_io(self._finish, job_id,
                                     time.perf_counter() - t0, glb, rembg)

    def _finish(self, job_id: str, device_s: float, glb: str, rembg: str) -> None:
        if not os.path.exists(glb):
            self._set(job_id, status="failed", finished=time.time(),
                      error=f"no GLB at {glb}")
            return
        self._set(job_id, status="done", finished=time.time(),
                  device_s=device_s, result=glb, rembg=rembg)

    def stop(self) -> None:
        """End the workers after the queued jobs (on a mesh the device
        thread then releases the followers) and wait for them, so the
        caller's next collective cannot cross theirs."""
        self._q_pre.put(None)
        for t in self._threads:
            t.join()


# ---------------------------------------------------------------- HTTP


def make_handler(server: TextureJobServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _file(self, path, ctype):
            with open(path, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            if parts == ["healthz"]:
                return self._json({"ok": True, "queue_depth": server.queue_depth()})
            if parts == ["jobs"]:
                with server._lock:
                    ids = list(server.jobs)
                return self._json([server.public_record(i) for i in ids])
            if len(parts) == 2 and parts[0] == "jobs":
                rec = server.public_record(parts[1])
                if rec is None:
                    return self._json({"error": "unknown job"}, 404)
                return self._json(rec)
            if len(parts) == 3 and parts[0] == "jobs":
                art = {"result": ("result", "model/gltf-binary"),
                       "rembg": ("rembg", "image/png")}.get(parts[2])
                if art is None:
                    return self._json({"error": "unknown artifact"}, 404)
                path = server.artifact_path(parts[1], art[0])
                if path is None:
                    rec = server.public_record(parts[1])
                    status = 404 if rec is None else 409
                    return self._json({"error": "not ready", "job": rec}, status)
                return self._file(path, art[1])
            return self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path.rstrip("/") != "/jobs":
                return self._json({"error": "not found"}, 404)
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                job_id = server.submit_request(body)
            except Exception as e:  # noqa: BLE001 -- bad request isolation
                return self._json({"error": str(e)}, 400)
            return self._json({"id": job_id, "status": "queued"}, 202)

    return Handler


def serve(
    pipeline,
    work_dir: str,
    port: int = 8080,
    host: str = "127.0.0.1",
    prefetch: bool = True,
    prewarm: bool = False,
) -> ThreadingHTTPServer:
    """Build the job server and its HTTP front end.  Returns the (not yet
    serving) ``ThreadingHTTPServer``; call ``serve_forever`` (or run it in
    a thread).  ``httpd.jobs`` is the :class:`TextureJobServer`."""
    jobs = TextureJobServer(pipeline, work_dir, prefetch=prefetch,
                            prewarm=prewarm)
    httpd = ThreadingHTTPServer((host, port), make_handler(jobs))
    httpd.jobs = jobs
    return httpd
