"""Nearest-neighbors REST server + client.
Counterpart of `deeplearning4j_tpu/clustering/server.py`: host numpy, no
device.

Reference: `deeplearning4j-nearestneighbor-server/
server/NearestNeighborsServer.java:44` (Play router :191) — REST over a
VPTree with base64 NDArray DTOs. Here: stdlib http.server (the embedded
web server role Play fills in the reference) with JSON bodies:

POST /knn        {"index": i, "k": n}             → neighbors of a stored point
POST /knnnew     {"vector": [...], "k": n}        → neighbors of a new vector
GET  /healthz                                      → {"status": "ok"}
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib import request as urlrequest

import numpy as np

from deeplearning4j_tpu_torch.clustering.vptree import VPTree


def _decode_vector(payload) -> np.ndarray:
    """Accepts a JSON list or the reference's base64-float32 DTO."""
    if isinstance(payload, list):
        return np.asarray(payload, np.float32)
    if isinstance(payload, str):
        raw = base64.b64decode(payload)
        return np.frombuffer(raw, np.float32).copy()
    raise ValueError("vector must be a list or base64 string")


class NearestNeighborsServer:
    def __init__(self, points: np.ndarray, port: int = 0,
                 distance: str = "euclidean"):
        self.points = np.asarray(points, np.float32)
        self.tree = VPTree(self.points, distance=distance)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok"})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    k = int(req.get("k", 5))
                    if self.path == "/knn":
                        idx = int(req["index"])
                        vec = outer.points[idx]
                    elif self.path == "/knnnew":
                        vec = _decode_vector(req["vector"])
                    else:
                        self._json(404, {"error": "not found"})
                        return
                    indices, dists = outer.tree.knn(vec, k)
                    self._json(200, {"results": [
                        {"index": int(i), "distance": float(d)}
                        for i, d in zip(indices, dists)]})
                except Exception as e:  # noqa: BLE001 — server boundary
                    self._json(400, {"error": str(e)})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


class NearestNeighborsClient:
    """Reference `deeplearning4j-nearestneighbors-client` equivalent."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")

    def _post(self, path: str, payload: dict):
        req = urlrequest.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urlrequest.urlopen(req) as resp:  # noqa: S310 — localhost
            return json.loads(resp.read())

    def knn(self, index: int, k: int):
        return self._post("/knn", {"index": index, "k": k})

    def knn_new(self, vector, k: int):
        vec = np.asarray(vector, np.float32)
        payload = base64.b64encode(vec.tobytes()).decode()
        return self._post("/knnnew", {"vector": payload, "k": k})
