"""SIBR-compatible network GUI: live-view protocol server.

Port of `wast3d_tpu/viewer/network_gui.py`, wire-compatible with the
reference's viewer hook, so the stock SIBR remote viewer connects
unmodified:

- TCP listener; each message is a 4-byte little-endian length + JSON with
  resolution, fovs, znear/zfar, train/keep_alive flags, scaling modifier,
  and row-major view / view-projection matrices (columns 1, 2 of the view
  and column 1 of the view-projection are sign-flipped on receipt, the
  reference's GL-convention fixup).
- The reply is raw RGB bytes (H*W*3, uint8) followed by a length-prefixed
  verification string (the model path); a message at resolution 0 is a
  keep-alive and gets the verification string alone.

The server runs on a background thread with a thread-safe `pending()` /
`submit_frame()` exchange: the Trainer polls `pending()` once per iteration
(`Trainer._pre_step`, before the step) and renders at most one frame,
through K1 with the training settings (`serve_scene`).
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Optional

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device


class GuiCamera:
    """Parsed viewer request (the reference's MiniCam payload)."""

    def __init__(self, msg):
        self.width = msg["resolution_x"]
        self.height = msg["resolution_y"]
        self.fovy = msg["fov_y"]
        self.fovx = msg["fov_x"]
        self.znear = msg["z_near"]
        self.zfar = msg["z_far"]
        self.do_training = bool(msg.get("train", True))
        self.shs_python = bool(msg.get("shs_python", False))
        self.rot_scale_python = bool(msg.get("rot_scale_python", False))
        self.keep_alive = bool(msg.get("keep_alive", True))
        self.scaling_modifier = msg.get("scaling_modifier", 1.0)
        view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        view[:, 1] = -view[:, 1]
        view[:, 2] = -view[:, 2]
        proj = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        proj[:, 1] = -proj[:, 1]
        self.view_transform = view
        self.full_proj_transform = proj
        cam_center = np.linalg.inv(view)[3, :3]
        self.camera_center = cam_center


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 verify: str = ""):
        self.host = host
        self.port = port
        self.verify = verify
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen()
        self._listener.settimeout(0.2)
        self._conn: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._request: Optional[GuiCamera] = None
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # ---- protocol ------------------------------------------------------
    def _read_msg(self, conn):
        hdr = conn.recv(4)
        if len(hdr) < 4:
            raise ConnectionError("closed")
        length = int.from_bytes(hdr, "little")
        buf = b""
        while len(buf) < length:
            chunk = conn.recv(length - len(buf))
            if not chunk:
                raise ConnectionError("closed")
            buf += chunk
        return json.loads(buf.decode("utf-8"))

    def _serve(self):
        while self._running:
            if self._conn is None:
                try:
                    conn, addr = self._listener.accept()
                    conn.settimeout(5.0)
                    self._conn = conn
                except (socket.timeout, OSError):
                    continue
            try:
                msg = self._read_msg(self._conn)
                if msg["resolution_x"] == 0 or msg["resolution_y"] == 0:
                    self._send_frame(None)
                    continue
                # The frame is produced by the training loop via pending()/
                # submit_frame; create the event BEFORE exposing the request
                # so submit_frame always finds it.
                self._frame_ready = threading.Event()
                with self._lock:
                    self._request = GuiCamera(msg)
                self._frame_ready.wait(timeout=10.0)
            except (ConnectionError, socket.timeout, OSError, json.JSONDecodeError):
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None

    def _send_frame(self, rgb_bytes: Optional[bytes]):
        conn = self._conn
        if conn is None:
            return
        try:
            if rgb_bytes is not None:
                conn.sendall(rgb_bytes)
            conn.sendall(len(self.verify).to_bytes(4, "little"))
            conn.sendall(self.verify.encode("ascii"))
        except OSError:
            self._conn = None

    # ---- training-loop interface --------------------------------------
    def pending(self) -> Optional[GuiCamera]:
        """The camera the viewer wants rendered, if any."""
        with self._lock:
            req = self._request
            self._request = None
        return req

    def submit_frame(self, image: np.ndarray) -> None:
        """image: [H,W,3] float in [0,1]."""
        rgb = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
        self._send_frame(rgb.tobytes())
        ev = getattr(self, "_frame_ready", None)
        if ev is not None:
            ev.set()

    def stop(self):
        self._running = False
        try:
            self._listener.close()
        except OSError:
            pass


def maybe_start(host: str, port: int, verify: str = "") -> Optional[NetworkGUI]:
    try:
        return NetworkGUI(host, port, verify)
    except OSError as e:
        print(f"network_gui disabled ({e})")
        return None


def serve_scene(gui: NetworkGUI, scene, settings=None, bg_color=None,
                device: DeviceLike = None) -> None:
    """Render one pending GUI request against `scene` on `device` (call per
    iteration, like the reference's in-loop poll): the port's `Camera` from
    the request's matrices, rendered with `settings`, submitted as uint8."""
    from wast3d_tpu_torch.core.camera import Camera
    from wast3d_tpu_torch.ops.rasterizer import api as raster_api

    req = gui.pending()
    if req is None:
        return
    dev = resolve_device(device)
    cam = Camera(
        view_transform=torch.from_numpy(req.view_transform).to(dev),
        full_proj_transform=torch.from_numpy(req.full_proj_transform).to(dev),
        camera_center=torch.from_numpy(np.asarray(req.camera_center, np.float32)).to(dev),
        fovx=float(req.fovx),
        fovy=float(req.fovy),
        znear=float(req.znear),
        zfar=float(req.zfar),
        width=int(req.width),
        height=int(req.height),
    )
    with torch.no_grad():
        out = raster_api.render(
            cam, scene, bg_color if bg_color is not None else torch.zeros(3),
            scaling_modifier=req.scaling_modifier,
            settings=settings or raster_api.RasterizeSettings(), device=dev)
        gui.submit_frame(out["render"].cpu().numpy())
