"""The remote-viewer bridge: camera requests and frames over TCP.

Port of ``aip_tpu/gs/network_gui.py`` (reference
``gaussian_renderer/network_gui.py:26-86``), stdlib and numpy only. The
viewer sends a length-prefixed JSON camera (view and projection matrices,
resolution, field of view, train and keep-alive flags, scaling modifier);
the trainer answers with the frame's raw HWC uint8 bytes, then a 4-byte
little-endian length and the ASCII verify string. ``gs.train.train`` polls
it without blocking once a loop pass.
"""

from __future__ import annotations

import json
import socket

import numpy as np

from aip_tpu_torch.gs.cameras import MiniCam


class NetworkGUI:
    """A non-blocking listener on ``host:port`` (port 0 picks a free one)
    with at most one viewer connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host = host
        self.port = port
        self.conn = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self) -> None:
        """Accept a waiting viewer, if there is one and none is connected."""
        if self.conn is not None:
            return
        try:
            self.conn, _addr = self.listener.accept()
            self.conn.settimeout(None)
        except (BlockingIOError, OSError):
            pass

    def _read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def receive(self):
        """Read one request. Returns (MiniCam, do_training, keep_alive,
        scaling_modifier), or four Nones at resolution 0. The view
        matrix's columns 1 and 2 and the projection's column 1 change sign
        (the viewer's axes to the renderer's)."""
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None
        view = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        view[:, 1] *= -1
        view[:, 2] *= -1
        proj = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        proj[:, 1] *= -1
        cam = MiniCam(
            image_width=width, image_height=height,
            FoVy=msg["fov_y"], FoVx=msg["fov_x"],
            znear=msg["z_near"], zfar=msg["z_far"],
            world_view_transform=view, full_proj_transform=proj,
        )
        return cam, bool(msg["train"]), bool(msg["keep_alive"]), msg["scaling_modifier"]

    def send(self, image_rgb_u8: np.ndarray | None, verify: str) -> None:
        """Send a frame (HWC uint8 on the host, or None) and the verify string."""
        if image_rgb_u8 is not None:
            self.conn.sendall(np.ascontiguousarray(image_rgb_u8).tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def disconnect(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.disconnect()
        self.listener.close()
