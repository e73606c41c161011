"""The port's viewers (`wast3d_tpu_torch/viewer/`, `cli.view`, the live
view of `cli.train --port`) against the JAX package's on the CPU.

The SIBR protocol: `GuiCamera` of JAX's canonical request
(`tests/test_sibr_protocol.py`) equals JAX's bit for bit; JAX's byte-level
transcript runs against the port's `NetworkGUI`; the port's `serve_scene`
replies within 2/255 of JAX's (both plain renderers) to the same request.
The web viewer: `orbit_camera` within 1e-6 of JAX's, `render_orbit_frame`
within 2/255 of JAX's, and an HTTP round trip (`/`, `/info`, a `/frame` PNG
that PIL and the port's decoder read alike, a 404). nerfstudio: the camera
conversion and intrinsics within 1e-6, `depth_to_normals` within 1e-5 of
JAX on its tilted plane, `render_viewer_outputs` within 1e-5 of JAX's, and
the gated import. Training: `train_scene(gui=...)` answers a client's
request with a framed reply; `cli.train --port <busy>` trains on.

Every socket and HTTP wait has its own timeout of at most 10 s; ports are
free ones (bound to 0).
"""

import io
import json
import socket
import struct
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam, _random_scene
from tests.test_sibr_protocol import REQUEST
from tests.test_torch_scene import port_scene
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.viewer import nerfstudio_shim as jshim
from wast3d_tpu.viewer import network_gui as jgui
from wast3d_tpu.viewer import web as jweb
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.utils import png
from wast3d_tpu_torch.viewer import nerfstudio_shim as tshim
from wast3d_tpu_torch.viewer import network_gui as tgui
from wast3d_tpu_torch.viewer import web as tweb

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 10.0
JTILED = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 13, max_per_tile=256,
                                chunk=16)
TTILED = tapi.RasterizeSettings(renderer="tiled")
FRAME_TOL = 2  # uint8 units: 2/255


def _frame(msg: dict) -> bytes:
    body = json.dumps(msg).encode("utf-8")
    return len(body).to_bytes(4, "little") + body


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


def _reply(sock, w, h):
    rgb = _recv_exact(sock, w * h * 3) if w else None
    vlen = struct.unpack("<I", _recv_exact(sock, 4))[0]
    return rgb, _recv_exact(sock, vlen).decode("ascii")


def _wait_pending(gui, timeout=TIMEOUT):
    t0 = time.time()
    while time.time() - t0 < timeout:
        req = gui.pending()
        if req is not None:
            return req
        time.sleep(0.01)
    return None


def _request_for(cam, w, h):
    """A SIBR request for a JAX camera: its matrices in the viewer's GL
    convention (the server flips them back)."""
    view = np.array(cam.view_transform, np.float32)
    proj = np.array(cam.full_proj_transform, np.float32)
    view[:, 1:3] *= -1
    proj[:, 1] *= -1
    return dict(REQUEST, resolution_x=w, resolution_y=h, fov_x=float(cam.fovx),
                fov_y=float(cam.fovy), view_matrix=view.reshape(-1).tolist(),
                view_projection_matrix=proj.reshape(-1).tolist())


# ---- SIBR protocol -------------------------------------------------------------

def test_gui_camera_equals_jaxs_bit_for_bit():
    a, b = tgui.GuiCamera(REQUEST), jgui.GuiCamera(REQUEST)
    for f in ("view_transform", "full_proj_transform", "camera_center"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("width", "height", "fovx", "fovy", "znear", "zfar", "do_training",
              "shs_python", "rot_scale_python", "keep_alive", "scaling_modifier"):
        assert getattr(a, f) == getattr(b, f), f


def test_wire_transcript_byte_exact():
    """JAX's byte-level transcript (`test_sibr_protocol.py`) against the
    port's server."""
    gui = tgui.NetworkGUI(host="127.0.0.1", port=0, verify="/models/golden")
    try:
        port = gui._listener.getsockname()[1]
        with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as client:
            client.settimeout(TIMEOUT)
            client.sendall(_frame(REQUEST))
            req = _wait_pending(gui)
            assert req is not None and (req.width, req.height) == (8, 6)
            img = np.linspace(0, 1, 8 * 6 * 3, dtype=np.float32).reshape(6, 8, 3)
            gui.submit_frame(img)
            rgb = _recv_exact(client, 6 * 8 * 3)
            assert rgb == (np.clip(img, 0, 1) * 255).astype(np.uint8).tobytes()
            vlen = struct.unpack("<I", _recv_exact(client, 4))[0]
            assert vlen == len("/models/golden")
            assert _recv_exact(client, vlen) == b"/models/golden"
            client.sendall(_frame(dict(REQUEST, resolution_x=0, resolution_y=0)))
            vlen2 = struct.unpack("<I", _recv_exact(client, 4))[0]
            assert _recv_exact(client, vlen2) == b"/models/golden"
    finally:
        gui.stop()


def _serve_once(mod, gui_cls, scene, req, w, h, **kw):
    gui = gui_cls(host="127.0.0.1", port=0, verify="v")
    try:
        port = gui._listener.getsockname()[1]
        with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as client:
            client.settimeout(TIMEOUT)
            client.sendall(_frame(req))
            deadline = time.time() + TIMEOUT
            while gui._request is None and time.time() < deadline:
                time.sleep(0.01)
            mod.serve_scene(gui, scene, **kw)
            rgb, verify = _reply(client, w, h)
    finally:
        gui.stop()
    assert verify == "v"
    return np.frombuffer(rgb, np.uint8).reshape(h, w, 3).astype(np.int32)


def test_serve_scene_replies_like_jaxs():
    w, h = 48, 32
    js = _random_scene(n=120, seed=5)
    req = _request_for(_cam(w=w, h=h), w, h)
    want = _serve_once(jgui, jgui.NetworkGUI, js, req, w, h, settings=JTILED,
                       bg_color=jnp.zeros(3))
    got = _serve_once(tgui, tgui.NetworkGUI, port_scene(js), req, w, h, settings=TTILED,
                      bg_color=torch.zeros(3), device="cpu")
    assert want.max() > 0
    assert np.abs(got - want).max() <= FRAME_TOL


def test_maybe_start_on_a_busy_port_prints_and_returns_none(capsys):
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        assert tgui.maybe_start("127.0.0.1", busy.getsockname()[1]) is None
    assert "network_gui disabled" in capsys.readouterr().out


# ---- the web viewer ------------------------------------------------------------

@pytest.mark.parametrize("yaw,pitch,radius", [(0.7, 0.2, 5.0), (2.5, -0.4, 3.0)])
def test_orbit_camera_matches_jax(yaw, pitch, radius):
    a = tweb.orbit_camera(yaw, pitch, radius, 96, device="cpu")
    b = jweb.orbit_camera(yaw, pitch, radius, 96)
    for f in ("view_transform", "full_proj_transform", "camera_center"):
        np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)), atol=1e-6)
    assert (a.width, a.height) == (b.width, b.height)
    np.testing.assert_allclose([a.fovx, a.fovy], [float(b.fovx), float(b.fovy)], atol=1e-6)


def test_render_orbit_frame_matches_jax():
    js = _random_scene(n=150, seed=3)
    a = tweb.render_orbit_frame(port_scene(js), 0.3, 0.1, 4.0, 64, settings=TTILED,
                                device="cpu")
    b = jweb.render_orbit_frame(js, 0.3, 0.1, 4.0, 64, settings=JTILED)
    assert a.dtype == np.uint8 and a.shape == b.shape == (64, 64, 3) and b.max() > 0
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= FRAME_TOL


def test_http_round_trip():
    from PIL import Image

    scene = port_scene(_random_scene(n=40, seed=3))
    srv = tweb.serve_scene(scene, port=0, settings=TTILED, background=True, device="cpu")
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        page = urllib.request.urlopen(f"{base}/", timeout=TIMEOUT).read()
        assert b"/frame?" in page
        info = json.loads(urllib.request.urlopen(f"{base}/info", timeout=TIMEOUT).read())
        assert info == {"num_gaussians": 40}
        raw = urllib.request.urlopen(f"{base}/frame?yaw=0.3&pitch=0.1&radius=4&res=64",
                                     timeout=TIMEOUT).read()
        mine = png.decode_png(raw)
        assert mine.shape == (64, 64, 3)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(raw))), mine)
        assert np.array_equal(mine, tweb.render_orbit_frame(scene, 0.3, 0.1, 4.0, 64,
                                                            settings=TTILED, device="cpu"))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=TIMEOUT)
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()


def test_cli_view_flags_and_imports():
    from wast3d_tpu_torch.cli import view

    a = view.build_parser().parse_args(["-m", "x"])
    assert (a.iteration, a.port, a.renderer, a.fast, a.dup_capacity, a.device) == (
        -1, 8090, "pallas", True, 1 << 21, "cuda")
    assert view.build_parser().parse_args(["-m", "x", "--no-fast"]).fast is False
    code = ("import sys, wast3d_tpu_torch.cli.view, wast3d_tpu_torch.cli.convert, "
            "wast3d_tpu_torch.viewer.network_gui, wast3d_tpu_torch.viewer.nerfstudio_shim; "
            "print(sorted(m for m in ('jax', 'PIL', 'wast3d_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_cli_view_serves_a_saved_model(tmp_path):
    """`cli.view --device cpu` in a subprocess answers /info and a frame
    equal to `render_orbit_frame` of the same PLY."""
    from wast3d_tpu_torch.scene.ply import load_ply, save_ply

    js = _random_scene(n=60, seed=4)
    path = tmp_path / "point_cloud" / "iteration_3" / "point_cloud.ply"
    save_ply(port_scene(js), str(path))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "wast3d_tpu_torch.cli.view", "-m",
                             str(tmp_path), "--port", str(port), "--device", "cpu",
                             "--renderer", "tiled"], cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        info = None
        t0 = time.time()
        while info is None and time.time() - t0 < 60 and proc.poll() is None:
            try:
                info = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/info", timeout=TIMEOUT).read())
            except OSError:
                time.sleep(0.2)
        assert info == {"num_gaussians": 60}
        raw = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/frame?yaw=0.5&pitch=0.0&radius=4&res=64",
            timeout=TIMEOUT).read()
    finally:
        proc.terminate()
        proc.wait(TIMEOUT)
    want = tweb.render_orbit_frame(load_ply(str(path), device="cpu"), 0.5, 0.0, 4.0, 64,
                                   settings=tapi.RasterizeSettings(renderer="tiled",
                                                                   fast_chain=True),
                                   device="cpu")
    assert np.array_equal(png.decode_png(raw), want)


# ---- nerfstudio ----------------------------------------------------------------

def _c2w(seed=0):
    rng = np.random.default_rng(seed)
    u, _, vt = np.linalg.svd(rng.normal(size=(3, 3)))
    rot = u @ vt
    if np.linalg.det(rot) < 0:
        rot[:, 0] *= -1
    return np.concatenate([rot, rng.normal(size=(3, 1))], axis=1)


@pytest.mark.parametrize("orient", [False, True])
def test_ns_camera_and_intrinsics_match_jax(orient):
    flip = np.diag([1.0, -1.0, -1.0, 1.0]) if orient else None
    args = (_c2w(), 420.0, 400.0, 640, 480)
    a = tshim.ns_c2w_to_camera(*args, orientation_transform=flip, device="cpu")
    b = jshim.ns_c2w_to_camera(*args, orientation_transform=flip)
    for f in ("view_transform", "full_proj_transform", "camera_center"):
        np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)), atol=1e-6)
    np.testing.assert_allclose([a.fovx, a.fovy], [float(b.fovx), float(b.fovy)], atol=1e-6)
    np.testing.assert_allclose(tshim.camera_intrinsics(a).numpy(),
                               np.asarray(jshim.camera_intrinsics(b)), atol=1e-6)


def test_depth_to_normals_matches_jax_on_a_tilted_plane():
    H, W = 48, 64
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    a, b, c = 0.2, -0.1, 3.0
    uu = (np.arange(W)[None, :] - K[0, 2]) / K[0, 0]
    vv = (np.arange(H)[:, None] - K[1, 2]) / K[1, 1]
    depth = (c / (1.0 - a * uu - b * vv)).astype(np.float32)
    got = tshim.depth_to_normals(torch.from_numpy(depth), torch.from_numpy(K)).numpy()
    want = np.asarray(jshim.depth_to_normals(jnp.asarray(depth), jnp.asarray(K)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    expect = np.array([a, b, -1.0]) / np.linalg.norm([a, b, -1.0])
    assert np.all(np.abs(got[8:-8, 8:-8].reshape(-1, 3) @ expect) > 0.999)


def test_render_viewer_outputs_match_jax():
    js = _random_scene(n=60, seed=7)
    cam = _cam(w=64, h=48)
    from tests.test_torch_scene import port_cam

    got = tshim.render_viewer_outputs(port_scene(js), port_cam(w=64, h=48), [0, 0, 0],
                                      settings=TTILED, device="cpu")
    want = jshim.render_viewer_outputs(js, cam, [0, 0, 0], settings=JTILED)
    assert set(got) == set(want) == {"rgb1", "depth", "rgb"}
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


def test_make_model_classes_raises_without_nerfstudio():
    with pytest.raises(ImportError, match="nerfstudio is required"):
        tshim.make_model_classes()


# ---- training with the live view ---------------------------------------------------

def test_train_scene_answers_a_live_view_request(tmp_path):
    from tests.test_torch_train import blender_scene
    from wast3d_tpu_torch.config import OptimizationConfig
    from wast3d_tpu_torch.train.driver import train_scene

    src = str(tmp_path / "scene")
    blender_scene(src)
    gui = tgui.NetworkGUI(host="127.0.0.1", port=0, verify=str(tmp_path))
    w, h = 32, 24
    req = _request_for(_cam(w=w, h=h, eye=(0, 0, -4)), w, h)
    try:
        port = gui._listener.getsockname()[1]
        with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as client:
            client.settimeout(TIMEOUT)
            client.sendall(_frame(req))
            deadline = time.time() + TIMEOUT
            while gui._request is None and time.time() < deadline:
                time.sleep(0.01)
            tr = train_scene(src, str(tmp_path / "model"), iterations=3, save_iterations=[3],
                             opt_cfg=OptimizationConfig(iterations=3), settings=TTILED,
                             quiet=True, gui=gui, device="cpu")
            rgb, verify = _reply(client, w, h)
    finally:
        gui.stop()
    assert tr.state.step == 3 and tr.gui is gui
    assert len(rgb) == w * h * 3 and verify == str(tmp_path)


def test_cli_train_on_a_busy_port_trains_on(tmp_path, capsys):
    from tests.test_torch_train import blender_scene
    from wast3d_tpu_torch.cli import train as cli

    src = str(tmp_path / "scene")
    blender_scene(src)
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        cli.main(["-s", src, "-m", str(tmp_path / "model"), "--iterations", "2",
                  "--save_iterations", "2", "--port", str(busy.getsockname()[1]), "--quiet",
                  "--renderer", "tiled", "--device", "cpu"])
    assert "network_gui disabled" in capsys.readouterr().out
    assert (tmp_path / "model" / "point_cloud" / "iteration_2" / "point_cloud.ply").exists()
