"""The port's demo server, Grad-CAM test CLI and PNG codec against the JAX
package's CLIs and PIL, on the CPU.

Both sides build the tiny model of ``tests/test_eval.py`` (``create_model``
monkeypatched on each side; both CLIs import it inside their functions), so
medmamba_t is never compiled here, and both read one ``.pth`` written from
JAX variables drawn with numpy (the JAX package converts it with
``torch_to_flax``). Tolerances: probabilities 1e-5, CAMs 1e-4 absolute,
overlays and decoded pixels exact, printed confidences 1e-3.
"""
import argparse
import io
import os
import re
import struct
import threading
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import medmamba_tpu.eval.gradcam as jg
import medmamba_tpu.models.registry as jreg
import medmamba_tpu_torch.eval.gradcam as tg
import medmamba_tpu_torch.models.registry as treg
from medmamba_tpu.cli import demo as jdemo
from medmamba_tpu.cli import test as jtest
from medmamba_tpu.models import vssm as jv
from medmamba_tpu_torch.cli import demo as tdemo
from medmamba_tpu_torch.cli import test as ttest
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.utils import png
from medmamba_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_model import _init
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

TINY = dict(depths=(1, 1), dims=(8, 16), d_state=4, drop_path_rate=0.0)
SIZE = 16


def _image(seed, size=SIZE, channels=3):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 255, size)[None, :, None]
    img = 0.5 * ramp + 0.5 * rng.integers(0, 256, (size, size, channels))
    return img.astype(np.uint8)


def _pil_png(arr, mode):
    buf = io.BytesIO()
    Image.fromarray(arr if mode != "L" else arr[..., 0], mode).save(buf,
                                                                    "PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """A .pth of the tiny model (3 classes) from numpy-drawn variables."""
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    variables = _init(jv.VSSM(num_classes=3, **TINY, scan_impl="seq"), x, 5,
                      True)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pth")
    torch.save({"model_state_dict": state_dict_from_jax(variables),
                "num_classes": 3, "epoch": 0, "best_acc": 0.0,
                "class_indices": {"class_0": 0, "class_1": 1,
                                  "class_2": 2}}, path)
    return path


@pytest.fixture
def tiny_models(monkeypatch):
    monkeypatch.setattr(jreg, "create_model", lambda size, num_classes, **kw:
                        jv.VSSM(num_classes=num_classes, **TINY,
                                scan_impl="seq"))
    monkeypatch.setattr(treg, "create_model",
                        lambda size, num_classes, device="cuda", **kw:
                        tv.VSSM(num_classes=num_classes, **TINY).to(device))


# ------------------------------------------------------------------- PNG


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_decodes_what_pil_writes(mode):
    arr = _image(1, 23, 4 if mode == "RGBA" else 3)
    data = _pil_png(arr, mode)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(png.decode(data), want)


def _filtered_png(arr):
    """An RGB PNG whose rows take the filters 0-4 in turn (PNG spec 9.2)."""
    h, w, _ = arr.shape
    a = arr.reshape(h, w * 3).astype(np.int64)
    raw = b""
    for y in range(h):
        kind = y % 5
        up = a[y - 1] if y else np.zeros(w * 3, np.int64)
        left = np.concatenate([np.zeros(3, np.int64), a[y, :-3]])
        ul = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        if kind == 0:
            pred = np.zeros_like(left)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        raw += bytes([kind]) + ((a[y] - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_decodes_every_row_filter():
    arr = _image(2, 11)
    data = _filtered_png(arr)
    np.testing.assert_array_equal(png.decode(data), arr)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), arr)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_pil_reads_what_png_encodes(channels):
    arr = _image(3, 13, channels)
    img = arr[..., 0] if channels == 1 else arr
    back = np.asarray(Image.open(io.BytesIO(png.encode(img))))
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(
        png.decode(png.encode(img)),
        np.asarray(Image.open(io.BytesIO(png.encode(img))).convert("RGB")))


def test_load_rgb_takes_pil_pixels_at_any_size():
    """A PNG at the size is decoded here, another size goes through PIL;
    both give the JAX CLIs' pixels."""
    for data in (_pil_png(_image(4, 20), "RGB"),
                 _pil_png(_image(4, SIZE, 4), "RGBA")):
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB").resize(
            (SIZE, SIZE), Image.BILINEAR))
        np.testing.assert_array_equal(png.load_rgb(data, SIZE), want)
    palette = io.BytesIO()
    Image.fromarray(_image(5)).convert("P").save(palette, "PNG")
    with pytest.raises(png.Unsupported):
        png.decode(palette.getvalue())
    np.testing.assert_array_equal(
        png.load_rgb(palette.getvalue(), SIZE),
        np.asarray(Image.open(palette).convert("RGB")))


# ---------------------------------------------------------------- demo


def _multipart(image: bytes, target=None, boundary="XyZ12", quote=False):
    parts = [b'Content-Disposition: form-data; name="image"; '
             b'filename="x.png"\r\nContent-Type: image/png\r\n\r\n' + image]
    if target is not None:
        parts.append(b'Content-Disposition: form-data; name="target"\r\n\r\n'
                     + str(target).encode())
    body = b"".join(b"--" + boundary.encode() + b"\r\n" + p + b"\r\n"
                    for p in parts) + b"--" + boundary.encode() + b"--\r\n"
    b = f'"{boundary}"' if quote else boundary
    return body, f"multipart/form-data; boundary={b}"


@pytest.mark.parametrize("target,quote", [(None, False), (2, True),
                                          ("x", False), ("", False)])
def test_parse_multipart_matches_jax(target, quote):
    body, ctype = _multipart(_pil_png(_image(6), "RGB"), target, quote=quote)
    assert tdemo._parse_multipart(body, ctype) == \
        jdemo._parse_multipart(body, ctype)
    with pytest.raises(ValueError):
        tdemo._parse_multipart(body, "text/plain")


def _recording(monkeypatch, module, into):
    real = module.grad_cam

    def record(*a, **kw):
        into.append(real(*a, **kw))
        return into[-1]
    monkeypatch.setattr(module, "grad_cam", record)


@pytest.mark.parametrize("target", [-1, 2])
def test_infer_matches_jax(pth, tiny_models, monkeypatch, target):
    jcams, tcams = [], []
    _recording(monkeypatch, jg, jcams)
    _recording(monkeypatch, tg, tcams)
    common = dict(checkpoint_path=pth, num_classes=None, medmb_size="T",
                  image_size=SIZE, scan_tau="auto", tau_gate="outcome")
    jinfer = jdemo.build_app(argparse.Namespace(**common))[0]
    tinfer = tdemo.build_app(argparse.Namespace(**common, device="cpu"))[0]
    data = _pil_png(_image(7), "RGB")
    j_img, j_overlay, j_probs, j_pred, j_tc = jinfer(data, target)
    t_img, t_overlay, t_probs, t_pred, t_tc = tinfer(data, target)
    np.testing.assert_array_equal(t_img, np.asarray(j_img))
    np.testing.assert_allclose(t_probs, j_probs, rtol=0, atol=1e-5)
    assert (t_pred, t_tc) == (j_pred, j_tc)
    t_cam, j_cam = tcams[0][0], jcams[0][0]
    np.testing.assert_allclose(t_cam, j_cam, rtol=0, atol=1e-4)
    # the overlay of a CAM is exact; the two pipelines' overlays differ only
    # at the pixels whose CAM values, 1e-6 apart, fall on either side of an
    # edge of the colormap's 256 entries
    np.testing.assert_array_equal(
        t_overlay, jg.show_cam_on_image(t_img.astype(np.float32) / 255.0,
                                        t_cam))
    same = (np.minimum(np.floor(t_cam * 256), 255)
            == np.minimum(np.floor(j_cam * 256), 255))
    assert same.mean() > 0.95
    np.testing.assert_array_equal(t_overlay[same], j_overlay[same])


def test_demo_server_answers_a_post(pth, tiny_models, tmp_path):
    tree = tmp_path / "tree" / "class_1"
    tree.mkdir(parents=True)
    (tree / "a.png").write_bytes(png.encode(_image(8)))
    args = tdemo.parse_args(["--checkpoint_path", pth, "--image_size",
                             str(SIZE), "--port", "0", "--device", "cpu",
                             "--test_dir", str(tmp_path / "tree")])
    srv = tdemo.make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        body, ctype = _multipart(png.encode(_image(9)), 1)
        req = urllib.request.Request(url, data=body,
                                     headers={"Content-Type": ctype})
        pages = [urllib.request.urlopen(req, timeout=60).read().decode(),
                 urllib.request.urlopen(url + "/random?mode=gt",
                                        timeout=60).read().decode()]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    for page in pages:
        assert "Prediction:" in page and "error" not in page
        imgs = re.findall(r'data:image/png;base64,([A-Za-z0-9+/=]+)', page)
        assert len(imgs) == 2
        probs = re.search(r"data-probs='([^']+)'", page).group(1)
        assert abs(sum(map(float, probs.strip("[]").split(","))) - 1) < 1e-5
    assert "Grad-CAM target: class_1" in pages[0] + pages[1]


# ------------------------------------------------------------ cli.test


def test_test_cli_matches_jax(pth, tiny_models, tmp_path, capsys):
    root = tmp_path / "tree"
    for c in range(2):
        (root / f"class_{c}").mkdir(parents=True)
        for i in range(2):
            (root / f"class_{c}" / f"{i}.png").write_bytes(
                _pil_png(_image(10 + 2 * c + i), "RGB"))
    argv = ["--checkpoint_path", pth, "--test_dir", str(root),
            "--num_classes", "3", "--image_size", str(SIZE),
            "--num_images", "2"]
    jtest.main(argv + ["--output_dir", str(tmp_path / "jax")])
    jax_lines = re.findall(r"^(\S+) -> class (\d+) conf ([\d.]+) saved",
                           capsys.readouterr().out, re.MULTILINE)
    got = ttest.main(argv + ["--output_dir", str(tmp_path / "port"),
                             "--device", "cpu"])
    assert [r["path"] for r in got] == [p for p, _, _ in jax_lines]
    assert [r["pred"] for r in got] == [int(c) for _, c, _ in jax_lines]
    for r, (_, _, conf) in zip(got, jax_lines):
        assert abs(r["conf"] - float(conf)) <= 1e-3
        side = png.decode(open(r["out"], "rb").read())
        assert side.shape == (SIZE, 2 * SIZE, 3)
        assert r["cam"].shape == (SIZE, SIZE)
