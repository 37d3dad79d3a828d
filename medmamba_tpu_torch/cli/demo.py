"""Inference demo server of the PyTorch port (counterpart of
``medmamba_tpu/cli/demo.py``, capability parity with the reference
``app_streamlit_demo.py``).

A standard-library HTTP server: upload an image, get class probabilities and
a Grad-CAM overlay (target = the predicted class or a manual index), or pick
a random image from ``--test_dir`` (``GET /random?mode=gt|pred|manual``).
Runs on the card (``--device cuda``, the default; raises without one),
where the softmax forward is one CUDA graph (``train/trainer.py:
compile_forward``) and the Grad-CAM runs eagerly, or, when asked, on the
CPU. Pages carry their images as PNGs written with
``utils/png.py``; an uploaded PNG already at ``--image_size`` square is
decoded without PIL, any other image needs PIL. ``--scan_tau`` and
``--tau_gate`` are accepted for the JAX CLI's flag surface and do nothing:
the port's scans are exact.

Usage:
    python -m medmamba_tpu_torch.cli.demo --checkpoint_path weights.pth \
        [--medmb_size T --num_classes N --port 8501 --test_dir DIR]
"""
from __future__ import annotations

import argparse
import base64
import json
import os
from http.server import BaseHTTPRequestHandler, HTTPServer

PAGE = """<!doctype html><html><head><title>MedMamba demo</title>
<style>body{{font-family:sans-serif;max-width:720px;margin:2em auto}}
img{{max-width:320px;margin:4px;border-radius:6px}}
table{{border-collapse:collapse}} td,th{{padding:4px 10px;border:1px solid #ccc}}
</style></head><body>
<h2>MedMamba inference demo</h2>
<form method="post" enctype="multipart/form-data">
<p><input type="file" name="image" accept="image/*" required>
Grad-CAM target class (-1 = predicted): <input type="number" name="target" value="-1" style="width:5em">
<button type="submit">Predict</button></p></form>
{random_form}
{result}
</body></html>"""

# Grad-CAM target selection for random picks: ground-truth class (from the
# image's class folder), predicted class, or a manual index -- the three
# target modes of the reference app (app_streamlit_demo.py:360-455).
RANDOM_FORM = """<form method="get" action="/random">
<p>or pick a random image from the test tree (<code>{test_dir}</code>):
target =
<select name="mode">
<option value="gt">ground-truth (from folder)</option>
<option value="pred">predicted</option>
<option value="manual">manual index:</option>
</select>
<input type="number" name="target" value="0" style="width:5em">
<button type="submit">Random image</button></p></form>"""


def build_app(args):
    """(infer, render, class_of) for the checkpoint in ``args``."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.eval import gradcam
    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train.checkpoint import restore_params
    from medmamba_tpu_torch.train.trainer import forward_fn
    from medmamba_tpu_torch.utils import png
    from medmamba_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    state_dict, meta = restore_params(args.checkpoint_path)
    num_classes = args.num_classes or meta.get("num_classes")
    class_indices = meta.get("class_indices") or {}
    idx_to_name = {int(v): str(k) for k, v in class_indices.items()} \
        if class_indices else {}
    name_to_idx = {str(k): int(v) for k, v in class_indices.items()}
    model = create_model(args.medmb_size, num_classes, device=device)
    model.load_state_dict(state_dict, strict=True)
    # the batch-1 softmax forward: one CUDA graph on the card
    forward = forward_fn(model, device, image_size=args.image_size)

    def infer(img_bytes: bytes, target: int):
        """(img, overlay, probs, pred, tc): the uint8 input and overlay,
        the softmax probabilities, the predicted class and the CAM's
        target class."""
        img = png.load_rgb(img_bytes, args.image_size)
        probs, x = forward(torch.from_numpy(img[None]))
        probs = probs[0].cpu().numpy()
        x = x.clone()     # the graph's buffer; the CAM runs eagerly on it
        pred = int(probs.argmax())
        tc = pred if target < 0 else int(target)
        cam = gradcam.grad_cam(model, x, target_class=np.array([tc]))[0]
        overlay = gradcam.show_cam_on_image(img.astype(np.float32) / 255.0,
                                            cam)
        return img, overlay, probs, pred, tc

    def render(img, overlay, probs, pred, tc):
        def b64(arr):
            return base64.b64encode(png.encode(arr)).decode()

        name = idx_to_name.get(pred, str(pred))
        rows = "".join(
            f"<tr><td>{idx_to_name.get(i, i)}</td><td>{p:.4f}</td></tr>"
            for i, p in enumerate(probs))
        # the probabilities again at full precision, for clients
        exact = json.dumps([float(p) for p in probs])
        return (f"<h3>Prediction: {name} ({probs[pred]:.3f})"
                f" &mdash; Grad-CAM target: {idx_to_name.get(tc, tc)}</h3>"
                f'<img src="data:image/png;base64,{b64(img)}">'
                f'<img src="data:image/png;base64,{b64(overlay)}">'
                f"<table data-probs='{exact}'><tr><th>class</th>"
                f"<th>prob</th></tr>{rows}</table>")

    def class_of(path: str):
        """Ground-truth class index of a class-folder image: the parent
        directory name, looked up in class_indices (folder mode) or parsed
        from the 'class_<v>' convention (NPZ-prep trees)."""
        folder = os.path.basename(os.path.dirname(path))
        if folder in name_to_idx:
            return name_to_idx[folder]
        if folder.startswith("class_") and folder[6:].isdigit():
            return int(folder[6:])
        return None

    return infer, render, class_of


def _parse_multipart(body: bytes, content_type: str):
    """Minimal multipart/form-data parser (the stdlib cgi module is gone in 3.12).

    Returns (image_bytes, target_int)."""
    import re
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("not multipart/form-data")
    boundary = m.group(1).encode()
    image, target = None, -1
    for part in body.split(b"--" + boundary):
        if b"\r\n\r\n" not in part:
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        payload = payload.rstrip(b"\r\n-")
        head_l = head.decode(errors="replace").lower()
        if 'name="image"' in head_l:
            image = payload
        elif 'name="target"' in head_l:
            try:
                target = int(payload.decode().strip() or "-1")
            except ValueError:
                target = -1
    if image is None:
        raise ValueError("no image field in form")
    return image, target


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MedMamba inference demo "
                                            "(PyTorch port).")
    p.add_argument("--checkpoint_path", required=True,
                   help="a .pth file in the reference schema, or a bare "
                        "state dict")
    p.add_argument("--medmb_size", default="T", choices=["T", "S", "B", "Te"])
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--scan_tau", type=str, default="auto",
                   choices=["auto", "16", "32", "64", "128"],
                   help="Accepted for the JAX CLI's flag surface; does "
                        "nothing here (the scan is exact).")
    p.add_argument("--tau_gate", type=str, default="outcome",
                   choices=["outcome", "exact"],
                   help="Accepted for the JAX CLI's flag surface; does "
                        "nothing here.")
    p.add_argument("--port", type=int, default=8501,
                   help="0 picks a free port")
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind address (default loopback; pass 0.0.0.0 "
                        "explicitly to expose the server)")
    p.add_argument("--test_dir", type=str, default=None,
                   help="class-folder tree for the random-image source; "
                        "fixed at launch (clients cannot request arbitrary "
                        "filesystem paths)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def make_server(args) -> HTTPServer:
    """The demo's HTTP server for ``args``, bound and not yet serving."""
    infer, render, class_of = build_app(args)
    random_form = (RANDOM_FORM.format(test_dir=args.test_dir)
                   if args.test_dir else "")

    def page(result=""):
        return PAGE.format(random_form=random_form, result=result)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, html, code=200):
            body = html.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # "random image from a folder tree" source, parity with the
            # reference app's second image source (app_streamlit_demo.py:248-327);
            # the source tree is fixed at launch (--test_dir).
            if self.path.startswith("/random"):
                import random as _random
                import urllib.parse
                q = urllib.parse.parse_qs(
                    urllib.parse.urlparse(self.path).query)
                mode = (q.get("mode") or ["gt"])[0]
                try:
                    manual = int((q.get("target") or ["0"])[0])
                except ValueError:
                    manual = 0
                exts = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".webp")
                files = []
                if args.test_dir and os.path.isdir(args.test_dir):
                    for base, _, names in os.walk(args.test_dir):
                        files += [os.path.join(base, n) for n in names
                                  if n.lower().endswith(exts)]
                if not files:
                    self._send(page("<p style='color:red'>no images found"
                                    f" under --test_dir {args.test_dir!r}"
                                    "</p>"))
                    return
                path = _random.choice(files)
                with open(path, "rb") as f:
                    data = f.read()
                if mode == "manual":
                    target = manual
                elif mode == "gt":
                    target = class_of(path)
                    if target is None:
                        target = -1  # folder name unknown -> predicted
                else:
                    target = -1
                try:
                    gt = class_of(path)
                    note = (f"<p>random pick: <code>{path}</code>"
                            + (f" (ground truth: class {gt})"
                               if gt is not None else "") + "</p>")
                    out = note + render(*infer(data, target))
                except Exception as e:
                    out = f"<p style='color:red'>error: {e}</p>"
                self._send(page(out))
                return
            self._send(page())

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            data, target = _parse_multipart(
                body, self.headers.get("Content-Type", ""))
            try:
                out = render(*infer(data, target))
            except Exception as e:  # surface errors in the page
                out = f"<p style='color:red'>error: {e}</p>"
            self._send(page(out))

        def log_message(self, *a):
            pass

    return HTTPServer((args.host, args.port), Handler)


def main(argv=None):
    args = parse_args(argv)
    srv = make_server(args)
    host, port = srv.server_address[:2]
    print(f"MedMamba demo listening on http://{host}:{port}")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
