"""Serving-layer tests: API contract parity with the reference Flask app
(POST /generate?mode=, blanks on bad input, image serving, 500 passthrough)."""

import io
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from icee_tpu.serve.app import parse_multipart, serve
from icee_tpu.serve.config import ServeConfig, load_dotenv, load_config


def _multipart_body(field, filename, data):
    boundary = "testboundary123"
    body = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="{field}"; '
        f'filename="{filename}"\r\n'
        f"Content-Type: application/octet-stream\r\n\r\n"
    ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def test_parse_multipart_roundtrip():
    body, ctype = _multipart_body("file", "cat.jpg", b"\xff\xd8JPEGDATA")
    parts = parse_multipart(body, ctype)
    assert parts["file"][0] == "cat.jpg"
    assert parts["file"][1] == b"\xff\xd8JPEGDATA"


class StubEngine:
    def __init__(self, fail=False):
        self.fail = fail
        self.calls = []

    def caption(self, path, mode):
        if self.fail:
            raise RuntimeError("boom from engine")
        self.calls.append((path, mode))
        return {"nic": "a", "nic_att": "b", "stylenet": "c",
                "stylenet_att": f"caption in {mode}"}


@pytest.fixture
def server(tmp_path):
    cfg = ServeConfig(backend_host="127.0.0.1", backend_port=0,
                      image_folder=str(tmp_path / "uploads"))
    engine = StubEngine()
    httpd = serve(cfg, engine=engine)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}", engine, cfg
    httpd.shutdown()


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_generate_happy_path(server):
    base, engine, cfg = server
    body, ctype = _multipart_body("file", "dog.jpg", b"fakejpg")
    status, resp = _post(f"{base}/generate?mode=happy", body, ctype)
    assert status == 200
    data = json.loads(resp)
    assert data["stylenet_att"] == "caption in happy"
    assert data["path_img"] == "/images/dog.jpg"
    # upload landed on disk and serves back
    with urllib.request.urlopen(f"{base}/images/dog.jpg") as r:
        assert r.read() == b"fakejpg"


def test_generate_bad_mode_returns_blanks(server):
    base, engine, _ = server
    body, ctype = _multipart_body("file", "x.jpg", b"d")
    status, resp = _post(f"{base}/generate?mode=joyful", body, ctype)
    assert status == 200
    data = json.loads(resp)
    assert data == {"nic": "-", "nic_att": "-", "stylenet": "-",
                    "stylenet_att": "-", "path_img": "-"}


def test_generate_missing_file_returns_blanks(server):
    base, _, _ = server
    status, resp = _post(f"{base}/generate?mode=happy", b"", "text/plain")
    assert status == 200
    assert json.loads(resp)["path_img"] == "-"


def test_engine_error_returns_500_with_text(tmp_path):
    cfg = ServeConfig(backend_host="127.0.0.1", backend_port=0,
                      image_folder=str(tmp_path))
    httpd = serve(cfg, engine=StubEngine(fail=True))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    body, ctype = _multipart_body("file", "x.jpg", b"d")
    status, resp = _post(f"http://127.0.0.1:{port}/generate?mode=sad",
                         body, ctype)
    assert status == 500
    assert b"boom from engine" in resp
    httpd.shutdown()


def test_static_frontend_served(server):
    """Full SPA client: every Main.vue UI state must be present
    (app/frontend/src/components/Main.vue:1-187)."""
    base, _, _ = server
    with urllib.request.urlopen(f"{base}/") as r:
        html = r.read().decode()
    assert "Image Captioning with Emotion" in html       # jumbotron title
    for mode in ("factual", "happy", "sad", "angry"):    # 4-mode radios
        assert f'value="{mode}"' in html
    for row in ("nic", "nic_att", "stylenet", "stylenet_att"):
        assert f'id="{row}"' in html                     # 4 result rows
    for badge in ("NIC", "NIC+Att", "StyleNet", "StyleNet+Att"):
        assert f">{badge}</span>" in html                # row badges
    assert 'id="status"' in html and "badge-secondary" in html
    assert 'id="filename"' in html                       # custom-file label
    with urllib.request.urlopen(f"{base}/index.js") as r:
        js = r.read().decode()
    assert "generate?mode=" in js
    # the 4 status-badge states of Main.vue:92-97
    for st, cls in (("loading...", "badge-primary"),
                    ("error", "badge-danger"),
                    ("done!", "badge-success")):
        assert st in js and cls in js
    assert "window.alert" in js                          # error alert contract
    assert "data:image/svg+xml" in js                    # SVG placeholder


def test_dotenv_and_config(tmp_path, monkeypatch):
    env = tmp_path / ".env"
    env.write_text(
        "DEBUG=true\nBACKEND_HOST_PORT=7001\nIMAGE_FOLDER=imgs/\n"
        "VOCAB_PATH=v.pkl\nCHECKPOINT_PATH_STYLENET_HAP=s_hap.ckpt\n"
        "# comment\n")
    for k in ("DEBUG", "BACKEND_HOST_PORT", "IMAGE_FOLDER", "VOCAB_PATH",
              "CHECKPOINT_PATH_STYLENET_HAP"):
        monkeypatch.delenv(k, raising=False)
    cfg = load_config(str(env))
    assert cfg.debug and cfg.backend_port == 7001
    assert cfg.checkpoint_paths["stylenet"]["happy"] == "s_hap.ckpt"
    assert cfg.checkpoint_paths["nic"]["factual"] is None


def test_real_engine_smoke_tiny(tmp_path, tiny_vocab):
    """The real CaptionEngine end-to-end on tiny configs: image file ->
    backbone -> all four variants -> captions, per-mode pipelines."""
    import numpy as np
    from PIL import Image

    from icee_tpu.core.config import (AttentionDecoderConfig, DecoderConfig,
                                      EncoderConfig)
    from icee_tpu.serve.engine import CaptionEngine

    tiny_vocab.save(str(tmp_path / "vocab.pkl"))
    img_path = str(tmp_path / "x.jpg")
    Image.fromarray(
        np.random.default_rng(0).integers(0, 255, (32, 32, 3), dtype=np.uint8),
        "RGB").save(img_path)

    v = len(tiny_vocab)
    engine = CaptionEngine(
        ServeConfig(vocab_path=str(tmp_path / "vocab.pkl"),
                    image_folder=str(tmp_path)),
        smoke_mode=True, image_size=32,
        dec_cfg=DecoderConfig(vocab_size=v, embed_size=8, hidden_size=12,
                              factored_size=12, max_seq_length=5),
        att_cfg=AttentionDecoderConfig(vocab_size=v, embed_size=8,
                                       hidden_size=12, factored_size=12,
                                       attention_size=8, max_seq_length=5),
        enc_cfg=EncoderConfig(embed_size=8))
    out = engine.caption(img_path, "happy")
    assert set(out) == {"nic", "nic_att", "stylenet", "stylenet_att"}
    for v_ in out.values():
        assert isinstance(v_, str)
    # a second mode reuses the compiled pipelines without error
    out2 = engine.caption(img_path, "sad")
    assert set(out2) == set(out)


def _no_pillow(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def fake_import(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", fake_import)


@pytest.mark.parametrize("decoder", ["pillow", "native", "none"])
def test_upload_decoder_choice(monkeypatch, decoder):
    """The engine picks its JPEG decoder when it starts: Pillow, else the
    libjpeg decoder built from native/imagedec.cpp; with neither it refuses
    to start, naming both, instead of failing at the first request."""
    from icee_tpu.data import transforms
    from icee_tpu.native import imagedec

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "examples", "data", "img", "i1.jpg")
    if decoder != "pillow":
        _no_pillow(monkeypatch)
    if decoder == "none":
        monkeypatch.setattr(imagedec, "native_available", lambda: False)
        with pytest.raises(RuntimeError, match="Pillow.*libjpeg"):
            transforms.pick_image_decoder(32)
        return
    if decoder == "native":
        monkeypatch.setattr(imagedec, "native_available", lambda: True)
        monkeypatch.setattr(
            imagedec, "decode_resize_paths",
            lambda paths, size: np.zeros((len(paths), size, size, 3),
                                         np.uint8))
    img = transforms.pick_image_decoder(32)(path)
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
