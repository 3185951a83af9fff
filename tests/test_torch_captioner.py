"""The port's captioner slot (imatch_tpu_torch/pipeline/captioner.py and
models/moondream/runtime.py) against the JAX package's, on the CPU.

- ``MoondreamTorch`` with JAX's tiny-md weights (``init_md_params(jax.
  random.key(0))``, what ``MoondreamJax`` loads) gives ``MoondreamJax``'s
  encodings (rtol/atol 1e-5), captions, open answers and yes/no answers
  (equal), segmented or not (IMATCH_MD_SEG).
- The int8 modes' environment gating, as tests/test_moondream.py:529
  holds JAX's: IMATCH_MD_ACT=int8 without IMATCH_MD_QUANT=int8, an unknown
  IMATCH_MD_ACT and IMATCH_MD_PARAM_DTYPE=int8 raise ValueError; the int8
  weights, the W8A8 prefill and the int8 cache build and answer.
- ``get_captioner``'s chain (null / cloud / moondream / auto) and
  ``CloudCaptioner`` against a local fake of the hosted API, as
  tests/test_cloud_captioner.py runs JAX's.
- An ``.npz`` encoding saved by either package loads in the other.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from imatch_tpu.models.moondream.model import init_md_params
from imatch_tpu.models.moondream.runtime import MoondreamJax
from imatch_tpu.models.moondream.configs import TINY_MD
from imatch_tpu.pipeline import captioner as jax_captioner
from imatch_tpu_torch.models.moondream.runtime import MoondreamTorch
from imatch_tpu_torch.pipeline import captioner
from imatch_tpu_torch.pipeline.captioner import (
    CloudCaptioner,
    NullCaptioner,
    get_captioner,
    load_encoded,
    save_encoded,
)

QUESTIONS = ["Yes or No: is this a drill?", "yes/no: is it red", "Yes or No: is there a cat?"]


@pytest.fixture(scope="module")
def services():
    tree = jax.tree.map(np.array, init_md_params(jax.random.key(0), TINY_MD))
    return MoondreamJax(config="tiny-md"), MoondreamTorch(config="tiny-md", params=tree, device="cpu")


def _images():
    rng = np.random.default_rng(3)
    return [
        rng.integers(0, 256, (40, 56, 3), dtype=np.uint8),
        rng.integers(0, 256, (64, 31, 3), dtype=np.uint8),
        rng.integers(0, 256, (28, 28), dtype=np.uint8),  # grayscale
        rng.integers(0, 256, (33, 47, 4), dtype=np.uint8),  # RGBA
    ]


@pytest.mark.parametrize("seg", ["0", "3", "8"])
def test_moondream_end_to_end_equals_jax(services, monkeypatch, seg):
    monkeypatch.setenv("IMATCH_MD_SEG", seg)
    jsvc, psvc = services
    for img in _images():
        enc_j, enc_p = jsvc.encode_image(img), psvc.encode_image(img)
        assert enc_p["features"].shape == (TINY_MD.vision.num_patches, TINY_MD.text.hidden_size)
        assert enc_p["features"].dtype == np.float32
        np.testing.assert_allclose(enc_p["features"], enc_j["features"], rtol=1e-5, atol=1e-5)
        assert psvc.caption(enc_p, max_new=10) == jsvc.caption(enc_j, max_new=10)
        assert psvc.caption(enc_p) == jsvc.caption(enc_j)  # the default 48 tokens
        for q in QUESTIONS:
            ans = psvc.query(enc_p, q)
            assert ans == jsvc.query(enc_j, q) and ans["answer"] in ("Yes", "No")
        assert psvc.query(enc_p, "What is shown?", max_new=6) == jsvc.query(enc_j, "What is shown?", max_new=6)


def test_moondream_batches_equal_jax(services):
    jsvc, psvc = services
    imgs = _images() * 5  # 20 frames: encode and caption chunks of 16 + 4
    encs_p, encs_j = psvc.encode_image_batch(imgs), jsvc.encode_image_batch(imgs)
    for a, b in zip(encs_p, encs_j):
        np.testing.assert_allclose(a["features"], b["features"], rtol=1e-5, atol=1e-5)
    assert psvc.caption_batch(encs_p, max_new=8) == jsvc.caption_batch(encs_j, max_new=8)
    for q in QUESTIONS:
        assert psvc.query_yes_no_batch(encs_p, q) == jsvc.query_yes_no_batch(encs_j, q)
    assert psvc.caption_batch([]) == [] and psvc.query_yes_no_batch([], QUESTIONS[0]) == []


@pytest.mark.parametrize(
    "env,error",
    [
        ({"IMATCH_MD_QUANT": "int8"}, None),
        ({"IMATCH_MD_ACT": "int8", "IMATCH_MD_QUANT": "int8"}, None),
        ({"IMATCH_MD_ACT": "int8"}, ValueError),
        ({"IMATCH_MD_CACHE": "int8"}, None),
        ({"IMATCH_MD_ACT": "fp4"}, ValueError),
        ({"IMATCH_MD_PARAM_DTYPE": "int8"}, ValueError),
    ],
)
def test_unported_and_unknown_modes_raise(monkeypatch, env, error):
    """tests/test_moondream.py:529 on the port: the gating raises where
    JAX's does; the modes that build carry their mode and answer."""
    from imatch_tpu_torch.models.moondream.model import Int8Linear

    for k in ("IMATCH_MD_QUANT", "IMATCH_MD_ACT", "IMATCH_MD_CACHE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if error is not None:
        with pytest.raises(error):
            MoondreamTorch(config="tiny-md", device="cpu")
        return
    m = MoondreamTorch(config="tiny-md", device="cpu")
    quant = env.get("IMATCH_MD_QUANT") == "int8"
    assert isinstance(m.model.text.lm_head, Int8Linear) == quant
    assert all(isinstance(layer.out, Int8Linear) == quant for layer in m.model.text.layers)
    assert m.act_quant == (env.get("IMATCH_MD_ACT") == "int8")
    assert m.cache_dtype == (torch.int8 if "IMATCH_MD_CACHE" in env else None)
    enc = m.encode_image(np.full((24, 30, 3), 128, np.uint8))
    assert m.query(enc, "Yes or No: is it gray?")["answer"] in ("Yes", "No")
    assert isinstance(m.caption(enc, max_new=6)["caption"], str)


def test_param_dtype_bf16_rounds_the_weights_as_jax(monkeypatch, services):
    """IMATCH_MD_PARAM_DTYPE=bf16 on the CPU: bf16-stored weights, fp32
    compute, as MoondreamJax under the same variable."""
    monkeypatch.setenv("IMATCH_MD_PARAM_DTYPE", "bf16")
    jsvc = MoondreamJax(config="tiny-md")
    psvc = MoondreamTorch(config="tiny-md", params=jax.tree.map(np.array, init_md_params(jax.random.key(0), TINY_MD)), device="cpu")
    img = _images()[0]
    enc_j, enc_p = jsvc.encode_image(img), psvc.encode_image(img)
    np.testing.assert_allclose(enc_p["features"], enc_j["features"], rtol=1e-5, atol=1e-5)
    assert psvc.caption(enc_p, max_new=8) == jsvc.caption(enc_j, max_new=8)


# -- the factory and the cloud client -------------------------------------


@pytest.fixture()
def mock_api():
    seen = {"auth": [], "paths": [], "bodies": []}

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen["auth"].append(self.headers.get("X-Moondream-Auth"))
            seen["paths"].append(self.path)
            seen["bodies"].append(body)
            if self.path.endswith("/caption"):
                out = {"caption": "a red power drill on a white table"}
            else:
                out = {"answer": "Yes" if "drill" in body.get("question", "").lower() else "No"}
            data = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_port}/v1", seen
    srv.shutdown()
    thread.join(timeout=10)


def test_cloud_caption_and_query(mock_api):
    url, seen = mock_api
    cap = CloudCaptioner("sk-test-123", base_url=url)
    enc = cap.encode_image(np.zeros((32, 32, 3), np.uint8))
    assert CloudCaptioner._url(enc).startswith("data:image/jpeg;base64,")
    assert cap.caption(enc)["caption"].startswith("a red power drill")
    assert cap.query(enc, "Yes or No: is there a drill?")["answer"] == "Yes"
    assert cap.query(enc, "Yes or No: is there a cat?")["answer"] == "No"
    assert set(seen["auth"]) == {"sk-test-123"}
    assert [p.rsplit("/", 1)[1] for p in seen["paths"]] == ["caption", "query", "query"]
    assert seen["bodies"][1]["question"] == "Yes or No: is there a drill?"
    # the same JPEG payload as the JAX client's
    jenc = jax_captioner.CloudCaptioner("k", base_url=url).encode_image(np.zeros((32, 32, 3), np.uint8))
    np.testing.assert_array_equal(enc["image_url"], jenc["image_url"])


def test_factory_chain(mock_api, monkeypatch):
    url, _ = mock_api
    monkeypatch.delenv("IMATCH_CAPTIONER", raising=False)
    monkeypatch.delenv("MOONDREAM_API_KEY", raising=False)
    monkeypatch.setenv("IMATCH_MD_CONFIG", "tiny-md")
    # auto without a key: the local VLM on the device asked for
    cap = get_captioner("cpu")
    assert isinstance(cap, MoondreamTorch) and cap.device.type == "cpu" and cap.available
    monkeypatch.setenv("IMATCH_CAPTIONER", "moondream")
    assert isinstance(get_captioner("cpu"), MoondreamTorch)
    monkeypatch.setenv("IMATCH_CAPTIONER", "null")
    cap = get_captioner("cpu")
    assert isinstance(cap, NullCaptioner) and not cap.available
    # auto + key -> cloud
    monkeypatch.setenv("MOONDREAM_API_KEY", "sk-abc")
    monkeypatch.setenv("MOONDREAM_API_URL", url)
    monkeypatch.delenv("IMATCH_CAPTIONER")
    cap = get_captioner("cpu")
    assert isinstance(cap, CloudCaptioner) and cap.base_url == url
    # explicit cloud without a key -> hard error
    monkeypatch.delenv("MOONDREAM_API_KEY")
    monkeypatch.setenv("IMATCH_CAPTIONER", "cloud")
    with pytest.raises(RuntimeError):
        get_captioner("cpu")
    # a failing local init: auto degrades to the null mode, moondream raises
    monkeypatch.setenv("IMATCH_MD_CONFIG", "no-such-config")
    monkeypatch.setenv("IMATCH_CAPTIONER", "auto")
    assert isinstance(get_captioner("cpu"), NullCaptioner)
    monkeypatch.setenv("IMATCH_CAPTIONER", "moondream")
    with pytest.raises(KeyError):
        get_captioner("cpu")


def test_cloud_in_ingest_pipeline(mock_api, tmp_path):
    """process_image with the cloud captioner: the caption lands in
    custom_metadata, the saved filters are answered over the API."""
    from imatch_tpu_torch.models.clip.configs import TINY
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
    from imatch_tpu_torch.pipeline.ingest import process_image
    from imatch_tpu_torch.pipeline.state import AppState

    url, _ = mock_api
    state = AppState(
        root=str(tmp_path),
        embedder=ClipEmbedder(config=TINY, device="cpu"),
        captioner=CloudCaptioner("sk-x", base_url=url),
        device="cpu",
    )
    state.save_filters(["is there a drill?"])
    img = Image.fromarray(np.random.default_rng(0).integers(0, 256, (40, 40, 3), np.uint8))
    md, is_new = process_image(state, img, "d.png", custom_metadata="mine")
    assert is_new
    assert md["custom_metadata"] == "mine\n\na red power drill on a white table"
    assert json.loads(md["filter_results_json"]) == {"is there a drill?": "Yes"}
    assert load_encoded(state.encoded_dir, md["id"]) is not None


def test_cloud_encoded_cache_roundtrip_and_grayscale(mock_api, tmp_path):
    url, seen = mock_api
    cap = CloudCaptioner("sk-x", base_url=url)
    enc = cap.encode_image(np.full((16, 16), 128, np.uint8))  # 2-D gray
    u = CloudCaptioner._url(enc)
    assert u.startswith("data:image/jpeg;base64,")
    save_encoded(str(tmp_path), "img_x", enc)
    assert cap.query(load_encoded(str(tmp_path), "img_x"), "Yes or No: is there a drill?")["answer"] == "Yes"
    assert seen["bodies"][-1]["image_url"] == u


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encoded_npz_loads_in_the_other_package(tmp_path, writer):
    feats = np.random.default_rng(1).standard_normal((16, 32)).astype(np.float32)
    url = np.frombuffer(b"data:image/jpeg;base64,AAAA", np.uint8)
    save, load = (
        (jax_captioner.save_encoded, captioner.load_encoded)
        if writer == "jax"
        else (captioner.save_encoded, jax_captioner.load_encoded)
    )
    save(str(tmp_path), "a", {"features": feats})
    save(str(tmp_path), "b", {"image_url": url})
    save(str(tmp_path), "c", feats)  # a bare array
    got = load(str(tmp_path), "a")
    assert list(got) == ["features"]
    np.testing.assert_array_equal(got["features"], feats)
    np.testing.assert_array_equal(load(str(tmp_path), "b")["image_url"], url)
    np.testing.assert_array_equal(load(str(tmp_path), "c")["encoded"], feats)
    assert load(str(tmp_path), "missing") is None
    (tmp_path / "torn.npz").write_bytes(b"PK\x03\x04 torn")
    assert load(str(tmp_path), "torn") is None
