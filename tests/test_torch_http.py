"""The port's HTTP front (`ldm3d_torch.serve.serve`) on the CPU: a server on
a free localhost port, run in a thread over a tiny service, answers
`/generate` with the service's own volumes as .npy, and as .nii.gz whose
decompressed bytes equal those of the JAX package's `save_nifti`; it
reports its signatures on `/healthz` and answers a bad request with 400.
"""

import gzip
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from ldm3d.data.nifti import save_nifti as j_save_nifti
from ldm3d_torch.core.config import flagship_cfg
from ldm3d_torch.data.nifti import save_nifti
from ldm3d_torch.serve import GenerationService, serve

# No proxy, whatever the environment says: every request stays on localhost.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))
REQUEST = {"num": 2, "context": 1, "sampler": "ddim", "sample_steps": 3,
           "seed": 7}


@pytest.fixture(scope="module")
def server():
    svc = GenerationService.from_random_init(flagship_cfg(tiny=True), seed=0,
                                             device="cpu", name="tiny")
    srv = serve(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield svc, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()


def _post(url, body: bytes):
    req = urllib.request.Request(url + "/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with _OPENER.open(req, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_generate_npy_round_trip(server):
    svc, url = server
    code, ctype, body = _post(url, json.dumps(REQUEST).encode())
    assert code == 200 and ctype == "application/octet-stream"
    vols = np.load(io.BytesIO(body))
    assert vols.shape == (2, 16, 16, 16, 1) and vols.dtype == np.float32
    want = svc.generate(**REQUEST)
    np.testing.assert_array_equal(vols, want)


def test_generate_nii_matches_jax_save_nifti(server, tmp_path):
    svc, url = server
    code, _, body = _post(url, json.dumps({**REQUEST,
                                           "format": "nii"}).encode())
    assert code == 200
    vol = svc.generate(**REQUEST)[0]
    ref = os.path.join(tmp_path, "ref.nii.gz")
    j_save_nifti(ref, vol)
    with gzip.open(ref, "rb") as f:
        want = f.read()
    # gzip headers carry a time, so the decompressed files are compared
    assert gzip.decompress(body) == want
    ours = save_nifti(os.path.join(tmp_path, "port.nii.gz"), vol)
    with gzip.open(ours, "rb") as f:
        assert f.read() == want


def test_healthz_lists_signatures(server):
    svc, url = server
    svc.generate(num=1, context=0, sampler="dpmpp", sample_steps=2, seed=1)
    with _OPENER.open(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["model"] == "tiny"
    assert [1, "dpmpp", 2, None] in health["compiled"]


@pytest.mark.parametrize("body,match", [
    (b"{not json", "JSONDecodeError"),
    (json.dumps({"num": 0}).encode(), "num must be"),
    (json.dumps({"sampler": "euler"}).encode(), "sampler must be"),
    (json.dumps({"guidance_scale": 2.0}).encode(), "cfg_dropout > 0"),
])
def test_bad_request_is_400(server, body, match):
    _, url = server
    code, ctype, payload = _post(url, body)
    assert code == 400 and ctype == "application/json"
    assert match in json.loads(payload)["error"]


def test_unknown_path_is_404(server):
    _, url = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _OPENER.open(url + "/nope", timeout=60)
    assert e.value.code == 404
