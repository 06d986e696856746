"""The port's serving daemon, LUT speakers and inference CLI, against the JAX
package, on the CPU.

The daemon's cases of ``tests/test_serve.py`` run on the port's
``Synthesizer`` over ``demo/serving_ckpt.msgpack`` (f32, prenet dropout 0,
mel-only: the overrides of ``tests/test_torch_synthesizer.py``); then one
module-scoped JAX ``TTSServer`` on the same checkpoint and overrides takes
the same requests as a port server, in the same order: equal status codes
and error bodies, equal mel lengths, wavs within 1e-3 of their peak, the
streamed PCM within the streaming tests' tolerance, and the same program
keys behind ``/stats`` ``compiled_programs``. Co-batching changes a row's
audio in both packages (the buckets follow the batch), so the comparisons
hold like with like: the same lone request, or a batch the worker ran
against a direct ``synthesize`` of the same texts in the same order.
"""

import base64
import io
import json
import pathlib
import socket
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.hparams import Recursive_Parse as JaxRecursiveParse
from multi_speaker_tts_tpu.inference import Synthesizer as JaxSynthesizer
from multi_speaker_tts_tpu.models.speaker import SpeakerLUT as JaxSpeakerLUT
from multi_speaker_tts_tpu.serve import TTSServer as JaxTTSServer
from multi_speaker_tts_tpu.train.checkpoints import load_compact
from multi_speaker_tts_tpu_torch import inference as port_inference
from multi_speaker_tts_tpu_torch.audio import wav_io
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.inference import Synthesizer
from multi_speaker_tts_tpu_torch.models.speaker import SpeakerLUT
from multi_speaker_tts_tpu_torch.serve import DynamicBatcher, ServingStats, TTSServer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "demo" / "serving_ckpt.msgpack"
ENROLL_WAV = ROOT / "demo" / "enroll_spk0_utt0.wav"
OTHER_WAV = ROOT / "demo" / "enroll_spk5_utt0.wav"
OVERRIDES = dict(
    Linear_Head={"Use": False},
    Train={"Use_Mixed_Precision": False},
    Decoder={"Prenet": {"Dropout_Rate": 0.0}},
)
# f32 on both sides, as tests/test_torch_synthesizer.py and
# tests/test_torch_streaming.py state them: the mel differs by summation order
# (~1e-6), 60 Griffin-Lim iterations carry that to ~1e-4 of the wav's peak;
# int16 PCM adds one step of rounding.
MEL_TOL, WAV_REL_TOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def ckpt():
    return load_compact(CKPT)


@pytest.fixture(scope="module")
def synth(ckpt):
    params, batch_stats, meta = ckpt
    return Synthesizer(Recursive_Parse(meta["hp"]).replace(**OVERRIDES), params, batch_stats,
                       device="cpu")


@pytest.fixture(scope="module")
def spk(synth):
    return synth.enroll([str(ENROLL_WAV)])


def _record_synthesize(monkeypatch, synth) -> list:
    """Wrap ``synth.synthesize``: every call's texts and results."""
    calls, original = [], synth.synthesize

    def recorded(texts, *args, **kwargs):
        out = original(texts, *args, **kwargs)
        calls.append((list(texts), args, kwargs, out))
        return out

    monkeypatch.setattr(synth, "synthesize", recorded)
    return calls


def _concurrently(fns, timeout=300):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


# -- the batcher -----------------------------------------------------------------


def test_batcher_coalesces_concurrent_requests(synth, spk, monkeypatch):
    """Simultaneous submissions land in one synthesize call, every request
    gets its own row, and a batch the worker ran equals a direct synthesize
    of the same texts in the same order."""
    calls = _record_synthesize(monkeypatch, synth)
    stats = ServingStats()
    b = DynamicBatcher(synth, max_batch=8, max_wait_ms=400.0, stats=stats, vocode=False)
    try:
        texts = ["one", "two two", "three three three", "four"]
        results, errors = {}, []

        def worker(t):
            def run():
                try:
                    results[t] = b.submit(t, spk, max_steps=16)
                except Exception as exc:  # pragma: no cover - reported below
                    errors.append(exc)
            return run

        _concurrently([worker(t) for t in texts])
        assert not errors
        assert set(results) == set(texts)
        for item in results.values():
            assert item["mel"].shape[0] == item["mel_length"] >= 1
            assert np.isfinite(item["mel"]).all()
        assert max(stats.batch_sizes) > 1, f"requests never coalesced: {stats.batch_sizes}"
        snap = stats.snapshot()
        assert snap["requests"] == 4 and "latency_ms" in snap
    finally:
        b.close()
    monkeypatch.undo()
    batch_texts, args, kwargs, out = next(c for c in calls if len(c[0]) > 1)
    again = synth.synthesize(batch_texts, *args, **kwargs)
    for text, got, want in zip(batch_texts, out, again):
        assert results[text] is got
        assert got["mel_length"] == want["mel_length"]
        np.testing.assert_array_equal(got["mel"], want["mel"])


def test_batcher_single_request_and_close(synth, spk):
    b = DynamicBatcher(synth, max_batch=4, max_wait_ms=1.0, vocode=False)
    try:
        assert b.submit("hello", spk, max_steps=16)["mel_length"] >= 1
    finally:
        b.close()
    with pytest.raises(RuntimeError):
        b.submit("after close", spk)


def test_batcher_propagates_errors(synth, spk):
    """A group that fails inside the worker (speaker ids on a model without
    a lookup table) resolves only its own requests with the error; the
    embedding group of the same window synthesizes, and the worker serves
    on."""
    b = DynamicBatcher(synth, max_batch=8, max_wait_ms=400.0, vocode=False)
    try:
        results, failures = {}, {}

        def good(t):
            def run():
                results[t] = b.submit(t, spk, max_steps=16)
            return run

        def by_id():
            try:
                b.submit("by id", speaker_id=0, max_steps=16)
            except Exception as exc:
                failures["id"] = exc

        _concurrently([good("alpha"), good("beta beta"), by_id])
        assert isinstance(failures["id"], ValueError)
        assert "no speaker lookup table" in str(failures["id"])
        assert set(results) == {"alpha", "beta beta"}
        assert b.submit("ok", spk, max_steps=16)["mel_length"] >= 1
    finally:
        b.close()


def test_bad_request_fails_alone_in_concurrent_window(synth, spk):
    """A malformed request (wrong embedding shape, non-string text) raises
    in its own caller at submit time; the good requests of the window all
    synthesize."""
    b = DynamicBatcher(synth, max_batch=8, max_wait_ms=400.0, vocode=False)
    try:
        good_texts = ["alpha", "beta beta", "gamma gamma gamma"]
        results, failures = {}, {}

        def good(t):
            def run():
                results[t] = b.submit(t, spk, max_steps=16)
            return run

        def bad_shape():
            try:
                b.submit("bad shape", np.zeros((3,), np.float32), max_steps=16)
            except Exception as exc:
                failures["shape"] = exc

        def bad_text():
            try:
                b.submit(12345, spk, max_steps=16)
            except Exception as exc:
                failures["text"] = exc

        _concurrently([good(t) for t in good_texts] + [bad_shape, bad_text])
        assert isinstance(failures.get("shape"), ValueError)
        assert "text" in failures
        assert set(results) == set(good_texts)
        for item in results.values():
            assert item["mel_length"] >= 1 and np.isfinite(item["mel"]).all()
    finally:
        b.close()


def test_missing_speaker_fails_at_submit(synth):
    b = DynamicBatcher(synth, max_batch=4, max_wait_ms=1.0, vocode=False)
    try:
        with pytest.raises(ValueError, match="speaker-conditioned"):
            b.submit("no speaker", None, max_steps=16)
    finally:
        b.close()


# -- HTTP ------------------------------------------------------------------------


def _post(url: str, payload, accept: str = "") -> tuple:
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST")
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _get(url: str) -> tuple:
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _read_chunked(sock) -> tuple[list, bytes]:
    """An HTTP/1.1 chunked response off a raw socket: its chunk payloads (each
    framed and flushed before the terminal 0-chunk) and its header block."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        data = sock.recv(65536)
        assert data, "connection closed before headers"
        buf += data
    headers, buf = buf.split(b"\r\n\r\n", 1)
    if b"Transfer-Encoding: chunked" not in headers:
        n = 0
        for line in headers.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                n = int(line.split(b":")[1])
        while len(buf) < n:
            data = sock.recv(65536)
            if not data:
                break
            buf += data
        raise AssertionError(f"non-chunked reply: {headers!r} body {buf!r}")

    def need(n):
        nonlocal buf
        while len(buf) < n:
            data = sock.recv(65536)
            assert data, "connection closed mid-chunk"
            buf += data

    chunks = []
    while True:
        while b"\r\n" not in buf:
            need(len(buf) + 1)
        size_line, buf = buf.split(b"\r\n", 1)
        size = int(size_line.split(b";")[0], 16)
        if size == 0:
            break
        need(size + 2)
        chunks.append(buf[:size])
        buf = buf[size + 2:]
    return chunks, headers


def _stream(port: int, payload: dict) -> tuple[list, bytes]:
    body = json.dumps(payload).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=300) as sock:
        sock.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        return _read_chunked(sock)


@pytest.fixture(scope="module")
def server(synth, spk):
    srv = TTSServer(synth, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=5.0)
    srv.registry.register("spk0", spk)
    srv.start_background()
    yield srv
    srv.shutdown()


def test_http_synthesize_json(server):
    base = f"http://127.0.0.1:{server.port}"
    status, ctype, body = _post(f"{base}/synthesize",
                                {"text": "hello world", "speaker": "spk0", "max_steps": 16})
    assert status == 200 and ctype == "application/json"
    out = json.loads(body)
    assert out["mel_length"] >= 1
    assert out["sample_rate"] == server.synth.dsp_cfg.sample_rate
    wav, sr = wav_io.load_wav(io.BytesIO(base64.b64decode(out["wav_b64"])))
    assert sr == out["sample_rate"]
    assert len(wav) == max(out["mel_length"] - 1, 1) * server.synth.dsp_cfg.hop


def test_http_synthesize_raw_wav(server):
    status, ctype, body = _post(f"http://127.0.0.1:{server.port}/synthesize",
                                {"text": "raw please", "speaker": "spk0", "max_steps": 16},
                                accept="audio/wav")
    assert status == 200 and ctype == "audio/wav"
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"


def test_http_synthesize_errors(server):
    base = f"http://127.0.0.1:{server.port}"
    status, _, body = _post(f"{base}/synthesize", {"speaker": "spk0"})
    assert status == 400 and b"text" in body
    status, _, body = _post(f"{base}/synthesize", {"text": "x", "speaker": "nobody"})
    assert status == 400 and b"unknown speaker" in body
    status, _, body = _post(f"{base}/synthesize", {"text": "x"})
    assert status == 400 and b"speaker-conditioned" in body
    status, _, _ = _post(f"{base}/synthesize", b"{not json")
    assert status == 400


def test_http_enroll_and_list(server):
    base = f"http://127.0.0.1:{server.port}"
    status, _, body = _post(f"{base}/enroll?name=newspk", OTHER_WAV.read_bytes())
    assert status == 200 and json.loads(body)["ok"]
    status, body = _get(f"{base}/speakers")
    assert status == 200 and {"newspk", "spk0"} <= set(json.loads(body))
    np.testing.assert_allclose(server.registry.get("newspk"),
                               server.synth.enroll([str(OTHER_WAV)]), atol=1e-7)
    status, _, _ = _post(f"{base}/synthesize",
                         {"text": "new speaker", "speaker": "newspk", "max_steps": 16})
    assert status == 200


def test_http_health_and_stats(server):
    base = f"http://127.0.0.1:{server.port}"
    status, body = _get(f"{base}/healthz")
    assert status == 200 and json.loads(body)["ok"]
    _post(f"{base}/synthesize", {"text": "stats", "speaker": "spk0", "max_steps": 16})
    status, body = _get(f"{base}/stats")
    snap = json.loads(body)
    assert snap["requests"] >= 1
    assert snap["compiled_programs"] == len(server.synth.compile_counts) >= 2
    assert "spk0" in snap["speakers"]
    assert _get(f"{base}/nope")[0] == 404


def test_http_stream_chunked(server):
    """/stream delivers a streaming WAV header and >= 2 incrementally framed
    PCM chunks, equal to ``Synthesizer.stream`` trimmed to the decoded
    length. A no-stop configuration (threshold > 1) keeps every segment's
    audio (the checkpoint's stop token ends this text within one segment)."""
    synth = server.synth
    no_stop = Synthesizer(synth.hp.replace(Decoder={"Stop_Threshold": 1.5}),
                          *_trees(), device="cpu")
    srv = TTSServer(no_stop, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=5.0)
    srv.registry.register("spk0", server.registry.get("spk0"))
    srv.start_background()
    try:
        payload = {"text": "stream me some audio please", "speaker": "spk0",
                   "max_steps": 64, "segment_steps": 12}
        chunks, headers = _stream(srv.port, payload)
    finally:
        srv.shutdown()
    assert b"200" in headers.split(b"\r\n")[0]
    assert chunks[0][:4] == b"RIFF" and chunks[0][8:12] == b"WAVE"
    assert len(chunks[1:]) >= 2, [len(c) for c in chunks]
    got = np.frombuffer(b"".join(chunks[1:]), "<i2")
    want, final = [], 0
    for item in no_stop.stream([payload["text"]], server.registry.get("spk0"), max_steps=64,
                               segment_steps=12, pcm16=True):
        want.append(item["wav_chunk"][0])
        final = int(item["mel_lengths"][0])
    np.testing.assert_array_equal(got, np.concatenate(want)[:final * synth.dsp_cfg.hop])


def test_http_stream_errors(server):
    base = f"http://127.0.0.1:{server.port}"
    status, _, body = _post(f"{base}/stream", {"text": "x", "speaker": "nobody"})
    assert status == 400 and b"unknown speaker" in body
    status, _, body = _post(f"{base}/stream", {"speaker": "spk0"})
    assert status == 400 and b"text" in body


def test_stream_on_the_cbhg_checkpoint_answers_501():
    """The full checkpoint's CBHG head cannot stream: 501 with the reason."""
    params, batch_stats, meta = load_compact(ROOT / "demo" / "serving_ckpt_full.msgpack")
    full = Synthesizer(Recursive_Parse(meta["hp"]), params, batch_stats, device="cpu")
    srv = TTSServer(full, host="127.0.0.1", port=0)
    srv.registry.register("spk0", np.eye(full.tacotron.speaker_embedding_size,
                                         dtype=np.float32)[0])
    srv.start_background()
    try:
        status, _, body = _post(f"http://127.0.0.1:{srv.port}/stream",
                                {"text": "hello", "speaker": "spk0"})
    finally:
        srv.shutdown()
    assert status == 501
    assert "bidirectional GRU needs the full sequence" in json.loads(body)["error"]


def _trees():
    """(params, batch_stats) of the module's checkpoint, for a second
    Synthesizer over the same weights."""
    params, batch_stats, _ = load_compact(CKPT)
    return params, batch_stats


# -- against the JAX server -------------------------------------------------------


@pytest.fixture(scope="module")
def servers(ckpt, spk):
    """A JAX server and a port server over the same checkpoint, overrides and
    registered embedding."""
    params, batch_stats, meta = ckpt
    jax_synth = JaxSynthesizer(JaxRecursiveParse(meta["hp"]).replace(**OVERRIDES), params,
                               batch_stats)
    port_synth = Synthesizer(Recursive_Parse(meta["hp"]).replace(**OVERRIDES), params,
                             batch_stats, device="cpu")
    pair = (JaxTTSServer(jax_synth, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=5.0),
            TTSServer(port_synth, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=5.0))
    for srv in pair:
        srv.registry.register("spk0", spk)
        srv.start_background()
    yield pair
    for srv in pair:
        srv.shutdown()


def _bases(servers):
    return [f"http://127.0.0.1:{srv.port}" for srv in servers]


BAD_PAYLOADS = [
    ("/synthesize", {"speaker": "spk0"}),
    ("/synthesize", {"text": "   ", "speaker": "spk0"}),
    ("/synthesize", {"text": 5, "speaker": "spk0"}),
    ("/synthesize", {"text": "x", "speaker": "nobody"}),
    ("/synthesize", {"text": "x"}),
    ("/synthesize", {"text": "x", "speaker_embedding": [0.1, 0.2]}),
    ("/synthesize", {"text": "x", "speaker_embedding": [[0.1] * 64]}),
    ("/synthesize", {"text": "x", "speaker": "spk0", "max_steps": "many"}),
    ("/synthesize", {"text": "x", "speaker": "spk0", "max_steps": [3]}),
    ("/synthesize", {"text": "x", "speaker": "spk0", "max_steps": 0}),
    ("/synthesize", {"text": "@@@", "speaker": "spk0"}),
    ("/synthesize", {"text": "x", "speaker_id": 0, "max_steps": 16}),
    ("/synthesize", b"{not json"),
    ("/stream", {"text": "x", "speaker": "nobody"}),
    ("/stream", {"speaker": "spk0"}),
    ("/stream", {"text": "x", "speaker": "spk0", "segment_steps": "few"}),
    ("/stream", {"text": "x", "speaker": "spk0", "segment_steps": 65}),
    ("/stream", {"text": "@@@", "speaker": "spk0"}),
    ("/stream", b"[1, 2"),
    ("/enroll", b"RIFF"),
    ("/enroll?name=x", b"not a wav"),
    ("/nowhere", {"text": "x"}),
]


@pytest.mark.parametrize("path, payload", BAD_PAYLOADS, ids=lambda v: str(v)[:40])
def test_bad_requests_match_the_jax_server(servers, path, payload):
    """Each malformed payload: the JAX server's status and error body, word
    for word (a speaker id on a GE2E model fails inside the worker, in
    both, with the same ValueError)."""
    got = [_post(base + path, payload) for base in _bases(servers)]
    assert got[1][0] == got[0][0] >= 400
    assert json.loads(got[1][2]) == json.loads(got[0][2])


def test_lone_synthesize_matches_the_jax_server(servers):
    jax_out, port_out = (json.loads(_post(f"{base}/synthesize", {
        "text": "the quick brown fox", "speaker": "spk0", "max_steps": 40})[2])
        for base in _bases(servers))
    assert port_out["mel_length"] == jax_out["mel_length"]
    assert port_out["sample_rate"] == jax_out["sample_rate"]
    assert port_out["duration_s"] == jax_out["duration_s"]
    want, got = (wav_io.load_wav(io.BytesIO(base64.b64decode(o["wav_b64"])))[0]
                 for o in (jax_out, port_out))
    assert got.shape == want.shape
    # int16 on the wire: one quantization step beside the f32 tolerance.
    assert np.abs(got - want).max() <= WAV_REL_TOL * np.abs(want).max() + 1 / 32768


def test_mel_only_stream_matches_the_jax_server(servers):
    payload = {"text": "a short stream", "speaker": "spk0", "max_steps": 64,
               "segment_steps": 12}
    (jax_chunks, _), (port_chunks, _) = (_stream(srv.port, payload) for srv in servers)
    assert len(port_chunks) == len(jax_chunks) >= 2
    assert port_chunks[0] == jax_chunks[0]  # the streaming WAV header
    want, got = (np.frombuffer(b"".join(c[1:]), "<i2").astype(np.float64)
                 for c in (jax_chunks, port_chunks))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= WAV_REL_TOL * np.abs(want).max() + 1


def test_compiled_programs_match_the_jax_server(servers):
    """The same requests reached the same program keys (``/stats``
    ``compiled_programs``)."""
    jax_srv, port_srv = servers
    assert set(port_srv.synth.compile_counts) == set(jax_srv.synth.compile_counts)
    snaps = [json.loads(_get(f"{base}/stats")[1]) for base in _bases(servers)]
    assert snaps[1]["compiled_programs"] == snaps[0]["compiled_programs"] >= 3


# -- LUT speakers ------------------------------------------------------------------


def test_speaker_lut_matches_the_jax_module():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(5, 8)).astype(np.float32)
    table[3] *= 1e-9  # below the 1e-6 norm floor
    ids = np.asarray([0, 3, 4, 3], np.int32)
    want = np.asarray(JaxSpeakerLUT(num_speakers=5, embedding_size=8).apply(
        {"params": {"table": {"embedding": jnp.asarray(table)}}}, jnp.asarray(ids)))
    lut = SpeakerLUT(5, 8)
    with torch.no_grad():
        lut.table.weight.copy_(torch.from_numpy(table))
        got = lut(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.fixture(scope="module")
def lut_model(ckpt):
    """The small checkpoint's weights as a closed-set model: Type LUT, four
    speakers, a seeded table of the checkpoint's embedding width."""
    params, batch_stats, meta = ckpt
    emb = int(meta["hp"]["Speaker_Embedding"]["Embedding_Size"])
    table = np.random.default_rng(7).normal(size=(4, emb)).astype(np.float32)
    params = {k: v for k, v in params.items() if k != "ge2e"}
    params["speaker_lut"] = {"table": {"embedding": table}}
    lut = dict(OVERRIDES, Speaker_Embedding={"Type": "LUT", "Num_Speakers": 4})
    port = Synthesizer(Recursive_Parse(meta["hp"]).replace(**lut), params, batch_stats,
                       device="cpu")
    return port, params, batch_stats, JaxRecursiveParse(meta["hp"]).replace(**lut), table


def test_lut_speaker_ids_equal_the_normalized_row(lut_model):
    port, *_, table = lut_model
    texts = ["hello world."]
    by_id = port.synthesize(texts, speaker_ids=[2], max_steps=32)[0]
    row = table[2] / np.float32(np.linalg.norm(table[2]))
    by_row = port.synthesize(texts, row, max_steps=32)[0]
    assert by_id["mel_length"] == by_row["mel_length"]
    # The same row up to the norm's summation order (one f32 ulp).
    assert np.abs(by_id["mel"] - by_row["mel"]).max() <= 1e-6
    np.testing.assert_allclose(port.embed_speaker_ids([2])[0], row, rtol=1e-6)


def test_lut_synthesize_matches_jax(lut_model):
    port, params, batch_stats, jax_hp, _ = lut_model
    texts = ["the quick brown fox", "a b c"]
    want = JaxSynthesizer(jax_hp, params, batch_stats).synthesize(
        texts, speaker_ids=[1, 3], max_steps=48, vocode=False)
    got = port.synthesize(texts, speaker_ids=[1, 3], max_steps=48, vocode=False)
    for w, g in zip(want, got):
        assert g["mel_length"] == w["mel_length"]
        assert np.abs(g["mel"] - w["mel"]).max() <= MEL_TOL


def test_lut_server_serves_speaker_ids(lut_model):
    port, *_ = lut_model
    srv = TTSServer(port, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=5.0)
    srv.start_background()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        status, _, body = _post(f"{base}/synthesize",
                                {"text": "hello", "speaker_id": 1, "max_steps": 16})
        assert status == 200 and json.loads(body)["mel_length"] >= 1
        status, _, body = _post(f"{base}/synthesize", {"text": "hello"})
        assert status == 400 and b"speaker-conditioned" in body
    finally:
        srv.shutdown()


# -- the inference CLI --------------------------------------------------------------


@pytest.mark.parametrize("stream", [False, True], ids=["synthesize", "stream"])
def test_inference_cli_on_the_cpu(tmp_path, stream):
    """``python -m multi_speaker_tts_tpu_torch.inference -device cpu`` on the
    small checkpoint as it is: utt_0.wav holds the port's own synthesis of
    the request (and, plain, its mel)."""
    text = "hello world."
    argv = ["-checkpoint", str(CKPT), "-text", text, "-ref", str(ENROLL_WAV),
            "-out", str(tmp_path), "-device", "cpu", "-max_steps", "48"]
    port_inference.main(argv + (["-stream"] if stream else []))
    wav, sr = wav_io.load_wav(tmp_path / "utt_0.wav")
    synth = Synthesizer.from_compact(str(CKPT), device="cpu")
    emb = synth.enroll([str(ENROLL_WAV)])
    assert sr == synth.hp.Sound.Sample_Rate
    if stream:
        chunks = list(synth.stream([text], emb, max_steps=48))
        n = max(int(chunks[-1]["mel_lengths"][0]) - 1, 1) * synth.dsp_cfg.hop
        want = np.concatenate([c["wav_chunk"] for c in chunks], axis=1)[0, :n]
    else:
        item = synth.synthesize([text], emb, max_steps=48)[0]
        np.testing.assert_array_equal(np.load(tmp_path / "utt_0_mel.npy"), item["mel"])
        want = item["wav"]
    # save_wav writes 16-bit PCM, peak-normalized where it clips.
    want = want / max(1.0, float(np.abs(want).max()))
    np.testing.assert_array_equal(wav, (want * 32767.0).astype(np.int16) / np.float32(32768.0))


def test_cli_refuses_what_the_port_cannot_read(tmp_path):
    with pytest.raises(SystemExit):
        port_inference.main(["-checkpoint", str(tmp_path), "-text", "x", "-device", "cpu"])
    from multi_speaker_tts_tpu_torch import serve

    with pytest.raises(SystemExit):
        serve.main(["-checkpoint", str(tmp_path), "-device", "cpu"])
