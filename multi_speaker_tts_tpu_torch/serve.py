"""The serving daemon (port of ``multi_speaker_tts_tpu.serve``): dynamic
request batching and an HTTP API over the port's ``Synthesizer``.

- :class:`DynamicBatcher` -- a background worker that drains a request
  queue into batches (up to ``max_batch`` rows or ``max_wait_ms``,
  whichever comes first), runs ONE ``Synthesizer.synthesize`` a batch (its
  pow2 batch / token / decode buckets and the stop-aware early exit do the
  rest) and hands each request its own row. Requests are checked when they
  are submitted, so a malformed one fails in its own caller and never
  poisons the requests batched with it.
- :class:`SpeakerRegistry` -- named speaker embeddings, enrolled at boot
  (``-enroll name=wav``) or over HTTP, so requests name speakers instead of
  shipping embeddings.
- A stdlib HTTP front end (``ThreadingHTTPServer``): POST ``/synthesize``
  (JSON in, WAV out), POST ``/stream`` (JSON in, chunked-transfer WAV out
  while the decoder runs, ``Synthesizer.stream`` with the device lock held
  a segment at a time), POST ``/enroll``, GET ``/speakers`` / ``/stats`` /
  ``/healthz``.

All device work goes through one lock: the batcher's worker thread and the
HTTP threads call into the port, and one program on the card at a time is
how a one-card server runs. ``Synthesizer.synthesize``, ``stream``,
``enroll`` and ``embed_speaker_ids`` run without autograd (grad mode is
per thread in torch, and each is decorated ``torch.no_grad``); the kernels
build at first use under a lock of their own (``ops/_build.py``). A failure
inside a batch, on the card or not, resolves that batch's requests with
the error (the client gets 500); nothing falls back to the CPU.

CLI (the card by default; ``-device cpu`` runs the plain versions)::

    python -m multi_speaker_tts_tpu_torch.serve -checkpoint demo/serving_ckpt_full.msgpack \
        -enroll spk0=demo/enroll_spk0_utt0.wav -quantize bf16_pallas [-port 8000] [-warmup]

``/stream`` answers 501 for a checkpoint with the CBHG linear head (its
bidirectional GRU needs the whole sequence) and for the HiFi-GAN vocoder
(``-hp`` with ``Vocoder.Type: HiFiGAN``, its weights read from the ``.npz``
that ``Vocoder.HiFiGAN.Weights`` names); the mel-only and Conv-head
configurations stream under Griffin-Lim.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from multi_speaker_tts_tpu_torch import text as text_frontend
from multi_speaker_tts_tpu_torch.audio import wav_io
from multi_speaker_tts_tpu_torch.hparams import load_hyper_parameters
from multi_speaker_tts_tpu_torch.inference import Synthesizer, _decode_bucket
from multi_speaker_tts_tpu_torch.models.hifigan import read_weights


# ---------------------------------------------------------------------------
# Stats


class ServingStats:
    """Thread-safe serving counters: request latencies (bounded window),
    batch-size histogram, error count. ``snapshot()`` feeds ``/stats``."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._latencies_ms: deque = deque(maxlen=window)
        self.batch_sizes: dict[int, int] = {}
        self.requests = 0
        self.errors = 0

    def record_request(self, latency_ms: float) -> None:
        with self._lock:
            self.requests += 1
            self._latencies_ms.append(latency_ms)

    def record_batch(self, size: int) -> None:
        with self._lock:
            self.batch_sizes[size] = self.batch_sizes.get(size, 0) + 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies_ms, np.float64)
            out = {
                "requests": self.requests,
                "errors": self.errors,
                "batch_size_histogram": dict(sorted(self.batch_sizes.items())),
            }
            if lat.size:
                out["latency_ms"] = {
                    "p50": round(float(np.percentile(lat, 50)), 2),
                    "p95": round(float(np.percentile(lat, 95)), 2),
                    "p99": round(float(np.percentile(lat, 99)), 2),
                    "mean": round(float(lat.mean()), 2),
                    "window": int(lat.size),
                }
            return out


# ---------------------------------------------------------------------------
# Dynamic batching


@dataclass
class _Pending:
    text: str
    speaker_embedding: np.ndarray | None
    speaker_id: int | None
    max_steps: int | None
    done: threading.Event = field(default_factory=threading.Event)
    result: dict | None = None
    error: Exception | None = None
    enqueued_at: float = field(default_factory=time.perf_counter)


class DynamicBatcher:
    """Coalesces concurrent synthesis requests into Synthesizer batches.

    A single worker thread drains the queue: the first request opens a
    batch window; further requests join until ``max_batch`` rows are
    collected or ``max_wait_ms`` elapses. The batch then runs ONE
    ``Synthesizer.synthesize`` call (pow2 batch/token/decode buckets +
    stop-aware early exit do the rest) and each request's future is
    resolved with its own row. Requests may carry different speakers and
    lengths — every pipeline op is row-independent.

    ``synth_kwargs`` are passed through to ``synthesize`` (e.g.
    ``pcm16=True, return_linear=False`` for a wav-serving deployment).
    """

    def __init__(
        self,
        synth: Synthesizer,
        max_batch: int = 32,
        max_wait_ms: float = 15.0,
        stats: ServingStats | None = None,
        device_lock: threading.Lock | None = None,
        **synth_kwargs,
    ):
        self.synth = synth
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.stats = stats or ServingStats()
        self.device_lock = device_lock or threading.Lock()
        self.synth_kwargs = dict(synth_kwargs)
        self.synth_kwargs.setdefault("return_linear", False)
        self._queue: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._worker = threading.Thread(
            target=self._run, name="tts-batcher", daemon=True
        )
        self._worker.start()

    # -- client side ---------------------------------------------------------
    def submit(
        self,
        text: str,
        speaker_embedding: np.ndarray | None = None,
        speaker_id: int | None = None,
        max_steps: int | None = None,
        timeout: float | None = 120.0,
    ) -> dict:
        """Enqueue one utterance and block until its row is synthesized.

        Returns the per-utterance dict from ``Synthesizer.synthesize``
        (wav, mel, alignment, mel_length). Raises the batch's exception if
        synthesis failed, TimeoutError if the deadline passes.

        Request validation happens HERE, before the request joins a
        batch: the text is encoded through the model's front-end (the
        exact deterministic call ``synthesize`` will repeat) and the
        embedding shape is checked, so a malformed request raises in its
        own caller and can never poison the co-batched requests of other
        clients."""
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        try:
            seq = text_frontend.encode_text(text, self.synth.hp)
        except Exception as exc:
            raise ValueError(f"text failed to encode: {exc!r}") from exc
        if not any(t != text_frontend.EOS_ID for t in seq):
            # encode_text always appends EOS, so "no usable content" means
            # the sequence is EOS-only (every char was dropped by cleaners).
            raise ValueError(
                f"text encodes to no tokens under the model front-end: "
                f"{text!r}"
            )
        emb_size = self.synth.tacotron.speaker_embedding_size
        if emb_size and speaker_embedding is None and speaker_id is None:
            raise ValueError(
                "model is speaker-conditioned: pass speaker_embedding or "
                "speaker_id"
            )
        if speaker_embedding is not None:
            speaker_embedding = np.asarray(speaker_embedding, np.float32)
            if (speaker_embedding.ndim != 1
                    or (emb_size
                        and speaker_embedding.shape[0] != emb_size)):
                raise ValueError(
                    f"speaker_embedding must be shape ({emb_size},); got "
                    f"{speaker_embedding.shape}"
                )
        req = _Pending(
            text=text,
            speaker_embedding=(
                None if speaker_embedding is None
                else np.asarray(speaker_embedding, np.float32)
            ),
            speaker_id=speaker_id,
            max_steps=max_steps,
        )
        self._queue.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError(f"synthesis timed out after {timeout}s")
        if req.error is not None:
            raise req.error
        self.stats.record_request(
            (time.perf_counter() - req.enqueued_at) * 1e3
        )
        return req.result

    def close(self) -> None:
        self._closed.set()
        self._queue.put(None)  # wake the worker
        self._worker.join(timeout=10.0)

    # -- worker side ---------------------------------------------------------
    def _collect(self) -> list[_Pending]:
        """Block for the first request, then drain until max_batch rows or
        the wait window closes."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        while not self._closed.is_set():
            batch = self._collect()
            if not batch:
                continue
            # A window's requests may mix conditioning kinds (enrolled
            # embedding vs LUT speaker id vs unconditioned); synthesize
            # takes one kind per call, so run one sub-batch per kind.
            # A failure resolves only ITS group's futures.
            for group in self._partition(batch):
                self.stats.record_batch(len(group))
                try:
                    self._synthesize_batch(group)
                except Exception as exc:  # resolve the futures, never wedge
                    self.stats.record_error()
                    for req in group:
                        req.error = exc
                        req.done.set()

    @staticmethod
    def _partition(batch: list[_Pending]) -> list[list[_Pending]]:
        groups: dict[str, list[_Pending]] = {}
        for req in batch:
            kind = ("emb" if req.speaker_embedding is not None
                    else "id" if req.speaker_id is not None else "none")
            groups.setdefault(kind, []).append(req)
        return list(groups.values())

    def _synthesize_batch(self, batch: list[_Pending]) -> None:
        texts = [r.text for r in batch]
        spk = None
        if batch[0].speaker_embedding is not None:
            spk = np.stack([r.speaker_embedding for r in batch])
        ids = None
        if spk is None and batch[0].speaker_id is not None:
            ids = [r.speaker_id for r in batch]
        # One decode bucket per batch: the largest explicit cap, or
        # auto-bucketing from the longest text when none is set.
        caps = [r.max_steps for r in batch if r.max_steps is not None]
        max_steps = max(caps) if len(caps) == len(batch) else None
        with self.device_lock:
            results = self.synth.synthesize(
                texts, spk, max_steps=max_steps, speaker_ids=ids,
                **self.synth_kwargs,
            )
        for req, res in zip(batch, results):
            req.result = res
            req.done.set()


# ---------------------------------------------------------------------------
# Speaker registry


class SpeakerRegistry:
    """Named speaker embeddings: enroll once, synthesize by name."""

    def __init__(self, synth: Synthesizer,
                 device_lock: threading.Lock | None = None):
        self.synth = synth
        self.device_lock = device_lock or threading.Lock()
        self._lock = threading.Lock()
        self._speakers: dict[str, np.ndarray] = {}

    def enroll(self, name: str, wavs) -> np.ndarray:
        with self.device_lock:
            emb = self.synth.enroll(wavs)
        with self._lock:
            self._speakers[name] = emb
        return emb

    def register(self, name: str, embedding: np.ndarray) -> None:
        """Store an already-computed embedding under a name (no device
        work) — for callers that enrolled through their own Synthesizer."""
        with self._lock:
            self._speakers[name] = np.asarray(embedding, np.float32)

    def get(self, name: str) -> np.ndarray | None:
        with self._lock:
            return self._speakers.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._speakers)


# ---------------------------------------------------------------------------
# HTTP front-end


class _HTTPServer(ThreadingHTTPServer):
    """A listen backlog of 128 (the stdlib's is 5): a burst of up to
    ``max_batch`` concurrent connections is accepted at once, not partly on
    the clients' SYN retries a second later, past the batch window."""

    request_queue_size = 128


class TTSServer:
    """Owns the Synthesizer, batcher, registry, and the HTTP server."""

    def __init__(
        self,
        synth: Synthesizer,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_batch: int = 32,
        max_wait_ms: float = 15.0,
        **synth_kwargs,
    ):
        self.synth = synth
        self.stats = ServingStats()
        self.device_lock = threading.Lock()
        self.batcher = DynamicBatcher(
            synth, max_batch=max_batch, max_wait_ms=max_wait_ms,
            stats=self.stats, device_lock=self.device_lock, **synth_kwargs,
        )
        self.registry = SpeakerRegistry(synth, device_lock=self.device_lock)
        handler = _make_handler(self)
        self.httpd = _HTTPServer((host, port), handler)
        self.httpd.daemon_threads = True

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self) -> None:
        print(f"serving on http://{self.httpd.server_address[0]}:{self.port}")
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(
            target=self.httpd.serve_forever, name="tts-http", daemon=True
        )
        t.start()
        return t

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()

    def warmup(self, text: str = "warmup", speaker: np.ndarray | None = None,
               speaker_id: int | None = None) -> None:
        """One request of the common shape before traffic: the first use
        builds the kernels (``nvcc``, seconds), loads them and packs the
        weights, so that the first real request does not pay for it."""
        t0 = time.perf_counter()
        self.batcher.submit(text, speaker, speaker_id=speaker_id)
        print(f"warmup run: {time.perf_counter() - t0:.1f}s")

    # -- request handlers (called from HTTP threads) --------------------------
    def _parse_request(self, payload: dict):
        """Shared /synthesize + /stream validation. Returns either
        ``(None, (status, ctype, body))`` on error or
        ``((text, spk, speaker_id, max_steps), None)``. The messages are the
        JAX server's, word for word."""
        text = payload.get("text")
        if not isinstance(text, str) or not text.strip():
            return None, (400, "application/json",
                          _jerr("missing or empty 'text'"))
        spk = None
        speaker_id = payload.get("speaker_id")
        name = payload.get("speaker")
        if name is not None:
            spk = self.registry.get(str(name))
            if spk is None:
                return None, (400, "application/json", _jerr(
                    f"unknown speaker {name!r}; enrolled: "
                    f"{self.registry.names()}"
                ))
        elif payload.get("speaker_embedding") is not None:
            spk = np.asarray(payload["speaker_embedding"], np.float32)
        if spk is not None:
            want = self.synth.tacotron.speaker_embedding_size
            if spk.ndim != 1 or (want and spk.shape[0] != want):
                return None, (400, "application/json", _jerr(
                    f"speaker embedding must be a flat vector of "
                    f"{want} floats, got shape {spk.shape}"
                ))
        if (spk is None and speaker_id is None
                and self.synth.tacotron.speaker_embedding_size):
            return None, (400, "application/json", _jerr(
                "model is speaker-conditioned: pass 'speaker' (an enrolled "
                "name), 'speaker_embedding' (floats), or 'speaker_id'"
            ))
        max_steps = payload.get("max_steps")
        if max_steps is not None:
            try:
                max_steps = int(max_steps)
            except (TypeError, ValueError):
                return None, (400, "application/json", _jerr(
                    f"'max_steps' must be an integer, got {max_steps!r}"
                ))
            if max_steps < 1:
                return None, (400, "application/json",
                              _jerr("'max_steps' must be >= 1"))
            # Quantize the client value to a pow2 bucket (no floor, so
            # small explicit budgets stay exact), as the JAX server does:
            # there every distinct value is a compiled program; here it
            # keeps the batches' decode buckets, and with them the audio,
            # the same as the JAX server's.
            max_steps = _decode_bucket(
                max_steps, int(self.synth.hp.Decoder.Max_Step), floor=1
            )
        return (text, spk, speaker_id, max_steps), None

    def handle_synthesize(self, payload: dict, accept: str) -> tuple:
        parsed, err = self._parse_request(payload)
        if err is not None:
            return err
        text, spk, speaker_id, max_steps = parsed
        try:
            item = self.batcher.submit(
                text, spk, speaker_id=speaker_id, max_steps=max_steps,
            )
        except ValueError as exc:  # submit-time validation: client error
            self.stats.record_error()
            return 400, "application/json", _jerr(str(exc))
        except Exception as exc:
            self.stats.record_error()
            return 500, "application/json", _jerr(f"synthesis failed: {exc}")

        sr = self.synth.dsp_cfg.sample_rate
        wav_bytes = _wav_bytes(item["wav"], sr)
        if "audio/wav" in (accept or ""):
            return 200, "audio/wav", wav_bytes
        body = json.dumps({
            "sample_rate": sr,
            "mel_length": int(item["mel_length"]),
            "duration_s": round(len(item["wav"]) / sr, 3),
            "wav_b64": base64.b64encode(wav_bytes).decode("ascii"),
        }).encode()
        return 200, "application/json", body

    def stream_pcm(self, text: str, spk: np.ndarray | None = None,
                   speaker_id: int | None = None,
                   max_steps: int | None = None,
                   segment_steps: int = 16):
        """Yield PCM16 byte chunks for one utterance as decoding
        progresses (``Synthesizer.stream`` under the hood, ``pcm16=True``
        so the conversion happens on the device).

        The device lock is held PER SEGMENT — around each ``next()`` of
        the stream generator, i.e. one segment decode + windowed vocode —
        not for the whole request, so concurrent batched ``/synthesize``
        requests interleave with a long stream instead of waiting for it.
        Chunks are trimmed to the decoded length: the
        stream's pad region past ``mel_lengths*hop`` is silence and is
        never sent."""
        seq = text_frontend.encode_text(text, self.synth.hp)
        if not any(t != text_frontend.EOS_ID for t in seq):
            # encode_text always appends EOS, so "no usable content" means
            # the sequence is EOS-only (every char was dropped by cleaners).
            raise ValueError(
                f"text encodes to no tokens under the model front-end: "
                f"{text!r}"
            )
        gen = self.synth.stream(
            [text], spk,
            speaker_ids=None if speaker_id is None else [speaker_id],
            max_steps=max_steps, segment_steps=segment_steps, pcm16=True,
        )
        hop = self.synth.dsp_cfg.hop
        try:
            while True:
                with self.device_lock:
                    try:
                        item = next(gen)
                    except StopIteration:
                        break
                chunk = np.asarray(item["wav_chunk"][0])
                total = int(item["mel_lengths"][0]) * hop
                off = int(item["frame_offset"]) * hop
                valid = max(0, min(chunk.shape[0], total - off))
                if valid:
                    yield np.asarray(chunk[:valid], "<i2").tobytes()
                if item.get("done"):
                    break
        finally:
            gen.close()

    def handle_enroll(self, name: str, body: bytes) -> tuple:
        if not name:
            return 400, "application/json", _jerr("pass ?name=<speaker>")
        try:
            wav, _ = wav_io.load_wav(
                io.BytesIO(body), target_sr=self.synth.hp.Sound.Sample_Rate
            )
        except Exception as exc:
            return 400, "application/json", _jerr(f"bad wav body: {exc}")
        self.registry.enroll(name, [wav])
        return 200, "application/json", json.dumps(
            {"ok": True, "name": name, "n_samples": int(len(wav))}
        ).encode()

    def handle_stats(self) -> tuple:
        snap = self.stats.snapshot()
        snap["compiled_programs"] = len(self.synth.compile_counts)
        snap["speakers"] = self.registry.names()
        return 200, "application/json", json.dumps(snap).encode()


def _jerr(msg: str) -> bytes:
    return json.dumps({"error": msg}).encode()


def _wav_stream_header(sample_rate: int, channels: int = 1,
                       bits: int = 16) -> bytes:
    """A WAV header with unknown (0xFFFFFFFF) RIFF/data sizes — the
    standard streaming-WAV convention; players treat the stream as
    until-EOF. Lets ``/stream`` responses be piped straight into any
    audio player while chunks are still being decoded."""
    byte_rate = sample_rate * channels * bits // 8
    return (
        b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                byte_rate, channels * bits // 8, bits)
        + b"data" + struct.pack("<I", 0xFFFFFFFF)
    )


def _wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    wav_io.save_wav(buf, wav, sample_rate)
    return buf.getvalue()


def _make_handler(server: TTSServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, status: int, ctype: str, body: bytes) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._reply(200, "application/json", b'{"ok": true}')
            elif path == "/stats":
                self._reply(*server.handle_stats())
            elif path == "/speakers":
                self._reply(200, "application/json",
                            json.dumps(server.registry.names()).encode())
            else:
                self._reply(404, "application/json", _jerr("not found"))

        def _write_chunk(self, data: bytes) -> None:
            # Manual HTTP/1.1 chunked framing (BaseHTTPRequestHandler has
            # no built-in support): <hex size>\r\n<data>\r\n.
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        def _stream(self, payload: dict) -> None:
            parsed, err = server._parse_request(payload)
            if err is not None:
                self._reply(*err)
                return
            text, spk, speaker_id, max_steps = parsed
            # segment_steps is a program key of the JAX server too: the
            # same small fixed range.
            try:
                segment_steps = int(payload.get("segment_steps", 16))
            except (TypeError, ValueError):
                self._reply(400, "application/json", _jerr(
                    "'segment_steps' must be an integer"))
                return
            if not 1 <= segment_steps <= 64:
                self._reply(400, "application/json", _jerr(
                    "'segment_steps' must be in [1, 64]"))
                return
            try:
                gen = server.stream_pcm(
                    text, spk, speaker_id=speaker_id, max_steps=max_steps,
                    segment_steps=segment_steps,
                )
                first = next(gen, b"")  # surface validation and model errors
            except NotImplementedError as exc:  # e.g. CBHG linear head
                server.stats.record_error()
                self._reply(501, "application/json", _jerr(str(exc)))
                return
            except ValueError as exc:
                server.stats.record_error()
                self._reply(400, "application/json", _jerr(str(exc)))
                return
            except Exception as exc:
                server.stats.record_error()
                self._reply(500, "application/json",
                            _jerr(f"stream failed: {exc}"))
                return
            sr = server.synth.dsp_cfg.sample_rate
            t0 = time.perf_counter()
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Sample-Rate", str(sr))
            self.end_headers()
            try:
                self._write_chunk(_wav_stream_header(sr))
                if first:
                    self._write_chunk(first)
                for data in gen:
                    if data:
                        self._write_chunk(data)
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
                server.stats.record_request(
                    (time.perf_counter() - t0) * 1e3
                )
            except (BrokenPipeError, ConnectionResetError):
                pass  # client hung up mid-stream
            except Exception:
                # Headers are sent; abort the chunked body so the client
                # sees a truncated (invalid) stream rather than silence.
                server.stats.record_error()
                self.close_connection = True

        def do_POST(self):
            parsed = urlparse(self.path)
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else b""
            if parsed.path in ("/synthesize", "/stream"):
                try:
                    payload = json.loads(body or b"{}")
                except json.JSONDecodeError as exc:
                    self._reply(400, "application/json",
                                _jerr(f"bad json: {exc}"))
                    return
                if parsed.path == "/stream":
                    self._stream(payload)
                else:
                    self._reply(*server.handle_synthesize(
                        payload, self.headers.get("Accept", "")
                    ))
            elif parsed.path == "/enroll":
                q = parse_qs(parsed.query)
                name = (q.get("name") or [""])[0]
                self._reply(*server.handle_enroll(name, body))
            else:
                self._reply(404, "application/json", _jerr("not found"))

    return Handler


# ---------------------------------------------------------------------------
# CLI


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="TTS serving daemon")
    parser.add_argument("-checkpoint", required=True,
                        help=".msgpack compact checkpoint (export_compact) or a "
                             "training checkpoint directory")
    parser.add_argument("-hp", "--hyper_parameters", default=None,
                        help="hyper-parameters (YAML, needs pyyaml, or JSON) in place "
                             "of the checkpoint's own")
    parser.add_argument("-host", default="127.0.0.1")
    parser.add_argument("-port", type=int, default=8000)
    parser.add_argument("-max_batch", type=int, default=32)
    parser.add_argument("-max_wait_ms", type=float, default=15.0)
    parser.add_argument("-enroll", action="append", default=[],
                        metavar="NAME=WAV",
                        help="enroll a named speaker at boot (repeatable)")
    parser.add_argument("-pcm16", action="store_true",
                        help="convert waveforms to int16 on the device")
    parser.add_argument("-warmup", action="store_true",
                        help="serve one request before accepting traffic "
                             "(builds and loads the kernels)")
    parser.add_argument("-quantize", default=None, choices=["int8", "int8_pallas", "bf16_pallas"],
                        help="the AR decode: weight-only int8, or the decode "
                             "kernel with int8 or bf16 gates")
    parser.add_argument("-device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    hp = load_hyper_parameters(args.hyper_parameters) if args.hyper_parameters else None

    try:
        synth = Synthesizer.from_path(args.checkpoint, hp=hp, quantize=args.quantize,
                                      device=args.device, vocoder_params=read_weights(hp))
    except FileNotFoundError as e:  # no such file, or a directory without a checkpoint
        parser.error(f"-checkpoint {args.checkpoint!r}: {e}")
    server = TTSServer(
        synth, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        pcm16=args.pcm16,
    )
    for spec in args.enroll:
        name, _, path = spec.partition("=")
        if not path:
            parser.error(f"-enroll expects NAME=WAV, got {spec!r}")
        server.registry.enroll(name, [path])
        print(f"enrolled speaker {name!r} from {path}")

    if args.warmup:
        names = server.registry.names()
        spk = server.registry.get(names[0]) if names else None
        sid = 0 if (spk is None and synth.speaker_lut is not None) else None
        server.warmup(speaker=spk, speaker_id=sid)

    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
