"""PyTorch port, online serving: ``serve.py``'s ``DynamicBatcher``,
``AudioService`` and ``serve_http``, with the behaviours
``tests/test_serve.py`` holds the JAX package's to (coalescing, ``max_batch``,
error propagation, the bounded queue, deadlines, the static batch shape,
pairing through pad rows, resampling, the HTTP surface on a local port),
then the service over the port's ``AudioTranscriber`` against JAX's on the
same weights (CPU, f32, tiny widths)."""

import io
import json
import os
import time
import urllib.request
import wave as wave_mod

import numpy as np
import pytest

from multimodal_av_model_tpu_torch.serve import AudioService, DynamicBatcher


def test_batcher_coalesces_concurrent_requests():
    seen = []

    def infer(items):
        seen.append(len(items))
        time.sleep(0.02)            # device-busy window for coalescing
        return [x * 10 for x in items]

    b = DynamicBatcher(infer, max_batch=8, max_wait_ms=30)
    futs = [b.submit(i) for i in range(20)]
    results = [f.result(5) for f in futs]
    b.close()
    assert results == [i * 10 for i in range(20)]
    assert sum(seen) == 20
    # while batch k runs, k+1's requests queue up -> later batches coalesce
    assert max(seen) > 1
    assert b.stats.requests == 20 and b.stats.batches == len(seen)


def test_batcher_respects_max_batch():
    sizes = []

    def infer(items):
        sizes.append(len(items))
        return items

    b = DynamicBatcher(infer, max_batch=4, max_wait_ms=200)
    futs = [b.submit(i) for i in range(10)]
    for f in futs:
        f.result(5)
    b.close()
    assert max(sizes) <= 4


def test_batcher_propagates_errors_and_keeps_serving():
    def infer(items):
        if any(x < 0 for x in items):
            raise ValueError("bad item")
        return items

    b = DynamicBatcher(infer, max_batch=1, max_wait_ms=1)
    with pytest.raises(ValueError):
        b.submit(-1).result(5)
    assert b.submit(7).result(5) == 7
    b.close()


def test_batcher_bounded_queue_sheds_overload():
    """Flood a slow batcher past its queue bound: excess submits raise
    Overloaded immediately, admitted requests all complete, and their
    latency is bounded by queue_depth/throughput + one device forward —
    NOT by the (unbounded) offered load."""
    from multimodal_av_model_tpu_torch.serve import Overloaded

    step_s = 0.02

    def infer(items):
        time.sleep(step_s)          # fixed device time per batch
        return items

    b = DynamicBatcher(infer, max_batch=4, max_wait_ms=1, max_queue=8)
    admitted, shed = [], 0
    t0 = time.monotonic()
    for i in range(64):             # burst far above queue+batch capacity
        try:
            admitted.append((i, b.submit(i), time.monotonic()))
        except Overloaded:
            shed += 1
    assert shed > 0 and b.stats.shed_queue_full == shed
    lat = []
    for i, f, t_sub in admitted:
        assert f.result(10) == i
        lat.append(time.monotonic() - t_sub)
    b.close()
    # Bound: <= ceil(max_queue+max_batch / max_batch)+1 device steps + slack.
    assert max(lat) < (8 / 4 + 2) * step_s + 0.5
    # The batcher still serves after shedding.
    b2 = DynamicBatcher(infer, max_batch=4, max_wait_ms=1, max_queue=8)
    assert b2.submit(5).result(5) == 5
    b2.close()


def test_batcher_deadline_sheds_stale_requests():
    """Requests older than deadline_ms when they reach the head of the queue
    get DeadlineExceeded instead of a stale (still expensive) execution."""
    from multimodal_av_model_tpu_torch.serve import DeadlineExceeded

    def infer(items):
        time.sleep(0.05)
        return items

    b = DynamicBatcher(infer, max_batch=1, max_wait_ms=1, deadline_ms=60)
    futs = [b.submit(i) for i in range(8)]
    outcomes = []
    for f in futs:
        try:
            f.result(10)
            outcomes.append("ok")
        except DeadlineExceeded:
            outcomes.append("shed")
    b.close()
    # Early requests (queue wait < 60ms) succeed; late ones (wait would be
    # up to 8*50ms) are shed before touching the device.
    assert outcomes[0] == "ok"
    assert "shed" in outcomes
    assert b.stats.shed_deadline == outcomes.count("shed")


def test_http_surface_returns_503_on_overload():
    """End-to-end: a flooded HTTP server answers 503 (not a hung socket)."""
    import threading
    import urllib.error

    from multimodal_av_model_tpu_torch.serve import serve_http

    class SlowTranscriber:
        def transcribe(self, audio, mask, use_beam=True):
            time.sleep(0.1)
            return ["x"] * audio.shape[0]

    svc = AudioService(SlowTranscriber(), max_batch=1, max_seconds=0.01,
                       max_wait_ms=1, max_queue=1)
    server = serve_http(svc, port=0, block=False)
    port = server.server_address[1]
    codes = []
    lock = threading.Lock()

    def post():
        body = np.zeros(160, np.float32).tobytes()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/transcribe", data=body,
            headers={"X-Sample-Rate": "16000"})
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
        with lock:
            codes.append(code)

    threads = [threading.Thread(target=post) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.shutdown()
    svc.close()
    assert 200 in codes and 503 in codes
    # health endpoint reports the shed counters
    # (server already shut down, so read the stats object directly)
    assert svc.batcher.stats.shed_queue_full == codes.count(503)


class FakeTranscriber:
    """Stands in for infer.AudioTranscriber: returns per-row checksums so the
    test can verify request<->result pairing through pad rows."""

    def __init__(self):
        self.batch_shapes = []

    def transcribe(self, audio, mask, use_beam=True):
        self.batch_shapes.append(audio.shape)
        return [f"{audio[i].sum():.3f}:{int(mask[i].sum())}"
                for i in range(audio.shape[0])]


def test_audio_service_static_shape_and_pairing():
    ft = FakeTranscriber()
    svc = AudioService(ft, max_batch=4, max_seconds=0.01, max_wait_ms=5)
    S = svc.samples
    waves = [np.full((min(S, 40 + 13 * i),), 0.01 * (i + 1), np.float32)
             for i in range(9)]
    futs = [svc.submit(w) for w in waves]
    got = [f.result(5) for f in futs]
    svc.close()
    # every device call used the ONE static shape
    assert set(ft.batch_shapes) == {(4, S)}
    for w, text in zip(waves, got):
        assert text == f"{w.sum():.3f}:{len(w)}"


def test_audio_service_resamples():
    ft = FakeTranscriber()
    svc = AudioService(ft, max_batch=2, max_seconds=0.02, max_wait_ms=1)
    wave8k = np.ones((80,), np.float32)          # 10 ms at 8 kHz
    text = svc.transcribe(wave8k, rate=8000)
    svc.close()
    n_valid = int(text.split(":")[1])
    assert abs(n_valid - 160) <= 2               # ~10 ms at 16 kHz


def _wav_bytes(wave_f32, rate=16000):
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        pcm = np.clip(wave_f32 * 32767, -32768, 32767).astype(np.int16)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def test_http_server_round_trip():
    from multimodal_av_model_tpu_torch.serve import serve_http

    ft = FakeTranscriber()
    svc = AudioService(ft, max_batch=2, max_seconds=0.05, max_wait_ms=1)
    server = serve_http(svc, port=0, block=False)
    port = server.server_address[1]
    try:
        wav = _wav_bytes(np.ones((400,), np.float32) * 0.5)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/transcribe", data=wav, method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            out = json.load(r)
        assert ":" in out["text"] and out["latency_ms"] >= 0

        raw = np.ones((320,), np.float32).tobytes()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/transcribe", data=raw, method="POST",
            headers={"X-Sample-Rate": "16000"})
        with urllib.request.urlopen(req, timeout=10) as r:
            out2 = json.load(r)
        assert out2["text"].endswith(":320")

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            health = json.load(r)
        assert health["ok"] and health["requests"] >= 2
    finally:
        server.shutdown()
        svc.close()


def test_audio_service_over_the_port_transcriber_matches_jax():
    """Nine requests of different lengths (one at 8 kHz) through
    ``AudioService(max_batch=4)`` over the port's ``AudioTranscriber`` and
    over JAX's, on the same weights: every answer equal, and equal to a
    direct transcription of the request alone at the service's shape."""
    import jax
    import jax.numpy as jnp
    import torch

    from multimodal_av_model_tpu.infer import AudioTranscriber as JAudioTranscriber
    from multimodal_av_model_tpu.models import AudioOnlyCTC as JAudioOnly
    from multimodal_av_model_tpu.serve import AudioService as JAudioService
    from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
    from multimodal_av_model_tpu_torch.compat import audio_only_from_jax
    from multimodal_av_model_tpu_torch.data.audio_io import resample
    from multimodal_av_model_tpu_torch.infer import AudioTranscriber
    from multimodal_av_model_tpu_torch.models import AudioOnlyCTC
    from multimodal_av_model_tpu_torch.text import CharTokenizer
    from test_models import tiny_config
    from test_torch_models import port_config

    vocab = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
    cfg = tiny_config()
    cfg.model.decoder.vocab_size = 800
    S = 4000                                           # 0.25 s at 16 kHz
    v = jax.tree.map(np.asarray, jax.jit(JAudioOnly(cfg.model).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, S)), jnp.ones((1, S), bool)))
    model = AudioOnlyCTC(port_config(cfg).model)
    model.load_state_dict(audio_only_from_jax(v), strict=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t = AudioTranscriber(port_config(cfg), CharTokenizer(vocab), model, device="cpu")
        jt = JAudioTranscriber(cfg, JTokenizer(vocab), v, dtype=jnp.float32)
        rng = np.random.default_rng(0)
        reqs = [((rng.standard_normal(int(rng.integers(800, 5000))) * 0.3).astype(np.float32),
                 16000) for _ in range(8)]
        reqs.append(((rng.standard_normal(1500) * 0.3).astype(np.float32), 8000))
        answers = {}
        for name, tr, cls in (("port", t, AudioService), ("jax", jt, JAudioService)):
            svc = cls(tr, max_batch=4, max_seconds=S / 16000, max_wait_ms=20)
            futs = [svc.submit(w, r) for w, r in reqs]
            answers[name] = [f.result(60) for f in futs]
            svc.close()
        assert answers["port"] == answers["jax"]
        direct = []
        for w, r in reqs:
            w = resample(w, r, 16000)
            audio = np.zeros((4, S), np.float32)
            mask = np.zeros((4, S), bool)
            audio[0, :len(w[:S])], mask[0, :len(w[:S])] = w[:S], True
            direct.append(t.transcribe(audio, mask)[0])
        assert answers["port"] == direct
    finally:
        torch.set_num_threads(threads)
