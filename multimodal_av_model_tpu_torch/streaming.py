"""Streaming and long-form transcription at one static window shape.

Mirrors ``multimodal_av_model_tpu/streaming.py:47-714``:

* ``StreamingAudioTranscriber`` (``:132-306``): audio-only CTC over windows
  of ``[context | chunk]`` samples; context zeros go on the left and are
  masked out, only the new chunk's frames are emitted, and the encoder
  attends over the already-seen context;
* ``StreamingAVTranscriber`` (``:308-519``): the two-speaker flagship over
  windows of ``context + chunk`` video frames (context first, zeros on the
  right), preprocessed ``[T, 1, H, W]`` lips per speaker and the mixture;
  masks are 2 over valid samples and 3 elsewhere unless ``mask_fn`` gives
  them;
* ``StreamingPool`` (``:521-714``): up to ``max_streams`` audio streams
  through one ``[max_streams, window]`` forward per tick, greedy; the argmax
  runs on the device and only ``[B, frames]`` ids are read back.

Emission: greedy collapse carries the last raw token across windows (exact);
``algorithm="prefix_beam"`` carries a prefix beam per stream (and speaker)
(``_PrefixBeamStream``, ``:51-128``) and emits the tokens every live beam
agrees on, so streamed text never retracts; ``flush`` drains the best beam's
tail, then resets.  Frame clock: one encoder frame per ``hop_length *
subsample_factor`` samples; chunk and context snap to that multiple.

The windows are built on the host (numpy) and copied to ``device`` (the card
unless the caller asks for the CPU); the forward, the argmax and the beam
step run there.  ``forward_fn`` replaces the model (tests inject frame-local
oracles): ``(window [1, S], sample_mask [1, S]) -> log_probs [1, T, V]`` for
audio, ``(lip1, lip2, audio, mask1, mask2, len1, len2) -> (log_probs1,
log_probs2)`` for AV, on tensors on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .config import Config, require_flagship
from .infer import load_fusion_lm, served
from .ops.prefix_beam_search import _NEG_INF, prefix_beam_state_init, prefix_beam_stream_step


def _snap(n: int, multiple: int) -> int:
    return max(multiple, (n // multiple) * multiple)


def _collapse(raw: np.ndarray, prev: int, blank: int) -> tuple[list[int], int]:
    """Greedy CTC collapse of ``raw`` ids continuing from the raw token
    ``prev``: ``(emitted, last raw token)``."""
    out = []
    for tok in raw:
        tok = int(tok)
        if tok != prev and tok != blank:
            out.append(tok)
        prev = tok
    return out, prev


class _PrefixBeamStream:
    """Carried prefix-beam state over one stream of emitted frames
    (``streaming.py:51-128``): ``advance`` consumes the new frames of a
    window and returns the newly committed tokens (the prefix every live beam
    shares, beam 0 always live); ``tail`` returns the best beam's
    uncommitted rest.  When the buffer of ``capacity`` tokens could overflow
    within two more advances, the committed tokens are shifted out."""

    def __init__(self, decode_cfg, blank: int, n_frames: int, capacity: int, lm=None):
        self._dcfg = decode_cfg
        self._blank = blank
        self._n_frames = n_frames           # frames per advance
        self._capacity = capacity
        self._lm = lm
        self.state = None
        self.committed = 0

    def advance(self, log_probs: torch.Tensor, start: int, end: int) -> list[int]:
        dcfg = self._dcfg
        if self.state is None:
            self.state = prefix_beam_state_init(dcfg.beam_width, self._capacity,
                                                log_probs.device)
        # n_frames rows from `start`; as jax.lax.dynamic_slice_in_dim, the
        # start is clamped so that the slice fits (a torch slice would come
        # out shorter instead).  Rows past `end - start` are identity.
        T, n = log_probs.shape[0], self._n_frames
        if T < n:
            raise ValueError(f"{T} frames of log-probs, fewer than the {n} of an advance")
        s = min(max(start, 0), T - n)
        self.state = prefix_beam_stream_step(
            self.state, log_probs[s:s + n], end - start, top_k=dcfg.prefix_top_k,
            blank_id=self._blank, lm=self._lm,
            lm_weight=dcfg.lm_weight if self._lm is not None else 0.0,
            length_bonus=dcfg.length_bonus if self._lm is not None else 0.0)

        prefixes, lens, pb, pnb = (a.cpu().numpy() for a in self.state)
        total = np.logaddexp(np.maximum(pb, _NEG_INF), np.maximum(pnb, _NEG_INF))
        live = total > _NEG_INF / 2
        live[0] = True                               # the best beam always counts
        # Committed = the longest common prefix of the live beams.
        commit = int(lens[live].min())
        top = prefixes[0]
        for i in np.where(live)[0]:
            if commit == 0:
                break
            agree = prefixes[i, :commit] == top[:commit]
            commit = int(np.argmin(agree)) if not agree.all() else commit
        out = [int(t) for t in top[self.committed:commit]]
        self.committed = commit

        C = prefixes.shape[1]
        if self.committed and int(lens.max()) > C - 2 * n:
            k = self.committed
            shifted = np.full_like(prefixes, -1)
            shifted[:, :C - k] = prefixes[:, k:]
            dev = log_probs.device
            self.state = (torch.from_numpy(shifted).to(dev),
                          torch.from_numpy(np.maximum(lens - k, 0)).to(dev),
                          self.state[2], self.state[3])
            self.committed = 0
        return out

    def tail(self) -> list[int]:
        """The best beam's uncommitted tokens (drained at flush)."""
        if self.state is None:
            return []
        prefixes, lens = self.state[0][0].cpu().numpy(), int(self.state[1][0])
        return [int(t) for t in prefixes[self.committed:lens]]


def _audio_frame_sizes(config: Config, chunk_seconds: float, context_seconds: float):
    """``(samples per encoder frame, chunk, context)`` in samples, snapped."""
    fe = config.model.frontend
    spf = fe.hop_length * config.model.audio.subsample_factor
    return (spf, _snap(int(chunk_seconds * fe.sample_rate), spf),
            _snap(int(context_seconds * fe.sample_rate), spf))


@dataclasses.dataclass
class StreamingAudioTranscriber:
    """Incremental audio-only CTC transcription (``streaming.py:132-306``).

        s = StreamingAudioTranscriber(cfg, tok, model, chunk_seconds=2.0,
                                      context_seconds=8.0)
        for block in microphone():        # float32 blocks of any size
            print(s.feed(block), end="")  # newly emitted text, maybe ""
        print(s.flush())                  # the tail; then reset

    ``model`` is an ``AudioOnlyCTC`` (served fp or, with ``quantize``, int8);
    ``algorithm`` None takes ``config.decode.algorithm``: "prefix_beam"
    streams the beam, anything else the greedy collapse.
    """

    config: Config
    tokenizer: Any
    model: Any = None
    chunk_seconds: float = 2.0
    context_seconds: float = 8.0
    device: str = "cuda"
    forward_fn: Callable | None = None
    algorithm: str | None = None
    beam_capacity: int = 512            # transcript tokens per stream segment
    quantize: bool = False
    quantize_min_size: int = 4096

    def __post_init__(self):
        require_flagship(self.config.model, "streaming")
        self._samples_per_frame, self._chunk, self._ctx = _audio_frame_sizes(
            self.config, self.chunk_seconds, self.context_seconds)
        self._window = self._ctx + self._chunk
        if self.algorithm is None:
            self.algorithm = self.config.decode.algorithm
        self._beam = self.algorithm == "prefix_beam"
        self._lm = load_fusion_lm(self.config.decode.lm_path if self._beam else "", self.device)
        if self.forward_fn is None:
            forward, self.model = served(self.model, self.device, self.quantize,
                                         self.quantize_min_size)
            self.forward_fn = lambda window, mask: forward(window, mask)[0]
        self.reset()

    def reset(self) -> None:
        """Forget all buffered audio and decoder state."""
        self._buffer = np.zeros((0,), np.float32)   # not-yet-emitted samples
        self._context = np.zeros((0,), np.float32)  # already-emitted tail
        self._prev_raw = self.config.model.decoder.blank_id
        self._ids: list[int] = []
        self._beam_stream = (_PrefixBeamStream(
            self.config.decode, self.config.model.decoder.blank_id,
            self._chunk // self._samples_per_frame, self.beam_capacity,
            self._lm) if self._beam else None)

    @property
    def window_samples(self) -> int:
        return self._window

    @property
    def chunk_samples(self) -> int:
        return self._chunk

    def feed(self, samples) -> str:
        """Append audio; decode every complete chunk; return the new text."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, samples])
        emitted: list[int] = []
        while self._buffer.shape[0] >= self._chunk:
            chunk, self._buffer = self._buffer[:self._chunk], self._buffer[self._chunk:]
            emitted.extend(self._decode_window(chunk, self._chunk))
        return self._emit(emitted)

    def flush(self) -> str:
        """Decode the buffered tail (zero-padded, masked out), drain the beam,
        and reset."""
        emitted: list[int] = []
        n = self._buffer.shape[0]
        if n:
            emitted.extend(self._decode_window(np.pad(self._buffer, (0, self._chunk - n)), n))
        if self._beam_stream is not None:
            emitted.extend(self._beam_stream.tail())
        text = self._emit(emitted)
        self.reset()
        return text

    @property
    def text(self) -> str:
        """Everything emitted since the last ``reset``/``flush``."""
        return self.tokenizer.decode(self._ids)

    @torch.no_grad()
    def _decode_window(self, chunk: np.ndarray, valid: int) -> list[int]:
        """The model over ``[context | chunk]``, the new frames decoded;
        ``valid`` <= the chunk's length marks real samples."""
        ctx = self._context
        pad = self._ctx - ctx.shape[0]
        window = np.concatenate([np.zeros((pad,), np.float32), ctx, chunk])
        mask = np.ones((1, self._window), bool)
        mask[0, :pad] = False
        mask[0, self._ctx + valid:] = False
        log_probs = self.forward_fn(torch.from_numpy(window[None]).to(self.device),
                                    torch.from_numpy(mask).to(self.device))

        spf = self._samples_per_frame
        start = self._ctx // spf                       # the first new frame
        end = (self._ctx + valid + spf - 1) // spf     # past the last one
        if self._beam:
            out = self._beam_stream.advance(log_probs[0], start, end)
        else:
            raw = log_probs[0, start:end].argmax(dim=-1).cpu().numpy()
            out, self._prev_raw = _collapse(raw, self._prev_raw,
                                            self.config.model.decoder.blank_id)
        # Slide the context: keep the last ctx samples of real audio.
        tail = np.concatenate([ctx, chunk[:valid]])
        self._context = tail[-self._ctx:] if self._ctx else tail[:0]
        return out

    def _emit(self, ids: list[int]) -> str:
        self._ids.extend(ids)
        return self.tokenizer.decode(ids) if ids else ""


@dataclasses.dataclass
class StreamingAVTranscriber:
    """Streaming two-speaker transcription on the flagship
    (``streaming.py:308-519``): log-probs are anchored one to one to video
    frames, so windows are ``context_frames + chunk_frames`` frames of lips
    per speaker and ``frames * audio_samples_per_video_frame`` samples.

        s = StreamingAVTranscriber(cfg, tok, model)
        for lips1, lips2, audio in camera_and_mic():   # any block sizes
            t1, t2 = s.feed(lips1, lips2, audio)
        t1, t2 = s.flush()

    Lips come in preprocessed, ``[T, 1, H, W]`` f32 in [0, 1] (host
    preprocessing, as the JAX CLI does), so K2 is not on this path.
    ``mask_fn(n_valid_samples) -> (m1, m2)`` gives diarised speaker masks.
    """

    config: Config
    tokenizer: Any
    model: Any = None
    chunk_frames: int = 30              # 1 s of video at 30 fps
    context_frames: int = 120           # 4 s of already-seen media
    lip_size: int = 96
    device: str = "cuda"
    forward_fn: Callable | None = None
    algorithm: str | None = None
    beam_capacity: int = 512
    mask_fn: Callable | None = None

    def __post_init__(self):
        require_flagship(self.config.model, "streaming")
        self._spf = self.config.data.audio_samples_per_video_frame
        self._win_f = self.context_frames + self.chunk_frames
        self._win_s = self._win_f * self._spf
        if self.algorithm is None:
            self.algorithm = self.config.decode.algorithm
        self._beam = self.algorithm == "prefix_beam"
        self._lm = load_fusion_lm(self.config.decode.lm_path if self._beam else "", self.device)
        if self.forward_fn is None:
            forward, self.model = served(self.model, self.device)

            def av_forward(*args):
                out = forward(*args)
                return out["log_probs1"], out["log_probs2"]
            self.forward_fn = av_forward
        self.reset()

    def reset(self) -> None:
        H = self.lip_size
        self._lip_buf = [np.zeros((0, 1, H, H), np.float32) for _ in range(2)]
        self._lip_ctx = [np.zeros((0, 1, H, H), np.float32) for _ in range(2)]
        self._audio_buf = np.zeros((0,), np.float32)
        self._audio_ctx = np.zeros((0,), np.float32)
        blank = self.config.model.decoder.blank_id
        self._prev_raw = [blank, blank]
        self._ids: list[list[int]] = [[], []]
        self._beams = ([_PrefixBeamStream(self.config.decode, blank, self.chunk_frames,
                                          self.beam_capacity, self._lm)
                        for _ in range(2)] if self._beam else None)

    @property
    def chunk_samples(self) -> int:
        return self.chunk_frames * self._spf

    def feed(self, lips1, lips2, audio) -> tuple[str, str]:
        """Append synchronised media (lips ``[T, 1, H, W]``, audio
        ``[T * spf]``); decode every complete chunk; return each speaker's
        new text."""
        self._lip_buf[0] = np.concatenate([self._lip_buf[0], np.asarray(lips1, np.float32)])
        self._lip_buf[1] = np.concatenate([self._lip_buf[1], np.asarray(lips2, np.float32)])
        self._audio_buf = np.concatenate([self._audio_buf,
                                          np.asarray(audio, np.float32).reshape(-1)])
        emitted: list[list[int]] = [[], []]
        while (min(b.shape[0] for b in self._lip_buf) >= self.chunk_frames
               and self._audio_buf.shape[0] >= self.chunk_samples):
            out = self._decode_window(self.chunk_frames)
            emitted[0].extend(out[0])
            emitted[1].extend(out[1])
        return self._emit(emitted)

    def flush(self) -> tuple[str, str]:
        """Decode the buffered tail, drain the beams' tails, reset."""
        emitted: list[list[int]] = [[], []]
        n_f = min(min(b.shape[0] for b in self._lip_buf),
                  -(-self._audio_buf.shape[0] // self._spf))
        if n_f:
            out = self._decode_window(n_f)
            emitted[0].extend(out[0])
            emitted[1].extend(out[1])
        if self._beams is not None:
            for s in range(2):
                emitted[s].extend(self._beams[s].tail())
        text = self._emit(emitted)
        self.reset()
        return text

    def text(self, speaker: int) -> str:
        return self.tokenizer.decode(self._ids[speaker])

    @torch.no_grad()
    def _decode_window(self, valid_f: int) -> tuple[list[int], list[int]]:
        H = self.lip_size
        ctx_f = self._lip_ctx[0].shape[0]
        lips, new_ctx = [], []
        for s in range(2):
            chunk = self._lip_buf[s][:valid_f]
            self._lip_buf[s] = self._lip_buf[s][valid_f:]
            if chunk.shape[0] < valid_f:           # flush past the audio's tail
                chunk = np.concatenate(
                    [chunk, np.zeros((valid_f - chunk.shape[0], 1, H, H), np.float32)])
            win = np.zeros((1, self._win_f, 1, H, H), np.float32)
            win[0, :ctx_f] = self._lip_ctx[s]
            win[0, ctx_f:ctx_f + valid_f] = chunk
            lips.append(win)
            tail = np.concatenate([self._lip_ctx[s], chunk])
            new_ctx.append(tail[-self.context_frames:] if self.context_frames else tail[:0])

        valid_s = valid_f * self._spf
        a_chunk = self._audio_buf[:valid_s]
        self._audio_buf = self._audio_buf[valid_s:]
        if a_chunk.shape[0] < valid_s:
            a_chunk = np.pad(a_chunk, (0, valid_s - a_chunk.shape[0]))
        ctx_s = self._audio_ctx.shape[0]
        audio = np.zeros((1, self._win_s), np.float32)
        audio[0, :ctx_s] = self._audio_ctx
        audio[0, ctx_s:ctx_s + valid_s] = a_chunk
        a_tail = np.concatenate([self._audio_ctx, a_chunk])
        ctx_samples = self.context_frames * self._spf
        self._audio_ctx = a_tail[-ctx_samples:] if ctx_samples else a_tail[:0]

        n_valid_s = ctx_s + valid_s
        if self.mask_fn is not None:
            pad = (0, max(0, self._win_s - n_valid_s))
            m1, m2 = (np.pad(np.asarray(m, np.int32)[:self._win_s], pad,
                             constant_values=3)[None] for m in self.mask_fn(n_valid_s))
        else:
            m1 = np.full((1, self._win_s), 3, np.int32)
            m1[0, :n_valid_s] = 2
            m2 = m1
        lens = np.full((1,), ctx_f + valid_f, np.int32)

        def dev(x):
            return torch.from_numpy(x).to(self.device)
        lp1, lp2 = self.forward_fn(dev(lips[0]), dev(lips[1]), dev(audio), dev(m1), dev(m2),
                                   dev(lens), dev(lens))
        self._lip_ctx = new_ctx

        start, end = ctx_f, ctx_f + valid_f
        blank = self.config.model.decoder.blank_id
        out: list[list[int]] = []
        for s, lp in enumerate((lp1, lp2)):
            if self._beams is not None:
                out.append(self._beams[s].advance(lp[0], start, end))
                continue
            toks, self._prev_raw[s] = _collapse(lp[0, start:end].argmax(dim=-1).cpu().numpy(),
                                                self._prev_raw[s], blank)
            out.append(toks)
        return out[0], out[1]

    def _emit(self, emitted: list[list[int]]) -> tuple[str, str]:
        texts = []
        for s in range(2):
            self._ids[s].extend(emitted[s])
            texts.append(self.tokenizer.decode(emitted[s]) if emitted[s] else "")
        return texts[0], texts[1]


@dataclasses.dataclass
class StreamingPool:
    """Up to ``max_streams`` concurrent audio streams through one static
    ``[max_streams, window]`` forward per tick (``streaming.py:521-714``).
    Per stream, exactly the single-stream transcriber's greedy path (same
    window, context, mask and collapse carry); streams share the forward,
    never state.

        pool = StreamingPool(cfg, tok, model, max_streams=8)
        a, b = pool.open(), pool.open()
        pool.feed(a, mic_a_block); pool.feed(b, mic_b_block)
        print(pool.flush(a))        # stream a ends; its slot is free again
    """

    config: Config
    tokenizer: Any
    model: Any = None
    max_streams: int = 8
    chunk_seconds: float = 2.0
    context_seconds: float = 8.0
    device: str = "cuda"
    quantize: bool = False
    quantize_min_size: int = 4096

    def __post_init__(self):
        require_flagship(self.config.model, "streaming")
        self._spf, self._chunk, self._ctx = _audio_frame_sizes(
            self.config, self.chunk_seconds, self.context_seconds)
        self._window = self._ctx + self._chunk
        self._forward, self.model = served(self.model, self.device, self.quantize,
                                           self.quantize_min_size)
        B = self.max_streams
        self._active = [False] * B
        self._buffer = [None] * B
        self._context = [None] * B
        self._prev_raw = [0] * B
        self._pending: list[list[int]] = [[] for _ in range(B)]
        self._texts: list[list[int]] = [[] for _ in range(B)]

    @property
    def window_samples(self) -> int:
        return self._window

    @property
    def chunk_samples(self) -> int:
        return self._chunk

    def open(self) -> int:
        """Claim a free slot; returns the stream id."""
        for sid in range(self.max_streams):
            if not self._active[sid]:
                self._active[sid] = True
                self._buffer[sid] = np.zeros((0,), np.float32)
                self._context[sid] = np.zeros((0,), np.float32)
                self._prev_raw[sid] = self.config.model.decoder.blank_id
                self._pending[sid] = []
                self._texts[sid] = []
                return sid
        raise RuntimeError(f"all {self.max_streams} stream slots busy")

    def close(self, sid: int) -> None:
        self._active[sid] = False

    @property
    def active_streams(self) -> int:
        return sum(self._active)

    def feed(self, sid: int, samples) -> str:
        """Append audio to stream ``sid``; batch-decode every stream with a
        complete chunk; return ``sid``'s new text."""
        if not self._active[sid]:
            raise ValueError(f"stream {sid} is not open")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buffer[sid] = np.concatenate([self._buffer[sid], samples])
        while self._buffer[sid].shape[0] >= self._chunk:
            self._step()
        return self._drain(sid)

    def flush(self, sid: int) -> str:
        """Decode ``sid``'s buffered tail, return all its remaining text, free
        the slot."""
        while self._active[sid] and self._buffer[sid].shape[0] >= self._chunk:
            self._step()
        if self._buffer[sid].shape[0]:
            self._step(flush_sid=sid)
        text = self._drain(sid)
        self.close(sid)
        return text

    def text(self, sid: int) -> str:
        """Everything emitted on ``sid`` since ``open``."""
        return self.tokenizer.decode(self._texts[sid])

    def _drain(self, sid: int) -> str:
        out, self._pending[sid] = self._pending[sid], []
        return self.tokenizer.decode(out) if out else ""

    @torch.no_grad()
    def _step(self, flush_sid: int | None = None) -> None:
        """One batched tick: every active stream with a full chunk (and
        ``flush_sid``'s partial tail) advances one chunk together."""
        B, W = self.max_streams, self._window
        windows = np.zeros((B, W), np.float32)
        masks = np.zeros((B, W), bool)
        ready: list[tuple[int, int]] = []            # (sid, valid samples)
        for sid in range(B):
            if not self._active[sid]:
                continue
            buffered = self._buffer[sid].shape[0]
            if buffered >= self._chunk:
                valid = self._chunk
            elif sid == flush_sid and buffered:
                valid = buffered
            else:
                continue
            chunk = np.pad(self._buffer[sid][:valid], (0, self._chunk - valid))
            self._buffer[sid] = self._buffer[sid][valid:]
            ctx = self._context[sid]
            pad = self._ctx - ctx.shape[0]
            windows[sid] = np.concatenate([np.zeros((pad,), np.float32), ctx, chunk])
            masks[sid, pad:self._ctx + valid] = True
            tail = np.concatenate([ctx, chunk[:valid]])
            self._context[sid] = tail[-self._ctx:] if self._ctx else tail[:0]
            ready.append((sid, valid))
        if not ready:
            return
        log_probs, _ = self._forward(torch.from_numpy(windows).to(self.device),
                                     torch.from_numpy(masks).to(self.device))
        raw = log_probs.argmax(dim=-1).cpu().numpy()   # [B, frames] ids read back
        blank = self.config.model.decoder.blank_id
        start = self._ctx // self._spf
        for sid, valid in ready:
            end = (self._ctx + valid + self._spf - 1) // self._spf
            toks, self._prev_raw[sid] = _collapse(raw[sid, start:end], self._prev_raw[sid],
                                                  blank)
            self._pending[sid].extend(toks)
            self._texts[sid].extend(toks)
