"""Serving surface: model weights -> transcripts.

Mirrors ``multimodal_av_model_tpu/infer.py:43-340``: ``decode_ids``
("greedy", "prefix_beam", "reference_beam"), ``Transcriber`` (the flagship:
``from_checkpoint``, ``transcribe``), ``AudioTranscriber`` (the audio-only
model), each optionally served from int8 weights (``quantize=True``,
``ops/quantize.py``: the fp parameters are dropped and the int8 form is
dequantized per forward), and the serving export: ``export_transcriber``
writes one bucket shape's whole serving computation (forward, K1 as the
operator ``mmav::log_mel``, and the decode; ids out) as a ``torch.export``
program, and ``ExportedTranscriber.load`` serves it with no model class and
no config.  The forward and the decode run on ``device`` (the card unless the
caller asks for the CPU); the host reads back only the decoded ids, to turn
them into text.

    model = MultiSpeakerAVModel(cfg.model, dtype)
    model.load_state_dict(from_jax_variables(variables))   # or init_weights
    t = Transcriber(cfg, tokenizer, model)
    t = Transcriber.from_checkpoint(cfg, tokenizer, "ckpt/best_wer.ckpt")
    texts = t.transcribe(batch)     # [(speaker1_text, speaker2_text), ...]
    export_transcriber(t, "artifact", batch)          # batch fixes the shapes
    texts = ExportedTranscriber.load("artifact").transcribe(batch)
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from .config import Config, require_flagship, torch_dtype
from .models.av_model import AudioOnlyCTC, MultiSpeakerAVModel, build_av_model
from .ops.beam_search import beam_search_decode
from .ops.ctc import ctc_greedy_decode
from .ops.prefix_beam_search import prefix_beam_search_decode
from .ops.quantize import QuantizedModel
from .text.ngram_lm import load_bigram_lm
from .tracing import span


def load_fusion_lm(path: str, device) -> torch.Tensor | None:
    """Bigram LM table ``[V+1, V]`` (``text/ngram_lm.py``) for shallow
    fusion, on ``device``; '' -> None."""
    if not path:
        return None
    return torch.from_numpy(load_bigram_lm(path)).to(device)


def decode_ids(config: Config, log_probs: torch.Tensor, lengths: torch.Tensor,
               use_beam: bool = True, lm: torch.Tensor | None = None):
    """Decoder dispatch per ``config.decode.algorithm`` -> ``(ids, out_len)``."""
    blank = config.model.decoder.blank_id
    if not use_beam or config.decode.algorithm == "greedy":
        return ctc_greedy_decode(log_probs, lengths, blank)
    if config.decode.algorithm == "prefix_beam":
        ids, out_len, _ = prefix_beam_search_decode(
            log_probs, lengths, config.decode.beam_width, config.decode.prefix_top_k,
            blank, lm=lm,
            lm_weight=config.decode.lm_weight if lm is not None else 0.0,
            length_bonus=config.decode.length_bonus if lm is not None else 0.0)
        return ids, out_len
    if config.decode.algorithm == "reference_beam":
        ids, out_len, _ = beam_search_decode(log_probs, lengths, config.decode.beam_width, blank)
        return ids, out_len
    raise ValueError(f"unknown decode algorithm {config.decode.algorithm!r}")


def load_weights(model: torch.nn.Module, path) -> torch.nn.Module:
    """The parameters and statistics of a port checkpoint (``state["model"]``),
    loaded strictly by name; ``path`` may be a list of checkpoint files of one
    run, averaged first (``train.checkpoints.average_checkpoints``)."""
    from .train.checkpoints import average_checkpoints, restore_checkpoint

    ckpt = (average_checkpoints(list(path)) if isinstance(path, (list, tuple))
            else restore_checkpoint(path))
    state = ckpt.get("state", ckpt)
    model.load_state_dict(state.get("model", state), strict=True)
    return model


def served(model: torch.nn.Module, device, quantize: bool = False, min_size: int = 4096):
    """``(forward, module)``: the model in eval mode on ``device``, or with
    ``quantize`` its int8 form (``ops/quantize.QuantizedModel``: only the
    int8 tensors, scales and unquantized tensors stay on the device; the
    module moves to the meta device)."""
    if quantize:
        q = QuantizedModel(model, device, min_size)
        return q, q.model
    model = model.to(device).eval()
    return model, model


def _tensor(x, device) -> torch.Tensor:
    """A tensor or numpy array on ``device``."""
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device)


def _texts(tokenizer, ids: torch.Tensor, lens: torch.Tensor) -> list[str]:
    ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
    return [tokenizer.decode(ids[b, : lens[b]].tolist()) for b in range(ids.shape[0])]


_BATCH_KEYS = ("lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")


@dataclasses.dataclass
class Transcriber:
    """The two-speaker model (``build_av_model``: the flagship or AV-HuBERT)
    served on ``device``.  ``forward`` runs it: the module, or with
    ``quantize`` its int8 form (``ops/quantize.QuantizedModel``, the flagship
    only; ``model`` then lives on the meta device)."""

    config: Config
    tokenizer: Any
    model: MultiSpeakerAVModel
    device: str = "cuda"
    quantize: bool = False
    quantize_min_size: int = 4096

    def __post_init__(self):
        if self.quantize:
            require_flagship(self.config.model, "int8 serving")
        self.forward, self.model = served(self.model, self.device, self.quantize,
                                           self.quantize_min_size)
        self.lm = load_fusion_lm(self.config.decode.lm_path, self.device)

    @classmethod
    def from_checkpoint(cls, config: Config, tokenizer, path, device: str = "cuda",
                        dtype: torch.dtype | None = None, quantize: bool = False,
                        quantize_min_size: int = 4096) -> "Transcriber":
        """A Transcriber on the model of a port checkpoint (``load_weights``;
        ``path`` may be a list, averaged).  The compute dtype is
        ``config.model.dtype`` unless given."""
        model = build_av_model(config.model, dtype or torch_dtype(config.model.dtype))
        return cls(config, tokenizer, load_weights(model, path), device, quantize,
                   quantize_min_size)

    @torch.no_grad()
    def transcribe(self, batch: dict, use_beam: bool = True):
        """Batch dict (collate layout; tensors or numpy arrays) -> list of
        ``(speaker1_text, speaker2_text)``.  Spans (``tracing``):
        ``transcribe`` and its ``.forward``, ``.decode`` and ``.readback``."""
        with span("transcribe"):
            with span("transcribe.forward"):
                out = self.forward(*[_tensor(batch[k], self.device) for k in _BATCH_KEYS])
            B = out["log_probs1"].shape[0]
            # The decode rows are independent, so both speakers run as one [2B] batch.
            with span("transcribe.decode"):
                ids, lens = decode_ids(
                    self.config, torch.cat([out["log_probs1"], out["log_probs2"]]),
                    torch.cat([out["input_lengths1"], out["input_lengths2"]]), use_beam, self.lm)
            with span("transcribe.readback"):
                texts = _texts(self.tokenizer, ids, lens)
            return list(zip(texts[:B], texts[B:]))


@dataclasses.dataclass
class AudioTranscriber:
    """The audio-only CTC model (``AudioOnlyCTC``) served on ``device``
    (``infer.py:306-340``), fp or int8 as ``Transcriber``."""

    config: Config
    tokenizer: Any
    model: AudioOnlyCTC
    device: str = "cuda"
    quantize: bool = False
    quantize_min_size: int = 4096

    def __post_init__(self):
        self.forward, self.model = served(self.model, self.device, self.quantize,
                                           self.quantize_min_size)
        self.lm = load_fusion_lm(self.config.decode.lm_path, self.device)

    @torch.no_grad()
    def transcribe(self, audio, sample_mask=None, use_beam: bool = True) -> list[str]:
        """``audio [B, S]`` (tensor or numpy), ``sample_mask [B, S]`` bool or
        None -> one text per row."""
        mask = None if sample_mask is None else _tensor(sample_mask, self.device)
        log_probs, lengths = self.forward(_tensor(audio, self.device).float(), mask)
        ids, lens = decode_ids(self.config, log_probs, lengths, use_beam, self.lm)
        return _texts(self.tokenizer, ids, lens)


class ServingProgram(torch.nn.Module):
    """The whole serving computation of a ``Transcriber`` as one module, the
    function ``export_transcriber`` exports (JAX's ``serve``,
    ``infer.py:199-221``): ``(lm, lip1, lip2, audio, mask1, mask2,
    lip1_lengths, lip2_lengths) -> (ids1, len1, ids2, len2)``, the decode on
    both speakers as one ``[2B]`` batch, as ``Transcriber.transcribe`` runs
    it.  ``lm`` is the bigram table or None.  The forward is the
    Transcriber's: the model, or its ``QuantizedModel``, whose buffers are
    the int8 tensors and scales."""

    def __init__(self, t: "Transcriber", use_beam: bool = True):
        super().__init__()
        self.config, self.use_beam = t.config, use_beam
        self.forward_model = t.forward

    def forward(self, lm, lip1, lip2, audio, mask1, mask2, lip1_lengths, lip2_lengths):
        out = self.forward_model(lip1, lip2, audio, mask1, mask2, lip1_lengths, lip2_lengths)
        B = out["log_probs1"].shape[0]
        ids, lens = decode_ids(
            self.config, torch.cat([out["log_probs1"], out["log_probs2"]]),
            torch.cat([out["input_lengths1"], out["input_lengths2"]]), self.use_beam, lm)
        return ids[:B], lens[:B], ids[B:], lens[B:]


def _program_device(program) -> torch.device:
    """The one device an exported program computes on (its weights and the
    devices baked into its graph); raises if it names several.  0-d tensors
    are left out: a CPU scalar takes part in a CUDA computation."""
    values = [n.meta.get("val") for n in program.graph.nodes]
    values += list(program.state_dict.values()) + list(program.constants.values())
    devices = {t.device for t in values if isinstance(t, torch.Tensor) and t.ndim > 0}
    if len(devices) != 1:
        raise ValueError(f"exported program spans devices {sorted(map(str, devices))}")
    return devices.pop()


def export_transcriber(t: Transcriber, out_dir: str, example_batch: dict,
                       use_beam: bool = True) -> dict:
    """Package ``t``'s whole serving computation for one bucket shape
    (``infer.py:160-254``).  Writes to ``out_dir``:

    * ``model.pt2``: ``torch.export.save`` of ``ServingProgram`` (forward
      and decode, ids out), its weights inside (the int8 tensors and scales
      for an int8 ``Transcriber``);
    * ``lm.npy``: the bigram table of ``config.decode.lm_path`` read now, as
      JAX reads it at export (an input of the program; None without one);
    * ``vocab.txt``: the tokenizer's vocabulary;
    * ``meta.json``: JAX's keys (``keys``, ``shapes``, ``use_beam``,
      ``algorithm``, ``has_lm``, ``quantized``).

    ``example_batch`` fixes every shape; each BiLSTM layer's recurrence is
    one ``mmav::lstm_scan`` node and the decode one ``mmav::prefix_beam``
    node.  The
    program computes on ``t.device``, where it is traced (devices are part
    of the graph).  Returns ``{"seconds", "nodes", "bytes"}``: the export's
    time, the graph's node count and ``model.pt2``'s size."""
    require_flagship(t.config.model, "the serving export")
    os.makedirs(out_dir, exist_ok=True)
    lm = load_fusion_lm(t.config.decode.lm_path, t.device)
    program = ServingProgram(t, use_beam).eval()
    args = (lm,) + tuple(_tensor(example_batch[k], t.device) for k in _BATCH_KEYS)
    t0 = time.perf_counter()
    with torch.no_grad():
        exported = torch.export.export(program, args, strict=False)
    seconds = time.perf_counter() - t0
    path = os.path.join(out_dir, "model.pt2")
    torch.export.save(exported, path)
    if lm is not None:
        np.save(os.path.join(out_dir, "lm.npy"), lm.cpu().numpy())
    vocab = getattr(t.tokenizer, "vocab_path", None)
    if vocab and os.path.isfile(vocab):
        shutil.copy(vocab, os.path.join(out_dir, "vocab.txt"))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({
            "keys": list(_BATCH_KEYS),
            "shapes": {k: list(np.shape(example_batch[k])) for k in _BATCH_KEYS},
            "use_beam": use_beam,
            "algorithm": t.config.decode.algorithm,
            "has_lm": lm is not None,
            "quantized": isinstance(t.forward, QuantizedModel),
        }, f, indent=2)
    return {"seconds": seconds, "nodes": len(exported.graph.nodes),
            "bytes": os.path.getsize(path)}


@dataclasses.dataclass
class ExportedTranscriber:
    """Serves an ``export_transcriber`` artifact (``infer.py:257-303``) with
    no model class and no config: the computation is the exported program.
    Batches must have the shapes it was exported at."""

    program: Any
    tokenizer: Any
    lm: torch.Tensor | None = None
    device: str = "cuda"

    def __post_init__(self):
        self.module = self.program.module()

    @classmethod
    def load(cls, out_dir: str, tokenizer=None, device: str = "cuda") -> "ExportedTranscriber":
        """The artifact in ``out_dir``, served on ``device``, which must be
        the device it was exported on (raises otherwise).  Loading needs the
        operators the graph calls registered, and the tokenizer."""
        from .ops import logmel, resize  # noqa: F401  (mmav::log_mel, mmav::lip_preprocess)
        from .text import CharTokenizer

        program = torch.export.load(os.path.join(out_dir, "model.pt2"))
        where = _program_device(program)
        if where.type != torch.device(device).type:
            raise ValueError(f"the artifact in {out_dir} computes on {where}, not on {device}: "
                             "export it on the device that serves it")
        lm_path = os.path.join(out_dir, "lm.npy")
        lm = torch.from_numpy(np.load(lm_path)).to(where) if os.path.isfile(lm_path) else None
        if tokenizer is None:
            tokenizer = CharTokenizer(os.path.join(out_dir, "vocab.txt"))
        return cls(program, tokenizer, lm, str(where))

    @torch.no_grad()
    def transcribe(self, batch: dict):
        """Batch dict (collate layout; tensors or numpy arrays) -> list of
        ``(speaker1_text, speaker2_text)``."""
        ids1, len1, ids2, len2 = self.module(
            self.lm, *[_tensor(batch[k], self.device) for k in _BATCH_KEYS])
        return list(zip(_texts(self.tokenizer, ids1, len1), _texts(self.tokenizer, ids2, len2)))
