"""Serving surface: model weights -> per-speaker transcripts.

Mirrors ``multimodal_av_model_tpu/infer.py:43-157`` (``decode_ids`` for
"greedy" and "prefix_beam", ``Transcriber.from_checkpoint`` and
``transcribe``).  The forward and the decode run on ``device`` (the card
unless the caller asks for the CPU); the host reads back only the decoded
ids, to turn them into text.

    model = MultiSpeakerAVModel(cfg.model, dtype)
    model.load_state_dict(from_jax_variables(variables))   # or init_weights
    t = Transcriber(cfg, tokenizer, model)
    t = Transcriber.from_checkpoint(cfg, tokenizer, "ckpt/best_wer.ckpt")
    texts = t.transcribe(batch)     # [(speaker1_text, speaker2_text), ...]
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .config import Config, torch_dtype
from .models.av_model import MultiSpeakerAVModel
from .ops.ctc import ctc_greedy_decode
from .ops.prefix_beam_search import prefix_beam_search_decode


def load_fusion_lm(path: str, device) -> torch.Tensor | None:
    """Bigram LM table ``[V+1, V]`` (``.npy`` log-probs) for shallow fusion;
    '' -> None.  Checked as
    ``multimodal_av_model_tpu/text/ngram_lm.py:57 load_bigram_lm`` does."""
    if not path:
        return None
    lm = np.load(path)
    if lm.ndim != 2 or lm.shape[0] != lm.shape[1] + 1:
        raise ValueError(f"not a bigram LM table: shape {lm.shape}")
    return torch.from_numpy(lm.astype(np.float32)).to(device)


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
    raise ValueError(f"decode algorithm {config.decode.algorithm!r} is not ported")


_BATCH_KEYS = ("lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")


@dataclasses.dataclass
class Transcriber:
    config: Config
    tokenizer: Any
    model: MultiSpeakerAVModel
    device: str = "cuda"

    def __post_init__(self):
        self.model = self.model.to(self.device).eval()
        self.lm = load_fusion_lm(self.config.decode.lm_path, self.device)

    @classmethod
    def from_checkpoint(cls, config: Config, tokenizer, path, device: str = "cuda",
                        dtype: torch.dtype | None = None) -> "Transcriber":
        """A Transcriber on the model of a port checkpoint (parameters and
        BatchNorm statistics, loaded strictly by name).  ``path`` may be a
        list of checkpoint files of one run, averaged first
        (``train.checkpoints.average_checkpoints``).  The compute dtype is
        ``config.model.dtype`` unless given."""
        from .train.checkpoints import average_checkpoints, restore_checkpoint

        ckpt = (average_checkpoints(list(path)) if isinstance(path, (list, tuple))
                else restore_checkpoint(path))
        state = ckpt.get("state", ckpt)
        model = MultiSpeakerAVModel(config.model, dtype or torch_dtype(config.model.dtype))
        model.load_state_dict(state.get("model", state), strict=True)
        return cls(config, tokenizer, model, device)

    @torch.no_grad()
    def transcribe(self, batch: dict, use_beam: bool = True):
        """Batch dict (collate layout; tensors or numpy arrays) -> list of
        ``(speaker1_text, speaker2_text)``."""
        args = []
        for k in _BATCH_KEYS:
            x = batch[k]
            x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
            args.append(x.to(self.device))
        out = self.model(*args)
        B = out["log_probs1"].shape[0]
        # The decode rows are independent, so both speakers run as one [2B] batch.
        ids, lens = decode_ids(
            self.config, torch.cat([out["log_probs1"], out["log_probs2"]]),
            torch.cat([out["input_lengths1"], out["input_lengths2"]]), use_beam, self.lm)
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        return [(self.tokenizer.decode(ids[b, : lens[b]].tolist()),
                 self.tokenizer.decode(ids[B + b, : lens[B + b]].tolist()))
                for b in range(B)]
