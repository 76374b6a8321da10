"""Runner ``transcribe``: one client in a closed loop; a request is a raw
collated batch -> ``preprocess_batch_device`` -> ``Transcriber.transcribe``
-> texts, one request a unit.

The pool's requests are served in turn.  For each, the log-probabilities
and lengths the timed forward produced and the texts returned are kept
(the last time it was served).  After the window the program is freed and
``check_requests`` of the pool, drawn from the seed with the longest among
them, are judged:

* ``lp_err``: the widest ``|log-prob - reference's|`` over every token of
  every valid frame of both speakers; ``lp_rms``, its root mean square;
* ``lp_bias``: each token's gap averaged over every valid frame of every
  judged row, then the root mean square over the tokens.  Rounding of the
  activations averages out over ~10,000 frames; an error of the weights
  (coarser ones than the bf16 that the configuration computes with, and
  that the reference rounds its weights to) shifts a token alike at every
  frame and stays;
* ``lp_gap``: at every valid frame, how far the reference's log-probability
  of the program's best token lies below the reference's best (the widest
  such gap);
* ``len_mismatch``: rows whose decoded length differs from the reference's;
* ``decode_mismatch``: the decode stage judged from the program's own
  output: rows whose ids differ from the reference decoder's
  (``reference/decode.py``, float64) on the program's log-probabilities.
  The program searches in float32, so on a near tie the two can part: a
  rare row, never several;
* ``text_mismatch``: texts that differ from the program's ids read through
  the vocabulary file;
* ``ref_decode_mismatch`` (a second witness): rows whose ids differ from the
  reference decoder's on the reference's own log-probabilities.
"""

from __future__ import annotations

import time

import numpy as np

from .. import flops, traffic
from ..reference import decode as ref_decode
from ..reference import preprocess as ref_pre
from ..reference.model import Net
from . import common

KIND = "transcribe"


class Job:
    def __init__(self, ctx, quantize: bool = False):
        from multimodal_av_model_tpu_torch.data.device_pipeline import preprocess_batch_device
        from multimodal_av_model_tpu_torch.infer import Transcriber
        from multimodal_av_model_tpu_torch.text import CharTokenizer

        self.ctx, self.mix, self.device = ctx, ctx.mix, ctx.device
        self._preprocess = preprocess_batch_device
        self.pool = traffic.raw_batches(self.mix, ctx.seed)
        model, self.template = common.seeded_model(ctx)
        self.t = Transcriber(ctx.config, CharTokenizer(ctx.vocab_path), model, device=self.device,
                             quantize=quantize)
        self.outputs: dict[int, dict] = {}
        self.ids: dict[int, tuple] = {}
        self.texts: dict[int, list] = {}
        self._current = 0
        self._forward_end = None
        forward = self.t.forward

        def keep(*args):
            out = forward(*args)
            self.outputs[self._current] = out
            if self._spans is not None:
                self.sync()
                self._forward_end = time.perf_counter()
            return out

        self.t.forward = keep

        # The decoded ids, where the program produces them.
        from multimodal_av_model_tpu_torch import infer

        decode = self._decode = infer.decode_ids

        def keep_ids(*args, **kwargs):
            ids, lens = decode(*args, **kwargs)
            self.ids[self._current] = (ids, lens)
            return ids, lens

        infer.decode_ids = keep_ids
        self._spans = None
        self.next_unit = self.mix["warmup"]
        self.failed_units = 0

    # -- the timed path ---------------------------------------------------------

    def unit(self, i: int, spans=None) -> None:
        raw = self.pool[i % len(self.pool)]
        self._current, self._spans = i % len(self.pool), spans
        if spans is not None:
            self.sync()
            t0 = time.perf_counter()
        batch = self._preprocess(raw["lip1_raw"], raw["lip2_raw"], raw["audio1"], raw["audio2"],
                                 raw["audio1_len"], raw["audio2_len"],
                                 out_size=self.mix["lip_size"], device=self.device)
        batch["lip1_lengths"], batch["lip2_lengths"] = raw["lip1_lengths"], raw["lip2_lengths"]
        if spans is not None:
            self.sync()
            spans.add("preprocess", time.perf_counter() - t0)
        texts = self.t.transcribe(batch)
        if spans is not None:
            spans.add("decode", time.perf_counter() - self._forward_end)
        self.texts[self._current] = texts

    def sync(self) -> None:
        common.sync(self.device)

    def attach(self, spans) -> None:
        """Spans for a traced window: the encoders and the fusion by hooks."""
        m = self.t.model
        spans.hook("encoders", m.visual_encoder)
        spans.hook("encoders", m.audio_encoder)
        spans.hook("fusion", m.fusion)

    def warm_up(self) -> None:
        for k in range(self.mix["warmup"]):
            self.unit(k)
        self.sync()

    # -- results --------------------------------------------------------------------

    def end_to_end(self, lat, window_s: float) -> dict:
        return {"transcribe_p90_ms": percentile(lat, 90) * 1e3,
                "transcribe_utt_per_s": self.mix["batch"] * len(lat) / window_s}

    def flops_per_unit(self) -> float:
        B, T, S = common.shapes(self.mix)
        return flops.forward(self.ctx.model, B, T, S, self.mix["lip_size"])

    def kernel_work(self) -> dict:
        return common.kernel_work(self.mix, self.ctx.model["frontend"])

    def launches(self) -> dict:
        return common.launches()

    def sample(self) -> list[int]:
        """Pool indices to judge: the longest request and others drawn from the seed."""
        P = len(self.pool)
        frames = [int(r["lip1_lengths"].sum() + r["lip2_lengths"].sum()) for r in self.pool]
        longest = int(np.argmax(frames))
        rest = np.random.default_rng(self.ctx.seed ^ 0x5A).permutation(
            [i for i in range(P) if i != longest])
        return [longest] + [int(i) for i in rest[:self.mix["check_requests"] - 1]]

    def served(self, idx: list[int]) -> dict:
        """The kept outputs of requests ``idx`` on the host."""
        import torch

        got = {}
        for i in idx:
            out = self.outputs[i]
            ids, lens = self.ids[i]
            got[i] = {"lp": torch.cat([out["log_probs1"], out["log_probs2"]]).float().cpu(),
                      "len": torch.cat([out["input_lengths1"], out["input_lengths2"]]).cpu(),
                      "ids": [ids[r, : int(lens[r])].tolist() for r in range(ids.shape[0])],
                      "texts": ([p[0] for p in self.texts[i]]
                                + [p[1] for p in self.texts[i]])}
        return got

    def check(self) -> dict:
        idx = self.sample()
        missing = [i for i in idx if i not in self.outputs or i not in self.ids
                   or len(self.texts.get(i, [])) != self.mix["batch"]]
        self.failed_units += len(missing)
        got = self.served([i for i in idx if i not in missing])
        from multimodal_av_model_tpu_torch import infer

        infer.decode_ids = self._decode
        del self.t, self.outputs, self.ids
        common.free(self.device)
        ref = reference_outputs(self.ctx, self.template, self.pool, list(got))
        return compare(got, ref, self.ctx, self.mix["batch"])


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by linear interpolation between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def computed_weights(P: dict, dtype: str) -> dict:
    """The weights as the configuration's compute reads them: under
    ``bfloat16`` each matrix and kernel (two axes or more) rounded to
    bfloat16 and back; the rest as they are."""
    import torch

    if dtype != "bfloat16":
        return P
    return {k: v.to(torch.bfloat16).float() if v.ndim >= 2 else v for k, v in P.items()}


def reference_outputs(ctx, template: dict, pool: list, idx: list[int], lowp: bool = False):
    """The reference's log-probabilities and lengths of requests ``idx``,
    from the seeded weights as the configuration computes with them."""
    import torch

    from .. import weights

    P = computed_weights(weights.seeded_state_dict(template, ctx.seed, ctx.device),
                         ctx.model["dtype"])
    net = Net(P, ctx.model, lowp=lowp)
    out = {}
    with torch.no_grad(), common.full_f32():
        for i in idx:
            inp = ref_pre.model_inputs(pool[i], ctx.device, ctx.mix["lip_size"])
            r = net.forward(inp, ref_pre.log_mel(inp["audio"], ctx.model["frontend"]))
            out[i] = {"lp": r["log_probs"].cpu(), "len": r["input_lengths"].cpu()}
    del P, net
    common.free(ctx.device)
    return out


def lp_gap(lp, ref_lp, lengths) -> float:
    """Widest gap below the reference's best of the reference's
    log-probability at the program's best token, over valid frames."""
    worst = 0.0
    for r in range(lp.shape[0]):
        n = int(lengths[r])
        if n == 0:
            continue
        pick = lp[r, :n].argmax(-1)
        gap = ref_lp[r, :n].max(-1).values - ref_lp[r, :n].gather(1, pick[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def lp_stats(got: dict, ref: dict) -> dict:
    """``lp_err``, ``lp_rms`` and ``lp_bias`` (module docstring) of the
    requests both have; each holds ``lp`` ``[rows, frames, tokens]`` and
    ``len``."""
    import torch

    worst, squares, count, tok_sum, frames = 0.0, 0.0, 0, 0.0, 0
    for i, g in got.items():
        r = ref[i]
        for row in range(g["lp"].shape[0]):
            n = int(min(g["len"][row], r["len"][row]))
            if n:
                d = (g["lp"][row, :n] - r["lp"][row, :n]).double()
                worst = max(worst, float(d.abs().max()))
                squares, count = squares + float((d * d).sum()), count + d.numel()
                tok_sum, frames = tok_sum + d.sum(0), frames + n
    bias = float(torch.sqrt(torch.mean((tok_sum / frames) ** 2))) if frames else 0.0
    return {"lp_err": worst, "lp_rms": (squares / count) ** 0.5 if count else 0.0,
            "lp_bias": bias}


def compare(got: dict, ref: dict, ctx, B: int) -> dict:
    """The compared numbers (module docstring)."""
    vocab = ref_decode.read_vocab(ctx.vocab_path)
    d, blank = ctx.decode, ctx.model["decoder"]["blank_id"]

    def decode(lp, n):
        return ref_decode.prefix_beam(lp.numpy(), n, d["beam_width"], d["prefix_top_k"], blank)

    gap, lens, rows, ref_rows, texts = 0.0, 0, 0, 0, 0
    for i, g in got.items():
        r = ref[i]
        lens += int((g["len"] != r["len"]).sum())
        gap = max(gap, lp_gap(g["lp"], r["lp"], r["len"]))
        for row in range(2 * B):                 # speaker 1's rows, then speaker 2's
            rows += int(g["ids"][row] != decode(g["lp"][row], int(g["len"][row])))
            ref_rows += int(g["ids"][row] != decode(r["lp"][row], int(r["len"][row])))
            texts += int(ref_decode.to_text(vocab, g["ids"][row]) != g["texts"][row])
    return {**lp_stats(got, ref), "lp_gap": gap, "len_mismatch": float(lens),
            "decode_mismatch": float(rows), "text_mismatch": float(texts),
            "ref_decode_mismatch": float(ref_rows)}
