"""Import the upstream reference's torch checkpoints into the port's
``MultiSpeakerAVModel`` state dict, torch to torch.

Mirrors ``multimodal_av_model_tpu/compat/torch_import.py:57-344``.  The
reference saves a dict of per-module ``state_dict``s (``{'epoch',
'visual_encoder', 'audio_encoder', 'fusion', 'decoder1', 'optimizer'}``) or
a bare visual-encoder snapshot (its keys start with ``frontend3D``).  What
maps, and how:

* ``visual_encoder`` -> ``visual_encoder.*``: the Conv3D frontend kernel
  ``[64, 1, 5, 7, 7]`` becomes ``frontend_conv.weight [64, 5, 7, 7]`` (tap
  k of the 3D kernel is input channel k of the time-folded 2D conv);
  BatchNorm ``weight``, ``bias``, ``running_mean`` and ``running_var`` map
  across (``num_batches_tracked`` is not read); ``layerS.B`` becomes
  ``trunk.blocks.i`` in (stage, block) order, with ``downsample.{0,1}``;
  the reference's one PReLU per block is copied into both ``act1`` and
  ``act2``;
* ``fusion`` -> ``fusion.*``: ``visual_proj``, ``audio_proj`` and
  ``fusion_proj`` map across; ``nn.MultiheadAttention``'s ``in_proj [3E,
  E]`` splits into ``query``, ``key`` and ``value``, ``out_proj`` maps to
  ``out``; the bidirectional ``nn.LSTM``'s ``weight_ih_l{i}{,_reverse}``
  and ``weight_hh`` stack into ``w_ih[dir]`` and ``w_hh[dir]`` (gate order
  i, f, g, o in both), ``bias_ih + bias_hh`` into ``b_hh[dir]``; the dead
  ``cross_attn_visual`` is not read;
* ``decoder1`` -> ``decoder.head`` (``net.0``);
* ``audio_encoder`` (a HuggingFace wav2vec2 state the reference itself never
  restores) and ``optimizer`` are skipped with JAX's report strings.

Entries the checkpoint lacks (the audio encoder, the contrastive
projection) keep the template's tensors.  ``strict`` raises on a missing,
extra or mis-shaped tensor, naming the key; otherwise only the tensors that
fit the template are taken.

CLI (file work on the host, as in JAX):
  python -m multimodal_av_model_tpu_torch.compat.torch_import <ckpt.pt> <out.ckpt> [vocab_size]
loads the file with ``torch.load(weights_only=True)``, converts it onto a
seeded flagship template and writes ``{"state": {"model": state_dict},
"epoch": n}`` (``train/checkpoints.py``), which ``Transcriber.from_checkpoint``
serves and ``train.visual_init_ckpt`` grafts.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

# torch.nn.LSTM's gate order (i, f, g, o) is the port's FusedBiLSTMLayer's.


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


def _linear(sd: Mapping[str, Any], src: str, dst: str, out: dict) -> None:
    out[f"{dst}.weight"] = _f32(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])


def _bn(sd: Mapping[str, Any], src: str, dst: str, out: dict) -> None:
    for k in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{k}"] = _f32(sd[f"{src}.{k}"])


def convert_visual_state_dict(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference ``VisualEncoder.state_dict()`` -> the port's
    ``VisualEncoder`` state dict (``torch_import.py:81-139``)."""
    out: dict[str, torch.Tensor] = {}
    w3 = _f32(sd["frontend3D.0.weight"])                      # [O, 1, kt, kh, kw]
    if w3.shape[1] != 1:
        raise ValueError(f"expected C_in=1 frontend Conv3D, got {tuple(w3.shape)}")
    out["frontend_conv.weight"] = w3[:, 0].contiguous()       # [O, kt, kh, kw]
    _bn(sd, "frontend3D.1", "frontend_norm", out)
    if "frontend3D.2.weight" in sd:                           # PReLU (absent for relu)
        out["frontend_act.alpha"] = _f32(sd["frontend3D.2.weight"])
    blocks = sorted({tuple(int(x) for x in k[len("trunk.layer"):].split(".")[:2])
                     for k in sd if k.startswith("trunk.layer")})
    for i, (stage, b) in enumerate(blocks):
        src, dst = f"trunk.layer{stage}.{b}", f"trunk.blocks.{i}"
        out[f"{dst}.conv1.weight"] = _f32(sd[f"{src}.conv1.weight"])
        _bn(sd, f"{src}.bn1", f"{dst}.norm1", out)
        out[f"{dst}.conv2.weight"] = _f32(sd[f"{src}.conv2.weight"])
        _bn(sd, f"{src}.bn2", f"{dst}.norm2", out)
        if f"{src}.downsample.0.weight" in sd:
            out[f"{dst}.downsample.0.weight"] = _f32(sd[f"{src}.downsample.0.weight"])
            _bn(sd, f"{src}.downsample.1", f"{dst}.downsample.1", out)
        if f"{src}.relu.weight" in sd:
            # One reference PReLU used at both sites -> both of the port's.
            out[f"{dst}.act1.alpha"] = _f32(sd[f"{src}.relu.weight"])
            out[f"{dst}.act2.alpha"] = _f32(sd[f"{src}.relu.weight"])
    return out


def _mha(sd: Mapping[str, Any], src: str, dst: str, num_heads: int, out: dict) -> None:
    w_in, b_in = _f32(sd[f"{src}.in_proj_weight"]), _f32(sd[f"{src}.in_proj_bias"])
    E = w_in.shape[1]
    if E % num_heads:
        raise ValueError(f"embed dim {E} not divisible by {num_heads} heads")
    for i, name in enumerate(("query", "key", "value")):
        out[f"{dst}.{name}.weight"] = w_in[i * E:(i + 1) * E].clone()
        out[f"{dst}.{name}.bias"] = b_in[i * E:(i + 1) * E].clone()
    _linear(sd, f"{src}.out_proj", f"{dst}.out", out)


def _bilstm(sd: Mapping[str, Any], src: str, dst: str, num_layers: int, out: dict) -> None:
    for layer in range(num_layers):
        w_ih, w_hh, b = [], [], []
        for suffix in ("", "_reverse"):
            w_ih.append(_f32(sd[f"{src}.weight_ih_l{layer}{suffix}"]))
            w_hh.append(_f32(sd[f"{src}.weight_hh_l{layer}{suffix}"]))
            # The port keeps one bias: torch's two only ever appear summed.
            b.append(_f32(sd[f"{src}.bias_ih_l{layer}{suffix}"])
                     + _f32(sd[f"{src}.bias_hh_l{layer}{suffix}"]))
        d = f"{dst}.layers.{layer}"
        out[f"{d}.w_ih"], out[f"{d}.w_hh"], out[f"{d}.b_hh"] = (
            torch.stack(w_ih), torch.stack(w_hh), torch.stack(b))


def convert_fusion_state_dict(sd: Mapping[str, Any], num_heads: int = 4,
                              temporal_layers: int = 2) -> dict[str, torch.Tensor]:
    """The reference ``CrossAttentionFusion.state_dict()`` -> the port's
    ``CrossAttentionFusion`` (BiLSTM temporal model) state dict."""
    out: dict[str, torch.Tensor] = {}
    for name in ("visual_proj", "audio_proj"):
        _linear(sd, name, name, out)
    _mha(sd, "cross_attn_audio", "cross_attn_audio", num_heads, out)
    _linear(sd, "fusion_proj", "fusion_proj", out)
    _bilstm(sd, "temporal_model", "temporal_bilstm", temporal_layers, out)
    return out


def convert_decoder_state_dict(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference ``CTCDecoder.state_dict()`` (``net.0``) -> ``CTCDecoder``'s."""
    out: dict[str, torch.Tensor] = {}
    _linear(sd, "net.0", "head", out)
    return out


def _problems(new: dict, template: Mapping[str, torch.Tensor], name: str) -> list[str]:
    """Each key of ``new`` or of ``template`` under ``name`` that is missing,
    extra or of another shape."""
    have = {k for k in template if k.startswith(name + ".")}
    out = []
    for k in sorted(have | {f"{name}.{k}" for k in new}):
        sub = k[len(name) + 1:]
        if sub not in new:
            out.append(f"{k}: missing from imported tree")
        elif k not in have:
            out.append(f"{k}: not in model template")
        elif tuple(new[sub].shape) != tuple(template[k].shape):
            out.append(f"{k}: shape {tuple(new[sub].shape)} != template "
                       f"{tuple(template[k].shape)}")
    return out


def import_reference_checkpoint(ckpt: Mapping[str, Any],
                                template: Mapping[str, torch.Tensor], num_heads: int = 4,
                                temporal_layers: int = 2, strict: bool = True):
    """A loaded reference checkpoint (full or bare visual snapshot) merged
    into a copy of ``template``, a ``MultiSpeakerAVModel`` state dict ->
    ``(state_dict, report)``; ``report`` lists the ``imported`` and
    ``skipped`` entries, and without ``strict`` the ``not_fitted`` tensors
    that kept the template's."""
    out = dict(template)
    report: dict = {"imported": [], "skipped": []}
    if "visual_encoder" not in ckpt and any(k.startswith("frontend3D") for k in ckpt):
        ckpt = {"visual_encoder": ckpt}                       # bare encoder snapshot

    def merge(name: str, new: dict) -> None:
        problems = _problems(new, template, name)
        if problems and strict:
            raise ValueError(f"imported '{name}' does not fit the model config:\n  "
                             + "\n  ".join(problems[:20]))
        if problems:
            report.setdefault("not_fitted", []).extend(problems)
        for k, v in new.items():
            key = f"{name}.{k}"
            if key in template and tuple(v.shape) == tuple(template[key].shape):
                out[key] = v
        report["imported"].append(name)

    if "visual_encoder" in ckpt:
        merge("visual_encoder", convert_visual_state_dict(ckpt["visual_encoder"]))
    if "fusion" in ckpt:
        merge("fusion", convert_fusion_state_dict(ckpt["fusion"], num_heads, temporal_layers))
    if "decoder1" in ckpt:
        merge("decoder", convert_decoder_state_dict(ckpt["decoder1"]))
    if "audio_encoder" in ckpt:
        report["skipped"].append(
            "audio_encoder (HF wav2vec2 state — the reference's own loader "
            "skips restoring it too, reference main.py:60-61)")
    if "optimizer" in ckpt:
        report["skipped"].append("optimizer (torch Adam moments, framework-specific)")
    for k in ckpt:
        if k not in ("visual_encoder", "fusion", "decoder1", "audio_encoder", "optimizer",
                     "epoch") and not k.startswith("frontend3D"):
            report["skipped"].append(k)
    return out, report


def _main(argv) -> int:
    from ..config import Config
    from ..models import MultiSpeakerAVModel, init_weights
    from ..train.checkpoints import save_checkpoint

    if len(argv) < 2:
        print("usage: python -m multimodal_av_model_tpu_torch.compat.torch_import "
              "<reference_ckpt.pt> <out.ckpt> [vocab_size]")
        return 2
    src, out_path = argv[0], argv[1]
    cfg = Config()
    if len(argv) > 2:
        cfg.model.decoder.vocab_size = int(argv[2])
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    # The template: the flagship's seeded initialisation, which the entries
    # the checkpoint lacks keep.
    model = init_weights(MultiSpeakerAVModel(cfg.model), torch.Generator().manual_seed(0))
    sd, report = import_reference_checkpoint(ckpt, model.state_dict(), cfg.model.fusion.num_heads,
                                             cfg.model.fusion.temporal_layers)
    epoch = int(ckpt.get("epoch", 0)) if hasattr(ckpt, "get") else 0
    save_checkpoint(out_path, {"state": {"model": sd}, "epoch": epoch})
    print(f"imported: {report['imported']} -> {out_path}")
    for s in report["skipped"]:
        print(f"skipped: {s}")
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(_main(sys.argv[1:]))
