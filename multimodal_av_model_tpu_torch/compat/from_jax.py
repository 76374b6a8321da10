"""Weight bridge: flax ``{"params", "batch_stats"}`` -> the port's ``state_dict``.

The inverse direction of ``multimodal_av_model_tpu/compat/torch_import.py:11-37``
for the flagship ``MultiSpeakerAVModel``, ``AudioOnlyCTC``, ``VisualOnlyCTC``
and the SSL family's ``MaskedAudioPretrainModel``, written from the layouts
alone (that module is not imported):

* Dense ``kernel [in, out]`` -> ``weight [out, in]`` (transposed);
* attention ``query/key/value kernel [E, H, hd]`` -> ``[H*hd, E]``, ``out
  kernel [H, hd, E]`` -> ``[E, H*hd]``;
* LSTM ``ii..io`` / ``hi..ho`` kernels -> ``w_ih`` / ``w_hh`` in gate order
  i, f, g, o, forward and backward stacked; the recurrent biases -> ``b_hh``;
* GRU ``{fwd,bwd}{i}/GRUCell_0``: ``ir, iz, in`` kernels and biases ->
  ``w_ih``, ``b_ih`` in gate order r, z, n; ``hr, hz, hn`` kernels ->
  ``w_hh``; the ``hn`` bias -> ``b_hn`` (the legacy family);
* the transformer temporal model's auto-named children (``_transformer``);
* conv ``HWIO`` -> ``OIHW`` (1D: ``[k, I, O]`` -> ``[O, I, k]``; the
  depthwise conv keeps ``I = 1`` for groups = d);
* BatchNorm ``scale, bias`` + ``batch_stats mean, var`` -> ``weight, bias,
  running_mean, running_var``; GroupNorm ``scale, bias`` -> ``weight, bias``;
* both PReLU sites of each block map to ``act1`` / ``act2``.

Input leaves are numpy arrays (``jax.device_get`` of the variables).  Every
flax leaf must be consumed: an unknown or left-over key raises.  A tree of
``params`` alone (no ``batch_stats``) converts too, into a state dict without
running statistics: a gradient tree or Adam moments go through the same
(linear) bridge.  ``train_state_from_jax`` carries a whole JAX ``TrainState``
(parameters, statistics, both Adam groups, accumulation, step) across, so a
JAX run can resume in the port; ``single_modality_state_from_jax`` and
``ssl_state_from_jax`` do the same for the families' states, and
``legacy_state_from_jax`` for the legacy trainer's.  ``stacked_blocks_from_jax``
carries the pipeline's stacked Conformer blocks.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch


def _p(*parts) -> str:
    """Flax path from parts, skipping an empty root."""
    return "/".join(str(p) for p in parts if p != "")


def _d(*parts) -> str:
    """state_dict key from parts, skipping an empty root."""
    return ".".join(str(p) for p in parts if p != "")


class _Tree:
    """Reads leaves of the flax tree by path and records which were read."""

    def __init__(self, variables: dict):
        self.leaves: dict[str, np.ndarray] = {}
        for col, tree in variables.items():
            if col not in ("params", "batch_stats"):
                raise KeyError(f"unknown variable collection {col!r}")
            self._flatten(tree, col)
        self.used: set[str] = set()

    def _flatten(self, tree, prefix):
        for k, v in tree.items():
            if hasattr(v, "items"):
                self._flatten(v, _p(prefix, k))
            else:
                self.leaves[_p(prefix, k)] = np.asarray(v, dtype=np.float32)

    def get(self, *parts) -> np.ndarray:
        path = _p(*parts)
        if path not in self.leaves:
            raise KeyError(f"missing flax leaf {path!r}")
        self.used.add(path)
        return self.leaves[path]

    def has(self, *parts) -> bool:
        return _p(*parts) in self.leaves

    def has_collection(self, col: str) -> bool:
        return any(k.startswith(col + "/") for k in self.leaves)

    def children(self, *parts) -> list[str]:
        pre = _p(*parts) + "/"
        return sorted({k[len(pre):].split("/", 1)[0] for k in self.leaves if k.startswith(pre)})

    def check_all_used(self):
        left = sorted(set(self.leaves) - self.used)
        if left:
            raise KeyError(f"unconsumed flax leaves: {left}")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(tree, sd, src, dst):
    sd[_d(dst, "weight")] = _t(tree.get("params", src, "kernel").T)
    sd[_d(dst, "bias")] = _t(tree.get("params", src, "bias"))


def _layer_norm(tree, sd, src, dst):
    sd[_d(dst, "weight")] = _t(tree.get("params", src, "scale"))
    sd[_d(dst, "bias")] = _t(tree.get("params", src, "bias"))


def _mha(tree, sd, src, dst):
    for name in ("query", "key", "value"):
        k = tree.get("params", src, name, "kernel")                  # [E, H, hd]
        sd[_d(dst, name, "weight")] = _t(k.reshape(k.shape[0], -1).T)
        sd[_d(dst, name, "bias")] = _t(tree.get("params", src, name, "bias").reshape(-1))
    k = tree.get("params", src, "out", "kernel")                     # [H, hd, E]
    sd[_d(dst, "out", "weight")] = _t(k.reshape(-1, k.shape[-1]).T)
    sd[_d(dst, "out", "bias")] = _t(tree.get("params", src, "out", "bias"))


def _norm(tree, sd, parent, index, dst):
    """``BatchNorm_{index}`` or ``_AdaptiveGroupNorm_{index}`` under ``parent``."""
    bn = _p(parent, f"BatchNorm_{index}")
    if tree.has("params", bn, "scale"):
        sd[_d(dst, "weight")] = _t(tree.get("params", bn, "scale"))
        sd[_d(dst, "bias")] = _t(tree.get("params", bn, "bias"))
        if tree.has_collection("batch_stats"):
            sd[_d(dst, "running_mean")] = _t(tree.get("batch_stats", bn, "mean"))
            sd[_d(dst, "running_var")] = _t(tree.get("batch_stats", bn, "var"))
    else:
        _layer_norm(tree, sd, _p(parent, f"_AdaptiveGroupNorm_{index}", "GroupNorm_0"), dst)


def _act(tree, sd, parent, index, dst):
    if tree.has("params", parent, f"PReLU_{index}", "alpha"):    # absent for "relu"
        sd[_d(dst, "alpha")] = _t(tree.get("params", parent, f"PReLU_{index}", "alpha"))


def _conv2d(tree, sd, src, dst):
    sd[_d(dst, "weight")] = _t(tree.get("params", src, "kernel").transpose(3, 2, 0, 1))


def _conv1d(tree, sd, src, dst_weight, dst_bias):
    sd[dst_weight] = _t(tree.get("params", src, "kernel").transpose(2, 1, 0))
    sd[dst_bias] = _t(tree.get("params", src, "bias"))


def _visual(tree, sd, src, dst):
    _conv2d(tree, sd, _p(src, "frontend_conv"), _d(dst, "frontend_conv"))
    _norm(tree, sd, src, 0, _d(dst, "frontend_norm"))
    _act(tree, sd, src, 0, _d(dst, "frontend_act"))
    names = tree.children("params", src, "trunk")
    for name in names:
        if not re.fullmatch(r"layer\d+_\d+", name):
            raise KeyError(f"unknown trunk child {name!r}")
    order = sorted(names, key=lambda n: tuple(int(x) for x in re.findall(r"\d+", n)))
    for i, name in enumerate(order):
        s, d = _p(src, "trunk", name), _d(dst, "trunk", "blocks", i)
        _conv2d(tree, sd, _p(s, "Conv_0"), _d(d, "conv1"))
        _norm(tree, sd, s, 0, _d(d, "norm1"))
        _act(tree, sd, s, 0, _d(d, "act1"))
        _conv2d(tree, sd, _p(s, "Conv_1"), _d(d, "conv2"))
        _norm(tree, sd, s, 1, _d(d, "norm2"))
        if tree.has("params", s, "Conv_2", "kernel"):
            _conv2d(tree, sd, _p(s, "Conv_2"), _d(d, "downsample", 0))
            _norm(tree, sd, s, 2, _d(d, "downsample", 1))
        _act(tree, sd, s, 1, _d(d, "act2"))
    if tree.has("params", src, "Dense_0", "kernel"):
        _dense(tree, sd, _p(src, "Dense_0"), _d(dst, "proj"))


def _audio(tree, sd, src, dst):
    _conv1d(tree, sd, _p(src, "subsample"), _d(dst, "subsample_weight"),
            _d(dst, "subsample_bias"))
    for name in tree.children("params", src):
        if not re.fullmatch(r"block\d+", name):
            continue                          # subsample / out_proj; leftovers raise
        _conformer_block(tree, sd, _p(src, name), _d(dst, "blocks", int(name[5:])))
    _dense(tree, sd, _p(src, "out_proj"), _d(dst, "out_proj"))


def _conformer_block(tree, sd, s, d):
    for ff, dff in (("FeedForwardModule_0", "ff1"), ("FeedForwardModule_1", "ff2")):
        _layer_norm(tree, sd, _p(s, ff, "LayerNorm_0"), _d(d, dff, "norm"))
        _dense(tree, sd, _p(s, ff, "Dense_0"), _d(d, dff, "fc1"))
        _dense(tree, sd, _p(s, ff, "Dense_1"), _d(d, dff, "fc2"))
    _layer_norm(tree, sd, _p(s, "LayerNorm_0"), _d(d, "attn_norm"))
    _mha(tree, sd, _p(s, "self_attention"), _d(d, "attn"))
    c, dc = _p(s, "ConvModule_0"), _d(d, "conv")
    _layer_norm(tree, sd, _p(c, "LayerNorm_0"), _d(dc, "norm"))
    _dense(tree, sd, _p(c, "Dense_0"), _d(dc, "pointwise_in"))
    _conv1d(tree, sd, _p(c, "Conv_0"), _d(dc, "depthwise_weight"),
            _d(dc, "depthwise_bias"))
    _layer_norm(tree, sd, _p(c, "LayerNorm_1"), _d(dc, "depthwise_norm"))
    _dense(tree, sd, _p(c, "Dense_1"), _d(dc, "pointwise_out"))
    _layer_norm(tree, sd, _p(s, "LayerNorm_1"), _d(d, "final_norm"))


def _bilstm(tree, sd, src, dst):
    for name in tree.children("params", src):
        if not re.fullmatch(r"layer\d+", name):
            raise KeyError(f"unknown BiLSTM child {name!r}")
        s, d = _p(src, name), _d(dst, "layers", int(name[5:]))
        w_ih, w_hh, b_hh = [], [], []
        for direction in ("fwd", "bwd"):
            p = _p(s, direction)
            w_ih.append(np.concatenate([tree.get("params", p, f"i{g}", "kernel")
                                        for g in "ifgo"], 1).T)
            w_hh.append(np.concatenate([tree.get("params", p, f"h{g}", "kernel")
                                        for g in "ifgo"], 1).T)
            b_hh.append(np.concatenate([tree.get("params", p, f"h{g}", "bias")
                                        for g in "ifgo"]))
        sd[_d(d, "w_ih")] = _t(np.stack(w_ih))
        sd[_d(d, "w_hh")] = _t(np.stack(w_hh))
        sd[_d(d, "b_hh")] = _t(np.stack(b_hh))


def _bigru(tree, sd, src, dst):
    """A flax ``BiGRU`` (``layers.py:305-318``): layer ``i``'s ``fwd{i}`` and
    ``bwd{i}`` ``GRULayer``s stacked into the port's ``FusedBiGRULayer``."""
    names = tree.children("params", src)
    for name in names:
        if not re.fullmatch(r"(fwd|bwd)\d+", name):
            raise KeyError(f"unknown BiGRU child {name!r}")
    for i in sorted({int(n[3:]) for n in names}):
        w_ih, b_ih, w_hh, b_hn = [], [], [], []
        for direction in ("fwd", "bwd"):
            p = _p(src, f"{direction}{i}", "GRUCell_0")
            w_ih.append(np.concatenate([tree.get("params", p, f"i{g}", "kernel")
                                        for g in "rzn"], 1).T)
            b_ih.append(np.concatenate([tree.get("params", p, f"i{g}", "bias") for g in "rzn"]))
            w_hh.append(np.concatenate([tree.get("params", p, f"h{g}", "kernel")
                                        for g in "rzn"], 1).T)
            b_hn.append(tree.get("params", p, "hn", "bias"))
        d = _d(dst, "layers", i)
        for k, v in (("w_ih", w_ih), ("b_ih", b_ih), ("w_hh", w_hh), ("b_hn", b_hn)):
            sd[_d(d, k)] = _t(np.stack(v))


def _transformer(tree, sd, src, dst):
    """A flax ``TransformerTemporalBlock``: its compact loop names layer
    ``i``'s children ``LayerNorm_{2i}`` (attention), ``LayerNorm_{2i+1}``
    (FFN), ``MultiHeadDotProductAttention_i`` and ``Dense_{2i}``,
    ``Dense_{2i+1}``; ``LayerNorm_{2L}`` is the final norm."""
    n = len([c for c in tree.children("params", src)
             if re.fullmatch(r"MultiHeadDotProductAttention_\d+", c)])
    for i in range(n):
        d = _d(dst, "layers", i)
        _layer_norm(tree, sd, _p(src, f"LayerNorm_{2 * i}"), _d(d, "attn_norm"))
        _mha(tree, sd, _p(src, f"MultiHeadDotProductAttention_{i}"), _d(d, "attn"))
        _layer_norm(tree, sd, _p(src, f"LayerNorm_{2 * i + 1}"), _d(d, "ffn_norm"))
        _dense(tree, sd, _p(src, f"Dense_{2 * i}"), _d(d, "fc1"))
        _dense(tree, sd, _p(src, f"Dense_{2 * i + 1}"), _d(d, "fc2"))
    _layer_norm(tree, sd, _p(src, f"LayerNorm_{2 * n}"), _d(dst, "final_norm"))


def _fusion(tree, sd, src, dst):
    _dense(tree, sd, _p(src, "visual_proj"), _d(dst, "visual_proj"))
    _dense(tree, sd, _p(src, "audio_proj"), _d(dst, "audio_proj"))
    _mha(tree, sd, _p(src, "cross_attn_audio"), _d(dst, "cross_attn_audio"))
    _dense(tree, sd, _p(src, "fusion_proj"), _d(dst, "fusion_proj"))
    if tree.has("params", src, "temporal_out", "kernel"):      # temporal_model="transformer"
        _transformer(tree, sd, _p(src, "temporal_tf"), _d(dst, "temporal_tf"))
        _dense(tree, sd, _p(src, "temporal_out"), _d(dst, "temporal_out"))
    else:
        _bilstm(tree, sd, _p(src, "temporal_bilstm"), _d(dst, "temporal_bilstm"))


def _convert(variables, fill) -> dict[str, torch.Tensor]:
    tree = _Tree(variables)
    sd: dict[str, torch.Tensor] = {}
    fill(tree, sd)
    tree.check_all_used()
    return sd


def audio_encoder_from_jax(variables) -> dict[str, torch.Tensor]:
    """Variables of a flax ``AudioEncoder`` -> the port's ``AudioEncoder`` state_dict."""
    return _convert(variables, lambda tree, sd: _audio(tree, sd, "", ""))


def stacked_blocks_from_jax(stacked_np: dict, num_layers: int) -> dict[str, torch.Tensor]:
    """JAX's stacked Conformer blocks (``parallel/pp.py:stack_block_params``,
    leaves ``[L, ...]``, as numpy) -> the port's stacked dict
    (``parallel/pp.py:stack_block_params``): each layer's subtree through the
    audio encoder's block mapping, then stacked again."""
    from ..parallel.pp import stack_block_params

    def fill(tree, sd):
        for i in range(num_layers):
            _conformer_block(tree, sd, f"block{i}", _d("blocks", i))

    unstacked = {f"block{i}": _index_tree(stacked_np, i) for i in range(num_layers)}
    return stack_block_params(_convert({"params": unstacked}, fill), num_layers)


def _index_tree(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def visual_encoder_from_jax(variables) -> dict[str, torch.Tensor]:
    """Variables of a flax ``VisualEncoder`` -> the port's ``VisualEncoder`` state_dict."""
    return _convert(variables, lambda tree, sd: _visual(tree, sd, "", ""))


def bilstm_from_jax(variables) -> dict[str, torch.Tensor]:
    """Variables of a flax ``BiLSTM`` -> the port's ``BiLSTM`` state_dict."""
    return _convert(variables, lambda tree, sd: _bilstm(tree, sd, "", ""))


def bigru_from_jax(variables) -> dict[str, torch.Tensor]:
    """Variables of a flax ``BiGRU`` -> the port's ``BiGRU`` state_dict."""
    return _convert(variables, lambda tree, sd: _bigru(tree, sd, "", ""))


def transformer_from_jax(variables) -> dict[str, torch.Tensor]:
    """Variables of a flax ``TransformerTemporalBlock`` -> the port's state_dict."""
    return _convert(variables, lambda tree, sd: _transformer(tree, sd, "", ""))


def fusion_from_jax(variables) -> dict[str, torch.Tensor]:
    """Variables of a flax ``CrossAttentionFusion`` -> the port's state_dict."""
    return _convert(variables, lambda tree, sd: _fusion(tree, sd, "", ""))


def from_jax_variables(variables_np) -> dict[str, torch.Tensor]:
    """Flax ``MultiSpeakerAVModel`` variables -> the port's ``MultiSpeakerAVModel``
    state_dict (load it with ``strict=True``)."""
    def fill(tree, sd):
        _visual(tree, sd, "visual_encoder", "visual_encoder")
        _audio(tree, sd, "audio_encoder", "audio_encoder")
        _fusion(tree, sd, "fusion", "fusion")
        _dense(tree, sd, "decoder/head", "decoder.head")
        _dense(tree, sd, "contrastive_proj", "contrastive_proj")
    return _convert(variables_np, fill)


def audio_only_from_jax(variables_np) -> dict[str, torch.Tensor]:
    """Flax ``AudioOnlyCTC`` variables (``av_model.py:148-161``) -> the port's
    ``AudioOnlyCTC`` state_dict (load it with ``strict=True``)."""
    def fill(tree, sd):
        _audio(tree, sd, "audio_encoder", "audio_encoder")
        _dense(tree, sd, "decoder/head", "decoder.head")
    return _convert(variables_np, fill)


def visual_only_from_jax(variables_np) -> dict[str, torch.Tensor]:
    """Flax ``VisualOnlyCTC`` variables (``av_model.py:164-178``) -> the port's
    ``VisualOnlyCTC`` state_dict."""
    def fill(tree, sd):
        _visual(tree, sd, "visual_encoder", "visual_encoder")
        _dense(tree, sd, "decoder/head", "decoder.head")
    return _convert(variables_np, fill)


def ssl_pretrain_from_jax(variables_np) -> dict[str, torch.Tensor]:
    """Flax ``MaskedAudioPretrainModel`` variables (``ssl_pretrain.py:33-51``:
    the audio encoder with its ``mask_embedding``, and ``ssl_head``) -> the
    port's state_dict."""
    def fill(tree, sd):
        _audio(tree, sd, "audio_encoder", "audio_encoder")
        sd["audio_encoder.mask_embedding"] = _t(
            tree.get("params", "audio_encoder", "mask_embedding"))
        _dense(tree, sd, "ssl_head", "ssl_head")
    return _convert(variables_np, fill)


def legacy_from_jax(variables_np) -> dict[str, torch.Tensor]:
    """Flax ``MultimodalCTCKoreanModel`` variables (``models/legacy.py:54-81``)
    -> the port's state_dict: the lip CNN's ``Conv_0``, ``Conv_1``, both
    encoders' ``BiGRU_0`` and ``fc``."""
    def fill(tree, sd):
        for i in (0, 1):
            src = f"lip_encoder/Conv_{i}"
            sd[f"lip_encoder.conv{i}_weight"] = _t(
                tree.get("params", src, "kernel").transpose(3, 2, 0, 1))
            sd[f"lip_encoder.conv{i}_bias"] = _t(tree.get("params", src, "bias"))
        _bigru(tree, sd, "lip_encoder/BiGRU_0", "lip_encoder.gru")
        _bigru(tree, sd, "audio_encoder/BiGRU_0", "audio_encoder.gru")
        _dense(tree, sd, "fc", "fc")
    return _convert(variables_np, fill)


def _find_adam(tree):
    """The ``ScaleByAdamState`` (``{count, mu, nu}``) inside one group's
    optimizer state, or None (the frozen group's ``set_to_zero``).  Optax's
    own tuples and named tuples are read as the dicts of their state-dict
    form."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    elif isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if not isinstance(tree, dict):
        return None
    if {"count", "mu", "nu"} <= set(tree):
        return tree
    for v in tree.values():
        found = _find_adam(v)
        if found is not None:
            return found
    return None


def _merge_masked(trees, params):
    """One params-shaped tree from group trees whose leaves outside the group
    are masked (``{}``); a leaf in no group (frozen) becomes zeros."""
    out = {}
    for k, p in params.items():
        subs = [t[k] for t in trees if isinstance(t, dict) and k in t]
        if isinstance(p, dict):
            out[k] = _merge_masked(subs, p)
        else:
            leaf = next((s for s in subs if not isinstance(s, dict)), None)
            out[k] = np.zeros_like(p) if leaf is None else leaf
    return out


def train_state_from_jax(state) -> dict:
    """A JAX ``TrainState`` in state-dict form (``flax.serialization.
    to_state_dict(jax.device_get(state))``, the tree a JAX checkpoint file
    holds) -> the port's ``TrainState.state_dict()`` layout, without the
    dropout generator (JAX's PRNG key has no torch counterpart).

    Maps ``params`` and ``batch_stats`` to the model, each group's Adam
    ``count``, ``mu`` and ``nu`` (the ``multi_transform`` inner states) to the
    optimizer, an ``optax.MultiSteps`` wrapper's ``mini_step`` and
    ``acc_grads`` to its accumulator, and ``step``."""
    params = state["params"]
    variables = {"params": params}
    if state.get("batch_stats"):
        variables["batch_stats"] = state["batch_stats"]
    opt = state["opt_state"]
    multi = "inner_opt_state" in opt
    groups = (opt["inner_opt_state"] if multi else opt)["inner_states"]
    adam = [a for a in (_find_adam(groups.get(g)) for g in ("base", "audio")) if a is not None]
    counts = {int(np.asarray(a["count"])) for a in adam}
    if len(counts) > 1:
        raise ValueError(f"optimizer groups disagree on the update count: {counts}")
    mini_step = int(np.asarray(opt["mini_step"])) if multi else 0
    return {
        "step": int(np.asarray(state["step"])),
        "model": from_jax_variables(variables),
        "optimizer": {
            "updates": counts.pop() if counts else 0,
            "mini_step": mini_step,
            "mu": from_jax_variables({"params": _merge_masked([a["mu"] for a in adam], params)}),
            "nu": from_jax_variables({"params": _merge_masked([a["nu"] for a in adam], params)}),
            "acc": from_jax_variables({"params": opt["acc_grads"]}) if mini_step else None,
        },
    }


def _one_group_state(params, batch_stats, opt_state, convert) -> dict:
    """A one-group optax state (``adam``, or ``chain(clip_by_global_norm,
    adam(schedule))``) -> the port's ``TrainState.state_dict()`` layout,
    without the dropout generator; ``step`` is the Adam count."""
    adam = _find_adam(opt_state)
    count = int(np.asarray(adam["count"]))
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    return {
        "step": count,
        "model": convert(variables),
        "optimizer": {"updates": count, "mini_step": 0,
                      "mu": convert({"params": adam["mu"]}),
                      "nu": convert({"params": adam["nu"]}), "acc": None},
    }


def single_modality_state_from_jax(state, family: str) -> dict:
    """A JAX ``SingleModalityTrainer`` state (``{"params", "opt_state",
    "batch_stats", "rng"}`` as numpy, ``single_modality.py:48-54``) of the
    ``"audio"`` or ``"visual"`` family -> the port's state dict."""
    convert = {"audio": audio_only_from_jax, "visual": visual_only_from_jax}[family]
    return _one_group_state(state["params"], state.get("batch_stats"), state["opt_state"],
                            convert)


def ssl_state_from_jax(state) -> dict:
    """A JAX ``MaskedAudioPretrainer`` state (``{"params", "opt_state",
    "key"}`` as numpy, ``ssl_pretrain.py:82-94``) -> the port's state dict."""
    return _one_group_state(state["params"], None, state["opt_state"], ssl_pretrain_from_jax)


def legacy_state_from_jax(params, opt_state) -> dict:
    """A JAX ``LegacyTrainer`` state (``train/legacy.py:104-108``: flax
    ``params`` and ``optax.adam``'s state, as numpy) -> the port's
    ``LegacyTrainer`` state dict: parameters and Adam's count, mu and nu."""
    return _one_group_state(params, None, opt_state, legacy_from_jax)
