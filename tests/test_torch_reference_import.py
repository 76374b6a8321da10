"""PyTorch port, the upstream reference's checkpoint import
(``compat/torch_import.py``), held against the JAX package's importer on
the CPU at a tiny config (BatchNorm visual trunk, as the reference's).

The reference's modules are not needed: each test fills the keys that both
converters read (the reference's ``state_dict`` layout) with seeded tensors,
BatchNorm statistics and PReLU slopes included, plus the keys both must
ignore (``num_batches_tracked``, the dead ``cross_attn_visual``).

Tolerances:
* the port's import against ``from_jax_variables`` of JAX's import: equal,
  tensor for tensor (both only copy, slice, transpose and add two f32
  biases); the report's ``imported`` and ``skipped`` lists equal;
* the imported model's eval forward against the imported JAX model's:
  log-probs on valid frames within 2e-4, lengths equal.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.compat import import_reference_checkpoint as j_import
from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu_torch import config as pconfig
from multimodal_av_model_tpu_torch.compat import from_jax_variables, import_reference_checkpoint
from multimodal_av_model_tpu_torch.compat import torch_import
from multimodal_av_model_tpu_torch.infer import Transcriber
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train import graft_subtree, restore_checkpoint
from test_models import tiny_config
from test_torch_models import _av_inputs, port_config, to_np

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = tiny_config()
    cfg.model.visual.norm = "batch"
    return cfg


@pytest.fixture(scope="module")
def jax_template():
    cfg = _cfg()
    return cfg, to_np(JModel(cfg.model).init(jax.random.PRNGKey(0),
                                             *map(jnp.asarray, _av_inputs())))


def _reference_checkpoint(template: dict, seed: int = 0, vocab: int | None = None) -> dict:
    """A full reference save (``{'epoch', 'visual_encoder', 'audio_encoder',
    'fusion', 'decoder1', 'optimizer'}``) whose tensors fit the port state
    dict ``template``, drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    shape = lambda k: tuple(template[k].shape)  # noqa: E731

    def rand(*s, lo=-0.5, hi=0.5):
        return torch.rand(*s, generator=g) * (hi - lo) + lo

    def bn(out, src, n):
        out[f"{src}.weight"] = rand(n, lo=0.5, hi=1.5)
        out[f"{src}.bias"] = rand(n)
        out[f"{src}.running_mean"] = rand(n, lo=-0.2, hi=0.2)
        out[f"{src}.running_var"] = rand(n, lo=0.5, hi=1.5)
        out[f"{src}.num_batches_tracked"] = torch.tensor(17)

    vis: dict = {}
    c0, kt, kh, kw = shape("visual_encoder.frontend_conv.weight")
    vis["frontend3D.0.weight"] = rand(c0, 1, kt, kh, kw)
    bn(vis, "frontend3D.1", c0)
    vis["frontend3D.2.weight"] = rand(c0, lo=0.05, hi=0.5)
    cfg = _cfg().model.visual
    i = 0
    for stage, n_blocks in enumerate(cfg.resnet_layers, start=1):
        for b in range(n_blocks):
            pre, port = f"trunk.layer{stage}.{b}", f"visual_encoder.trunk.blocks.{i}"
            vis[f"{pre}.conv1.weight"] = rand(*shape(f"{port}.conv1.weight"))
            bn(vis, f"{pre}.bn1", shape(f"{port}.norm1.weight")[0])
            vis[f"{pre}.conv2.weight"] = rand(*shape(f"{port}.conv2.weight"))
            bn(vis, f"{pre}.bn2", shape(f"{port}.norm2.weight")[0])
            if f"{port}.downsample.0.weight" in template:
                vis[f"{pre}.downsample.0.weight"] = rand(*shape(f"{port}.downsample.0.weight"))
                bn(vis, f"{pre}.downsample.1", shape(f"{port}.downsample.1.weight")[0])
            vis[f"{pre}.relu.weight"] = rand(shape(f"{port}.act1.alpha")[0], lo=0.05, hi=0.5)
            i += 1

    fus: dict = {}
    for name in ("visual_proj", "audio_proj", "fusion_proj"):
        fus[f"{name}.weight"] = rand(*shape(f"fusion.{name}.weight"))
        fus[f"{name}.bias"] = rand(*shape(f"fusion.{name}.bias"))
    E = shape("fusion.cross_attn_audio.query.weight")[0]
    for name in ("cross_attn_audio", "cross_attn_visual"):
        fus[f"{name}.in_proj_weight"] = rand(3 * E, E)
        fus[f"{name}.in_proj_bias"] = rand(3 * E)
        fus[f"{name}.out_proj.weight"] = rand(E, E)
        fus[f"{name}.out_proj.bias"] = rand(E)
    for layer in range(2):
        _, H4, d_in = shape(f"fusion.temporal_bilstm.layers.{layer}.w_ih")
        for suffix in ("", "_reverse"):
            fus[f"temporal_model.weight_ih_l{layer}{suffix}"] = rand(H4, d_in)
            fus[f"temporal_model.weight_hh_l{layer}{suffix}"] = rand(H4, H4 // 4)
            fus[f"temporal_model.bias_ih_l{layer}{suffix}"] = rand(H4)
            fus[f"temporal_model.bias_hh_l{layer}{suffix}"] = rand(H4)

    V, D = shape("decoder.head.weight")
    V = vocab or V
    dec = {"net.0.weight": rand(V, D), "net.0.bias": rand(V)}
    return {"epoch": 7, "visual_encoder": vis, "audio_encoder": {"w2v.weight": rand(3, 3)},
            "fusion": fus, "decoder1": dec,
            "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4, "params": [0, 1]}]}}


def _both(jax_template, ckpt, strict=True):
    cfg, v = jax_template
    jp, js, jreport = j_import(ckpt, v["params"], v["batch_stats"], num_heads=2,
                               temporal_layers=2, strict=strict)
    sd, report = import_reference_checkpoint(ckpt, from_jax_variables(v), num_heads=2,
                                             temporal_layers=2, strict=strict)
    return (jp, js, jreport), (sd, report)


def _assert_equal(sd, want):
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert sd[k].dtype == torch.float32 and sd[k].shape == v.shape, k
        assert torch.equal(sd[k], v), k


def test_full_checkpoint_equals_from_jax_of_jax_import(jax_template):
    cfg, v = jax_template
    ckpt = _reference_checkpoint(from_jax_variables(v), seed=1)
    (jp, js, jreport), (sd, report) = _both(jax_template, ckpt)
    _assert_equal(sd, from_jax_variables({"params": to_np(jp), "batch_stats": to_np(js)}))
    assert report == jreport
    assert report["imported"] == ["visual_encoder", "fusion", "decoder"]
    assert [s.split(" ")[0] for s in report["skipped"]] == ["audio_encoder", "optimizer"]
    template = from_jax_variables(v)                  # what the checkpoint lacks stays
    for k in sd:
        if k.startswith(("audio_encoder.", "contrastive_proj.")):
            assert torch.equal(sd[k], template[k]), k
    # The mapping itself, on a few tensors.
    fus, vis = ckpt["fusion"], ckpt["visual_encoder"]
    assert torch.equal(sd["visual_encoder.frontend_conv.weight"],
                       vis["frontend3D.0.weight"][:, 0])
    assert torch.equal(sd["visual_encoder.trunk.blocks.3.act2.alpha"],
                       vis["trunk.layer4.0.relu.weight"])
    E = fus["cross_attn_audio.out_proj.weight"].shape[0]
    assert torch.equal(sd["fusion.cross_attn_audio.key.weight"],
                       fus["cross_attn_audio.in_proj_weight"][E:2 * E])
    assert torch.equal(sd["fusion.temporal_bilstm.layers.1.b_hh"][1],
                       fus["temporal_model.bias_ih_l1_reverse"]
                       + fus["temporal_model.bias_hh_l1_reverse"])
    assert torch.equal(sd["decoder.head.bias"], ckpt["decoder1"]["net.0.bias"])


def test_imported_forward_matches_jax(jax_template):
    cfg, v = jax_template
    ckpt = _reference_checkpoint(from_jax_variables(v), seed=2)
    (jp, js, _), (sd, _) = _both(jax_template, ckpt)
    inputs = _av_inputs()
    ref = JModel(cfg.model).apply({"params": jp, "batch_stats": js}, *map(jnp.asarray, inputs))
    model = MultiSpeakerAVModel(port_config(cfg).model).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model(*map(torch.from_numpy, inputs))
    for s in ("1", "2"):
        lens = np.asarray(ref["input_lengths" + s])
        np.testing.assert_array_equal(out["input_lengths" + s].numpy(), lens)
        got, want = out["log_probs" + s].numpy(), np.asarray(ref["log_probs" + s])
        for b in range(got.shape[0]):
            np.testing.assert_allclose(got[b, :lens[b]], want[b, :lens[b]], rtol=2e-4,
                                       atol=2e-4)


def test_bare_visual_snapshot(jax_template):
    cfg, v = jax_template
    vis = _reference_checkpoint(from_jax_variables(v), seed=3)["visual_encoder"]
    (jp, js, jreport), (sd, report) = _both(jax_template, vis)
    _assert_equal(sd, from_jax_variables({"params": to_np(jp), "batch_stats": to_np(js)}))
    assert report == jreport == {"imported": ["visual_encoder"], "skipped": []}
    template = from_jax_variables(v)
    assert all(torch.equal(sd[k], template[k]) for k in sd if not k.startswith("visual_encoder."))


def test_unknown_top_level_entries_are_reported(jax_template):
    cfg, v = jax_template
    ckpt = _reference_checkpoint(from_jax_variables(v), seed=4)
    ckpt["scheduler"] = {"last_epoch": 3}
    del ckpt["optimizer"]
    (_, _, jreport), (_, report) = _both(jax_template, ckpt)
    assert report == jreport and report["skipped"][-1] == "scheduler"


def test_strict_raises_naming_the_key_and_non_strict_keeps_the_template(jax_template):
    cfg, v = jax_template
    template = from_jax_variables(v)
    ckpt = _reference_checkpoint(template, seed=5, vocab=23)          # the template has 20
    with pytest.raises(ValueError, match="decoder.head.weight: shape"):
        import_reference_checkpoint(ckpt, template, 2, 2)
    with pytest.raises(ValueError, match="does not fit the model config"):
        j_import(ckpt, v["params"], v["batch_stats"], 2, 2)
    del ckpt["visual_encoder"]["frontend3D.2.weight"]                  # a relu frontend
    with pytest.raises(ValueError, match="visual_encoder.frontend_act.alpha: missing"):
        import_reference_checkpoint(ckpt, template, 2, 2)
    sd, report = import_reference_checkpoint(ckpt, template, 2, 2, strict=False)
    for k in ("decoder.head.weight", "decoder.head.bias", "visual_encoder.frontend_act.alpha"):
        assert torch.equal(sd[k], template[k]), k
    assert torch.equal(sd["fusion.fusion_proj.weight"], ckpt["fusion"]["fusion_proj.weight"])
    assert report["imported"] == ["visual_encoder", "fusion", "decoder"]
    assert sorted(p.split(":")[0] for p in report["not_fitted"]) == [
        "decoder.head.bias", "decoder.head.weight", "visual_encoder.frontend_act.alpha"]
    MultiSpeakerAVModel(port_config(cfg).model).load_state_dict(sd, strict=True)


def test_cli_checkpoint_serves_and_grafts(jax_template, tmp_path, monkeypatch):
    """The CLI at the tiny config (``Config`` patched): ``torch.load`` with
    ``weights_only=True``, the port's checkpoint layout, JAX's report lines;
    the file serves through ``Transcriber.from_checkpoint`` and grafts its
    visual encoder as ``train.visual_init_ckpt`` does."""
    cfg, v = jax_template
    pcfg = port_config(cfg)
    cli_cfg = port_config(_cfg())
    monkeypatch.setattr(pconfig, "Config", lambda: cli_cfg)
    ckpt = _reference_checkpoint(MultiSpeakerAVModel(pcfg.model).state_dict(), seed=6, vocab=30)
    src, out = str(tmp_path / "ref.pt"), str(tmp_path / "imported.ckpt")
    torch.save(ckpt, src)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert torch_import._main([src, out, "30"]) == 0
    lines = printed.getvalue().splitlines()
    assert lines[0] == f"imported: ['visual_encoder', 'fusion', 'decoder'] -> {out}"
    assert [ln.split(" (")[0] for ln in lines[1:]] == ["skipped: audio_encoder",
                                                      "skipped: optimizer"]
    saved = restore_checkpoint(out)
    assert saved["epoch"] == 7 and set(saved) == {"state", "epoch"}
    assert torch.equal(saved["state"]["model"]["decoder.head.weight"],
                       ckpt["decoder1"]["net.0.weight"])

    pcfg.model.decoder.vocab_size = 30
    pcfg.model.dtype = "float32"
    t = Transcriber.from_checkpoint(pcfg, CharTokenizer(VOCAB), out, device="cpu")
    lip1, lip2, audio, m1, m2, l1, l2 = _av_inputs()
    texts = t.transcribe({"lip1": lip1, "lip2": lip2, "audio": audio, "mask1": m1, "mask2": m2,
                          "lip1_lengths": l1, "lip2_lengths": l2})
    assert len(texts) == 2 and all(isinstance(x, str) for pair in texts for x in pair)
    fresh = MultiSpeakerAVModel(pcfg.model).state_dict()
    grafted = graft_subtree(fresh, saved["state"]["model"], ["visual_encoder"])
    assert torch.equal(grafted["visual_encoder.trunk.blocks.0.conv1.weight"],
                       ckpt["visual_encoder"]["trunk.layer1.0.conv1.weight"])
