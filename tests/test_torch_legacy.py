"""PyTorch port, the legacy-v0 family: ``KoreanSyllableVocab``, flax's GRU
cell in ``GRULayer`` / ``BiGRU``, ``models/legacy.py``, ``train/legacy.py``
and ``data/legacy_preprocess.py``, held against the JAX package on the CPU
at tiny widths in f32, torch on one thread.

Tolerances:
* the vocabulary, ``scan_legacy_root``, the labels of ``load_legacy_sample``
  and the files of ``build_pair_sample`` / ``build_all_pair_samples``: equal
  (files byte for byte);
* ``GRULayer`` and ``BiGRU``: 1e-5 (absolute and relative);
* ``LipEncoder`` (H != W, so a wrong flatten order cannot pass),
  ``MelAudioEncoder`` and the model with ``T_lip != T_mel`` and ``T_lip ==
  T_mel``: 2e-4;
* the loss: 1e-5 (relative); its gradients with respect to the logits and
  to every parameter, the bar of ``tests/test_torch_trainer.py``: per tensor
  ``|g - g_jax| <= 1e-3 |g_jax| + 1e-7``;
* 1 and 3 ``LegacyTrainer`` steps from one state (carried by
  ``legacy_state_from_jax``): loss rtol 1e-4, each gradient at the bar
  above, parameters within ``2e-2 * lr`` per step on the elements whose
  first JAX gradient is exactly 0 (the lip CNN's dead ReLU channels: 5,137
  of 63,787 here) or at least 1e-7 and at least 1e-6 of its tensor's
  largest (Adam moves an element by about lr whatever its gradient's size,
  so an element whose gradient is f32 noise moves either way); the elements
  left out are counted and held under 1 % of the parameters (62 here);
* ``load_legacy_sample``: frames within 1e-6, the mel (the port's plain
  log-mel against JAX's plain log-mel) within rtol/atol 1e-4, as
  ``tests/test_torch_frontend.py`` holds the two;
* ``fit``'s ``[Epoch N] Loss: ...`` lines: JAX's format, the epoch sums
  within 1e-5 (relative).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.data.audio_io import write_wav as j_write_wav
from multimodal_av_model_tpu.data.legacy_preprocess import (
    build_all_pair_samples as j_build_all,
)
from multimodal_av_model_tpu.data.legacy_preprocess import build_pair_sample as j_build_pair
from multimodal_av_model_tpu.data.manifest import build_data_list as j_build_data_list
from multimodal_av_model_tpu.models.layers import BiGRU as JBiGRU
from multimodal_av_model_tpu.models.layers import GRULayer as JGRULayer
from multimodal_av_model_tpu.models.legacy import LipEncoder as JLipEncoder
from multimodal_av_model_tpu.models.legacy import MelAudioEncoder as JMelEncoder
from multimodal_av_model_tpu.models.legacy import MultimodalCTCKoreanModel as JModel
from multimodal_av_model_tpu.ops.ctc import ctc_loss as j_ctc_loss
from multimodal_av_model_tpu.text.korean import KoreanSyllableVocab as JVocab
from multimodal_av_model_tpu.train.legacy import LegacyTrainer as JTrainer
from multimodal_av_model_tpu.train.legacy import load_legacy_sample as j_load_sample
from multimodal_av_model_tpu.train.legacy import scan_legacy_root as j_scan
from multimodal_av_model_tpu_torch.compat import legacy_from_jax, legacy_state_from_jax
from multimodal_av_model_tpu_torch.compat.from_jax import bigru_from_jax
from multimodal_av_model_tpu_torch.data import build_all_pair_samples, build_pair_sample
from multimodal_av_model_tpu_torch.data.manifest import build_data_list
from multimodal_av_model_tpu_torch.models import (
    BiGRU,
    GRULayer,
    MultimodalCTCKoreanModel,
    init_legacy_weights,
)
from multimodal_av_model_tpu_torch.ops.ctc import ctc_loss
from multimodal_av_model_tpu_torch.text import KoreanSyllableVocab
from multimodal_av_model_tpu_torch.train import LegacyTrainer, load_legacy_sample, scan_legacy_root
from test_torch_fit import write_corpus
from test_torch_models import to_np

LR = 1e-4
HW = (12, 16)          # H != W: the flatten order shows
HIDDEN = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad_close(g, g_ref, what):
    assert torch.linalg.vector_norm(g - g_ref) <= \
        1e-3 * torch.linalg.vector_norm(g_ref) + 1e-7, what


# -- the vocabulary -----------------------------------------------------------

def test_korean_syllable_vocab_matches_jax():
    j, p = JVocab(), KoreanSyllableVocab()
    assert p.vocab == j.vocab and p.vocab_size == j.vocab_size == 11173
    assert p.blank_id == j.blank_id == 0
    for text in ("바나나", "사과 주스!", "abc", "", "힣가 각"):
        ids = p.text_to_indices(text)
        assert ids == j.text_to_indices(text)
        assert p.indices_to_text(ids) == j.indices_to_text(ids)
    ids = [0, 1, 11172, 0, 5]
    assert p.indices_to_text(ids) == j.indices_to_text(ids) == "가힣" + chr(0xAC00 + 4)


# -- GRU ------------------------------------------------------------------------

def _gru_state(p):
    """A flax ``GRUCell_0`` subtree -> one ``GRULayer``'s state dict."""
    cat = lambda names, leaf: np.concatenate([p[n][leaf] for n in names], -1)  # noqa: E731
    return {"w_ih": torch.from_numpy(cat(("ir", "iz", "in"), "kernel").T.copy()),
            "b_ih": torch.from_numpy(cat(("ir", "iz", "in"), "bias").copy()),
            "w_hh": torch.from_numpy(cat(("hr", "hz", "hn"), "kernel").T.copy()),
            "b_hn": torch.from_numpy(np.asarray(p["hn"]["bias"]).copy())}


def _nonzero_biases(variables, seed):
    """flax initialises biases to 0; draw them so their mapping shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
                         if path[-1].key == "bias" else a), to_np(variables))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_gru_layer_matches_flax(reverse, with_lengths):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    lengths = np.array([7, 4, 1], np.int32) if with_lengths else None
    jm = JGRULayer(6, reverse=reverse)
    variables = _nonzero_biases(jm.init(jax.random.PRNGKey(1), x, lengths), 1)
    want = np.asarray(jm.apply(variables, x, lengths))
    layer = GRULayer(5, 6, reverse)
    layer.load_state_dict(_gru_state(variables["params"]["GRUCell_0"]), strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(x),
                    None if lengths is None else torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if with_lengths:                                  # frames past a length are 0
        assert not got[1, 4:].any() and not got[2, 1:].any()


@pytest.mark.parametrize("with_lengths", [False, True])
def test_bigru_matches_flax(with_lengths):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    lengths = np.array([9, 5], np.int32) if with_lengths else None
    jm = JBiGRU(4, num_layers=2)
    variables = _nonzero_biases(jm.init(jax.random.PRNGKey(2), x, lengths), 2)
    want = np.asarray(jm.apply(variables, x, lengths))
    model = BiGRU(6, 4, 2)
    model.load_state_dict(bigru_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    None if lengths is None else torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- the model ------------------------------------------------------------------

def _inputs(T_lip, T_mel, B=2, V=11, L=3, seed=3):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, size=(2, B)).astype(np.int32)
    return {
        "frames_A": rng.uniform(size=(B, T_lip, *HW, 3)).astype(np.float32),
        "frames_B": rng.uniform(size=(B, T_lip, *HW, 3)).astype(np.float32),
        "mel": rng.standard_normal((B, T_mel, 80)).astype(np.float32),
        "mel_lengths": np.array([T_mel, T_mel - 3][:B], np.int32),
        "label_A": rng.integers(1, V, size=(B, L)).astype(np.int32), "len_A": lens[0],
        "label_B": rng.integers(1, V, size=(B, L)).astype(np.int32), "len_B": lens[1],
    }


def _jax_model(batch, V=11, seed=0):
    jm = JModel(V, HIDDEN)
    variables = jm.init(jax.random.PRNGKey(seed), batch["frames_A"], batch["frames_B"],
                        batch["mel"])
    return jm, _nonzero_biases(variables, seed)


def _port_model(variables, V=11):
    m = MultimodalCTCKoreanModel(V, HIDDEN, HW)
    m.load_state_dict(legacy_from_jax(variables), strict=True)
    return m


def test_legacy_parameter_count_at_full_width():
    """hidden 256, 96x96, 11,173 ids: 71,371,621 parameters, as
    ``jax.eval_shape`` of the JAX model counts; 56.6M are the lip GRU's
    ``[36864, 256]`` input kernels."""
    with torch.device("meta"):
        m = MultimodalCTCKoreanModel(11173, 256, (96, 96))
    assert sum(p.numel() for p in m.parameters()) == 71_371_621
    assert m.lip_encoder.gru.layers[0].w_ih.shape == (2, 768, 36864)


def test_lip_and_mel_encoders_match_jax():
    batch = _inputs(5, 17)
    jm, variables = _jax_model(batch)
    port = _port_model(variables)
    params = variables["params"]
    want_lip = np.asarray(JLipEncoder(HIDDEN).apply({"params": params["lip_encoder"]},
                                                    batch["frames_A"]))
    want_mel = np.asarray(JMelEncoder(HIDDEN).apply({"params": params["audio_encoder"]},
                                                    batch["mel"], batch["mel_lengths"]))
    with torch.no_grad():
        got_lip = port.lip_encoder(torch.from_numpy(batch["frames_A"])).numpy()
        got_mel = port.audio_encoder(torch.from_numpy(batch["mel"]),
                                     torch.from_numpy(batch["mel_lengths"])).numpy()
    assert got_lip.shape == (2, 5, 2 * HIDDEN)
    np.testing.assert_allclose(got_lip, want_lip, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_mel, want_mel, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T_lip,T_mel", [(5, 17), (9, 9)])
def test_model_matches_jax(T_lip, T_mel):
    batch = _inputs(T_lip, T_mel)
    jm, variables = _jax_model(batch)
    port = _port_model(variables)
    want = jm.apply(variables, batch["frames_A"], batch["frames_B"], batch["mel"],
                    batch["mel_lengths"])
    with torch.no_grad():
        got = port(*[torch.from_numpy(batch[k])
                     for k in ("frames_A", "frames_B", "mel", "mel_lengths")])
    for g, w in zip(got, want):
        assert g.shape == (2, T_mel, 11)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_loss_and_gradients_match_jax():
    batch = _inputs(5, 17)
    jm, variables = _jax_model(batch)
    jt = JTrainer(vocab_size=11, hidden_dim=HIDDEN)
    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(variables["params"], batch)

    def j_logit_loss(la, lb):
        return sum(j_ctc_loss(jax.nn.log_softmax(lg, -1), batch[f"label_{s}"],
                              batch["mel_lengths"], batch[f"len_{s}"], 0)
                   for lg, s in ((la, "A"), (lb, "B")))
    logits = jm.apply(variables, batch["frames_A"], batch["frames_B"], batch["mel"])
    jlg = jax.grad(j_logit_loss, argnums=(0, 1))(*logits)

    trainer = LegacyTrainer(vocab_size=11, hidden_dim=HIDDEN, image_size=HW, device="cpu")
    trainer.model.load_state_dict(legacy_from_jax(variables), strict=True)
    placed = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = trainer.loss_fn(trainer.model, placed)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = legacy_from_jax({"params": to_np(jgrads)})
    for name, p in trainer.model.named_parameters():
        _grad_close(p.grad, want[name], name)

    lg = [torch.from_numpy(np.array(x)).requires_grad_() for x in logits]
    total = sum(ctc_loss(torch.log_softmax(x, -1), placed[f"label_{s}"], placed["mel_lengths"],
                         placed[f"len_{s}"], 0) for x, s in zip(lg, "AB"))
    total.backward()
    for x, w in zip(lg, jlg):
        _grad_close(x.grad, torch.from_numpy(np.array(w)), "logits")


# -- the trainer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def legacy_steps():
    """Three JAX ``LegacyTrainer`` steps from one state, with their losses and
    gradients."""
    import optax

    batch = _inputs(5, 17, seed=4)
    jt = JTrainer(vocab_size=11, hidden_dim=HIDDEN)
    params, opt_state = jt.init(0, batch)
    start = (to_np(params), to_np(opt_state))

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(jt.loss_fn)(params, batch)
        updates, opt_state = jt.tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    steps = []
    for _ in range(3):
        params, opt_state, loss, grads = step(params, opt_state)
        steps.append({"loss": float(loss), "grads": legacy_from_jax({"params": to_np(grads)}),
                      "params": legacy_from_jax({"params": to_np(params)})})
    return {"batch": batch, "start": start, "steps": steps, "jt": jt}


def _port_trainer(start):
    trainer = LegacyTrainer(vocab_size=11, hidden_dim=HIDDEN, image_size=HW, device="cpu")
    state = trainer.init_state(0)
    state.load_state_dict(legacy_state_from_jax(*start))
    return trainer, state


def test_legacy_state_carries_adam():
    params = _jax_model(_inputs(5, 17))[1]["params"]
    jt = JTrainer(vocab_size=11, hidden_dim=HIDDEN)
    opt_state = to_np(jt.tx.init(params))
    sd = legacy_state_from_jax(params, opt_state)
    assert sd["step"] == sd["optimizer"]["updates"] == 0
    assert set(sd["optimizer"]["mu"]) == set(sd["model"]) == set(
        MultimodalCTCKoreanModel(11, HIDDEN, HW).state_dict())


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(legacy_steps, n_steps):
    trainer, state = _port_trainer(legacy_steps["start"])
    initial = {k: v.clone() for k, v in state.model.state_dict().items()}
    for i in range(n_steps):
        state, loss = trainer.train_step(state, legacy_steps["batch"])
        want = legacy_steps["steps"][i]
        np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-4, atol=1e-6)
        for name, p in state.model.named_parameters():
            _grad_close(p.grad, want["grads"][name], f"step {i + 1} grad {name}")
    assert state.step == state.optimizer.updates == n_steps
    want = legacy_steps["steps"][n_steps - 1]["params"]
    first = legacy_steps["steps"][0]["grads"]
    left_out = total = 0
    for name, value in state.model.state_dict().items():
        g = first[name].abs()
        sel = (g == 0) | ((g >= 1e-7) & (g >= 1e-6 * g.max()))
        diff = (value - want[name])[sel].abs()
        assert diff.numel() == 0 or diff.max() <= 2e-2 * LR * n_steps, name
        assert not torch.equal(value, initial[name]), name
        left_out += int((~sel).sum())
        total += sel.numel()
    assert left_out <= 0.01 * total, (left_out, total)


def test_fit_prints_the_epoch_sums_as_jax(legacy_steps):
    batch, jt = legacy_steps["batch"], legacy_steps["jt"]
    params, opt_state = (jax.tree.map(jnp.asarray, t) for t in legacy_steps["start"])
    want = []
    jt.fit(params, opt_state, [batch, batch], epochs=2, log_fn=want.append)
    trainer, state = _port_trainer(legacy_steps["start"])
    got = []
    trainer.fit(state, [batch, batch], epochs=2, log_fn=got.append)
    assert [g.split(":")[0] for g in got] == [w.split(":")[0] for w in want] == \
        ["[Epoch 1] Loss", "[Epoch 2] Loss"]
    for g, w in zip(got, want):
        assert g.count(".") == 1 and len(g.split(".")[1]) == 4          # "{:.4f}"
        np.testing.assert_allclose(float(g.split(": ")[1]), float(w.split(": ")[1]),
                                   rtol=1e-5)
    assert float(got[0].split(": ")[1]) > 1.5 * legacy_steps["steps"][0]["loss"]   # a sum


def test_fit_trains_a_one_shot_generator_in_epoch_one_only(legacy_steps):
    """JAX iterates ``batches`` anew each epoch: a generator is spent after
    epoch 1 and the later epochs print a sum of 0 (mirrored, ROADMAP Queue 3)."""
    batch, jt = legacy_steps["batch"], legacy_steps["jt"]
    params, opt_state = (jax.tree.map(jnp.asarray, t) for t in legacy_steps["start"])
    want = []
    jt.fit(params, opt_state, (b for b in [batch]), epochs=3, log_fn=want.append)
    trainer, state = _port_trainer(legacy_steps["start"])
    got = []
    trainer.fit(state, (b for b in [batch]), epochs=3, log_fn=got.append)
    assert got[1:] == want[1:] == ["[Epoch 2] Loss: 0.0000", "[Epoch 3] Loss: 0.0000"]
    assert state.step == 1
    np.testing.assert_allclose(float(got[0].split(": ")[1]), float(want[0].split(": ")[1]),
                               rtol=1e-5)


def test_seeded_init_follows_flax_distributions():
    m = init_legacy_weights(MultimodalCTCKoreanModel(11, 16, HW),
                            torch.Generator().manual_seed(0))
    again = init_legacy_weights(MultimodalCTCKoreanModel(11, 16, HW),
                                torch.Generator().manual_seed(0))
    for (name, p), q in zip(m.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
    w_hh = m.lip_encoder.gru.layers[0].w_hh.detach()
    for d in range(2):
        for g in range(3):                           # each gate's block is orthogonal
            blk = w_hh[d, g * 16:(g + 1) * 16]
            torch.testing.assert_close(blk @ blk.T, torch.eye(16), rtol=0, atol=1e-5)
    w = m.lip_encoder.gru.layers[0].w_ih.detach()
    bound = 2 / np.sqrt(w.shape[-1]) / 0.87962566103423978
    assert w.abs().max() <= bound and 0.8 < float(w.std() * np.sqrt(w.shape[-1])) < 1.2
    assert not m.lip_encoder.gru.layers[0].b_ih.any() and not m.fc.bias.any()


# -- the sample directories -------------------------------------------------------

@pytest.fixture(scope="module")
def legacy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy")
    rng = np.random.default_rng(0)
    for i in range(2):
        d = root / f"sample_{i:03d}"
        for side in ("A", "B"):
            fdir = d / f"frames_{side}"
            os.makedirs(fdir)
            for t in range(4):
                np.save(str(fdir / f"{t:04d}.npy"),
                        rng.uniform(0, 255, size=(32, 40, 3)).astype(np.uint8))
            with open(d / f"gt_{side}.txt", "w", encoding="utf-8") as f:
                f.write("바나나 x" if side == "A" else "사과")
        j_write_wav(str(d / "mixed.wav"), rng.standard_normal(3200 + 160 * i) * 0.1, 16000)
    os.makedirs(root / "not_a_sample")
    return str(root)


def test_scan_and_load_match_jax(legacy_root):
    dirs = scan_legacy_root(legacy_root)
    assert dirs == j_scan(legacy_root) and len(dirs) == 2
    for d in dirs:
        got = load_legacy_sample(d, KoreanSyllableVocab(), image_size=24, device="cpu")
        want = j_load_sample(d, JVocab(), image_size=24)
        assert set(got) == set(want)
        for k in ("frames_A", "frames_B"):
            assert got[k].shape == want[k].shape == (4, 24, 24, 3)
            assert got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        assert got["mel"].dtype == np.float32 and got["mel"].shape == want["mel"].shape
        np.testing.assert_allclose(got["mel"], want["mel"], rtol=1e-4, atol=1e-4)
        for k in ("label_A", "label_B"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_load_reads_image_frames_through_cv2(legacy_root, tmp_path):
    cv2 = pytest.importorskip("cv2")
    import shutil

    d = str(tmp_path / "sample_png")
    shutil.copytree(scan_legacy_root(legacy_root)[0], d)
    for side in ("A", "B"):
        folder = os.path.join(d, f"frames_{side}")
        for n in sorted(os.listdir(folder)):
            arr = np.load(os.path.join(folder, n))
            os.remove(os.path.join(folder, n))
            cv2.imwrite(os.path.join(folder, n.replace(".npy", ".png")), arr[:, :, ::-1])
    got = load_legacy_sample(d, KoreanSyllableVocab(), image_size=24, device="cpu")
    want = j_load_sample(d, JVocab(), image_size=24)
    np.testing.assert_allclose(got["frames_A"], want["frames_A"], rtol=0, atol=1e-6)
    ref = load_legacy_sample(scan_legacy_root(legacy_root)[0], KoreanSyllableVocab(),
                             image_size=24, device="cpu")
    np.testing.assert_allclose(got["frames_B"], ref["frames_B"], rtol=0, atol=1e-6)


def test_load_runs_k1_on_the_card_by_default(legacy_root):
    """``device`` defaults to "cuda": without a card the load raises instead
    of taking the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        load_legacy_sample(scan_legacy_root(legacy_root)[0], KoreanSyllableVocab())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("legacy_corpus") / "corpus"))


def _tree_bytes(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_build_all_pair_samples_byte_equal_to_jax(corpus, tmp_path):
    entries, _ = build_data_list(corpus["json_folder"], corpus["npy_dir"], corpus["text_dir"],
                                 corpus["wav_dir"])
    j_entries, _ = j_build_data_list(corpus["json_folder"], corpus["npy_dir"],
                                     corpus["text_dir"], corpus["wav_dir"])
    got = build_all_pair_samples(entries[:4], str(tmp_path / "port"), max_pairs=5)
    want = j_build_all(j_entries[:4], str(tmp_path / "jax"), max_pairs=5)
    assert [os.path.basename(d) for d in got] == [os.path.basename(d) for d in want] == \
        [f"sample_{i:04d}" for i in range(5)]
    port, ref = _tree_bytes(str(tmp_path / "port")), _tree_bytes(str(tmp_path / "jax"))
    assert sorted(port) == sorted(ref) and port == ref
    clip = np.load(entries[0].lip_path)
    assert len([k for k in port if k.startswith("sample_0000/frames_A/")]) == clip.shape[0]
    assert port["sample_0000/gt_A.txt"].decode("utf-8") == entries[0].sentence_text + "\n"


def test_build_pair_sample_of_dict_entries_reads_text_path(corpus, tmp_path):
    """A dict entry has no ``sentence_text`` attribute: both packages read
    the text from ``text_path``."""
    entries, _ = build_data_list(corpus["json_folder"], corpus["npy_dir"], corpus["text_dir"],
                                 corpus["wav_dir"])
    s1, s2 = ({k: getattr(e, k) for k in ("lip_path", "text_path", "audio_path",
                                          "start_time", "end_time")} for e in entries[5:7])
    build_pair_sample(s1, s2, str(tmp_path / "port"))
    j_build_pair(s1, s2, str(tmp_path / "jax"))
    port = _tree_bytes(str(tmp_path / "port"))
    assert port == _tree_bytes(str(tmp_path / "jax"))
    with open(s1["text_path"], encoding="utf-8") as f:
        assert port["gt_A.txt"].decode("utf-8") == f.read().strip() + "\n"
