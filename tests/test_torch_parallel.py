"""PyTorch port, the parallel layouts of the training step: the mesh,
``pad_batch_to_multiple``, the node-aware mesh's refusal and
``initialize_distributed``, the tensor plan and FSDP placements against JAX's
``tp_param_specs`` / ``fsdp_param_specs``, and the meshed step on gloo
processes (``parallel/spawn.py``, rendezvous through a file under the test's
``tmp_path``) at DP4, DP2 x TP2 and DP2 x TP2 x FSDP, on the tiny flagship of
``__graft_entry__.py`` (BatchNorm, the transformer temporal model) with a
batch of 3 rows padded to 4.

Tolerances:
* against the port's one-process step on the padded batch, dropout 0.1 on
  (the ranks draw the whole batch's masks): metrics rtol 1e-5; gradients per
  tensor ``|g - g_1| <= 1e-5 |g_1| + 1e-8 |G_1|`` (``G_1`` all of them; the
  attention key biases have no gradient in exact arithmetic, so theirs is
  rounding); BatchNorm statistics and parameters after 3 steps rtol 1e-5
  (atol 1e-7), parameters only where the first step's gradient is at least
  1e-6 (Adam moves an element by about the learning rate whatever the size
  of its gradient, so rounding-level gradients move it by rounding-level
  chance); the greedy eval's loss, WER and CER equal to 1e-6;
* against JAX's ``train_step`` from the same state, dropout 0: the bars of
  ``tests/test_torch_trainer.py``.
"""

import os
import socket

import numpy as np
import pytest
import torch

import jax
import optax
from flax import serialization
from flax.traverse_util import flatten_dict, unflatten_dict

from __graft_entry__ import _flagship_config
from multimodal_av_model_tpu.main import build_data as j_build_data
from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu.parallel import fsdp_param_specs as j_fsdp_specs
from multimodal_av_model_tpu.parallel import pad_batch_to_multiple as j_pad
from multimodal_av_model_tpu.parallel import tp_param_specs as j_tp_specs
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu.train import MultiSpeakerTrainer as JTrainer
from multimodal_av_model_tpu_torch import graft_entry
from multimodal_av_model_tpu_torch import parallel
from multimodal_av_model_tpu_torch.compat import from_jax_variables, train_state_from_jax
from multimodal_av_model_tpu_torch.main import build_data as p_build_data
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.parallel.spawn import meshed_train_steps, run_ranks
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer
from test_torch_models import port_config, to_np

VOCAB = graft_entry.VOCAB
KEYS = ("loss", "ctc1", "ctc2", "contrast1", "contrast2", "grad_norm")
LR = 1e-4
N_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(dropout: float):
    cfg = _flagship_config(tiny=True)
    cfg.model.decoder.vocab_size = 800
    cfg.model.audio.dropout = dropout
    cfg.train.log_every = 1000
    return cfg


def _batch():
    batch = graft_entry.train_batch(np.random.default_rng(0), 3, 800)
    batch["valid"] = np.ones(3, np.float32)
    return batch


def test_graft_entry_config_is_jax_s():
    assert graft_entry.flagship_config(tiny=True) == port_config(_flagship_config(tiny=True))
    assert graft_entry.flagship_config() == port_config(_flagship_config())


# -- mesh, padding, process set-up -----------------------------------------------


@pytest.mark.parametrize("b,multiple,valid", [(3, 2, True), (3, 4, False), (4, 2, True),
                                              (5, 3, True)])
def test_pad_batch_to_multiple_is_jax_s(b, multiple, valid):
    rng = np.random.default_rng(b)
    batch = {"x": rng.standard_normal((b, 2, 3)).astype(np.float32),
             "n": np.arange(b, dtype=np.int32), "scalar": np.float32(7)}
    if valid:
        batch["valid"] = np.ones(b, np.float32)
    got, want = parallel.pad_batch_to_multiple(batch, multiple), j_pad(batch, multiple)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_process_rows_cut_a_padded_batch():
    class FakeMesh:                      # axis_size / axis_rank read these
        def __init__(self, rank):
            self.rank = rank

        def __getitem__(self, axis):
            rank = self.rank

            class Axis:
                def size(self):
                    return 2 if axis == "data" else 1

                def get_local_rank(self):
                    return rank if axis == "data" else 0
            return Axis()

    batch = _batch()
    rows = [parallel.process_rows(FakeMesh(r), batch) for r in range(2)]
    assert [int(r["num_real"]) for r in rows] == [2, 1]
    np.testing.assert_array_equal(np.concatenate([r["valid"] for r in rows]), [1, 1, 1, 0])
    np.testing.assert_array_equal(np.concatenate([r["audio"] for r in rows]),
                                  j_pad(batch, 2)["audio"])


def test_initialize_distributed_without_the_environment_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not torch.distributed.is_initialized()
    assert parallel.initialize_distributed("cpu") is False
    assert parallel.initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert parallel.process_local_batch_size(8) == 8


@pytest.fixture
def one_rank(monkeypatch):
    """A one-rank gloo group from torchrun's environment, torn down after."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    assert parallel.initialize_distributed("cpu") is True
    yield
    torch.distributed.destroy_process_group()


def test_one_rank_group_and_its_mesh(one_rank):
    assert parallel.initialize_distributed("cpu") is True          # idempotent
    assert torch.distributed.get_backend() == "gloo"
    mesh = parallel.make_mesh(model_parallel=1, device_type="cpu")
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    assert tuple(parallel.make_hybrid_mesh(1, device_type="cpu").shape) == (1, 1)
    assert parallel.process_local_batch_size(8) == 8
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        parallel.make_mesh(model_parallel=2, device_type="cpu")


def test_hybrid_mesh_refuses_a_tensor_group_across_nodes(one_rank):
    with pytest.raises(ValueError, match="host 0 has 1 devices, not divisible by "
                                         "model_parallel=2 — a tensor-parallel group "
                                         "must stay inside one host's ICI domain"):
        parallel.make_hybrid_mesh(2, device_type="cpu")


# -- placements against JAX's specs ---------------------------------------------------


@pytest.fixture(scope="module")
def numbered():
    """JAX params of the tiny flagship with every element a distinct number,
    and the same numbers in the port's layout."""
    cfg = _jax_cfg(0.1)
    batch = _batch()
    variables = jax.jit(JModel(cfg.model).init)(
        jax.random.PRNGKey(0), *(np.asarray(batch[k]) for k in (
            "lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")))
    flat = flatten_dict(to_np(variables["params"]))
    start, numbered = 0, {}
    for path, leaf in flat.items():
        numbered[path] = np.arange(start, start + leaf.size, dtype=np.float64).reshape(leaf.shape)
        start += leaf.size
    params = unflatten_dict(numbered)
    port = from_jax_variables({"params": params, "batch_stats": to_np(variables["batch_stats"])})
    model = MultiSpeakerAVModel(port_config(cfg).model)
    return params, port, model


def _jax_owners(params, specs, axis: str, size: int) -> dict:
    """Number -> the ``axis`` coordinates whose shard holds it."""
    owners: dict = {}
    flat, flat_specs = flatten_dict(params), flatten_dict(specs)
    for path, leaf in flat.items():
        spec = list(flat_specs[path]) + [None] * leaf.ndim
        dims = [d for d in range(leaf.ndim) if spec[d] == axis]
        for k in range(size):
            piece = leaf
            for d in dims:
                piece = np.array_split(piece, size, axis=d)[k]
            for v in piece.ravel():
                owners.setdefault(v, set()).add(k)
    return owners


def _port_owners(port, placements, size: int) -> dict:
    owners: dict = {}
    for name, placement in placements.items():
        value = port[name].numpy()
        for k in range(size):
            piece = value
            if placement.is_shard():
                piece = np.array_split(value, size, axis=placement.dim)[k]
            for v in piece.ravel():
                owners.setdefault(v, set()).add(k)
    return owners


@pytest.mark.parametrize("model_parallel", [2, 3, 4])
def test_tp_plan_splits_what_jax_splits(numbered, model_parallel):
    """Each number lives on the same ``model`` ranks in both packages: 2
    splits every wide layer, 3 (2 heads, 64 FFN units) only the 48-wide
    ``out_proj``, 4 the FFNs and ``out_proj`` but not the 2-head attention."""
    params, port, model = numbered
    specs = parallel.tp_param_specs(model, model_parallel)
    assert set(specs) == set(port) - {k for k in port if "running" in k}
    j = _jax_owners(params, j_tp_specs(params, model_parallel), "model", model_parallel)
    assert _port_owners(port, specs, model_parallel) == j
    split = {n for n, p in specs.items() if p.is_shard()}
    if model_parallel == 3:
        assert split == {"audio_encoder.out_proj.weight", "audio_encoder.out_proj.bias"}
    else:
        assert "audio_encoder.blocks.0.ff1.fc1.weight" in split
        assert ("audio_encoder.blocks.0.attn.query.weight" in split) == (model_parallel == 2)


def test_fsdp_placements_keep_jax_s_model_split_and_shard_the_rest_over_data(numbered):
    params, port, model = numbered
    specs = parallel.fsdp_param_specs(model, data_parallel=2, model_parallel=2)
    jspecs = j_fsdp_specs(params, data_parallel=2, model_parallel=2)
    j = _jax_owners(params, jspecs, "model", 2)
    assert _port_owners(port, {n: s[1] for n, s in specs.items()}, 2) == j
    # FSDP2 splits every parameter over data; JAX leaves leaves under 4096
    # elements whole, and splits every larger one.
    assert all(s[0].is_shard() for s in specs.values())
    j_data = {v for v, ks in _jax_owners(params, jspecs, "data", 2).items() if len(ks) == 1}
    p_data = {v for v, ks in _port_owners(port, {n: s[0] for n, s in specs.items()}, 2).items()
              if len(ks) == 1}
    assert j_data and j_data <= p_data
    assert parallel.fsdp_param_specs(model, 1, 1)[
        "decoder.head.weight"][0].is_replicate()


# -- the meshed step on gloo processes -------------------------------------------


def _jax_step(trainer):
    def step(state, batch):
        rng, step_rng = jax.random.split(state.rng)
        (_, (metrics, new_stats, _)), grads = jax.value_and_grad(
            lambda p: trainer._losses(p, state.batch_stats, batch, step_rng, True),
            has_aux=True)(state.params)
        updates, new_opt = trainer._tx.update(grads, state.opt_state, state.params)
        metrics["grad_norm"] = optax.global_norm(grads)
        return (state.replace(step=state.step + 1, params=optax.apply_updates(state.params, updates),
                              batch_stats=new_stats, opt_state=new_opt, rng=rng),
                metrics, grads)
    return jax.jit(step)


@pytest.fixture(scope="module")
def refs():
    """The one-process references on the padded batch: the port's step with
    dropout on, and JAX's with dropout off (plus its initial state)."""
    padded = j_pad(_batch(), 2)
    cfg_on = port_config(_jax_cfg(0.1))
    tok = CharTokenizer(VOCAB)
    trainer = MultiSpeakerTrainer(cfg_on, MultiSpeakerAVModel(cfg_on.model), tok, device="cpu")
    state = trainer.init_state(0)
    port = {"metrics": [], "grads": []}
    for _ in range(N_STEPS):
        state, m = trainer.train_step(state, padded)
        port["metrics"].append({k: float(v) for k, v in m.items()})
        port["grads"].append({n: p.grad.clone() for n, p in state.model.named_parameters()
                              if p.grad is not None})
    port["state"] = {k: v.clone() for k, v in state.model.state_dict().items()}
    port["eval"] = trainer.evaluate([padded], state, use_beam=False)

    jcfg = _jax_cfg(0.0)
    jt = JTrainer(jcfg, JModel(jcfg.model), JTokenizer(VOCAB))
    jstate = jt.init_state(0, padded)
    sd0 = train_state_from_jax(serialization.to_state_dict(jax.device_get(jstate)))
    step, placed = _jax_step(jt), jt._place(padded)
    jax_ref = {"metrics": [], "grads": []}
    for _ in range(N_STEPS):
        jstate, m, g = step(jstate, placed)
        jax_ref["metrics"].append({k: float(v) for k, v in m.items()})
        jax_ref["grads"].append(from_jax_variables({"params": to_np(g)}))
    jax_ref["state"] = from_jax_variables({"params": to_np(jstate.params),
                                           "batch_stats": to_np(jstate.batch_stats)})
    return {"port": port, "jax": jax_ref, "sd0": sd0, "cfg_on": cfg_on,
            "cfg_off": port_config(jcfg)}


LAYOUTS = {"dp4": (1, False), "dp2_tp2": (2, False), "dp2_tp2_fsdp": (2, True)}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def meshed(request, refs, tmp_path_factory):
    model_parallel, fsdp = LAYOUTS[request.param]
    work = str(tmp_path_factory.mktemp(request.param))
    on, off = os.path.join(work, "on.pt"), os.path.join(work, "off.pt")
    layout = {"model_parallel": model_parallel, "fsdp": fsdp, "steps": N_STEPS}
    run_ranks(meshed_train_steps, 4, work,
              ([{"out": on, "cfg": refs["cfg_on"], **layout},
                {"out": off, "cfg": refs["cfg_off"], "state_dict": refs["sd0"], **layout}],
               VOCAB, _batch()), timeout=240)
    return {"on": torch.load(on, weights_only=True), "off": torch.load(off, weights_only=True),
            "shape": (4 // model_parallel, model_parallel)}


def test_meshed_step_equals_the_one_process_step(meshed, refs):
    got, want = meshed["on"], refs["port"]
    assert got["mesh"] == meshed["shape"]
    # Plain and split parameters together: Adam steps them one by one (its
    # multi-tensor path, the default on the card, refuses the mix).
    assert got["adam_foreach"] is (None if meshed["shape"] == (4, 1) else False)
    for i in range(N_STEPS):
        for k in KEYS:
            np.testing.assert_allclose(got["metrics"][i][k], want["metrics"][i][k], rtol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
        total = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in want["grads"][i].values()]))
        assert set(got["grads"][i]) == set(want["grads"][i])
        for name, g1 in want["grads"][i].items():
            err = torch.linalg.vector_norm(got["grads"][i][name] - g1)
            assert err <= 1e-5 * torch.linalg.vector_norm(g1) + 1e-8 * total, \
                f"step {i + 1} grad {name}: {err:.3e}"
    moved = want["grads"][0]
    for name, value in want["state"].items():
        mine = got["state"]["model"][name]
        if "running" in name:
            torch.testing.assert_close(mine, value, rtol=1e-5, atol=1e-7, msg=name)
            continue
        sel = moved[name].abs() >= 1e-6
        torch.testing.assert_close(mine[sel], value[sel], rtol=1e-5, atol=1e-7, msg=name)


def test_meshed_eval_sums_the_ranks_counts(meshed, refs):
    got, want = meshed["on"]["eval"], refs["port"]["eval"]
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-6)
    assert got[3] == pytest.approx(want[3], rel=1e-6)


def test_meshed_step_matches_jax(meshed, refs):
    got, want = meshed["off"], refs["jax"]
    for i in range(N_STEPS):
        for k in KEYS:
            np.testing.assert_allclose(got["metrics"][i][k], want["metrics"][i][k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i + 1} {k}")
        for name, g_ref in want["grads"][i].items():
            g = got["grads"][i][name]
            assert torch.linalg.vector_norm(g - g_ref) <= \
                1e-3 * torch.linalg.vector_norm(g_ref) + 1e-7, f"step {i + 1} grad {name}"
    moved = want["grads"][0]
    for name, value in want["state"].items():
        mine = got["state"]["model"][name]
        if "running" in name:
            torch.testing.assert_close(mine, value, rtol=1e-4, atol=1e-5, msg=name)
            continue
        diff = (mine - value)[moved[name].abs() >= 1e-7].abs()
        assert diff.numel() == 0 or diff.max() <= 2e-2 * LR * N_STEPS, name


def test_dryrun_multichip_four_processes():
    report = graft_entry.dryrun_multichip(4)
    assert report["loss_diff"] < 1e-4 and np.isfinite(report["loss"])
    assert report["pp_diff"] < 2e-5 and np.isfinite(report["pp_loss"])     # the pipeline leg


def test_dryrun_multichip_six_processes_runs_the_pipeline_leg_on_four():
    """JAX runs the pipeline leg for every ``n >= 4``, on the first
    ``4 (n // 4)`` devices (``__graft_entry__.py:241-252``); the port runs
    it on a second spawn of that many processes."""
    report = graft_entry.dryrun_multichip(6)
    assert report["loss_diff"] < 1e-4 and np.isfinite(report["loss"])
    assert report["pp_diff"] < 2e-5 and np.isfinite(report["pp_loss"])


def test_every_process_loads_the_same_pairs_in_both_packages():
    """JAX's ``build_data`` is not process-aware (``main.py:27-110``): each
    process of a multi-process run draws the same seeded pairs, so a pair
    appears once per data rank in the global batch.  The port mirrors it."""
    jtok, tok = JTokenizer(VOCAB), CharTokenizer(VOCAB)
    jcfg = _jax_cfg(0.1)
    jcfg.data.num_pairs_per_epoch, jcfg.train.batch_size = 4, 2    # 4 global over 2 processes
    pcfg = port_config(jcfg)
    for build, tk, cfg, kw in ((j_build_data, jtok, jcfg, {}),
                               (p_build_data, tok, pcfg, {"device": "cpu"})):
        procs = [next(iter(build(cfg, tk, True, **kw)[0]())) for _ in range(2)]
        for k in ("audio", "text1", "lip1"):
            np.testing.assert_array_equal(np.asarray(procs[0][k]), np.asarray(procs[1][k]))


def test_entry_is_the_full_width_forward():
    fn, args = graft_entry.entry(device="cpu")
    assert args[0].shape == (2, 16, 1, 96, 96) and args[2].shape == (2, 16 * 534)
    lp1, lp2, lengths = fn(*args)
    assert lp1.shape == lp2.shape == (2, 16, 800)
    assert torch.isfinite(lp1.float()).all() and torch.isfinite(lp2.float()).all()
    assert lengths.shape == (2,) and (lengths <= 16).all()
