"""PyTorch port, pipeline parallelism (``parallel/pp.py``): the GPipe schedule
of the Conformer stack over a ``pipe`` axis of 4 gloo ranks, held against
JAX's ``pipeline_blocks`` and the sequential stack at JAX's test shapes
(``tests/test_pipeline_parallel.py``: L = 8 blocks of width 16, 2 heads, FFN
32, kernel 3; B = 8, T = 12, random lengths), with JAX's parameters carried
by ``stacked_blocks_from_jax``.

One spawned group of 8 ranks serves the module
(``parallel/spawn.py:pipeline_cases``) as a ``(data=2, pipe=4)`` mesh: the
pipe-4 cases run with no ``data_axis``, so each data slice runs the same
4-stage pipeline on the whole batch (JAX's ``P(None, None)``); the
data-parallel case splits each microbatch's rows over ``data``.

Tolerances (JAX's): forward within 2e-5; gradients of ``sum(y * valid)`` per
parameter at rtol 5e-4, atol 5e-5.  The stacking is exact.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from multimodal_av_model_tpu.models.audio import ConformerBlock as JBlock
from multimodal_av_model_tpu.parallel import pp as jpp
from multimodal_av_model_tpu_torch.compat.from_jax import (
    audio_encoder_from_jax,
    stacked_blocks_from_jax,
)
from multimodal_av_model_tpu_torch.models.audio import ConformerBlock
from multimodal_av_model_tpu_torch.models.layers import init_weights
from multimodal_av_model_tpu_torch.parallel import make_named_mesh, pp
from multimodal_av_model_tpu_torch.parallel.spawn import pipeline_cases, run_ranks
from test_torch_models import to_np

L, D, HEADS, FFN, KERNEL = 8, 16, 2, 32, 3
B, T = 8, 12
FWD = 2e-5
BLOCK_ARGS = (D, HEADS, FFN, KERNEL, 0.0, torch.float32)


def _inputs(seed):
    """``tests/test_pipeline_parallel.py:_inputs``: x, valid, mask as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = rng.integers(T // 2, T + 1, size=(B,))
    valid = np.arange(T)[None, :] < lens[:, None]
    return x, valid, valid[:, None, None, :] & valid[:, None, :, None]


@pytest.fixture(scope="module")
def jax_side():
    """JAX's blocks (``_init_blocks``) and every reference output."""
    block = JBlock(HEADS, FFN, KERNEL, 0.0, jnp.float32)
    z = (jnp.zeros((2, T, D)), jnp.ones((2, T), bool), jnp.ones((2, 1, T, T), bool))
    params = {f"block{i}": block.init(jax.random.PRNGKey(i), *z, True)["params"]
              for i in range(L)}
    stacked = jpp.stack_block_params(params, L)
    pipe4 = Mesh(np.array(jax.devices()[:4]), (jpp.PIPE_AXIS,))
    dp2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", jpp.PIPE_AXIS))

    def run(mesh, M, inputs, data_axis=None):
        s = jpp.shard_stacked_params(stacked, mesh)
        fn = jax.jit(lambda p, x, v, a: jpp.pipeline_blocks(block, p, x, v, a, mesh, M,
                                                            data_axis=data_axis))
        return np.asarray(fn(s, *(jnp.asarray(a) for a in inputs)))

    def seq(inputs):
        x, v, a = (jnp.asarray(t) for t in inputs)
        for i in range(L):
            x = block.apply({"params": params[f"block{i}"]}, x, v, a, True)
        return np.asarray(x)

    x, valid, amask = _inputs(2)

    def pp_loss(p):
        y = jpp.pipeline_blocks(block, p, jnp.asarray(x), jnp.asarray(valid),
                                jnp.asarray(amask), pipe4, 4)
        return (y * jnp.where(jnp.asarray(valid)[..., None], 1.0, 0.0)).sum()

    g_pp = jax.jit(jax.grad(pp_loss))(jpp.shard_stacked_params(stacked, pipe4))
    return {"params": params, "stacked": to_np(stacked),
            "fwd": {M: run(pipe4, M, _inputs(1)) for M in (2, 4, 8)},
            "seq": {seed: seq(_inputs(seed)) for seed in (1, 3)},
            "dp": run(dp2, 4, _inputs(3), "data"), "g_pp": to_np(g_pp)}


@pytest.fixture(scope="module")
def ported(jax_side, tmp_path_factory):
    """Every case on one spawned group of 8 gloo ranks."""
    work = str(tmp_path_factory.mktemp("pp"))
    jobs = [{"microbatches": M, **dict(zip(("x", "frame_valid", "attn_mask"), _inputs(1)))}
            for M in (2, 4, 8)]
    jobs.append({"microbatches": 4, "grad": True,
                 **dict(zip(("x", "frame_valid", "attn_mask"), _inputs(2)))})
    jobs.append({"microbatches": 4, "data_axis": "data", "grad": True,
                 **dict(zip(("x", "frame_valid", "attn_mask"), _inputs(3)))})
    stacked = stacked_blocks_from_jax(jax_side["stacked"], L)
    out = os.path.join(work, "out.pt")
    run_ranks(pipeline_cases, 8, work, (BLOCK_ARGS, stacked, jobs, out), timeout=180)
    res = torch.load(out, weights_only=True)
    return {"fwd": dict(zip((2, 4, 8), res[:3])), "grad": res[3], "dp": res[4],
            "stacked": stacked}


def _sequential_grads(stacked, inputs):
    """The port's blocks applied in turn, and the gradients of sum(y * valid)
    stacked: the one-process reference for the data-parallel case."""
    blocks = [ConformerBlock(*BLOCK_ARGS).eval() for _ in range(L)]
    for i, b in enumerate(blocks):
        b.load_state_dict({n: t[i] for n, t in stacked.items()})
    x, valid, amask = (torch.from_numpy(a) for a in inputs)
    for b in blocks:
        x = b(x, valid, amask)
    (x * valid[..., None]).sum().backward()
    return pp.stack_block_params({f"blocks.{i}.{n}": p.grad for i, b in enumerate(blocks)
                                  for n, p in b.named_parameters()}, L)


def test_stack_unstack_roundtrip():
    blocks = init_weights(torch.nn.ModuleList(ConformerBlock(*BLOCK_ARGS) for _ in range(L)),
                          torch.Generator().manual_seed(0))
    sd = {f"blocks.{k}": v for k, v in blocks.state_dict().items()}
    stacked = pp.stack_block_params({**sd, "out_proj.weight": torch.zeros(2, 2)}, L)
    assert all(t.shape[0] == L for t in stacked.values()) and len(stacked) == len(sd) // L
    back = pp.unstack_block_params(stacked, L)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def test_stacked_blocks_from_jax_is_the_per_block_bridge(jax_side, ported):
    """Equal to the audio encoder's bridge on JAX's unstacked blocks."""
    unstacked = to_np(jpp.unstack_block_params(jax.tree.map(jnp.asarray, jax_side["stacked"]),
                                               L))
    fake = {"params": {**unstacked,
                       "subsample": {"kernel": np.zeros((5, 1, 1), np.float32),
                                     "bias": np.zeros(1, np.float32)},
                       "out_proj": {"kernel": np.zeros((1, 1), np.float32),
                                    "bias": np.zeros(1, np.float32)}}}
    want = pp.stack_block_params(audio_encoder_from_jax(fake), L)
    got = ported["stacked"]
    assert got.keys() == want.keys()
    for n in want:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("microbatches", [2, 4, 8])
def test_pipeline_forward_matches_jax(jax_side, ported, microbatches):
    got = ported["fwd"][microbatches]["y"].numpy()
    np.testing.assert_allclose(got, jax_side["fwd"][microbatches], rtol=FWD, atol=FWD)
    np.testing.assert_allclose(got, jax_side["seq"][1], rtol=FWD, atol=FWD)


def test_pipeline_gradients_match_jax(jax_side, ported):
    want = stacked_blocks_from_jax(jax_side["g_pp"], L)
    got = ported["grad"]["grads"]
    assert got.keys() == want.keys()
    for n in want:
        for i in range(L):
            np.testing.assert_allclose(got[n][i].numpy(), want[n][i].numpy(), rtol=5e-4,
                                       atol=5e-5, err_msg=f"blocks.{i}.{n}")


def test_pipeline_composes_with_data_parallel(jax_side, ported):
    """(data=2, pipe=4): the forward against JAX's; the gradients, each data
    slice's share summed over ``data``, against the blocks applied in turn."""
    got = ported["dp"]
    np.testing.assert_allclose(got["y"].numpy(), jax_side["dp"], rtol=FWD, atol=FWD)
    np.testing.assert_allclose(got["y"].numpy(), jax_side["seq"][3], rtol=FWD, atol=FWD)
    want = _sequential_grads(ported["stacked"], _inputs(3))
    for n, g in want.items():
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(), rtol=5e-4, atol=5e-5,
                                   err_msg=n)


def test_bubble_fraction():
    assert pp.bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert pp.bubble_fraction(1, 8) == 0.0
    assert pp.bubble_fraction(4, 4) == jpp.bubble_fraction(4, 4)


@pytest.fixture
def one_rank(tmp_path):
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                                         rank=0, world_size=1)
    yield make_named_mesh((1, 1), ("data", pp.PIPE_AXIS), "cpu")
    torch.distributed.destroy_process_group()


def test_one_stage_is_the_sequential_stack(jax_side, ported, one_rank):
    """S = 1 (the card's ``chip_smoke.py``): the M microbatches through all L
    blocks, forward and gradients; and the shape checks."""
    blocks = pp.shard_stacked_params(ported["stacked"], one_rank,
                                     lambda: ConformerBlock(*BLOCK_ARGS)).eval()
    assert len(blocks) == L and pp.stage_layers(L, one_rank) == range(L)
    x, valid, amask = (torch.from_numpy(a) for a in _inputs(3))
    y = pp.pipeline_blocks(blocks, x, valid, amask, one_rank, 4, data_axis="data")
    np.testing.assert_allclose(y.detach().numpy(), jax_side["seq"][3], rtol=FWD, atol=FWD)
    (y * valid[..., None]).sum().backward()
    want = _sequential_grads(ported["stacked"], _inputs(3))
    for n, g in want.items():
        got = torch.stack([b.get_parameter(n).grad for b in blocks])
        torch.testing.assert_close(got, g, rtol=5e-4, atol=5e-5)
    with pytest.raises(ValueError, match="batch 8 not divisible by 3 microbatches"):
        pp.pipeline_blocks(blocks, x, valid, amask, one_rank, 3)
