"""PyTorch port, sequence-parallel attention (``parallel/sequence.py``):
gather-KV and ring attention with time split over 4 gloo ranks (one spawned
group for the module, ``parallel/spawn.py:sequence_cases``), each rank
passing its own time block, held against JAX's ``shard_map`` functions on a
4-device mesh on the same seeded numpy Q, K and V: JAX's own test shapes
``[T=64, H=4, D=16]`` and batched ``[B=2, T=16, H=2, D=8]``.

Tolerances: outputs and the gradients of ``sum(out * w)`` (against
``jax.grad`` of the same JAX function) within 1e-5 (f32; the two differ by
summation order only); bf16 ring against the f32 reference within 0.05, as
``tests/test_sequence_parallel.py`` holds JAX's.  At world size 1 (the card's
``chip_smoke.py``) the ring hop is the identity and both functions are the
reference.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.parallel import make_mesh as j_make_mesh
from multimodal_av_model_tpu.parallel import sequence as jseq
from multimodal_av_model_tpu_torch.parallel import make_named_mesh, ring_hop, sequence
from multimodal_av_model_tpu_torch.parallel.spawn import run_ranks, sequence_cases

WORLD = 4
SHAPES = {"unbatched": (64, 4, 16), "batched": (2, 16, 2, 8)}
FNS = {("gather", "unbatched"): "gather_kv_attention", ("ring", "unbatched"): "ring_attention",
       ("gather", "batched"): "gather_kv_attention_batched",
       ("ring", "batched"): "ring_attention_batched"}
TOL = 1e-5


def _qkvw(kind):
    rng = np.random.default_rng(0 if kind == "unbatched" else 1)
    return tuple(rng.standard_normal(SHAPES[kind]).astype(np.float32) for _ in range(4))


@pytest.fixture(scope="module")
def ported(tmp_path_factory):
    """Every case on one spawned group of 4 gloo ranks."""
    work = str(tmp_path_factory.mktemp("seq"))
    cases, keys = [], []
    for (impl, kind), fn in FNS.items():
        q, k, v, w = _qkvw(kind)
        cases.append({"fn": fn, "q": q, "k": k, "v": v, "w": w})
        keys.append((impl, kind))
    q, k, v, _ = _qkvw("unbatched")
    bf16 = {n: torch.from_numpy(a).bfloat16() for n, a in zip("qkv", (q, k, v))}
    cases.append({"fn": "ring_attention", **bf16, "w": None})
    keys.append(("ring", "bf16"))
    out = os.path.join(work, "out.pt")
    run_ranks(sequence_cases, WORLD, work, (cases, out), timeout=180)
    return dict(zip(keys, torch.load(out, weights_only=True)))


def _jax(impl, kind, q, k, v):
    return getattr(jseq, FNS[(impl, kind)])(q, k, v, j_make_mesh(n_devices=WORLD), "data")


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("impl", ["gather", "ring"])
def test_sharded_attention_matches_jax(ported, impl, kind):
    q, k, v, _ = (jnp.asarray(a) for a in _qkvw(kind))
    want = np.asarray(jax.jit(lambda q, k, v: _jax(impl, kind, q, k, v))(q, k, v))
    np.testing.assert_allclose(ported[(impl, kind)]["out"].numpy(), want, rtol=TOL, atol=TOL)
    if kind == "unbatched":        # and the unsharded oracle, as JAX's own test holds it
        ref = np.asarray(jseq.reference_attention(q, k, v))
        np.testing.assert_allclose(ported[(impl, kind)]["out"].numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("impl", ["gather", "ring"])
def test_sharded_attention_gradients_match_jax_grad(ported, impl, kind):
    q, k, v, w = (jnp.asarray(a) for a in _qkvw(kind))
    grads = jax.jit(jax.grad(lambda q, k, v: (_jax(impl, kind, q, k, v) * w).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    for name, want in zip("qkv", grads):
        np.testing.assert_allclose(ported[(impl, kind)][f"d{name}"].numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=f"d{name}")


def test_ring_attention_bf16_inputs(ported):
    q, k, v, _ = _qkvw("unbatched")
    got = ported[("ring", "bf16")]["out"]
    assert got.dtype == torch.bfloat16
    ref = np.asarray(jseq.reference_attention(*(jnp.asarray(a) for a in (q, k, v))))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0.05, atol=0.05)


def test_reference_attention_matches_jax():
    q, k, v, _ = _qkvw("unbatched")
    want = np.asarray(jseq.reference_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = sequence.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.fixture
def one_rank(tmp_path):
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                                         rank=0, world_size=1)
    yield make_named_mesh((1,), ("data",), "cpu")
    torch.distributed.destroy_process_group()


def test_world_of_one_hop_is_the_identity_and_attention_the_reference(one_rank):
    q, k, v, w = (torch.from_numpy(a) for a in _qkvw("batched"))
    assert ring_hop(q, one_rank, "data") is q
    ref = torch.stack([sequence.reference_attention(q[b], k[b], v[b]) for b in range(2)])
    for fn in (sequence.ring_attention_batched, sequence.gather_kv_attention_batched):
        torch.testing.assert_close(fn(q, k, v, one_rank), ref, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match=r"a mesh spans the whole process group: shape \(2,\)"):
        make_named_mesh((2,), ("data",), "cpu")


def test_local_block_refuses_a_length_the_axis_does_not_divide(one_rank, monkeypatch):
    monkeypatch.setattr(sequence, "axis_size", lambda mesh, axis: 4)
    monkeypatch.setattr(sequence, "axis_rank", lambda mesh, axis: 1)
    x = torch.arange(24.0).reshape(2, 12)
    torch.testing.assert_close(sequence.local_block(x, one_rank, "data", dim=1), x[:, 3:6])
    with pytest.raises(ValueError, match="T=10 is not divisible by the 'data' axis size 4"):
        sequence.local_block(x[:, :10], one_rank, "data", dim=1)
