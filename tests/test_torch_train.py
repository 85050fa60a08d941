"""The port's contrastive trainer (``pathway_tpu_torch.models.train``) against the JAX
package's (``pathway_tpu.models.train``), on a tiny f32 encoder (hidden 64, 2 layers,
4 heads, vocab 512) carried across by ``params_from_jax``, with b=8 pairs of t=16
tokens from numpy with a seed (ragged masks, every sequence with a real token).

Tolerances, all f32:
- the InfoNCE loss and every parameter's gradient within 1e-5 of JAX's, relative to
  the loss and to the leaf's largest gradient (the same arithmetic, summed in another
  order), with dense attention and with the flash attention of each package (JAX's
  Pallas kernels in interpret mode, the port's plain versions);
- one AdamW update within 1e-6 of ``optax.adamw(1e-4)`` on identical gradients;
- three train steps: the losses within 1e-4 of JAX ``make_train_step``'s on a
  one-device mesh. Adam turns gradients that are rounding noise into full +-lr steps of
  either sign, so the trajectories are compared by their losses only.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathway_tpu.models import train as jtrain
from pathway_tpu.models import transformer as jt
from pathway_tpu.parallel.mesh import MeshConfig, make_mesh
from pathway_tpu_torch.models import train as ttrain
from pathway_tpu_torch.models import transformer as tt
from pathway_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("pathway_tpu.ops.flash_attention")

SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, intermediate=128, max_len=64)
B, T = 8, 16


@pytest.fixture(scope="module")
def jax_params():
    cfg = jt.EncoderConfig(**SMALL, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jt.init_encoder_params(jax.random.key(0), cfg))


def _batch(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _side in range(2):
        ids = rng.integers(4, SMALL["vocab_size"], (B, T)).astype(np.int32)
        mask = np.arange(T)[None, :] < rng.integers(2, T + 1, B)[:, None]
        ids[~mask] = 0
        out += [ids, mask]
    return out


def _port_cfg():
    return tt.EncoderConfig(**SMALL, dtype=torch.float32)


def _port_model(params):
    model = tt.Encoder(_port_cfg(), device="cpu", seed=None, trainable=True)
    model.load_state_dict(tt.params_from_jax(params))
    return model


def test_params_carry_across_unchanged(jax_params):
    model = _port_model(jax_params)
    state = tt.params_from_jax(jax_params)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, name
        assert torch.equal(p.detach(), state[name]), name
    # a trainable encoder keeps its f32 masters even with a bf16 compute dtype
    cfg = tt.EncoderConfig(**SMALL)
    model = tt.Encoder(cfg, device="cpu", seed=None, trainable=True)
    model.load_state_dict(state)
    assert torch.equal(model.layers[0].qkv_w.detach(), state["layers.0.qkv_w"])


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_info_nce_loss_and_gradients_match_jax(jax_params, attn):
    batch = _batch(seed=1)
    jcfg = jt.EncoderConfig(**SMALL, dtype=jnp.float32)
    jattn = jt.dense_attention if attn == "dense" else jfa.flash_attention
    jbatch = jtrain.ContrastiveBatch(*(jnp.asarray(x) for x in batch))
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_params)
    ref_loss, ref_grads = jax.value_and_grad(jtrain.info_nce_loss)(
        jparams, jbatch, jcfg, 0.05, jattn
    )
    ref_grads = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads))

    model = _port_model(jax_params)
    tattn = tt.dense_attention if attn == "dense" else tfa.flash_attention
    tbatch = ttrain.ContrastiveBatch(*(torch.from_numpy(x) for x in batch))
    loss = ttrain.info_nce_loss(model, tbatch, model.cfg, 0.05, tattn)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for name, p in model.named_parameters():
        ref = ref_grads[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_adamw_update_matches_optax():
    rng = np.random.default_rng(2)
    params = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 4))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params] for _ in range(2)]
    tx = optax.adamw(1e-4)
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = ttrain.adamw(tparams, 1e-4)
    for step_grads in grads:  # two updates: the bias correction of step 1 and of step 2
        updates, opt_state = tx.update([jnp.asarray(g) for g in step_grads], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, step_grads):
            p.grad = torch.from_numpy(g)
        opt.step()
    for a, b in zip(tparams, jparams):
        assert np.abs(a.detach().numpy() - np.asarray(b)).max() < 1e-6


def test_three_steps_match_jax_make_train_step():
    jcfg = jt.EncoderConfig(**SMALL, dtype=jnp.float32)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jinit, jstep, sharding = jtrain.make_train_step(jcfg, mesh)
    jstate = jinit(jax.random.key(4))
    params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    batch = _batch(seed=5)
    jbatch = jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(x), s), jtrain.ContrastiveBatch(*batch), sharding
    )
    init_fn, step_fn = ttrain.make_train_step(_port_cfg(), device="cpu")
    state = init_fn(params=params)
    tbatch = ttrain.ContrastiveBatch(*(torch.from_numpy(x) for x in batch))
    ours, ref = [], []
    for _ in range(3):
        jstate, jloss = jstep(jstate, jbatch)
        state, loss = step_fn(state, tbatch)
        ref.append(float(jloss))
        ours.append(float(loss))
    assert state.step == 3 and int(jstate.step) == 3
    assert np.abs(np.array(ours) - np.array(ref)).max() < 1e-4, (ours, ref)
    assert ours[2] < ours[0] and np.isfinite(ours).all()


def test_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.make_train_step(_port_cfg())
