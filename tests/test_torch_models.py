"""Parity of the port's learner core with the JAX package: JAX-initialised
``ACParams`` carried across by ``utils.convert.actor_critic_from_jax`` give
the same ``mu``, ``value``, ``log_prob`` and ``evaluate`` outputs on fixed
observations and fixed noise (network dtype f32, atol 1e-5: the order of the
matmul sums differs); RMS update / normalise / freeze, atol 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partmanip_tpu.algos import rms as jrms
from partmanip_tpu.models.actor_critic import ActorCritic as JActorCritic
from partmanip_tpu_torch.algos import rms as trms
from partmanip_tpu_torch.models.actor_critic import ActorCritic as TActorCritic
from partmanip_tpu_torch.utils import convert

import _torch_port as tp

NUM_OBS, NUM_ACT, B = 37, 7, 16


def _model_cfg(dtype="f32", activation="tanh"):
    return {"action_std": 0.5, "action_activate": "tanh", "clipAction": 1.0,
            "network": {"name": "MLP", "hid_dim": [32, 32],
                        "activation": activation, "dtype": dtype}}


@pytest.fixture(scope="module")
def pair():
    cfg = _model_cfg()
    jac = JActorCritic(NUM_OBS, NUM_ACT, cfg)
    params = jac.init(jax.random.PRNGKey(3))
    # a log_std that is not the init value, so std = exp(2·log_std) shows
    params = params._replace(
        log_std=params.log_std + jnp.linspace(-0.3, 0.2, NUM_ACT))
    tac = TActorCritic(NUM_OBS, NUM_ACT, cfg)
    tac.load_state_dict(
        convert.actor_critic_from_jax(tp.jax_params_to_numpy(params)))
    rs = np.random.RandomState(0)
    obs = rs.normal(size=(B, NUM_OBS)).astype(np.float32)
    return jac, params, tac, obs


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_state_dict_layout(pair):
    jac, params, tac, _ = pair
    sd = tac.state_dict()
    kernel = np.asarray(params.actor["params"]["Dense_0"]["kernel"])
    assert kernel.shape == (NUM_OBS, 32)
    assert tuple(sd["actor.hidden.0.weight"].shape) == (32, NUM_OBS)
    np.testing.assert_array_equal(sd["actor.hidden.0.weight"].numpy(), kernel.T)
    assert tuple(sd["critic.head.weight"].shape) == (1, 32)


def test_act_and_value(pair):
    jac, params, tac, obs = pair
    with torch.no_grad():
        _close(tac.act(torch.as_tensor(obs)), jac.act(params, jnp.asarray(obs)))
        a, v = tac.act_cri(torch.as_tensor(obs))
        ja, jv = jac.act_cri(params, jnp.asarray(obs))
        _close(a, ja)
        _close(v, jv)
        _close(tac.cri(torch.as_tensor(obs)), jac.cri(params, jnp.asarray(obs)))
        _close(tac.std(), jac.std(params), 1e-6)


def test_sampling_with_the_same_noise(pair):
    jac, params, tac, obs = pair
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (B, NUM_ACT)))
    want = jac.random_act_cri(params, jnp.asarray(obs), key)
    with torch.no_grad():
        got = tac.random_act_cri(torch.as_tensor(obs),
                                 noise=torch.as_tensor(noise))
        got_a = tac.random_act(torch.as_tensor(obs),
                               noise=torch.as_tensor(noise))
    for g, w in zip(got, want):
        _close(g, w)
    _close(got_a, jac.random_act(params, jnp.asarray(obs), key))


def test_evaluate(pair):
    jac, params, tac, obs = pair
    stored = np.tanh(np.random.RandomState(2).normal(
        size=(B, NUM_ACT))).astype(np.float32)
    want = jac.evaluate(params, jnp.asarray(obs), jnp.asarray(stored))
    with torch.no_grad():
        got = tac.evaluate(torch.as_tensor(obs), torch.as_tensor(stored))
    for g, w in zip(got, want):
        # log-probs are O(10): 1e-5 relative
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


def test_generator_sampling_is_seeded(pair):
    tac, obs = pair[2], torch.as_tensor(pair[3])
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(9)
        with torch.no_grad():
            draws.append(tac.random_act(obs, generator=g))
    assert torch.equal(draws[0], draws[1])
    assert float(draws[0].abs().max()) <= 1.0


def test_rms_update_normalize_freeze():
    rs = np.random.RandomState(7)
    js, ts = jrms.init_rms(NUM_OBS), trms.init_rms(NUM_OBS)
    for i in range(4):
        x = (rs.normal(size=(B, NUM_OBS)) * (1 + i) + i).astype(np.float32)
        update = i < 3                     # the last batch arrives frozen
        jy, js = jrms.normalize(js, jnp.asarray(x), update)
        flag = update if i % 2 else torch.tensor(update)   # bool and tensor
        ty, ts = trms.normalize(ts, torch.as_tensor(x), flag)
        # early batches divide by a std of 1e-2 (S is seeded with 1e-4)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6,
                                   rtol=1e-5)
        _close(ts.mean, js.mean, 1e-6)
        _close(ts.S, js.S, 1e-5)
        assert int(ts.n) == int(js.n)
    assert int(ts.n) == 3
    conv = convert.rms_from_jax({"n": np.asarray(js.n),
                                 "mean": np.asarray(js.mean),
                                 "S": np.asarray(js.S)})
    _close(conv.std, js.std, 1e-6)
