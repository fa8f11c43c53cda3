"""The port's network module on its own (no JAX needed): seeded orthogonal
init with the gain schedule of the JAX package (√2 hidden, 0.01 policy head,
1 value head, zero biases), the bf16 / f32 compute-dtype knob, and the
refusal of the architectures that are not ported."""

import numpy as np
import pytest
import torch

from partmanip_tpu_torch.models import networks as tnetworks
from partmanip_tpu_torch.models.actor_critic import ActorCritic as TActorCritic

NUM_OBS, NUM_ACT, B = 37, 7, 16


def _model_cfg(dtype="f32", activation="tanh"):
    return {"action_std": 0.5, "action_activate": "tanh", "clipAction": 1.0,
            "network": {"name": "MLP", "hid_dim": [32, 32],
                        "activation": activation, "dtype": dtype}}


def test_seeded_init_follows_the_gain_schedule():
    tac = TActorCritic(NUM_OBS, NUM_ACT, _model_cfg())
    tac.init(4)
    first = {k: v.clone() for k, v in tac.state_dict().items()}
    tac.init(4)
    for k, v in tac.state_dict().items():
        assert torch.equal(v, first[k])
    w = first["actor.hidden.1.weight"]               # orthogonal, gain √2
    np.testing.assert_allclose((w @ w.T).numpy(), 2.0 * np.eye(32), atol=1e-4)
    head = first["actor.head.weight"]                # gain 0.01
    np.testing.assert_allclose((head @ head.T).numpy(),
                               1e-4 * np.eye(NUM_ACT), atol=1e-7)
    assert float(first["critic.head.bias"].abs().max()) == 0.0
    np.testing.assert_allclose(first["log_std"].numpy(), np.log(0.5), atol=1e-6)


def test_bf16_is_the_default_compute_dtype():
    cfg = _model_cfg()
    del cfg["network"]["dtype"]
    net = tnetworks.MLP(NUM_OBS, 4, cfg["network"])
    x = torch.as_tensor(np.random.RandomState(1).normal(
        size=(B, NUM_OBS)).astype(np.float32))
    with torch.no_grad():
        y = net(x)
        net.dtype = None
        y32 = net(x)
    assert y.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert 0 < float((y - y32).abs().max()) < 2e-2
    with pytest.raises(ValueError, match="dtype"):
        tnetworks.MLP(NUM_OBS, 4, dict(cfg["network"], dtype="f16"))


@pytest.mark.parametrize("name", ["depthResNet", "ResNet"])
def test_vision_networks_raise(name):
    """The image students build at their 72×128 input and raise on any
    other input size."""
    channels = 1 if name == "depthResNet" else 3
    net = tnetworks.make_network(name, channels * 72 * 128, 4, _model_cfg()["network"])
    assert isinstance(net, tnetworks.NETWORKS[name])
    with pytest.raises(ValueError, match=f"{channels} × 72 × 128"):
        tnetworks.make_network(name, 8, 4, _model_cfg()["network"])
