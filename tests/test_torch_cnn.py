"""The paper CNN in the port against the reference.

Same params (the reference's ``init_cnn`` draw, carried over with
``convert.cnn_params_from_jax``), same numpy inputs: client forward,
server loss and every gradient agree within 1e-5 at each cut; the
parameter and FLOP counts agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_cnn as jcfg  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.configs import paper_cnn as cfgs  # noqa: E402
from repro_torch.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

# f32 convolutions and matmuls in two libraries (XLA, oneDNN/ATen) sum in
# different orders; activations and gradients are of order one, so 1e-5
# holds the rounding and catches any layout slip (which is of order one)
TOL = 1e-5
CONFIGS = ["LIGHT_CONFIG", "LIGHT_CIFAR_CONFIG"]


def _setup(name, batch=4, seed=0):
    jc, tc = getattr(jcfg, name), getattr(cfgs, name)
    p_np = jax.tree.map(np.asarray, jcnn.init_cnn(jax.random.key(seed), jc))
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, jc.image_size, jc.image_size, jc.channels).astype(
        np.float32)
    y = rng.randint(0, jc.num_classes, batch).astype(np.int32)
    return jc, tc, p_np, x, y


def test_configs_are_copies():
    for name in ("CONFIG", "CIFAR_CONFIG", "LIGHT_CONFIG",
                 "LIGHT_CIFAR_CONFIG"):
        a, b = getattr(jcfg, name), getattr(cfgs, name)
        assert a.__dict__ == b.__dict__ and a.num_layers == b.num_layers


@pytest.mark.parametrize("name", CONFIGS + ["CONFIG"])
def test_counts_match(name):
    jc, tc = getattr(jcfg, name), getattr(cfgs, name)
    for v in range(1, jc.num_layers):
        assert cnn.phi(tc, v) == jcnn.phi(jc, v)
        assert cnn.smashed_numel(tc, v) == jcnn.smashed_numel(jc, v)
        assert cnn.client_flop_fraction(tc, v) == \
            jcnn.client_flop_fraction(jc, v)
    assert cnn.total_params(tc) == jcnn.total_params(jc)
    assert cnn.block_flops(tc) == jcnn.block_flops(jc)
    assert cnn.block_shapes(tc) == jcnn.block_shapes(jc)
    params = cnn.init_cnn(torch.Generator().manual_seed(0), tc)
    assert cnn.phi(tc, 2, params) == cnn.phi(tc, 2)
    ref = jcnn.init_cnn(jax.random.key(0), jc)
    assert [{k: tuple(v.shape) for k, v in b.items()} for b in params] == \
        [{k: tuple(v.shape) for k, v in b.items()} for b in ref]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("v", [1, 2, 3, 4])
def test_forward_loss_and_grads_match(name, v):
    jc, tc, p_np, x, y = _setup(name)
    params = cnn_params_from_jax(p_np)
    for blk in params:
        for t in blk.values():
            t.requires_grad_(True)

    smashed = cnn.client_forward(params[:v], torch.from_numpy(x), tc, v)
    sm_in = smashed.detach().requires_grad_(True)
    loss = cnn.server_loss(params[v:], sm_in, torch.from_numpy(y).long(),
                           tc, v)
    loss.backward()
    smashed.backward(sm_in.grad)

    def jloss(p, xb):
        sm = jcnn.client_forward(p[:v], xb, jc, v)
        return jcnn.server_loss(p[v:], sm, jnp.asarray(y), jc, v), sm

    (jl, jsm), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x))
    np.testing.assert_allclose(smashed.detach().numpy(), np.asarray(jsm),
                               rtol=TOL, atol=TOL)
    assert abs(loss.item() - float(jl)) <= TOL * max(1.0, abs(float(jl)))
    for tb, jb in zip(params, jg):
        for k in ("w", "b"):
            np.testing.assert_allclose(tb[k].grad.numpy(),
                                       np.asarray(jb[k]), rtol=TOL, atol=TOL)
    assert jgx.shape == x.shape


@pytest.mark.parametrize("name", CONFIGS)
def test_full_forward_matches(name):
    jc, tc, p_np, x, _ = _setup(name, batch=6, seed=3)
    got = cnn.forward_blocks(cnn_params_from_jax(p_np), torch.from_numpy(x),
                             tc, 0, tc.num_layers)
    want = jcnn.forward_blocks(jax.tree.map(jnp.asarray, p_np),
                               jnp.asarray(x), jc, 0, jc.num_layers)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_block1_flattens_nhwc():
    """fc1's rows follow the reference's NHWC flatten: an NCHW flatten
    would permute them, and the block's output would differ."""
    tc = cfgs.LIGHT_CONFIG
    params = cnn.init_cnn(torch.Generator().manual_seed(1), tc)
    x = torch.rand(2, 28, 28, 1)
    h = cnn.apply_block(0, params[0], x, tc)
    out = cnn.apply_block(1, params[1], h, tc)
    assert out.shape == (2, cnn.smashed_numel(tc, 2))
    w = params[1]["w"].permute(3, 2, 0, 1)
    y = torch.nn.functional.conv2d(h.permute(0, 3, 1, 2), w, padding=2)
    y = torch.nn.functional.max_pool2d(
        torch.relu(y + params[1]["b"][:, None, None]), 2, 2)
    assert torch.equal(out, y.permute(0, 2, 3, 1).reshape(2, -1))
    assert not torch.equal(out, y.reshape(2, -1))


def test_init_is_seeded_and_he_scaled():
    tc = cfgs.CONFIG
    a = cnn.init_cnn(torch.Generator().manual_seed(5), tc)
    b = cnn.init_cnn(torch.Generator().manual_seed(5), tc)
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a, b) for k in p)
    fc1 = a[2]["w"]
    assert abs(fc1.std().item() - (2.0 / fc1.shape[0]) ** 0.5) < 2e-3
    assert all(not p["b"].any() for p in a)
