"""The split LM's full-sequence forward: the port against the reference on
the CPU.

``client_forward`` -> ``server_forward`` and ``lm_loss``, with
``impl="flash"`` (kernels B4 and B5; on the CPU their plain versions,
against the reference's interpret-mode Pallas kernels) and
``impl="jnp"`` (the model's own masked-softmax attention and
``ssd_chunked`` in both packages), at reduced granite-8b (2 attention
layers) and reduced mamba2-130m (2 Mamba-2 layers), from the reference's
``init_lm`` weights. Sequence lengths are ragged for both kernels: 100
tokens for granite (a full and a partial 64-query tile), 70 for mamba2
(two chunks of 32 and a 6-token sequential tail).

Tolerance: logits within 1e-4 absolute (values of order 5; the two
frameworks' f32 differ by about 5e-6 after two layers), the loss within
1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

LOGITS_TOL = 1e-4
LOSS_RTOL = 1e-5
SEQ = {"granite-8b": 100, "mamba2-130m": 70}


@pytest.fixture(scope="module", params=sorted(SEQ))
def model(request):
    arch = request.param
    rcfg = ref_reduced(ref_get_config(arch))
    cfg = reduced_config(get_config(arch))
    rplan, plan = rlm.build_plan(rcfg, 1), lm.build_plan(cfg, 1)
    rparams = rlm.init_lm(jax.random.key(3), rplan, jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), plan)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, cfg.vocab_size, (2, SEQ[arch])).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, toks.shape).astype(np.int32)
    labels[0, :5] = -1  # ignored positions
    return (rplan, rparams), (plan, params), toks, labels


@pytest.mark.parametrize("impl", ["flash", "jnp"])
def test_split_forward_matches_reference(model, impl):
    (rplan, rparams), (plan, params), toks, _ = model
    sm_r, aux_r = rlm.client_forward(rparams, rplan, jnp.asarray(toks),
                                     impl=impl, remat=False,
                                     dtype=jnp.float32)
    lg_r, _ = rlm.server_forward(rparams, rplan, sm_r, impl=impl,
                                 remat=False)
    sm, aux = lm.client_forward(params, plan,
                                torch.from_numpy(toks).long(), impl=impl)
    lg, _ = lm.server_forward(params, plan, sm, impl=impl)
    np.testing.assert_allclose(sm.numpy(), np.asarray(sm_r),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    assert float(aux) == float(aux_r) == 0.0


@pytest.mark.parametrize("impl", ["flash", "jnp"])
def test_lm_loss_matches_reference(model, impl):
    (rplan, rparams), (plan, params), toks, labels = model
    total_r, (loss_r, _) = rlm.lm_loss(
        rparams, rplan, jnp.asarray(toks), jnp.asarray(labels), impl=impl,
        remat=False, dtype=jnp.float32)
    total, (loss, _) = lm.lm_loss(params, plan,
                                  torch.from_numpy(toks).long(),
                                  torch.from_numpy(labels).long(), impl=impl)
    assert abs(float(loss) - float(loss_r)) <= LOSS_RTOL * abs(float(loss_r))
    assert abs(float(total) - float(total_r)) <= \
        LOSS_RTOL * abs(float(total_r))


def test_boundary_fn_sees_the_smashed_data(model):
    """The SFL-GA aggregation op plugs in at the boundary: lm_loss hands
    it the client's output and continues from what it returns."""
    _, (plan, params), toks, labels = model
    seen = []

    def boundary(x):
        seen.append(x)
        return x * 0.0

    t = torch.from_numpy(toks).long()
    lm.lm_loss(params, plan, t, torch.from_numpy(labels).long(),
               boundary_fn=boundary)
    sm, _ = lm.client_forward(params, plan, t)
    torch.testing.assert_close(seen[0], sm, atol=0, rtol=0)
    zero_logits, _ = lm.server_forward(params, plan, torch.zeros_like(sm))
    want = lm.cross_entropy(zero_logits, torch.from_numpy(labels).long())
    _, (loss, _) = lm.lm_loss(params, plan, t,
                              torch.from_numpy(labels).long(),
                              boundary_fn=boundary)
    assert float(loss) == float(want)
